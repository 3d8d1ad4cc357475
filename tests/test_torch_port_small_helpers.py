"""The port's small helpers against the JAX package's and the root scripts'
on the CPU: `rgb2ycbcr` and `usm_sharp` (the same numpy code: equal at
atol 0), the bitstream container's primitives (byte for byte), the
fault injectors (the same bytes and latents from the same seeds), and
`make_file_list`'s lists (identical files)."""
import io
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from experiments import corruptors as jc
from rdeic_torch import make_file_list as t_make_file_list
from rdeic_torch.experiments import corruptors as tc
from rdeic_torch.utils import bitstream as tbs
from rdeic_torch.utils import image as ti
from rdeic_tpu.utils import bitstream as jbs
from rdeic_tpu.utils import image as ji

ROOT = Path(__file__).resolve().parent.parent


def _rgb(seed, shape=(2, 21, 34, 3)):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


@pytest.mark.parametrize("y_only", [True, False])
def test_rgb2ycbcr_equals_jax(y_only):
    img = _rgb(1)
    got = ti.rgb2ycbcr(img, y_only=y_only)
    np.testing.assert_array_equal(got, ji.rgb2ycbcr(img, y_only=y_only))
    assert got.shape == (*img.shape[:-1], 1 if y_only else 3)


@pytest.mark.parametrize("opts", [{}, {"weight": 0.8, "radius": 12,
                                       "threshold": 0.02}])
def test_usm_sharp_equals_jax(opts):
    img = _rgb(2, (40, 52, 3))
    got = ti.usm_sharp(img, **opts)
    np.testing.assert_array_equal(got, ji.usm_sharp(img, **opts))
    assert not np.array_equal(got, img)


@pytest.mark.parametrize("values", [(), (0,), (7, 2 ** 32 - 1, 12345)])
def test_uints_equal_jax(values):
    t_buf, j_buf = io.BytesIO(), io.BytesIO()
    assert tbs.write_uints(t_buf, values) == jbs.write_uints(j_buf, values)
    assert t_buf.getvalue() == j_buf.getvalue()
    assert tbs.read_uints(io.BytesIO(j_buf.getvalue()), len(values)) == values


@pytest.mark.parametrize("data", [b"", b"\x00", bytes(range(256)) * 3])
def test_bytes_equal_jax(data):
    t_buf, j_buf = io.BytesIO(), io.BytesIO()
    assert tbs.write_bytes(t_buf, data) == jbs.write_bytes(j_buf, data) == len(data)
    assert t_buf.getvalue() == j_buf.getvalue() == data
    src = io.BytesIO(data + b"tail")
    assert tbs.read_bytes(src, len(data)) == data and src.read() == b"tail"


def test_body_on_the_primitives_equals_jax():
    strings = [[b"abc"], [b""], [bytes(range(200))]]
    t_buf, j_buf = io.BytesIO(), io.BytesIO()
    assert (tbs.write_body(t_buf, (6, 9), strings)
            == jbs.write_body(j_buf, (6, 9), strings) == 12 + 3 * 4 + 203)
    assert t_buf.getvalue() == j_buf.getvalue()
    got = tbs.read_body(io.BytesIO(t_buf.getvalue()))
    assert got == jbs.read_body(io.BytesIO(t_buf.getvalue()))
    assert got == (strings, (6, 9))


DATA = np.random.default_rng(0).integers(0, 256, 3000, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("rate", [0.0, 1e-3, 0.05])
@pytest.mark.parametrize("seed", [0, 3])
def test_bit_and_burst_flips_equal_the_root_corruptors(rate, seed):
    got = tc.bit_flip_bytes(DATA, rate, seed=seed)
    assert got == jc.bit_flip_bytes(DATA, rate, seed=seed)
    burst = tc.burst_flip_bytes(DATA, rate, mean_burst_len=4.0, seed=seed)
    assert burst == jc.burst_flip_bytes(DATA, rate, mean_burst_len=4.0, seed=seed)
    assert (got == DATA) == (rate == 0.0)


@pytest.mark.parametrize("mode", ["mask_replace", "additive"])
@pytest.mark.parametrize("severity", [0.0, 0.3])
def test_latent_corruption_equals_the_root_corruptors(mode, severity):
    lat = np.random.default_rng(4).normal(size=(1, 6, 5, 4)).astype(np.float32)
    got = tc.Corruptor("latent", mode, severity, seed=5).apply_latent(lat)
    want = jc.Corruptor("latent", mode, severity, seed=5).apply_latent(lat)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if severity == 0.0:
        np.testing.assert_array_equal(got, lat)


def test_corruptor_dispatch_and_corrupt_file_equal_the_root(tmp_path):
    for mode in tc.Corruptor.BITSTREAM_MODES:
        assert (tc.Corruptor("bitstream", mode, 0.01, seed=2).apply_bytes(DATA)
                == jc.Corruptor("bitstream", mode, 0.01, seed=2).apply_bytes(DATA))
    for mod in (tc, jc):
        with pytest.raises(ValueError):
            mod.Corruptor("bitstream", "erase", 0.1).apply_bytes(DATA)
        with pytest.raises(ValueError, match="unknown latent"):
            mod.latent_corrupt(np.zeros(3), "erase")
    src = tmp_path / "s.rdeic"
    src.write_bytes(DATA)
    tc.corrupt_file(src, tmp_path / "t", 0.02, burst=True, seed=1)
    jc.corrupt_file(src, tmp_path / "j", 0.02, burst=True, seed=1)
    got = (tmp_path / "t").read_bytes()
    assert got == (tmp_path / "j").read_bytes()
    assert got[:12] == DATA[:12] and got != DATA


def test_make_file_list_equals_the_root_script(tmp_path, monkeypatch):
    for folder, names in (("a", ["x.png", "y.JPG", "sub/z.webp", "n.txt"]),
                          ("b", ["p.bmp", "q.jpeg"])):
        for name in names:
            (tmp_path / folder / name).parent.mkdir(parents=True, exist_ok=True)
            (tmp_path / folder / name).write_bytes(b"")
    args = ["--img_folder", str(tmp_path / "a"), str(tmp_path / "b"),
            "--val_size", "2", "--seed", "7"]
    t_make_file_list.main([*args, "--save_folder", str(tmp_path / "t")])
    sys.path.insert(0, str(ROOT))
    try:
        import make_file_list as j_make_file_list
    finally:
        sys.path.remove(str(ROOT))
    monkeypatch.setattr(sys, "argv", ["make_file_list.py", *args,
                                      "--save_folder", str(tmp_path / "j")])
    j_make_file_list.main()
    for name in ("train.list", "valid.list"):
        got = (tmp_path / "t" / name).read_text()
        assert got == (tmp_path / "j" / name).read_text()
    assert len((tmp_path / "t" / "train.list").read_text().split()) == 3


def test_harness_imports_pull_no_jax_yaml_or_pil():
    """The new modules import as the card's machine needs them: no JAX,
    yaml or PIL until a CLI reads a config or an image."""
    code = ("import sys, rdeic_torch.baseline_inference, "
            "rdeic_torch.image_checker, rdeic_torch.make_file_list, "
            "rdeic_torch.experiments.run_ood, "
            "rdeic_torch.experiments.run_robustness, "
            "rdeic_torch.experiments.generate_qualitative_grids, "
            "rdeic_torch.experiments.corruptors, rdeic_torch.utils.profiling, "
            "rdeic_torch.utils.niqe, rdeic_torch.utils.brisque; "
            "bad = {'jax', 'flax', 'yaml', 'PIL', 'rdeic_tpu'} & set(sys.modules); "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


@pytest.mark.parametrize("header,why", [
    (b"", "empty"),
    (np.asarray([0x80000000], "<u4").tobytes(), "v2 without lanes"),
    (np.asarray([0x80000000 | 1025], "<u4").tobytes(), "v2 past 1024 lanes"),
    (np.asarray([0x80000000 | 8, 4], "<u4").tobytes(), "v2 with counts"),
    (np.asarray([0], "<u4").tobytes(), "v1 without lanes"),
    (np.asarray([3, 10, 12], "<u4").tobytes(), "v1 short of counts"),
    (np.asarray([1, 10, 12], "<u4").tobytes(), "v1 past its counts"),
])
def test_lane_header_refuses_what_no_codec_writes(header, why):
    """A corrupt stream's lanes header raises ValueError before the decoder
    sizes anything by its K (a K of 0 would divide by zero in the host's
    shared decoder; a huge one would size the card's state)."""
    from rdeic_torch.pipeline.codec import (  # noqa: PLC0415
        lane_header, parse_lane_header)

    with pytest.raises(ValueError, match="corrupt lanes header"):
        parse_lane_header(header)
    ver, k, counts = parse_lane_header(lane_header(3, [10, 12, 14]))
    assert (ver, k, counts.tolist()) == (1, 3, [10, 12, 14])
    assert parse_lane_header(lane_header(1024, None)) == (2, 1024, None)
