"""Tiled high-resolution serving, rdeic_torch against rdeic_tpu on the CPU at
the micro width: the tile grid and blend weights exactly; the stream files
of `tiled_compress` (v1) and `tiled_compress_xctx` (v2), with and without
interleaved lanes, byte for byte with the same bpp; the JAX-written streams
(v1 with 2 and 3 groups a tile, v2 with 3 and 4 groups) decoded by
`tiled_decompress_decode` with each tile batch's noise from the JAX split
sequence, within 2e-4 of the JAX output, a ragged last tile batch
included; each tile batch bit-equal to `decode_pipeline` of its tiles; the
stream checks; and the CLI on a PNG."""
import struct

import jax
import numpy as np
import pytest
import torch

from rdeic_torch import tiled_inference
from rdeic_torch.pipeline import tiled as tt
from rdeic_tpu.pipeline import tiled as jt
from tests.test_torch_port_slice import _jax_noise
from tests.torch_port_helpers import (  # noqa: F401 (an autouse fixture)
    MICRO, micro_pair, one_torch_thread_per_module, random_flat_params)

STEPS = 2
# name -> (image H x W, v2, RDEIC_RANS_* settings, tile batch, string
# groups: a tile's in v1, the file's in v2)
CASES = {
    "v1": ((64, 96), False, {}, 2, 2),
    "v1_lanes": ((64, 96), False, {"RDEIC_RANS_LANES": "4"}, 0, 3),
    "v2": ((96, 160), True, {}, 4, 3),
    "v2_lanes": ((96, 160), True, {"RDEIC_RANS_LANES": "64",
                                   "RDEIC_RANS_OVERHEAD_PCT": "0"}, 4, 4),
}
ENV = ("RDEIC_RANS_LANES", "RDEIC_RANS_OVERHEAD_PCT", "RDEIC_RANS_SHARED",
       "RDEIC_RANS_DEVICE_ENC", "RDEIC_RANS_DEVICE_MIN_LANES")


@pytest.mark.parametrize("h,w,tile,overlap", [
    (128, 192, 64, 32), (64, 64, 64, 32), (1408, 2048, 512, 64),
    (100, 300, 64, 16), (64, 576, 64, 0)])
def test_tile_grid_and_blend_weight_are_the_jax_packages(h, w, tile, overlap):
    assert tt._tile_grid(h, w, tile, overlap) == jt._tile_grid(h, w, tile,
                                                               overlap)
    got, want = tt._blend_weight(tile, overlap), jt._blend_weight(tile, overlap)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_blend_is_the_jax_packages_numpy_blend():
    rng = np.random.default_rng(0)
    ys, xs = jt._tile_grid(128, 192, 64, 32)
    tiles = rng.uniform(size=(len(ys) * len(xs), 64, 64, 3)).astype(np.float32)
    want = jt._blend_tiles(tiles, ys, xs, 64, 32, 128, 192, 100, 170)
    got = tt._blend_tiles(torch.from_numpy(tiles), ys, xs, 64, 32, 128, 192,
                          100, 170)
    assert got.shape == (1, 100, 170, 3)
    np.testing.assert_array_equal(got.numpy(), want)


def _env(monkeypatch, settings):
    for key in ENV:
        monkeypatch.delenv(key, raising=False)
    for key, value in settings.items():
        monkeypatch.setenv(key, value)


@pytest.fixture(scope="module")
def tiled_runs(tmp_path_factory):
    """Each case's stream file written by both packages from one image,
    and the JAX decode of the JAX file."""
    jm, params, tm = micro_pair(seed=0)
    tmp = tmp_path_factory.mktemp("tiled")
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, ((h, w), v2, env, tile_batch, _) in CASES.items():
            _env(mp, env)
            jm._codec = tm._codec = None  # both read the settings when built
            img = np.random.default_rng(h + w).uniform(
                size=(1, h, w, 3)).astype(np.float32)
            j_path, t_path = tmp / f"{name}_jax.rdeic", tmp / f"{name}.rdeic"
            jf = jt.tiled_compress_xctx if v2 else jt.tiled_compress
            tf = tt.tiled_compress_xctx if v2 else tt.tiled_compress
            j_bpp = jf(jm, params, img, str(j_path), tile=64, overlap=32)
            t_bpp = tf(tm, img, t_path, tile=64, overlap=32)
            key = jax.random.PRNGKey(len(runs) + 1)
            want = jt.tiled_decompress_decode(jm, params, str(j_path), key,
                                              steps=STEPS,
                                              tile_batch=tile_batch)
            runs[name] = dict(j_path=j_path, t_path=t_path, j_bpp=j_bpp,
                              t_bpp=t_bpp, key=key, want=np.asarray(want),
                              env=env, tile_batch=tile_batch)
        jm._codec = tm._codec = None
    return dict(tm=tm, runs=runs)


def _tile_noise(key, n, tile_batch, shape):
    """The JAX package's draws: one split of `key` per tile batch
    (tiled.py `_batched_tile_decode`), each batch's key through
    decode_pipeline's draws, at the batch's own size."""
    out = []
    for a, b in tt.tile_batches(n, tile_batch):
        key, sub = jax.random.split(key)
        relay, steps = _jax_noise(sub, (b - a, *shape), STEPS)
        out.append({"relay_noise": relay, "step_noise": steps})
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_stream_files_are_byte_equal(tiled_runs, name):
    run = tiled_runs["runs"][name]
    assert run["t_path"].read_bytes() == run["j_path"].read_bytes()
    assert run["t_bpp"] == run["j_bpp"]
    strings, _ = tt.read_tiled(run["t_path"])
    meta = strings[0][0]
    v2, groups = CASES[name][1], CASES[name][4]
    if v2:  # meta + the codec's groups
        assert len(meta) == struct.calcsize(tt.META2_FMT)
        assert len(strings) == groups
    else:  # meta + each tile's groups
        assert len(meta) == struct.calcsize(tt.META_FMT)
        n_tiles = int(np.prod(struct.unpack(tt.META_FMT, meta)[4:]))
        assert len(strings) - 1 == n_tiles * groups


@pytest.mark.parametrize("name", list(CASES))
def test_decode_of_the_jax_stream_matches_jax(tiled_runs, monkeypatch, name):
    run, tm = tiled_runs["runs"][name], tiled_runs["tm"]
    _env(monkeypatch, run["env"])
    tm._codec = None
    strings, zshape = tt.read_tiled(run["j_path"])
    cl, gh, *_ = tt.decode_tile_latents(tm, strings, zshape)
    noise = _tile_noise(run["key"], cl.shape[0], run["tile_batch"],
                        tuple(cl.shape[1:]))
    got = tt.tiled_decompress_decode(tm, run["j_path"], steps=STEPS,
                                     tile_batch=run["tile_batch"], noise=noise)
    tm._codec = None
    assert got.shape == run["want"].shape
    np.testing.assert_allclose(got.numpy(), run["want"], atol=2e-4)
    # each tile batch is decode_pipeline of its tiles with the same noise
    batches = tt.tile_batches(cl.shape[0], run["tile_batch"])
    if name.startswith("v2") and run["tile_batch"]:
        assert batches[-1][1] - batches[-1][0] < run["tile_batch"]  # ragged
    recon = tt._batched_tile_decode(tm, cl, gh, STEPS, "ddpm",
                                    run["tile_batch"], noise, None)
    for j, (a, b) in enumerate(batches):
        alone = tm.decode_pipeline(cl[a:b], gh[a:b], STEPS, **noise[j])
        torch.testing.assert_close(recon[a:b], alone, rtol=0, atol=0)


def test_v2_features_are_each_tiles_own(tiled_runs):
    """The batched VAE encoder runs image by image: the stitched map holds
    each tile's single-tile feature (the last tile's corner here)."""
    tm = tiled_runs["tm"]
    img = np.random.default_rng(3).uniform(size=(1, 96, 160, 3)).astype(
        np.float32)
    h_full, (ph, pw), tile, _ = tt.stitched_feature(tm, img, 64, 32)
    padded = np.pad(img, ((0, 0), (0, ph - 96), (0, pw - 160), (0, 0)))
    last = tm.feature(torch.from_numpy(np.ascontiguousarray(
        padded[:, ph - tile:, pw - tile:])))
    torch.testing.assert_close(h_full[:, -16:, -16:], last[:, -16:, -16:],
                               rtol=0, atol=0)


def test_stream_checks(tiled_runs, tmp_path):
    tm = tiled_runs["tm"]
    img = np.zeros((1, 64, 64, 3), np.float32)
    with pytest.raises(ValueError, match="multiple of"):
        tt.tiled_compress_xctx(tm, img, tmp_path / "x.rdeic", tile=64,
                               overlap=2)
    with pytest.raises(ValueError, match="multiple of 64"):
        tt.tiled_compress(tm, img, tmp_path / "x.rdeic", tile=96)
    with pytest.raises(ValueError, match="even"):
        tt.tiled_compress(tm, img, tmp_path / "x.rdeic", tile=64, overlap=3)
    from rdeic_torch.utils.bitstream import write_body  # noqa: PLC0415

    bad = tmp_path / "bad.rdeic"
    meta = struct.pack(tt.META_FMT, 64, 128, 64, 32, 1, 3)
    with bad.open("wb") as f:
        write_body(f, (2, 2), [[meta]] + [[b"x"]] * 7)
    with pytest.raises(ValueError, match="corrupt tiled stream"):
        tt.tiled_decompress_decode(tm, bad)
    meta = struct.pack(tt.META2_FMT, 2, 64, 128, 64, 32, 1, 3)
    with bad.open("wb") as f:
        write_body(f, (2, 2), [[meta]] + [[b"x"]] * 4)
    with pytest.raises(ValueError, match="corrupt cross-tile stream"):
        tt.tiled_decompress_decode(tm, bad)


def test_cli_on_a_png(tmp_path, monkeypatch):
    """`python -m rdeic_torch.tiled_inference` on a micro YAML + .npz and a
    PNG: the PNG's size back, the stream the JAX package's v2 writes for
    the image, the root CLI's line; `--use_mesh` (over the one CPU) the
    same image."""
    yaml = pytest.importorskip("yaml")
    from PIL import Image  # noqa: PLC0415

    _env(monkeypatch, {})
    jm, params, _ = micro_pair(seed=1)
    np.savez(tmp_path / "p.npz", **random_flat_params(jm, (64, 64), seed=1))
    (tmp_path / "m.yaml").write_text(yaml.safe_dump(
        {"target": "rdeic_tpu.pipeline.rdeic.RDEIC", "params": MICRO}))
    arr = np.random.default_rng(2).integers(0, 256, (49, 77, 3), dtype=np.uint8)
    Image.fromarray(arr).save(tmp_path / "photo.png")
    args = ["--ckpt", str(tmp_path / "p.npz"), "--config",
            str(tmp_path / "m.yaml"), "--input", str(tmp_path / "photo.png"),
            "--output", str(tmp_path / "out"), "--tile", "64", "--overlap",
            "32", "--tile_batch", "2", "--device", "cpu"]
    tiled_inference.main(args)
    assert np.array(Image.open(tmp_path / "out" / "photo.png")).shape == \
        (49, 77, 3)
    jt.tiled_compress_xctx(jm, params, arr.astype(np.float32)[None] / 255.0,
                           str(tmp_path / "jax.rdeic"), tile=64, overlap=32)
    assert ((tmp_path / "out" / "bitstreams" / "photo.rdeic").read_bytes()
            == (tmp_path / "jax.rdeic").read_bytes())
    # --use_mesh over every device: the one CPU, so the run without it
    mesh_args = [a if a != str(tmp_path / "out") else str(tmp_path / "mesh")
                 for a in args]
    tiled_inference.main(mesh_args + ["--use_mesh"])
    np.testing.assert_array_equal(
        np.array(Image.open(tmp_path / "mesh" / "photo.png")),
        np.array(Image.open(tmp_path / "out" / "photo.png")))
