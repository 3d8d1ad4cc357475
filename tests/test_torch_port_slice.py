"""The whole inference slice, rdeic_torch against rdeic_tpu on the CPU: a
micro RDEIC with the same random weights codes a 49x77 image to byte-equal
stream files, decodes them to the same latents, and relay-samples to the same
reconstruction when the port is handed the JAX stream's noise."""
import jax
import numpy as np
import pytest
import torch

from rdeic_torch import inference as t_inference
from rdeic_torch.utils.image import pad, to_float01
from tests.helpers import micro_rdeic
from tests.torch_port_helpers import MICRO, micro_pair, n


def _jax_noise(rng, shape, steps):
    """The draws of rdeic_tpu's decode_pipeline for `rng`: the relay noise
    (pipeline/rdeic.py:446,430), then one per step (spaced.py:100,111)."""
    rng_init, rng_loop = jax.random.split(rng)
    relay = jax.random.normal(rng_init, shape, jax.numpy.float32)
    steps_noise = []
    for _ in range(steps):
        rng_loop, key = jax.random.split(rng_loop)
        steps_noise.append(jax.random.normal(key, shape, jax.numpy.float32))
    return (torch.from_numpy(np.array(relay)),
            [torch.from_numpy(np.array(s)) for s in steps_noise])


@pytest.fixture(scope="module")
def slice_run(tmp_path_factory):
    jm, params, tm = micro_pair(seed=1)
    ref = micro_rdeic()
    assert (ref.compression.slice_ch, ref.denoiser.model_channels) == \
        (jm.compression.slice_ch, jm.denoiser.model_channels)
    arr = np.random.default_rng(2).integers(0, 256, (49, 77, 3), dtype=np.uint8)
    img01 = to_float01(pad(arr, 64))[None]
    h, w = img01.shape[1:3]
    tmp = tmp_path_factory.mktemp("slice")
    j_path, t_path = tmp / "jax.rdeic", tmp / "torch.rdeic"

    j_bpp = jm.apply_condition_compress(params, jax.numpy.asarray(img01),
                                        str(j_path), h, w)
    j_cl, j_gh = jm.apply_condition_decompress(params, str(j_path))
    rng = jax.random.PRNGKey(5)
    j_out = jm.jitted_decode(steps=2)(params, j_cl, j_gh, rng)

    t_bpp = tm.apply_condition_compress(torch.from_numpy(img01), t_path, h, w)
    t_cl, t_gh = tm.apply_condition_decompress(t_path)
    relay, step_noise = _jax_noise(rng, tuple(t_cl.shape), 2)
    t_out = tm.decode_pipeline(t_cl, t_gh, 2, relay_noise=relay,
                               step_noise=step_noise)
    return dict(j_path=j_path, t_path=t_path, j_bpp=j_bpp, t_bpp=t_bpp,
                j_cl=np.asarray(j_cl), t_cl=n(t_cl), j_gh=np.asarray(j_gh),
                t_gh=n(t_gh), j_out=np.asarray(j_out), t_out=n(t_out))


def test_stream_files_are_byte_equal(slice_run):
    assert slice_run["t_path"].read_bytes() == slice_run["j_path"].read_bytes()
    assert slice_run["t_bpp"] == slice_run["j_bpp"]


def test_decoded_latents_agree(slice_run):
    # 1e-5 absolute and relative: see test_torch_port_codec's golden decode
    np.testing.assert_allclose(slice_run["t_cl"], slice_run["j_cl"],
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(slice_run["t_gh"], slice_run["j_gh"],
                               atol=1e-5, rtol=1e-5)


def test_reconstruction_agrees(slice_run):
    out = slice_run["t_out"]
    assert out.shape == (1, 64, 128, 3)
    np.testing.assert_allclose(out, slice_run["j_out"], atol=2e-3)


def test_cli_runs_the_slice_on_cpu(tmp_path, slice_run):
    """`python -m rdeic_torch.inference` end to end: a flat .npz of JAX
    params and a YAML config in, a cropped PNG and a stream file out."""
    yaml = pytest.importorskip("yaml")
    from PIL import Image

    from tests.torch_port_helpers import random_flat_params

    jm, _, _ = micro_pair(seed=1)
    np.savez(tmp_path / "p.npz", **random_flat_params(jm, (64, 64), seed=1))
    (tmp_path / "m.yaml").write_text(yaml.safe_dump(
        {"target": "rdeic_tpu.pipeline.rdeic.RDEIC", "params": MICRO}))
    arr = np.random.default_rng(2).integers(0, 256, (49, 77, 3), dtype=np.uint8)
    Image.fromarray(arr).save(tmp_path / "photo.png")
    t_inference.main([
        "--ckpt", str(tmp_path / "p.npz"), "--config", str(tmp_path / "m.yaml"),
        "--input", str(tmp_path / "photo.png"), "--output", str(tmp_path / "out"),
        "--device", "cpu"])
    assert np.array(Image.open(tmp_path / "out" / "photo.png")).shape == (49, 77, 3)
    stream = (tmp_path / "out" / "bitstreams" / "photo.rdeic").read_bytes()
    assert stream == slice_run["j_path"].read_bytes()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_inference.main(["--ckpt", "x.npz", "--input", "x", "--output", "y",
                          "--sampler", "ddim", "--device", "cpu"])
