"""Validation and the image logger, rdeic_torch against rdeic_tpu on the CPU
at the micro config, on the same random weights: eval-mode `get_input`
(and `encode_moments`), `log_images`' panels and bpp, `run_validation` in
the independent and the refine phase, and `ImageLogger`'s files. The port
is handed the noise the JAX `split` sequence draws; the metric suites share
the JAX suite's own random LPIPS weights, carried across by
utils/convert.py.

Limits, fp32: latents, features and rates 1e-5 absolute and relative (a
few ulps of ~20 convolutions summed in another order, as the slice test's
decoded latents); the relay samples 2e-3 (test_torch_port_slice's
reconstruction limit); the averages of a validation pass as set in
VAL_TOL, from those."""
import copy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from PIL import Image

from rdeic_torch.train.callbacks import ImageLogger, log_images, log_inputs
from rdeic_torch.train.validation import run_validation
from rdeic_torch.utils.convert import load_jax_params
from rdeic_torch.utils.image import encode_png
from rdeic_torch.utils.metrics import MetricSuite
from rdeic_tpu.models.lpips import LPIPS as JaxLPIPS
from rdeic_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL
from rdeic_tpu.pipeline.rdeic import RDEIC as JaxRDEIC
from rdeic_tpu.train import callbacks as j_callbacks
from rdeic_tpu.train.validation import run_validation as j_run_validation
from tests.test_torch_port_slice import _jax_noise
from tests.torch_port_helpers import MICRO, micro_pair, n, t
from tests.torch_port_tf32 import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.filterwarnings("ignore:LPIPS.*RANDOM-INIT")

LATENT_TOL = dict(atol=1e-5, rtol=1e-5)
SAMPLE_TOL = 2e-3
# a pass's averages: bpp from the rates (1e-5 relative); PSNR, MS-SSIM and
# LPIPS of samples within SAMPLE_TOL at the worst pixel, far less on
# average; usage is a count of the same indices
VAL_TOL = {"avg_bpp": dict(rtol=1e-5), "avg_psnr": dict(atol=1e-3),
           "avg_ms_ssim": dict(atol=1e-4), "avg_lpips": dict(atol=1e-4),
           "usage": dict(rtol=0, atol=0)}


def _images(seed, shape):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    return micro_pair(seed=3)


def test_encode_moments_matches_jax(pair):
    jm, params, tm = pair
    img = _images(0, (2, 64, 64, 3))
    j_mean, j_logvar = jm.vae.apply({"params": params["vae"]}, jnp.asarray(img),
                                    method=JaxAutoencoderKL.encode_moments)
    with torch.no_grad():
        mean, logvar = tm.vae.encode_moments(t(img))
    np.testing.assert_allclose(n(mean), np.asarray(j_mean), **LATENT_TOL)
    np.testing.assert_allclose(n(logvar), np.asarray(j_logvar), **LATENT_TOL)


def test_eval_get_input_matches_jax(pair):
    """training=False: the posterior mean and the compression model's
    eval forward, no noise; every field of cond against JAX's."""
    jm, params, tm = pair
    img = _images(1, (2, 64, 64, 3))
    j_z, j_cond = jax.jit(lambda p, x: jm.get_input(
        p, x, jax.random.PRNGKey(9), training=False))(params, jnp.asarray(img))
    with torch.no_grad():
        z, cond = tm.get_input(t(img), training=False)
    np.testing.assert_allclose(n(z), np.asarray(j_z), **LATENT_TOL)
    assert set(cond) == set(j_cond)
    for key in ("c_crossattn", "c_latent", "guide_hint", "bpp", "q_bpp",
                "emb_loss", "target", "z_hyper"):
        np.testing.assert_allclose(n(cond[key]), np.asarray(j_cond[key]),
                                   **LATENT_TOL, err_msg=key)
    np.testing.assert_array_equal(n(cond["vq_indices"]),
                                  np.asarray(j_cond["vq_indices"]))
    assert float(cond["emb_loss"]) == 0.0  # no CVQ losses out of training
    np.testing.assert_array_equal(n(cond["bpp"]), n(cond["q_bpp"]))


def test_training_get_input_still_needs_its_noise(pair):
    _, _, tm = pair
    with pytest.raises(TypeError):
        tm.get_input(t(_images(2, (1, 64, 64, 3))))


@pytest.mark.parametrize("refine", [False, True])
def test_log_images_matches_jax(pair, refine):
    """The target, vae_rec and samples panels and the bpp of JAX's
    log_images for one key: the port gets the sampler noise that key's
    `split` draws (5 steps, or the refine phase's `fixed_step`)."""
    jm, params, tm = pair
    if refine:
        jm = JaxRDEIC(**copy.deepcopy(MICRO), is_refine=True)
        tm = copy.copy(tm)
        tm.is_refine = True
    img = _images(4, (2, 64, 64, 3))
    rng = jax.random.PRNGKey(11)
    j_log, j_bpp = j_callbacks.log_images(jm, params, img, rng)
    steps = jm.fixed_step if refine else 5
    relay, step_noise = _jax_noise(jax.random.split(rng)[1], (2, 32, 32, 4),
                                   steps)
    log, bpp = log_images(tm, t(img), relay_noise=relay, step_noise=step_noise)
    assert set(log) == set(j_log) == {"target", "vae_rec", "samples"}
    np.testing.assert_array_equal(n(log["target"]), j_log["target"])
    np.testing.assert_allclose(n(log["vae_rec"]), j_log["vae_rec"], **LATENT_TOL)
    np.testing.assert_allclose(n(log["samples"]), j_log["samples"],
                               atol=SAMPLE_TOL)
    np.testing.assert_allclose(bpp, j_bpp, rtol=1e-5)
    # q_bpp plus 5 bits (a codebook of 32) for each VQ index
    cond, _ = log_inputs(tm, t(img))
    zh, zw = cond["vq_indices"].shape[1:3]
    assert bpp == pytest.approx(float(cond["q_bpp"]) + 5 * zh * zw / 64 ** 2)


def _jax_suite_lpips():
    """The weights the JAX `MetricSuite()` gives LPIPS when it has none
    (flax's init from PRNGKey(0)), as the port's state dict."""
    net = JaxLPIPS(net="alex")
    probe = jnp.zeros((1, 64, 64, 3))
    params = net.init(jax.random.PRNGKey(0), probe, probe)["params"]
    flat = {"/".join(k): np.asarray(v) for k, v in flatten_dict(params).items()}
    return load_jax_params(flat)


def _validation_noise(key, batches, latent_shape, steps):
    """run_validation's draws for each batch: (rng, sub, sub2) = split(rng,
    3), the sampler's noise from sub."""
    noise = []
    for _ in range(batches):
        key, sub, _ = jax.random.split(key, 3)
        relay, step_noise = _jax_noise(sub, latent_shape, steps)
        noise.append(dict(relay_noise=relay, step_noise=step_noise))
    return noise


@pytest.fixture(scope="module")
def lpips_weights():
    return _jax_suite_lpips()


@pytest.mark.parametrize("refine,hw", [(False, (192, 192)), (True, (64, 64))])
def test_run_validation_matches_jax(pair, lpips_weights, refine, hw):
    """Three batches of one image, at most two read: the independent phase
    at sample_steps 2 on 192x192 images (MS-SSIM defined from 176 px), the
    refine phase (its fixed_step, 2) on 64x64 ones, where MS-SSIM reads NaN
    on both sides. The same weights in both phases."""
    jm, params, tm = pair
    if refine:
        jm = JaxRDEIC(**copy.deepcopy(MICRO), is_refine=True)
        tm = copy.copy(tm)
        tm.is_refine = True
    loader = [{"jpg": _images(20 + i, (1, *hw, 3))} for i in range(3)]
    key = jax.random.PRNGKey(5)
    want = j_run_validation(jm, params, loader, key, max_batches=2,
                            sample_steps=2)
    latent = (1, hw[0] // 2, hw[1] // 2, 4)
    got = run_validation(tm, loader, max_batches=2, sample_steps=2,
                         noise=_validation_noise(key, 2, latent, 2),
                         suite=MetricSuite(lpips_params=lpips_weights))
    assert set(got) == set(want) == set(VAL_TOL)
    for k, tol in VAL_TOL.items():
        np.testing.assert_allclose(got[k], want[k], **tol, err_msg=k)
    assert np.isnan(got["avg_ms_ssim"]) == refine
    assert 0 < got["usage"] <= 2 * (hw[0] // 16) ** 2 / 32


def test_run_validation_draws_from_the_generator(pair):
    """Without explicit noise the sampler draws from `generator`: the same
    seed gives the same averages, another seed others."""
    _, _, tm = pair
    loader = [{"jpg": _images(30, (1, 64, 64, 3))}]
    kw = dict(metric_names=("psnr",), sample_steps=2)
    a, b, c = (run_validation(tm, loader, generator=torch.Generator().manual_seed(s),
                              **kw) for s in (1, 1, 2))
    assert a == b and a["avg_psnr"] != c["avg_psnr"]
    assert run_validation(tm, [], **kw) == {"usage": 0.0}


def test_run_validation_raises_what_is_not_a_size_rule(pair):
    """Only MS-SSIM under its size reads NaN; another metric's failure (here
    niqe without a fitted model's `model_path`, refused as in the JAX
    suite) raises."""
    _, _, tm = pair
    with pytest.raises(ValueError, match="niqe requires model_path="):
        run_validation(tm, [{"jpg": _images(31, (1, 64, 64, 3))}],
                       metric_names=("psnr", "niqe"))


def _read_png(path):
    with Image.open(path) as im:
        assert im.mode == "RGB"
        return np.asarray(im)


@pytest.mark.parametrize("hw", [(1, 1), (3, 5), (64, 128), (17, 31)])
def test_png_encoder_pixels_read_back_with_pil(tmp_path, hw):
    img = np.random.default_rng(hw[0]).integers(0, 256, (*hw, 3), dtype=np.uint8)
    (tmp_path / "x.png").write_bytes(encode_png(img))
    np.testing.assert_array_equal(_read_png(tmp_path / "x.png"), img)
    with pytest.raises(ValueError):
        encode_png(img.astype(np.float32))


def test_image_logger_writes_what_the_jax_logger_writes(pair, tmp_path,
                                                        monkeypatch):
    """At a logging step both loggers write the same files: target,
    vae_rec and samples, each a row of the first `max_images` images, and
    bpp.txt. The JAX logger is handed the port's own panels (its
    log_images is replaced), so the PNGs must agree pixel for pixel; the
    panels themselves are held to JAX's in test_log_images_matches_jax.
    Off the cadence neither writes anything."""
    jm, params, tm = pair
    img = _images(40, (3, 64, 64, 3))
    gen = torch.Generator().manual_seed(0)
    port = ImageLogger(tmp_path / "port", every_n_steps=3, max_images=2)
    assert port.maybe_log(tm, t(img), 4, generator=gen) is None
    out_dir, log, bpp = port.maybe_log(tm, t(img), 6, generator=gen)
    assert out_dir == tmp_path / "port" / "image_log" / "step_6"
    assert log["target"].shape[0] == 2

    def given(model, params_, img_, rng, sample_steps=5):
        assert img_.shape[0] == 2 and sample_steps == 5
        return {k: n(v) for k, v in log.items()}, bpp

    monkeypatch.setattr(j_callbacks, "log_images", given)
    ref = j_callbacks.ImageLogger(str(tmp_path / "jax"), every_n_steps=3,
                                  max_images=2)
    ref.maybe_log(jm, params, img, 6, jax.random.PRNGKey(6))
    ref_dir = tmp_path / "jax" / "image_log" / "step_6"
    assert sorted(p.name for p in out_dir.iterdir()) == \
        sorted(p.name for p in ref_dir.iterdir()) == \
        ["bpp.txt", "samples.png", "target.png", "vae_rec.png"]
    for name in ("target", "vae_rec", "samples"):
        got = _read_png(out_dir / f"{name}.png")
        assert got.shape == (64, 128, 3)
        np.testing.assert_array_equal(got, _read_png(ref_dir / f"{name}.png"))
    assert (out_dir / "bpp.txt").read_text() == (ref_dir / "bpp.txt").read_text()
    assert not (tmp_path / "port" / "image_log" / "step_4").exists()


def test_chip_smoke_validation_config_equals_the_yaml():
    """chip_smoke.py's validation phase runs configs/dataset/lic_valid.yaml's
    crop and batch (the card's machine has no yaml module)."""
    yaml = pytest.importorskip("yaml")
    root = Path(__file__).resolve().parents[1]
    cfg = yaml.safe_load((root / "configs" / "dataset" / "lic_valid.yaml")
                         .read_text())
    sys.path.insert(0, str(root))
    try:
        import chip_smoke  # noqa: PLC0415
    finally:
        sys.path.remove(str(root))
    assert chip_smoke.VAL_CONFIG == {
        "out_size": cfg["dataset"]["params"]["out_size"],
        "batch_size": cfg["data_loader"]["batch_size"]}
    assert set(chip_smoke.VAL_REF_TOL) == {"avg_bpp", "avg_psnr", "avg_lpips",
                                           "usage"}
