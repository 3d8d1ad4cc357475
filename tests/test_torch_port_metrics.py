"""rdeic_torch.utils.metrics against rdeic_tpu.utils.metrics on the CPU:
each metric on the same [0, 1] images, the suite's registry, and LPIPS on
weights carried from the JAX net by utils/convert.py.

Limits: 1e-5 absolute on SSIM, MS-SSIM, MSE, MAE and LPIPS (values of
order 1, summed in another order: fp32 rounding is ~1e-7), and 1e-5
relative on PSNR (a log of the MSE, 10-40 dB here)."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from rdeic_torch.utils import metrics as tm
from rdeic_torch.utils.convert import load_jax_params
from rdeic_tpu.models.lpips import LPIPS as JaxLPIPS
from rdeic_tpu.utils import metrics as jm
from tests.torch_port_tf32 import one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-5
PSNR_RTOL = 1e-5


def _pair(seed, shape, noise=0.1):
    """An image in [0, 1] and a noisy copy of it, clipped to [0, 1]."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + noise * rng.normal(size=shape), 0, 1).astype(np.float32)
    return a, b


def _both(fn_t, fn_j, a, b):
    got = fn_t(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(fn_j(jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == want.shape == (a.shape[0],)
    return got, want


@pytest.mark.parametrize("crop", [0, 4])
def test_psnr_matches_jax(crop):
    a, b = _pair(0, (3, 40, 48, 3))
    got, want = _both(lambda x, y: tm.psnr(x, y, crop),
                      lambda x, y: jm.psnr(x, y, crop), a, b)
    np.testing.assert_allclose(got, want, rtol=PSNR_RTOL)
    if crop:  # the border is left out: a change there moves nothing
        a2 = a.copy()
        a2[:, :crop] = 0.0
        np.testing.assert_array_equal(
            tm.psnr(torch.from_numpy(a2), torch.from_numpy(b), crop).numpy(), got)


def test_psnr_of_equal_images_is_capped():
    a, _ = _pair(1, (1, 16, 16, 3))
    x = torch.from_numpy(a)
    np.testing.assert_allclose(tm.psnr(x, x).numpy(), [120.0])
    np.testing.assert_allclose(np.asarray(jm.psnr(jnp.asarray(a), jnp.asarray(a))),
                               [120.0])


@pytest.mark.parametrize("name", ["ssim", "mse", "mae"])
def test_simple_metrics_match_jax(name):
    a, b = _pair(2, (2, 37, 45, 3), noise=0.2)
    got, want = _both(getattr(tm, name), getattr(jm, name), a, b)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("hw", [(176, 176), (192, 208)])
def test_ms_ssim_matches_jax(hw):
    """At 176 px a side, the smallest where the window fits the coarsest of
    the five levels, and at a size whose pooling drops odd rows."""
    a, b = _pair(3, (2, *hw, 3), noise=0.15)
    got, want = _both(tm.ms_ssim, jm.ms_ssim, a, b)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert np.all((0 < got) & (got < 1))


def test_ms_ssim_raises_under_its_side():
    a, b = _pair(4, (1, 175, 200, 3))
    with pytest.raises(ValueError, match="176"):
        tm.ms_ssim(torch.from_numpy(a), torch.from_numpy(b))
    assert tm.MS_SSIM_MIN_SIDE == 176


def test_gaussian_window_matches_jax():
    np.testing.assert_allclose(tm._fspecial_gauss(11, 1.5).numpy(),
                               np.asarray(jm._fspecial_gauss(11, 1.5)),
                               rtol=1e-6)


def test_suite_registry_matches_jax(tmp_path):
    """The same names give the same functions; crop_border reaches psnr;
    niqe with a fitted model's `model_path` scores a batch as JAX's (the
    same float64 host code: exactly), and without one raises ValueError in
    both; an unknown name raises as in JAX. Each JAX
    function comes from a suite of its own: the JAX suite caches a metric
    by name, so a second `create_metric("psnr", crop_border=3)` there
    returns the first one's uncropped psnr. The port's suite keeps no
    cache and gives the cropped one: checked on one suite below."""
    a, b = _pair(5, (2, 32, 32, 3))
    ts = tm.MetricSuite()
    for name, opts in [("psnr", {}), ("psnr", {"crop_border": 3}),
                       ("ssim", {}), ("mse", {}), ("mae", {})]:
        got, want = _both(ts.create_metric(name, **opts),
                          jm.MetricSuite().create_metric(name, **opts), a, b)
        tol = dict(rtol=PSNR_RTOL) if name == "psnr" else dict(atol=ATOL)
        np.testing.assert_allclose(got, want, **tol, err_msg=f"{name} {opts}")
    for suite in (ts, jm.MetricSuite()):
        with pytest.raises(ValueError, match="niqe requires model_path="):
            suite.create_metric("niqe")
    from rdeic_torch.utils.niqe import NIQEModel  # noqa: PLC0415

    pristine, _ = _pair(9, (3, 96, 112, 3))
    NIQEModel.fit_pristine(pristine).save(tmp_path / "niqe.npz")
    batch, noisy = _pair(10, (2, 96, 112, 3))
    got, want = _both(ts.create_metric("niqe", model_path=tmp_path / "niqe.npz"),
                      jm.MetricSuite().create_metric(
                          "niqe", model_path=tmp_path / "niqe.npz"),
                      batch, noisy)
    assert got.dtype == want.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)
    for suite in (ts, jm.MetricSuite()):
        with pytest.raises(ValueError, match="unknown metric"):
            suite.create_metric("fid")


def _jax_lpips_params(net, seed):
    """Random weights at every leaf of the JAX LPIPS (flat, "/"-joined)."""
    jnet = JaxLPIPS(net=net)
    probe = jnp.zeros((1, 32, 32, 3))
    shapes = jax.eval_shape(lambda r: jnet.init(r, probe, probe)["params"],
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    flat = {}
    for k, v in sorted(flatten_dict(shapes).items()):
        fan_in = int(np.prod(v.shape[:-1])) if len(v.shape) > 1 else 1
        flat["/".join(k)] = (rng.normal(size=v.shape) / np.sqrt(fan_in)
                             ).astype(np.float32)
    return flat


@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_lpips_suite_on_carried_weights_matches_jax(net):
    from tests.torch_port_helpers import unflatten  # noqa: PLC0415

    flat = _jax_lpips_params(net, seed=6)
    js = jm.MetricSuite(lpips_params=jax.tree_util.tree_map(
        jnp.asarray, unflatten(flat)), lpips_net=net)
    ts = tm.MetricSuite(lpips_params=load_jax_params(flat), lpips_net=net)
    a, b = _pair(7, (2, 48, 48, 3), noise=0.2)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # given weights: no random warning
        got, want = _both(ts.create_metric("lpips"),
                          js.create_metric("lpips"), a, b)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert np.abs(want).min() > 100 * ATOL  # the limit reads a real value


def test_lpips_suite_without_weights_warns_and_is_seeded():
    """No weights: the port's LPIPS warns, as the JAX suite does, and runs
    on random weights made from seed 0, the same in every suite."""
    a, b = _pair(8, (1, 32, 32, 3))
    x, y = torch.from_numpy(a), torch.from_numpy(b)
    from rdeic_torch.models import lpips as t_lpips  # noqa: PLC0415

    t_lpips._warned_contexts.discard("MetricSuite")
    with pytest.warns(UserWarning, match="RANDOM-INIT"):
        first = tm.MetricSuite().create_metric("lpips")(x, y)
    second = tm.MetricSuite().create_metric("lpips")(x, y)
    assert torch.isfinite(first).all() and first.shape == (1,)
    torch.testing.assert_close(first, second, rtol=0, atol=0)
