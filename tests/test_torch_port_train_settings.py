"""The independent loss under the `x0` and `v` parameterizations, rdeic_torch
against rdeic_tpu on the CPU at the micro config: the loss and its logs from
the same weights and the noise of JAX's own key sequence, and the sample of
a `v` model, whose output the sampler reads as eps, as JAX's does."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdeic_torch.pipeline.rdeic import RDEIC as TorchRDEIC
from rdeic_torch.utils.convert import load_jax_params
from rdeic_tpu.pipeline.rdeic import RDEIC as JaxRDEIC
from tests.test_torch_port_slice import _jax_noise
from tests.test_torch_port_train_model import LOSS_RTOL, jax_train_noise
from tests.torch_port_helpers import (  # noqa: F401 (an autouse fixture)
    one_torch_thread_per_module,
    ATOL,
    MICRO,
    n,
    random_flat_params,
    t,
    unflatten,
)


def _pair(parameterization: str, seed: int = 0):
    cfg = dict(copy.deepcopy(MICRO), parameterization=parameterization)
    jm = JaxRDEIC(**cfg)
    flat = random_flat_params(jm, (64, 64), seed)
    tm = TorchRDEIC(**copy.deepcopy(cfg), device="cpu")
    tm.load_state_dict(load_jax_params(flat), strict=True)
    params = jax.tree_util.tree_map(jnp.asarray, unflatten(flat))
    return jm, params, tm.eval()


@pytest.fixture(scope="module", params=["x0", "v"])
def loss_run(request):
    jm, params, tm = _pair(request.param)
    img = np.random.default_rng(4).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    rng = jax.random.PRNGKey(7)
    j_loss, j_logs = jax.jit(lambda p: jm.loss_fn(p, jnp.asarray(img), rng))(params)
    with torch.no_grad():
        loss, logs = tm.loss_fn(t(img), noise=jax_train_noise(tm, img, rng))
    return dict(param=request.param, j_loss=float(j_loss), j_logs=j_logs,
                loss=loss.item(), logs=logs)


def test_loss_and_logs_match_jax(loss_run):
    r = loss_run
    np.testing.assert_allclose(r["loss"], r["j_loss"], rtol=LOSS_RTOL)
    assert set(r["logs"]) == set(r["j_logs"])
    for key, want in r["j_logs"].items():
        np.testing.assert_allclose(n(r["logs"][key]), np.asarray(want),
                                   rtol=LOSS_RTOL, atol=1e-5, err_msg=key)


def test_the_parameterization_changes_the_regression(loss_run):
    """Against the eps loss of the same weights and noise, `l_simple` moves
    (the targets differ) and the other terms stay."""
    jm, params, tm = _pair("eps")
    img = np.random.default_rng(4).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        _, eps_logs = tm.loss_fn(
            t(img), noise=jax_train_noise(tm, img, jax.random.PRNGKey(7)))
    logs = loss_run["logs"]
    assert not np.isclose(logs["l_simple"].item(), eps_logs["l_simple"].item(),
                          rtol=1e-3)
    for key in ("l_guide", "l_bpp", "q_bpp", "l_emb"):
        assert logs[key].item() == eps_logs[key].item(), key


def test_an_unknown_parameterization_is_refused():
    _, _, tm = _pair("eps")
    tm.parameterization = "score"
    img = torch.zeros(1, 64, 64, 3)
    with pytest.raises(NotImplementedError, match="score"), torch.no_grad():
        tm.loss_fn(img, generator=torch.Generator().manual_seed(0))


def test_a_v_model_samples_as_jax_does():
    jm, params, tm = _pair("v", seed=3)
    rng = np.random.default_rng(5)
    c_latent = rng.normal(size=(1, 8, 8, 4)).astype(np.float32)
    guide_hint = rng.normal(size=(1, 8, 8, 8)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    want = jm.jitted_decode(steps=2)(params, jnp.asarray(c_latent),
                                     jnp.asarray(guide_hint), key)
    relay, steps = _jax_noise(key, c_latent.shape, 2)
    got = tm.decode_pipeline(t(c_latent), t(guide_hint), 2, relay_noise=relay,
                             step_noise=steps)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=ATOL)
