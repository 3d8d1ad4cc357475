"""Classifier-free guidance and the sampler dispatch, rdeic_torch against
rdeic_tpu on the CPU: the base UNet alone (the unconditional branch),
`RDEIC.sample` and `decode_pipeline` for both samplers with and without
guidance on micro_pair weights (noise handed across, ATOL 2e-4), and the
spaced sampler's `cond_fn` on a closed form (1e-5)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdeic_torch.diffusion import ddim as t_ddim
from rdeic_torch.diffusion import spaced as t_spaced
from rdeic_tpu.diffusion import spaced as j_spaced
from tests.torch_port_helpers import ATOL, micro_pair, n, t

LATENT = (1, 16, 16, 4)


@pytest.fixture(scope="module")
def pair():
    jm, params, tm = micro_pair(seed=3)
    rng = np.random.default_rng(4)
    hint = (*LATENT[:3], jm.denoiser.hint_channels)
    data = dict(c_latent=rng.normal(size=LATENT).astype(np.float32),
                guide_hint=rng.normal(size=hint).astype(np.float32),
                context=rng.normal(size=(1, 77, 16)).astype(np.float32),
                uncond=rng.normal(size=(1, 77, 16)).astype(np.float32))
    return jm, params, tm, data


def _pipeline_noise(rng, shape, steps):
    """The draws of rdeic_tpu's RDEIC.sample for `rng`: the relay noise,
    then one per sampler step (the same split sequence for both samplers)."""
    rng_init, rng_loop = jax.random.split(rng)
    relay = jax.random.normal(rng_init, shape, jnp.float32)
    out = []
    for _ in range(steps):
        rng_loop, key = jax.random.split(rng_loop)
        out.append(t(jax.random.normal(key, shape, jnp.float32)))
    return t(relay), out


def test_base_unet_matches_jax(pair):
    jm, params, tm, data = pair
    x = np.random.default_rng(5).normal(size=LATENT).astype(np.float32)
    ts = np.array([123], np.int32)
    want = np.asarray(jm.apply_model_unconditional(
        params, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(data["context"])))
    args = (t(x), torch.from_numpy(ts), t(data["context"]))
    with torch.no_grad():
        outs = (tm.denoiser.base(*args), tm.denoiser.forward_unconditional(*args),
                tm.apply_model_unconditional(*args))
    for got in outs:
        np.testing.assert_allclose(n(got), want, atol=ATOL)
    assert np.abs(want).max() > 1e-2  # the zero-init out_conv is filled


@pytest.mark.parametrize("sampler,guidance,own_uncond", [
    ("ddpm", 1.0, False), ("ddpm", 2.0, False), ("ddim", 1.0, False),
    ("ddim", 2.0, False), ("ddim", 2.0, True)])
def test_sample_matches_jax(pair, sampler, guidance, own_uncond):
    jm, params, tm, data = pair
    rng = jax.random.PRNGKey(6)
    uncond = data["uncond"] if own_uncond else None
    want = jm.sample(params, jnp.asarray(data["c_latent"]),
                     jnp.asarray(data["guide_hint"]),
                     jnp.asarray(data["context"]), rng, 2, sampler=sampler,
                     guidance_scale=guidance,
                     uncond_context=None if uncond is None else jnp.asarray(uncond))
    relay, steps = _pipeline_noise(rng, LATENT, 2)
    with torch.no_grad():
        got = tm.sample(t(data["c_latent"]), t(data["guide_hint"]),
                        t(data["context"]), 2, sampler=sampler,
                        guidance_scale=guidance,
                        uncond_context=None if uncond is None else t(uncond),
                        relay_noise=relay, step_noise=steps)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=ATOL)


def test_decode_pipeline_matches_jax_with_ddim_and_guidance(pair):
    jm, params, tm, data = pair
    rng = jax.random.PRNGKey(7)
    want = jm.jitted_decode(steps=2, sampler="ddim", guidance_scale=2.0)(
        params, jnp.asarray(data["c_latent"]), jnp.asarray(data["guide_hint"]),
        rng)
    relay, steps = _pipeline_noise(rng, LATENT, 2)
    got = tm.decode_pipeline(t(data["c_latent"]), t(data["guide_hint"]), 2,
                             sampler="ddim", guidance_scale=2.0,
                             relay_noise=relay, step_noise=steps)
    assert got.shape == (1, 32, 32, 3)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=2e-3)


def _refuse(*_):
    raise AssertionError("the unconditional branch ran")


@pytest.mark.parametrize("sampler", ["ddpm", "ddim"])
def test_scale_one_never_runs_the_unconditional_branch(pair, sampler,
                                                       monkeypatch):
    _, _, tm, data = pair
    monkeypatch.setattr(tm.denoiser, "forward_unconditional", _refuse)
    with torch.no_grad():
        tm.sample(t(data["c_latent"]), t(data["guide_hint"]),
                  t(data["context"]), 2, sampler=sampler, guidance_scale=1.0,
                  generator=torch.Generator().manual_seed(0))
    base = torch.zeros(LATENT)
    eps = lambda x, ts: torch.tanh(x)  # noqa: E731
    t_spaced.sample(eps, base, t_spaced.make_spaced_coefficients(
        tm.schedule, 300, 2), noise=[base] * 2, uncond_fn=_refuse)
    t_ddim.sample(eps, base, t_ddim.make_ddim_coefficients(tm.schedule, 300, 2),
                  noise=[base] * 2, uncond_fn=_refuse)
    with pytest.raises(AssertionError, match="unconditional"):
        tm.sample(t(data["c_latent"]), t(data["guide_hint"]),
                  t(data["context"]), 2, guidance_scale=2.0,
                  generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="sampler"):
        tm.sample(t(data["c_latent"]), t(data["guide_hint"]),
                  t(data["context"]), 2, sampler="plms")


def _closed_forms(lib):
    """denoise, uncond and cond_fn, written identically for jnp and torch."""
    def ts(v):
        return (v.astype(jnp.float32) if lib is jnp else v.float())[:, None, None, None]

    return (lambda x, s: lib.tanh(0.5 * x) + 1e-3 * ts(s),
            lambda x, s: 0.5 * lib.sin(x) - 2e-3 * ts(s),
            lambda x0, s: 0.1 * lib.cos(x0) + 1e-4 * ts(s))


@pytest.mark.parametrize("guidance", [1.0, 2.0])
def test_spaced_cond_fn_matches_jax(pair, guidance):
    _, _, tm, _ = pair
    from rdeic_tpu.diffusion.schedule import NoiseSchedule as JaxSchedule

    shape = (2, 4, 6, 3)
    x_T = np.random.default_rng(8).normal(size=shape).astype(np.float32)
    rng = jax.random.PRNGKey(9)
    jd, ju, jc = _closed_forms(jnp)
    want = j_spaced.sample(
        jd, jnp.asarray(x_T), rng,
        j_spaced.make_spaced_coefficients(JaxSchedule.create(), 300, 4),
        uncond_fn=ju, guidance_scale=guidance, cond_fn=jc)
    noise = []
    for _ in range(4):
        rng, key = jax.random.split(rng)
        noise.append(t(jax.random.normal(key, shape, jnp.float32)))
    td, tu, tc = _closed_forms(torch)
    coeffs = t_spaced.make_spaced_coefficients(tm.schedule, 300, 4)
    kw = dict(noise=noise, uncond_fn=tu, guidance_scale=guidance, cond_fn=tc)
    got = t_spaced.sample(td, t(x_T), coeffs, **kw)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-5, rtol=1e-5)
    # remat_steps under grad: the same output and the same gradient
    grads = []
    for remat in (False, True):
        x = t(x_T).requires_grad_()
        out = t_spaced.sample(td, x, coeffs, remat_steps=remat, **kw)
        assert torch.equal(out.detach(), got)
        grads.append(torch.autograd.grad(out.square().sum(), x)[0])
    assert torch.equal(grads[0], grads[1])
