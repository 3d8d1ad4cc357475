"""rdeic_torch's DDIM sampler, its extras and the schedule helpers against
rdeic_tpu's on the CPU, on a closed-form denoiser written identically on both
sides, with the noise handed across from the JAX split sequence: tables
bit-equal, sampler outputs within 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdeic_torch.diffusion import ddim as t_ddim
from rdeic_torch.diffusion.schedule import NoiseSchedule as TorchSchedule
from rdeic_tpu.diffusion import ddim as j_ddim
from rdeic_tpu.diffusion.schedule import NoiseSchedule as JaxSchedule

USED = 300
SHAPE = (2, 4, 6, 3)
TOL = 1e-5  # the samplers on a closed form: the same fp32 ops on both sides


@pytest.fixture(scope="module")
def schedules():
    return TorchSchedule.create(), JaxSchedule.create()


def j_eps(x, t):
    return jnp.tanh(0.5 * x) + 1e-3 * t.astype(jnp.float32)[:, None, None, None]


def t_eps(x, t):
    return torch.tanh(0.5 * x) + 1e-3 * t.float()[:, None, None, None]


def j_eps_u(x, t):
    return 0.5 * jnp.sin(x) - 2e-3 * t.astype(jnp.float32)[:, None, None, None]


def t_eps_u(x, t):
    return 0.5 * torch.sin(x) - 2e-3 * t.float()[:, None, None, None]


def _x(seed, shape=SHAPE):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _step_noise(rng, steps, shape=SHAPE):
    """The draws of a JAX sampler scan for `rng`: one split per step."""
    out = []
    for _ in range(steps):
        rng, key = jax.random.split(rng)
        out.append(torch.from_numpy(np.array(
            jax.random.normal(key, shape, jnp.float32))))
    return out


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=tol)


def test_schedule_helpers_match_jax(schedules):
    ts, js = schedules
    a, b = _x(0), _x(1)
    t = np.array([7, 250], np.int32)
    tt, jt = torch.from_numpy(t), jnp.asarray(t)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for name, targs, jargs in (
            ("predict_xstart_from_eps", (ta, tt, tb), (ja, jt, jb)),
            ("predict_eps_from_xstart", (ta, tt, tb), (ja, jt, jb)),
            ("predict_eps_from_z_and_v", (ta, tt, tb), (ja, jt, jb)),
            ("get_v", (ta, tb, tt), (ja, jb, jt)),
            ("q_posterior_mean", (ta, tb, tt), (ja, jb, jt))):
        _close(getattr(ts, name)(*targs), getattr(js, name)(*jargs), 1e-6)


@pytest.mark.parametrize("eta", [0.0, 0.5])
@pytest.mark.parametrize("steps", [2, 7, 50])
def test_ddim_tables_equal_jax(schedules, steps, eta):
    ts, js = schedules
    got = t_ddim.make_ddim_coefficients(ts, USED, steps, eta)
    want = j_ddim.make_ddim_coefficients(js, USED, steps, eta)
    assert got._fields == want._fields
    for g, w in zip(got, want):
        assert g.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got.num_steps == want.num_steps
    # the +1 shift on the model's timesteps and acp[0] (not 1) before step 0
    acp = ts.table("alphas_cumprod")
    assert got.timesteps[-1] == 1
    assert got.sqrt_alphas_prev[-1] == np.float32(np.sqrt(acp[0]))


@pytest.mark.parametrize("steps", [2, 10])
def test_encode_tables_equal_jax(schedules, steps):
    ts, js = schedules
    got = t_ddim.make_ddim_encode_coefficients(ts, USED, steps)
    want = j_ddim.make_ddim_encode_coefficients(js, USED, steps)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("guidance", [1.0, 2.0])
@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_sample_matches_jax(schedules, eta, guidance):
    ts, js = schedules
    steps = 5
    x_T = _x(2)
    rng = jax.random.PRNGKey(3)
    want = j_ddim.sample(j_eps, jnp.asarray(x_T), rng,
                         j_ddim.make_ddim_coefficients(js, USED, steps, eta),
                         uncond_fn=j_eps_u, guidance_scale=guidance)
    coeffs = t_ddim.make_ddim_coefficients(ts, USED, steps, eta)
    noise = _step_noise(rng, steps)
    got = t_ddim.sample(t_eps, torch.from_numpy(x_T), coeffs, noise=noise,
                        uncond_fn=t_eps_u, guidance_scale=guidance)
    _close(got, want)
    if eta == 0.0:  # every sigma is 0: the noise term is exactly zero
        zero = t_ddim.sample(t_eps, torch.from_numpy(x_T), coeffs,
                             noise=[torch.zeros(SHAPE)] * steps,
                             uncond_fn=t_eps_u, guidance_scale=guidance)
        assert torch.equal(got, zero)


def test_sample_takes_a_generator_or_the_right_noise_count(schedules):
    ts, _ = schedules
    coeffs = t_ddim.make_ddim_coefficients(ts, USED, 3, 0.5)
    x_T = torch.from_numpy(_x(4))
    a, b = (t_ddim.sample(t_eps, x_T, coeffs,
                          generator=torch.Generator().manual_seed(9))
            for _ in range(2))
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="noise"):
        t_ddim.sample(t_eps, x_T, coeffs, noise=[torch.zeros(SHAPE)] * 2)


@pytest.mark.parametrize("guidance", [1.0, 2.0])
def test_encode_matches_jax_and_calls_the_loop_index(schedules, guidance):
    ts, js = schedules
    steps = 6
    x0 = _x(5)
    want = j_ddim.encode(j_eps, jnp.asarray(x0),
                         j_ddim.make_ddim_encode_coefficients(js, USED, steps),
                         uncond_fn=j_eps_u, guidance_scale=guidance)
    seen = []

    def eps(x, t):
        seen.append(t.tolist())
        return t_eps(x, t)

    got = t_ddim.encode(eps, torch.from_numpy(x0),
                        t_ddim.make_ddim_encode_coefficients(ts, USED, steps),
                        uncond_fn=t_eps_u, guidance_scale=guidance)
    _close(got, want)
    assert seen == [[i, i] for i in range(steps)]  # not the DDIM timesteps


@pytest.mark.parametrize("use_original_steps", [False, True])
def test_stochastic_encode_matches_jax(schedules, use_original_steps):
    ts, js = schedules
    x0, noise = _x(6), _x(7)
    t = np.array([3, 8], np.int32)  # DDIM step indices, or raw timesteps
    want = j_ddim.stochastic_encode(js, USED, 10, jnp.asarray(x0),
                                    jnp.asarray(t), jnp.asarray(noise),
                                    use_original_steps=use_original_steps)
    got = t_ddim.stochastic_encode(ts, USED, 10, torch.from_numpy(x0),
                                   torch.from_numpy(t), torch.from_numpy(noise),
                                   use_original_steps=use_original_steps)
    _close(got, want, 1e-6)


@pytest.mark.parametrize("t_start", [3, 7])
def test_decode_matches_jax(schedules, t_start):
    ts, js = schedules
    x = _x(8)
    rng = jax.random.PRNGKey(11)
    want = j_ddim.decode(j_eps, jnp.asarray(x), rng,
                         j_ddim.make_ddim_coefficients(js, USED, 10, 0.5),
                         t_start, uncond_fn=j_eps_u, guidance_scale=2.0)
    coeffs = t_ddim.make_ddim_coefficients(ts, USED, 10, 0.5)
    got = t_ddim.decode(t_eps, torch.from_numpy(x), coeffs, t_start,
                        noise=_step_noise(rng, t_start), uncond_fn=t_eps_u,
                        guidance_scale=2.0)
    _close(got, want)
    for bad in (0, 11):
        with pytest.raises(ValueError, match="t_start"):
            t_ddim.decode(t_eps, torch.from_numpy(x), coeffs, bad)
