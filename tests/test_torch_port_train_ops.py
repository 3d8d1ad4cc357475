"""The training slice's ops, rdeic_torch against rdeic_tpu on the CPU: the
plain flash backward and the plain GroupNorm backward against the Pallas
kernels in interpret mode, gradcheck of both autograd functions, and the
small ops of the training forward (likelihood, lower bound, STE rounding,
checkerboard masks, the CVQ quantiser and codebook update, EMA)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdeic_torch.models.compression import VectorQuantiser, vq_codebook_update
from rdeic_torch.models.vae import sample_diagonal_gaussian
from rdeic_torch.ops import ckbd as t_ckbd
from rdeic_torch.ops import gaussian as t_gaussian
from rdeic_torch.ops.flash_attention import (
    _FlashAttention,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_lse,
    flash_attention_lse_plain,
)
from rdeic_torch.ops.fused_groupnorm import (
    _GroupNorm,
    group_norm,
    group_norm_bwd,
    group_norm_bwd_plain,
    group_norm_fwd,
    group_norm_fwd_plain,
)
from rdeic_torch.train.ema import ema_init, ema_update
from rdeic_tpu.models import compression as j_comp
from rdeic_tpu.ops import ckbd as j_ckbd
from rdeic_tpu.ops import fused_groupnorm as j_gn
from rdeic_tpu.ops import gaussian as j_gaussian
from rdeic_tpu.ops.flash_attention import _flash_backward, _flash_forward
from rdeic_tpu.train import ema as j_ema


def _normal(shape, seed, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * scale + shift).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


# -- flash attention backward ------------------------------------------------
@pytest.mark.parametrize("shape", [(1, 100, 2, 16), (2, 72, 1, 64)])
def test_flash_lse_and_backward_plain_match_pallas_interpret(shape):
    """L is not a multiple of the 32-row blocks: the Pallas kernels mask the
    padded q rows and k columns. fp32 limits: 2e-5 on the output and lse
    (softmax-weighted means of O(1) values), 2e-4 on the gradients (sums of
    L products), as tests/test_flash_attention.py holds the Pallas backward
    to XLA."""
    q, k, v, do = (_normal(shape, s) for s in range(4))
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    j_out, j_lse = _flash_forward(jq, jk, jv, block_q=32, block_k=32,
                                  interpret=True, save_residuals=True)
    j_grads = _flash_backward(jq, jk, jv, j_out, j_lse, jdo, block_q=32,
                              block_k=32, interpret=True)
    o, lse = flash_attention_lse_plain(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(o.numpy(), np.asarray(j_out), atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), atol=2e-5)
    grads = flash_attention_bwd_plain(_t(q), _t(k), _t(v), o, lse, _t(do))
    for got, want in zip(grads, j_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


def test_flash_wrappers_take_the_plain_versions_on_cpu():
    q, k, v, do = (_t(_normal((1, 50, 2, 16), s)) for s in range(4))
    counts = (flash_attention.launches, flash_attention_lse.launches)
    o, lse = flash_attention_lse(q, k, v)
    want_o, want_lse = flash_attention_lse_plain(q, k, v)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    for got, want in zip(flash_attention_bwd(q, k, v, o, lse, do),
                         flash_attention_bwd_plain(q, k, v, o, lse, do)):
        assert torch.equal(got, want)
    qg = q.clone().requires_grad_()
    out = flash_attention(qg, k, v)
    assert out.grad_fn is not None  # the autograd function, on the CPU too
    assert (flash_attention.launches, flash_attention_lse.launches) == counts


def test_flash_autograd_function_gradcheck_float64():
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 10, 2, 16), generator=gen, dtype=torch.float64,
                           requires_grad=True) for _ in range(3))
    assert torch.autograd.gradcheck(_FlashAttention.apply, (q, k, v))


# -- GroupNorm backward ------------------------------------------------------
def _jax_gn_grads(x, w, b, dy, groups, eps, silu):
    """(y, dx, dscale, dbias) of the Pallas GroupNorm in interpret mode,
    NHWC, through its custom VJP. The custom-VJP function is called rather
    than the jitted `group_norm`, whose trace cache would hand one route's
    program to the other route's test (the route is chosen at trace time
    from the patched budgets)."""
    def f(x, w, b):
        return j_gn._group_norm_p(x, w, b, groups, eps, silu, True)

    y, vjp = jax.vjp(f, *map(jnp.asarray, (x, w, b)))
    return (y, *vjp(jnp.asarray(dy)))


@pytest.mark.parametrize("route", ["whole_slab", "chunked"])
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("c,groups", [(64, 32), (48, 24)])
def test_groupnorm_backward_plain_matches_pallas_interpret(
        monkeypatch, route, silu, eps, c, groups):
    """Both Pallas routes (the whole-slab kernel and the chunked pair, over
    three row chunks) and a non-32 group count. fp32 limit 1e-4: x ~ 3N + 1
    normalises to O(1); dx and the summed dscale/dbias (up to ~20) are sums
    over a group's 10^3 elements in another order."""
    if route == "chunked":
        monkeypatch.setattr(j_gn, "_VMEM_BUDGET", 0)
        monkeypatch.setattr(j_gn, "_CHUNK_BYTES", 2 * 9 * c * 4)
    x = _normal((2, 6, 9, c), 0, 3.0, 1.0)  # NHWC for JAX
    dy = _normal((2, 6, 9, c), 3)
    w, b = _normal((c,), 1), _normal((c,), 2)
    j_y, j_dx, j_dw, j_db = _jax_gn_grads(x, w, b, dy, groups, eps, silu)
    xt = _t(x).permute(0, 3, 1, 2).contiguous()
    dyt = _t(dy).permute(0, 3, 1, 2).contiguous()
    y, mean, inv = group_norm_fwd_plain(xt, _t(w), _t(b), groups, eps, silu)
    dx, dw, db = group_norm_bwd_plain(xt, _t(w), _t(b), mean, inv, dyt,
                                      groups, silu)
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).numpy(), np.asarray(j_y),
                               atol=1e-4)
    np.testing.assert_allclose(dx.permute(0, 2, 3, 1).numpy(), np.asarray(j_dx),
                               atol=1e-4)
    np.testing.assert_allclose(dw.numpy(), np.asarray(j_dw), atol=1e-4)
    np.testing.assert_allclose(db.numpy(), np.asarray(j_db), atol=1e-4)


def test_groupnorm_wrappers_take_the_plain_versions_on_cpu():
    x, dy = _t(_normal((2, 48, 5, 7), 0)), _t(_normal((2, 48, 5, 7), 1))
    w, b = _t(_normal((48,), 2)), _t(_normal((48,), 3))
    counts = (group_norm.launches, group_norm_bwd.launches)
    y, mean, inv = group_norm_fwd(x, w, b, 24, 1e-5, True)
    assert mean.shape == inv.shape == (2, 24)
    for got, want in zip((y, mean, inv),
                         group_norm_fwd_plain(x, w, b, 24, 1e-5, True)):
        assert torch.equal(got, want)
    for got, want in zip(group_norm_bwd(x, w, b, mean, inv, dy, 24, True),
                         group_norm_bwd_plain(x, w, b, mean, inv, dy, 24, True)):
        assert torch.equal(got, want)
    assert group_norm(x.requires_grad_(), w, b, 24, 1e-5).grad_fn is not None
    assert (group_norm.launches, group_norm_bwd.launches) == counts


@pytest.mark.parametrize("silu", [False, True])
def test_groupnorm_autograd_function_gradcheck_float64(silu):
    gen = torch.Generator().manual_seed(1)
    x, w, b = (torch.randn(s, generator=gen, dtype=torch.float64,
                           requires_grad=True) for s in ((2, 6, 3, 5), (6,), (6,)))
    assert torch.autograd.gradcheck(
        lambda x, w, b: _GroupNorm.apply(x, w, b, 3, 1e-5, silu), (x, w, b))


# -- entropy model -----------------------------------------------------------
@pytest.mark.parametrize("noisy", [False, True])
def test_likelihood_and_its_gradients_match_jax(noisy):
    """Noisy (the uniform draw of JAX's key, handed to the port) and rounded
    likelihoods, and the gradients through the lower bounds and the STE:
    scales straddle the 0.11 bound, so both branches of its gradient rule
    are taken. Limits 1e-4: fp32 erfc of the same inputs."""
    y = _normal((2, 4, 6, 3), 0, 3.0)
    means = _normal((2, 4, 6, 3), 1)
    scales = np.abs(_normal((2, 4, 6, 3), 2, 0.2)) + 0.01
    w = _normal(y.shape, 4)
    key = jax.random.PRNGKey(3)
    noise = jax.random.uniform(key, y.shape, jnp.float32, -0.5, 0.5)

    def j_loss(y, s, m):
        out, like = j_gaussian.likelihood(y, s, m, noisy=noisy,
                                          rng=key if noisy else None)
        return jnp.sum(jnp.log(like) * w) + jnp.sum(out * w)

    want = jax.value_and_grad(j_loss, argnums=(0, 1, 2))(
        *map(jnp.asarray, (y, scales, means)))
    ty, ts, tm = (_t(a).requires_grad_() for a in (y, scales, means))
    out, like = t_gaussian.likelihood(ty, ts, tm,
                                      noise=_t(noise) if noisy else None)
    loss = (torch.log(like) * _t(w)).sum() + (out * _t(w)).sum()
    np.testing.assert_allclose(loss.item(), float(want[0]), rtol=1e-5)
    for g, j in zip(torch.autograd.grad(loss, (ty, ts, tm)), want[1]):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-4)


def test_lower_bound_gradient_rule():
    """The gradient passes where x >= bound or where it pushes x down."""
    x = torch.tensor([0.05, 0.05, 0.2, 0.2], requires_grad=True)
    g = torch.tensor([1.0, -1.0, 1.0, -1.0])
    (got,) = torch.autograd.grad(t_gaussian.lower_bound(x, 0.11), x, g)
    _, vjp = jax.vjp(lambda a: j_gaussian.lower_bound(a, 0.11),
                     jnp.asarray(x.detach().numpy()))
    assert got.tolist() == [0.0, -1.0, 1.0, -1.0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(vjp(jnp.asarray(g.numpy()))[0]))
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, 0.4], requires_grad=True)
    y = t_gaussian.ste_round(x)
    np.testing.assert_array_equal(y.detach().numpy(),
                                  np.asarray(j_gaussian.ste_round(jnp.asarray(x.detach().numpy()))))
    assert torch.autograd.grad(y.sum(), x)[0].tolist() == [1.0] * 5


@pytest.mark.parametrize("name", ["ckbd_anchor", "ckbd_nonanchor"])
def test_ckbd_masks_match_jax(name):
    y = _normal((2, 6, 8, 3), 0)
    got = getattr(t_ckbd, name)(_t(y))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(getattr(j_ckbd, name)(jnp.asarray(y))))
    a, na = t_ckbd.ckbd_split(_t(y))
    assert torch.equal(t_ckbd.ckbd_merge(a, na), _t(y))


def test_posterior_sample_matches_jax():
    mean, logvar = _normal((1, 4, 4, 4), 0), _normal((1, 4, 4, 4), 1)
    key = jax.random.PRNGKey(3)
    noise = np.asarray(jax.random.normal(key, mean.shape, jnp.float32))
    from rdeic_tpu.models.vae import sample_diagonal_gaussian as j_sample

    want = j_sample(key, jnp.asarray(mean), jnp.asarray(logvar))
    got = sample_diagonal_gaussian(_t(mean), _t(logvar), _t(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


# -- CVQ ---------------------------------------------------------------------
def _quantisers(num_embed=16, dim=8, seed=0):
    emb = _normal((num_embed, dim), seed, 0.5)
    jq = j_comp.VectorQuantiser(num_embed, dim)
    tq = VectorQuantiser(num_embed, dim)
    with torch.no_grad():
        tq.embedding.copy_(_t(emb))
    return jq, {"params": {"embedding": jnp.asarray(emb)}}, tq


@pytest.mark.parametrize("n_rows", [40, 2])
def test_vector_quantiser_training_loss_and_grads_match_jax(n_rows):
    """Commitment + codebook + contrastive loss, the straight-through z_q,
    and the gradients into z and the codebook. 40 rows: 2 positives per
    code; 2 rows: one positive, one negative."""
    jq, jparams, tq = _quantisers()
    z = _normal((1, n_rows // 2, 2, 8), 5)
    w = _normal(z.shape, 6)

    def j_loss(params, z):
        z_q, loss, idx = jq.apply(params, z, training=True)
        return loss + jnp.sum(z_q * w), idx

    (j_val, j_idx), (j_gp, j_gz) = jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True)(jparams, jnp.asarray(z))
    tz = _t(z).requires_grad_()
    z_q, loss, idx = tq(tz, training=True)
    total = loss + (z_q * _t(w)).sum()
    g_emb, g_z = torch.autograd.grad(total, (tq.embedding, tz))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(total.item(), float(j_val), rtol=1e-5)
    np.testing.assert_allclose(g_z.numpy(), np.asarray(j_gz), atol=1e-5)
    np.testing.assert_allclose(g_emb.numpy(),
                               np.asarray(j_gp["params"]["embedding"]), atol=1e-5)


def test_vq_codebook_update_matches_jax():
    emb = _normal((16, 8), 0, 0.5)
    prob = np.abs(_normal((16,), 1, 1e-3))
    z = _normal((24, 8), 2)
    want = j_comp.vq_codebook_update(*map(jnp.asarray, (emb, prob, z)))
    got = vq_codebook_update(_t(emb), _t(prob), _t(z))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_ema_matches_jax():
    params = {"a": _normal((3, 4), 0), "b": _normal((5,), 1)}
    new = {"a": _normal((3, 4), 2), "b": _normal((5,), 3)}
    j_shadow = j_ema.ema_init({k: jnp.asarray(v) for k, v in params.items()})
    shadow = ema_init({k: _t(v) for k, v in params.items()})
    for step in (0, 1, 50):
        j_shadow = j_ema.ema_update(
            j_shadow, {k: jnp.asarray(v) for k, v in new.items()}, 0.999,
            jnp.asarray(step))
        ema_update(shadow, {k: _t(v) for k, v in new.items()}, 0.999, step)
    for k in params:
        np.testing.assert_allclose(shadow[k].numpy(), np.asarray(j_shadow[k]),
                                   rtol=1e-6, atol=1e-7)


def test_predict_xstart_from_eps_matches_jax():
    from rdeic_torch.diffusion.schedule import NoiseSchedule as TSchedule
    from rdeic_tpu.diffusion.schedule import NoiseSchedule as JSchedule

    x, eps = _normal((3, 4, 4, 4), 0), _normal((3, 4, 4, 4), 1)
    tt = np.array([0, 150, 299])
    want = JSchedule.create().predict_xstart_from_eps(
        jnp.asarray(x), jnp.asarray(tt), jnp.asarray(eps))
    got = TSchedule.create().predict_xstart_from_eps(
        _t(x), torch.from_numpy(tt), _t(eps))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
