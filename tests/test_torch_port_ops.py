"""rdeic_torch ops against rdeic_tpu on the CPU: the plain versions of the two
kernels against the Pallas kernels in interpret mode, and the small ops of
the main path against their JAX counterparts."""
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdeic_torch.diffusion import schedule as t_schedule
from rdeic_torch.diffusion import spaced as t_spaced
from rdeic_torch.models import blocks as t_blocks
from rdeic_torch.ops import ckbd as t_ckbd
from rdeic_torch.ops import gaussian as t_gaussian
from rdeic_torch.ops.attention import attention, sdp_attention
from rdeic_torch.ops.flash_attention import flash_attention, flash_attention_plain
from rdeic_torch.ops.fused_groupnorm import (
    MAX_CLUSTER,
    SCRATCH_BYTES,
    SMEM_LIMIT,
    group_norm,
    group_norm_fwd_plain,
    group_norm_plain,
    group_norm_plan,
)
from rdeic_torch.utils import bitstream as t_bitstream
from rdeic_tpu.diffusion import schedule as j_schedule
from rdeic_tpu.diffusion import spaced as j_spaced
from rdeic_tpu.models import blocks as j_blocks
from rdeic_tpu.ops import ckbd as j_ckbd
from rdeic_tpu.ops import fused_groupnorm as j_gn
from rdeic_tpu.ops import gaussian as j_gaussian
from rdeic_tpu.ops.attention import sdp_attention as j_sdp
from rdeic_tpu.ops.flash_attention import _flash_forward
from rdeic_tpu.utils import bitstream as j_bitstream


def _normal(shape, seed, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * scale + shift).astype(np.float32)


# -- flash attention --------------------------------------------------------
@pytest.mark.parametrize("shape", [(1, 100, 2, 16), (2, 72, 1, 64),
                                   (1, 40, 1, 512)])
def test_flash_plain_matches_pallas_interpret(shape):
    """L is not a multiple of the 32-row blocks, so the padded K tail is
    masked in the Pallas kernel."""
    q, k, v = (_normal(shape, s) for s in range(3))
    want = _flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          block_q=32, block_k=32, interpret=True)
    got = flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_flash_wrapper_takes_the_plain_version_on_cpu():
    q, k, v = (torch.from_numpy(_normal((1, 33, 2, 16), s)) for s in range(3))
    before = flash_attention.launches
    torch.testing.assert_close(flash_attention(q, k, v),
                               flash_attention_plain(q, k, v))
    assert flash_attention.launches == before  # no kernel ran


@pytest.mark.parametrize("lq,lk", [(40, 40), (24, 77)])
def test_sdp_and_dispatch_match_jax(lq, lk):
    q = _normal((2, lq, 2, 8), 0)
    k, v = _normal((2, lk, 2, 8), 1), _normal((2, lk, 2, 8), 2)
    want = np.asarray(j_sdp(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    np.testing.assert_allclose(sdp_attention(tq, tk, tv).numpy(), want, atol=2e-6)
    np.testing.assert_allclose(attention(tq, tk, tv).numpy(), want, atol=2e-6)


# -- GroupNorm(+SiLU) -------------------------------------------------------
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("shape,groups", [
    ((2, 8, 16, 128), 32),
    ((1, 4, 8, 96), 24),     # find_denominator(96, 32) = 32; 24 is non-32
    ((3, 2, 4, 64), 16),
    ((1, 72, 64, 128), 32),  # test_fused_groupnorm's _CHUNKED_SHAPE
])
def test_groupnorm_plain_matches_pallas_interpret(shape, groups, eps, silu):
    x = _normal(shape, 0, scale=3.0, shift=1.0)
    c = shape[-1]
    w, b = _normal((c,), 1), _normal((c,), 2)
    want = j_gn.group_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                           groups=groups, eps=eps, silu=silu, interpret=True)
    x_nchw = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    got = group_norm_plain(x_nchw, torch.from_numpy(w), torch.from_numpy(b),
                           groups, eps, silu)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=5e-5, rtol=1e-5)


def test_groupnorm_wrapper_and_module_on_cpu():
    x = torch.from_numpy(_normal((2, 48, 5, 7), 3))
    mod = t_blocks.GroupNorm32(48, silu=True)
    assert mod.groups == 24
    before = group_norm.launches
    torch.testing.assert_close(
        mod(x), group_norm_plain(x, mod.GroupNorm_0.weight,
                                 mod.GroupNorm_0.bias, 24, 1e-5, True))
    assert group_norm.launches == before


# GroupNorm32 inputs on the paths: the denoiser's channel counts at each
# latent level (UNet and control, 32 groups), served at 768x512 (B = 1,
# latents 64x96 and their halvings) and trained at 512x512 (B = 2); and a
# span larger than 8 CTAs' shared memory
GN_LEVEL_CHANNELS = [(64, 320, 640, 960), (64, 128, 320, 640, 960, 1280, 1920),
                     (128, 256, 640, 1280, 1920, 2560), (256, 1280, 2560)]
GN_PATH_SHAPES = [(b, c, h >> lv, w >> lv)
                  for b, h, w in ((1, 64, 96), (2, 64, 64))
                  for lv, chans in enumerate(GN_LEVEL_CHANNELS) for c in chans]
GN_STREAM_SHAPE = (1, 512, 256, 256)


def _check_plan(shape, groups, itemsize):
    plan = group_norm_plan(shape, groups, itemsize)
    hw = shape[2] * shape[3]
    assert plan.span == shape[1] // groups * hw
    assert 1 <= plan.cluster <= MAX_CLUSTER
    slices = plan.slices()
    assert len(slices) == plan.cluster
    covered = np.zeros(plan.span, dtype=np.int64)
    for lo, hi in slices:
        assert lo < hi  # no CTA without elements
        covered[lo:hi] += 1
    assert (covered == 1).all()  # every element of a span exactly once
    assert plan.smem_bytes <= SMEM_LIMIT
    assert plan.threads % 32 == 0 and 128 <= plan.threads <= 512
    if plan.vec:  # a 16-byte vector never crosses a channel or a slice
        per_vec = 16 // itemsize
        assert hw % per_vec == 0 and plan.chunk % per_vec == 0
    assert plan.resident == (SCRATCH_BYTES + plan.chunk * itemsize <= SMEM_LIMIT)
    if plan.resident:
        assert plan.smem_bytes == SCRATCH_BYTES + plan.chunk * itemsize
    return plan


@pytest.mark.parametrize("shape", GN_PATH_SHAPES)
def test_groupnorm_plan_at_the_path_shapes(shape):
    """Every path shape takes the vector path with its slices in shared
    memory (x read once), in fp32 and bf16."""
    for itemsize in (4, 2):
        plan = _check_plan(shape, 32, itemsize)
        assert plan.vec and plan.resident


def test_groupnorm_plan_largest_path_span():
    """(1, 960, 64, 96): 30 x 6144 fp32 (720 KB) in 8 CTAs of ~90 KB."""
    plan = _check_plan((1, 960, 64, 96), 32, 4)
    assert (plan.cluster, plan.chunk) == (8, 23040)
    assert plan.smem_bytes == SCRATCH_BYTES + 23040 * 4


@pytest.mark.parametrize("shape,groups", [
    (GN_STREAM_SHAPE, 32), ((2, 96, 7, 9), 32), ((1, 32, 17, 19), 32),
    ((2, 48, 32, 32), 24), ((3, 2, 4, 64), 1), ((1, 1024, 17, 19), 32)])
def test_groupnorm_plan_off_the_path(shape, groups):
    """A span larger than 8 CTAs' shared memory streams (both dtypes);
    ragged H * W takes the element path; C/G = 1 and one group work."""
    for itemsize in (4, 2):
        plan = _check_plan(shape, groups, itemsize)
        assert plan.resident == (shape != GN_STREAM_SHAPE)
        assert plan.vec == (shape[2] * shape[3] % (16 // itemsize) == 0)


def group_norm_cluster_emulated(x, weight, bias, groups, eps, silu, plan):
    """The forward kernel's arithmetic: each CTA of `plan` sums (x, x^2) of
    its slice in fp32, the partials are added in rank order in fp32, then
    mean, var = max(E[x^2] - mean^2, 0), inv = 1/sqrt(var + eps) and
    y = x * w + off (w = inv * scale, off = bias - mean * w), SiLU when
    asked. (Inside a CTA the kernel sums in its own thread order; torch's
    sum stands in for it.)"""
    b, c, h, w = x.shape
    xf = x.float().reshape(b * groups, plan.span)
    tot = torch.zeros(b * groups)
    tot2 = torch.zeros(b * groups)
    for lo, hi in plan.slices():
        part = xf[:, lo:hi]
        tot = tot + part.sum(-1)
        tot2 = tot2 + (part * part).sum(-1)
    mean = tot / plan.span
    var = torch.clamp(tot2 / plan.span - mean * mean, min=0.0)
    inv = 1.0 / torch.sqrt(var + eps)
    cg = c // groups
    wc = inv.reshape(b, groups).repeat_interleave(cg, 1) * weight[None]
    off = bias[None] - mean.reshape(b, groups).repeat_interleave(cg, 1) * wc
    y = x.float() * wc[..., None, None] + off[..., None, None]
    if silu:
        y = y * torch.sigmoid(y)
    return y, mean.reshape(b, groups), inv.reshape(b, groups)


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("shape,smem_limit", [
    ((1, 256, 32, 48), SMEM_LIMIT),   # 3 CTAs, resident
    ((2, 320, 24, 32), SMEM_LIMIT),   # 2 CTAs, resident
    ((1, 256, 32, 48), 4096),         # 3 CTAs, streamed
    ((1, 1024, 17, 19), SMEM_LIMIT),  # 3 CTAs, element path
])
def test_groupnorm_cluster_combine_matches_pallas_interpret(shape, smem_limit,
                                                            silu):
    """The kernel's fixed-order combine of per-CTA partials, emulated,
    against the Pallas forward in interpret mode (NHWC) and the plain
    version, within 1e-5."""
    c = shape[1]
    x = _normal(shape, 0, scale=3.0, shift=1.0)
    w, b = _normal((c,), 1), _normal((c,), 2)
    plan = group_norm_plan(shape, 32, 4, True, smem_limit)
    assert plan.cluster > 1
    tx, tw, tb = map(torch.from_numpy, (x, w, b))
    got, mean, inv = group_norm_cluster_emulated(tx, tw, tb, 32, 1e-5, silu,
                                                 plan)
    want = j_gn.group_norm(jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(w),
                           jnp.asarray(b), groups=32, eps=1e-5, silu=silu,
                           interpret=True)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=1e-5, rtol=1e-5)
    plain, pmean, pinv = group_norm_fwd_plain(tx, tw, tb, 32, 1e-5, silu)
    torch.testing.assert_close(got, plain, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(mean, pmean, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(inv, pinv, atol=0, rtol=1e-5)


# -- checkerboard, entropy tables, blocks -----------------------------------
@pytest.mark.parametrize("name", ["anchor", "nonanchor"])
def test_ckbd_matches_jax(name):
    y = _normal((2, 6, 8, 3), 4)
    squeeze = getattr(t_ckbd, f"ckbd_{name}_squeeze")
    unsqueeze = getattr(t_ckbd, f"ckbd_{name}_unsqueeze")
    want_sq = np.asarray(getattr(j_ckbd, f"ckbd_{name}_squeeze")(jnp.asarray(y)))
    got_sq = squeeze(torch.from_numpy(y))
    np.testing.assert_array_equal(got_sq.numpy(), want_sq)
    j_unsqueeze = getattr(j_ckbd, f"ckbd_{name}_unsqueeze")
    want_un = np.asarray(j_unsqueeze(jnp.asarray(want_sq)))
    np.testing.assert_array_equal(unsqueeze(got_sq).numpy(), want_un)


def test_cdf_tables_and_indexes_match_jax():
    table = t_gaussian.get_scale_table()
    np.testing.assert_array_equal(table, j_gaussian.get_scale_table())
    for got, want in zip(t_gaussian.build_cdf_tables(table),
                         j_gaussian.build_cdf_tables(table)):
        np.testing.assert_array_equal(got, want)
    scales = np.exp(_normal((3, 5, 7), 5, scale=3.0))
    scales[0, 0, :3] = table[[0, 10, 63]].astype(np.float32)  # on the edges
    want = np.asarray(j_gaussian.build_indexes(jnp.asarray(scales), table))
    got = t_gaussian.build_indexes(torch.from_numpy(scales), table)
    np.testing.assert_array_equal(got.numpy(), want)


def test_timestep_embedding_and_pixel_shuffle_match_jax():
    ts = np.array([0, 1, 150, 299, 999], np.int32)
    want = np.asarray(j_blocks.timestep_embedding(jnp.asarray(ts), 33))
    got = t_blocks.timestep_embedding(torch.from_numpy(ts), 33)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    x = _normal((2, 3, 5, 12), 6)
    want = np.asarray(j_blocks.pixel_shuffle(jnp.asarray(x), 2))
    got = t_blocks.pixel_shuffle(torch.from_numpy(x).permute(0, 3, 1, 2), 2)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    for number, start in [(320, 32), (64, 32), (48, 32), (7, 16), (128, 16)]:
        assert t_blocks.find_denominator(number, start) == \
            j_blocks.find_denominator(number, start)


# -- schedule and sampler ---------------------------------------------------
@pytest.mark.parametrize("name", ["linear", "cosine", "sqrt_linear", "sqrt"])
def test_beta_schedules_match_jax(name):
    np.testing.assert_array_equal(
        t_schedule.make_beta_schedule(name, 1000, 0.00085, 0.012),
        j_schedule.make_beta_schedule(name, 1000, 0.00085, 0.012))
    for counts in (2, [3, 4], "10,5", "ddim10"):
        assert t_schedule.space_timesteps(300, counts) == \
            j_schedule.space_timesteps(300, counts)


def test_schedule_tables_match_jax():
    tj = j_schedule.NoiseSchedule.create()
    tt = t_schedule.NoiseSchedule.create()
    for name in ("alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
                 "posterior_mean_coef1", "posterior_variance"):
        np.testing.assert_array_equal(tt.table(name), tj.table(name))
    for steps in (2, 5, "10,3"):
        sj, idx_j = j_schedule.spaced_schedule(tj, 300, steps)
        st, idx_t = t_schedule.spaced_schedule(tt, 300, steps)
        np.testing.assert_array_equal(idx_t, idx_j)
        np.testing.assert_array_equal(st.betas, sj.betas)
    x, noise = _normal((2, 4, 4, 3), 7), _normal((2, 4, 4, 3), 8)
    ts = np.array([299, 17], np.int32)
    want = tj.q_sample(jnp.asarray(x), jnp.asarray(ts), jnp.asarray(noise))
    got = tt.q_sample(torch.from_numpy(x), torch.from_numpy(ts),
                      torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_spaced_sampler_matches_jax_with_the_same_noise():
    """A linear stand-in for the denoiser; the per-step noise is the JAX
    stream's own draws, passed to the port."""
    sched_j = j_schedule.NoiseSchedule.create()
    sched_t = t_schedule.NoiseSchedule.create()
    for var_type in ("fixed_large", "fixed_small"):
        cj = j_spaced.make_spaced_coefficients(sched_j, 300, 3, var_type)
        ct = t_spaced.make_spaced_coefficients(sched_t, 300, 3, var_type)
        for a, b in zip(ct, cj):
            np.testing.assert_array_equal(a, np.asarray(b))
    x_T = _normal((1, 4, 6, 4), 9)
    w = 0.3

    def den_j(x, ts):
        return w * x + ts[:, None, None, None].astype(jnp.float32) * 1e-3

    def den_t(x, ts):
        return w * x + ts[:, None, None, None].float() * 1e-3

    rng = jax.random.PRNGKey(3)
    want = j_spaced.sample(den_j, jnp.asarray(x_T), rng, cj)
    noise, r = [], rng
    for _ in range(3):
        r, key = jax.random.split(r)
        noise.append(torch.from_numpy(np.array(
            jax.random.normal(key, x_T.shape, jnp.float32))))
    got = t_spaced.sample(den_t, torch.from_numpy(x_T), ct, noise=noise)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_bitstream_container_bytes_match_jax():
    strings = [[b"\x01\x02\x03"], [b""], [bytes(range(200))]]
    buf_j, buf_t = io.BytesIO(), io.BytesIO()
    j_bitstream.write_body(buf_j, (3, 5), strings)
    t_bitstream.write_body(buf_t, (3, 5), strings)
    assert buf_t.getvalue() == buf_j.getvalue()
    buf_t.seek(0)
    got, shape = t_bitstream.read_body(buf_t)
    assert got == strings and tuple(shape) == (3, 5)
