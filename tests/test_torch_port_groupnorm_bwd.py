"""The GroupNorm(+SiLU) backward kernel's launch plan and its fixed-order
sums (`rdeic_torch/csrc/group_norm_bwd.cu`), on the CPU.

The kernel runs one cluster of up to 8 CTAs per (batch, group) span. Each
CTA cuts its slice into tasks of up to 128 units (16-byte vectors, or
elements) inside one channel and adds their (sum dp, sum dp x_hat) per
channel in task order; the cluster adds each channel's pieces in rank order
through distributed shared memory; the last span of a group sums dscale and
dbias over the batch in b order. `group_norm_bwd_cluster_emulated` follows
that order with the kernel's own index arithmetic, and the tests hold it to
the Pallas backward in interpret mode and to the plain version, at plans of
1 to 8 CTAs, resident and streamed, on the vector and the element path;
they hold `group_norm_bwd_plan` to its rules at every training shape.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdeic_torch.ops.fused_groupnorm import (
    BWD_HEAD_FLOATS,
    BWD_TASK_UNITS,
    MAX_CLUSTER,
    SMEM_LIMIT,
    group_norm_bwd,
    group_norm_bwd_plain,
    group_norm_bwd_plan,
    group_norm_fwd_plain,
)
from rdeic_tpu.ops import fused_groupnorm as j_gn
from tests.torch_port_tf32 import one_torch_thread  # noqa: F401 (autouse)

# GroupNorm32 inputs of the training paths: the denoiser's channel counts
# (UNet and control, 32 groups) at each latent level of 512x512, B = 2
GN_TRAIN_SHAPES = [
    (2, c, 64 >> lv, 64 >> lv)
    for lv, chans in enumerate([(64, 320, 640, 960),
                                (64, 128, 320, 640, 960, 1280, 1920),
                                (128, 256, 640, 1280, 1920, 2560),
                                (256, 1280, 2560)])
    for c in chans]


def _normal(shape, seed, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * scale + shift).astype(np.float32)


def _channels_touched(plan, hw):
    """For each CTA, the channels (of its group) its slice touches."""
    return [range(lo // hw, (hi - 1) // hw + 1) for lo, hi in plan.slices()]


def _check_bwd_plan(shape, groups, itemsize, smem_limit=SMEM_LIMIT):
    plan = group_norm_bwd_plan(shape, groups, itemsize, True, smem_limit)
    hw = shape[2] * shape[3]
    assert plan.span == shape[1] // groups * hw
    assert 1 <= plan.cluster <= MAX_CLUSTER
    covered = np.zeros(plan.span, dtype=np.int64)
    for lo, hi in plan.slices():
        assert lo < hi  # no CTA without elements
        covered[lo:hi] += 1
    assert (covered == 1).all()  # every element of a span exactly once
    unit = 16 // itemsize if plan.vec else 1
    if plan.vec:  # a 16-byte vector never crosses a channel or a slice
        assert hw % unit == 0 and plan.chunk % unit == 0
    tpc = -(-(hw // unit) // BWD_TASK_UNITS)
    for chans in _channels_touched(plan, hw):
        assert len(chans) <= plan.nch  # room for every channel partial
        assert len(chans) * tpc <= plan.tasks  # and every task
    head = -(-(BWD_HEAD_FLOATS + 2 * plan.nch + 2 * plan.tasks) // 4) * 4
    slab = 2 * plan.chunk * 4  # x_hat and dp in fp32, whatever the dtype
    assert plan.resident == (4 * head + slab <= smem_limit)
    assert plan.smem_bytes == 4 * head + (slab if plan.resident else 0)
    assert plan.smem_bytes <= smem_limit
    assert plan.threads % 32 == 0 and 128 <= plan.threads <= 512
    return plan


@pytest.mark.parametrize("shape", GN_TRAIN_SHAPES)
def test_groupnorm_bwd_plan_at_the_training_shapes(shape):
    """Every training shape takes the vector path with x_hat and dp
    resident (x and dy read once), in fp32 and bf16."""
    for itemsize in (4, 2):
        plan = _check_bwd_plan(shape, 32, itemsize)
        assert plan.vec and plan.resident


def test_groupnorm_bwd_plan_largest_training_span():
    """(2, 960, 64, 64): 30 x 4096 elements in 8 CTAs, each keeping 2 x 60 KB
    of x_hat and dp."""
    plan = _check_bwd_plan((2, 960, 64, 64), 32, 4)
    assert (plan.cluster, plan.chunk) == (8, 15360)
    assert plan.smem_bytes > 2 * 15360 * 4


@pytest.mark.parametrize("shape,groups", [
    ((1, 512, 256, 256), 32), ((2, 96, 7, 9), 32), ((2, 48, 32, 32), 24),
    ((3, 2, 4, 64), 1), ((1, 1024, 17, 19), 32)])
def test_groupnorm_bwd_plan_off_the_path(shape, groups):
    """A span larger than 8 CTAs' shared memory streams; ragged H * W takes
    the element path; C/G = 1 and one group work."""
    for itemsize in (4, 2):
        plan = _check_bwd_plan(shape, groups, itemsize)
        assert plan.resident == (shape != (1, 512, 256, 256))
        assert plan.vec == (shape[2] * shape[3] % (16 // itemsize) == 0)


def group_norm_bwd_cluster_emulated(x, dy, weight, bias, mean, inv, groups,
                                    silu, plan, itemsize=4):
    """(dx, dscale, dbias) in the kernel's order: each CTA's tasks (up to
    BWD_TASK_UNITS units of one channel) summed in fp32 and added per
    channel in task order; each channel's pieces added in rank order over
    the ranks rlo..rhi the kernel reads (local index c - r * chunk // hw);
    m1 and m2 from the channel sums; the per-(b, c) sums added over the
    batch in b order. (Inside a task the kernel sums in its own lane order;
    torch's sum stands in for it.)"""
    b, c, h, w = x.shape
    hw, cg = h * w, c // groups
    rows = b * groups
    xf = x.float().reshape(rows, plan.span)
    xhat = (xf - mean.reshape(rows, 1)) * inv.reshape(rows, 1)
    g = weight.float().reshape(groups, cg).repeat(b, 1)  # [rows, cg]
    gel = g.repeat_interleave(hw, dim=1)
    dyf = dy.float().reshape(rows, plan.span)
    if silu:
        p = xhat * gel + bias.float().reshape(groups, cg).repeat(b, 1) \
            .repeat_interleave(hw, dim=1)
        sig = torch.sigmoid(p)
        dp = dyf * sig * (1.0 + p * (1.0 - sig))
    else:
        dp = dyf
    unit = 16 // itemsize if plan.vec else 1
    te = BWD_TASK_UNITS * unit  # elements of a task
    partials = []  # per CTA: {channel: (sum dp, sum dp x_hat)}
    for lo, hi in plan.slices():
        part = {}
        for ch in range(lo // hw, (hi - 1) // hw + 1):
            s1 = s2 = torch.zeros(rows)
            for k0 in range(ch * hw, (ch + 1) * hw, te):
                a, e = max(lo, k0), min(hi, k0 + te, (ch + 1) * hw)
                if a < e:
                    s1 = s1 + dp[:, a:e].sum(1)
                    s2 = s2 + (dp[:, a:e] * xhat[:, a:e]).sum(1)
            part[ch] = (s1, s2)
        partials.append(part)
    t1, t2 = torch.zeros(rows, cg), torch.zeros(rows, cg)
    for ch in range(cg):
        rlo = ch * hw // plan.chunk
        rhi = min(plan.cluster - 1, ((ch + 1) * hw - 1) // plan.chunk)
        for r in range(rlo, rhi + 1):
            assert ch - r * plan.chunk // hw in range(plan.nch)
            s1, s2 = partials[r][ch]
            t1[:, ch] += s1
            t2[:, ch] += s2
    n = float(cg * hw)
    m1 = (g * t1).sum(1, keepdim=True) / n
    m2 = (g * t2).sum(1, keepdim=True) / n
    dx = inv.reshape(rows, 1) * (dp * gel - m1 - xhat * m2)
    sums = torch.stack([t1, t2], -1).reshape(b, c, 2)
    dbias, dscale = torch.zeros(c), torch.zeros(c)
    for i in range(b):  # the last span of a group: b order
        dbias = dbias + sums[i, :, 0]
        dscale = dscale + sums[i, :, 1]
    return dx.reshape(x.shape), dscale, dbias


def _pallas_bwd(x, dy, w, b, groups, silu):
    """The Pallas backward in interpret mode, NCHW in and out."""
    def f(xn, w_, b_):
        return j_gn.group_norm(xn, w_, b_, groups=groups, eps=1e-5,
                               silu=silu, interpret=True)

    _, vjp = jax.vjp(f, jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(w),
                     jnp.asarray(b))
    dx, dw, db = vjp(jnp.asarray(dy.transpose(0, 2, 3, 1)))
    return (torch.from_numpy(np.array(dx).transpose(0, 3, 1, 2)),
            torch.from_numpy(np.array(dw)), torch.from_numpy(np.array(db)))


def _rel(got, want) -> float:
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("shape,groups,smem_limit,cluster", [
    ((2, 256, 32, 48), 32, SMEM_LIMIT, 6),   # 6 CTAs, slices end mid-channel
    ((2, 320, 24, 32), 32, SMEM_LIMIT, 4),   # 4 CTAs, 2.5 channels each
    ((2, 960, 16, 16), 32, SMEM_LIMIT, 4),   # 4 CTAs, 7.5 channels each
    ((2, 256, 32, 48), 32, 4096, 6),         # 6 CTAs, streamed
    ((2, 1024, 17, 19), 32, SMEM_LIMIT, 6),  # 6 CTAs, element path
    ((3, 48, 32, 32), 24, SMEM_LIMIT, 1),    # one CTA, three images
])
def test_groupnorm_bwd_cluster_order_matches_pallas_interpret(
        shape, groups, smem_limit, cluster, silu):
    """The kernel's task, rank and batch order, emulated, against the
    Pallas backward in interpret mode (NHWC) and the plain version: dx
    within 1e-5 of max, dscale and dbias within 1e-5 of max."""
    c = shape[1]
    x = _normal(shape, 0, scale=3.0, shift=1.0)
    dy = _normal(shape, 3)
    w, b = _normal((c,), 1), _normal((c,), 2)
    plan = group_norm_bwd_plan(shape, groups, 4, True, smem_limit)
    assert plan.cluster == cluster
    tx, tdy, tw, tb = map(torch.from_numpy, (x, dy, w, b))
    _, mean, inv = group_norm_fwd_plain(tx, tw, tb, groups, 1e-5, silu)
    got = group_norm_bwd_cluster_emulated(tx, tdy, tw, tb, mean, inv, groups,
                                          silu, plan)
    pallas = _pallas_bwd(x, dy, w, b, groups, silu)
    plain = group_norm_bwd_plain(tx, tw, tb, mean, inv, tdy, groups, silu)
    for g, want_p, want in zip(got, pallas, plain):
        assert _rel(g, want_p) <= 1e-5
        assert _rel(g, want) <= 1e-5


def test_groupnorm_bwd_rank_order_covers_each_channel_once():
    """For every plan of a span cut 1 to 8 ways, the ranks rlo..rhi that
    the kernel reads for channel c hold pieces of c that tile it exactly,
    in rank order, and their local indices are inside each CTA's
    partials."""
    hw, sizes = 24 * 40, set()
    for cg in range(1, 21):
        plan = group_norm_bwd_plan((1, 32 * cg, 24, 40), 32, 4)
        sizes.add(plan.cluster)
        slices = plan.slices()
        for ch in range(cg):
            rlo = ch * hw // plan.chunk
            rhi = min(plan.cluster - 1, ((ch + 1) * hw - 1) // plan.chunk)
            pieces = [(max(lo, ch * hw), min(hi, (ch + 1) * hw))
                      for lo, hi in slices[rlo:rhi + 1]]
            assert pieces[0][0] == ch * hw and pieces[-1][1] == (ch + 1) * hw
            assert all(a[1] == b[0] for a, b in zip(pieces, pieces[1:]))
            assert all(lo < hi for lo, hi in pieces)
            for r in range(rlo, rhi + 1):
                assert 0 <= ch - r * plan.chunk // hw < plan.nch
    assert sizes == set(range(1, MAX_CLUSTER + 1))


def test_groupnorm_bwd_wrapper_takes_the_plain_version_on_cpu():
    x = torch.from_numpy(_normal((2, 64, 6, 6), 0))
    dy = torch.from_numpy(_normal((2, 64, 6, 6), 1))
    w, b = (torch.from_numpy(_normal((64,), s)) for s in (2, 3))
    _, mean, inv = group_norm_fwd_plain(x, w, b, 32, 1e-5, True)
    before = group_norm_bwd.launches
    got = group_norm_bwd(x, w, b, mean, inv, dy, 32, True)
    assert group_norm_bwd.launches == before  # no kernel on the CPU
    for g, want in zip(got, group_norm_bwd_plain(x, w, b, mean, inv, dy, 32,
                                                 True)):
        assert torch.equal(g, want)
