"""The port's kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with nvcc, and skip elsewhere.
This file imports no JAX, so it also runs where JAX is not installed; there,
skip the repository's conftest (it configures JAX):

    python -m pytest --noconftest -q -m cuda tests/test_torch_port_cuda.py
"""
import math
import struct
import threading

import numpy as np
import pytest
import torch

from rdeic_torch.models.blocks import GroupNorm32
from rdeic_torch.models.unet import CrossAttention
from rdeic_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_dkv,
    flash_attention_dq,
    flash_attention_lse,
    flash_attention_lse_plain,
    flash_attention_plain,
)
from rdeic_torch.ops.fused_groupnorm import (
    _launch_bwd,
    _launch_fwd,
    group_norm,
    group_norm_bwd,
    group_norm_bwd_plain,
    group_norm_fwd,
    group_norm_fwd_plain,
    group_norm_bwd_plan,
    group_norm_plain,
    group_norm_plan,
)

pytestmark = pytest.mark.cuda

# d = 512 with B = 2 and H = 2 (every path shape has H = 1) and an L that
# is a multiple of no tile of the tensor-core kernels
D512_SHAPES = [(2, 1000, 2, 512), (2, 4097, 2, 512)]
# (B, L, H, D) of every main-path flash launch at 768x512, plus ragged L
FLASH_SHAPES = [(1, 6144, 5, 64), (1, 6144, 4, 16), (1, 6144, 1, 512),
                (1, 1536, 10, 64), (1, 1536, 8, 16),
                (2, 1000, 3, 64), (1, 77, 2, 16), (1, 130, 1, 512),
                *D512_SHAPES]
# (B, C, H, W) of GroupNorm32 inputs: UNet and control at 96x64 latents,
# the path's largest span (30 x 6144), C/G = 1 (vector and element paths),
# a ragged span, and a span larger than a cluster's shared memory (the
# kernel streams it: GN_STREAM_SHAPE)
GN_STREAM_SHAPE = (1, 512, 256, 256)
GN_SHAPES = [(1, 320, 96, 64), (1, 2560, 12, 8), (1, 1920, 24, 16),
             (1, 960, 48, 32), (1, 640, 96, 64), (1, 64, 96, 64),
             (1, 256, 12, 8), (2, 128, 7, 9), (1, 960, 64, 96),
             (1, 32, 64, 64), (2, 32, 17, 19), GN_STREAM_SHAPE]
# (B, L, H, D) of the training paths' flash calls at 512x512, B = 2 (the
# refine phase adds the VAE decoder's d = 512), the decoder's at 256x256,
# plus ragged L (the backward masks padded q rows and k columns; at d = 64
# an L past one 64-row tile, inside one, and below one 32-row chunk), at
# d = 64 and d = 16 twice the paths' longest L (the dq, dk and dv sums run
# over L), and d = 16 at the serving shapes
FLASH_TRAIN_SHAPES = [(2, 4096, 5, 64), (2, 1024, 10, 64), (2, 4096, 4, 16),
                      (2, 1024, 8, 16), (2, 4096, 1, 512), (1, 1024, 1, 512),
                      (2, 1000, 3, 64), (1, 130, 2, 64), (2, 40, 3, 64),
                      (1, 8192, 2, 64), (1, 77, 2, 16), (1, 130, 1, 512),
                      (1, 1000, 4, 16), (1, 8192, 4, 16), (1, 6144, 4, 16),
                      (1, 1536, 8, 16), *D512_SHAPES]
FAULT_SCALE = 1.05  # a planted output-scale error each check must read
# (B, C, H, W, groups) of GroupNorm backward: denoiser widths at 512x512
# (64x64 latents), a 48-channel control width (find_denominator gives 24
# groups), and ragged spans
GN_TRAIN_SHAPES = [(2, 320, 64, 64, 32), (2, 1280, 8, 8, 32),
                   (2, 64, 64, 64, 32), (2, 48, 32, 32, 24),
                   (2, 256, 16, 16, 32), (1, 96, 7, 9, 32)]
# every GroupNorm32 input of the training paths: the denoiser's channel
# counts (UNet and control) at each latent level of 512x512, B = 2
GN_BWD_PATH_SHAPES = [
    (2, c, 64 >> lv, 64 >> lv, 32)
    for lv, chans in enumerate([(64, 320, 640, 960),
                                (64, 128, 320, 640, 960, 1280, 1920),
                                (128, 256, 640, 1280, 1920, 2560),
                                (256, 1280, 2560)])
    for c in chans]
# the d = 16 forward (flash_fwd_d16 after flash_fwd_d16_split, and
# flash_fwd_d16_bf16, on wgmma): every path shape (serving, training with
# lse, validation, batched and tiled serving), B = 2 with H = 3 at a ragged
# L, twice the serving L (the sums run over L), and L = 20 (inside one
# tile), 77 and 130 (past one and two 64-key tiles)
D16_SHAPES = [(1, 6144, 4, 16), (1, 1536, 8, 16), (2, 4096, 4, 16),
              (2, 1024, 8, 16), (1, 4096, 4, 16), (1, 1024, 8, 16),
              (2, 6144, 4, 16), (2, 1536, 8, 16), (4, 4096, 4, 16),
              (4, 1024, 8, 16), (3, 4096, 4, 16), (3, 1024, 8, 16),
              (15, 4096, 4, 16), (2, 1000, 3, 16), (1, 8192, 4, 16),
              (1, 20, 2, 16), (1, 77, 2, 16), (1, 130, 1, 16)]
# the bf16 forward kernels of their own (flash_fwd_d16_bf16,
# flash_fwd_d64_bf16, flash_fwd_d512_bf16): the serving and training path
# shapes, tails (an L inside one q tile, one past a tile, an L of no tile
# multiple with B = 2, H > 1) and L = 8192
BF16_FWD_SHAPES = [(1, 6144, 4, 16), (1, 1536, 8, 16), (2, 4096, 4, 16),
                   (2, 1024, 8, 16), (1, 20, 2, 16), (1, 77, 2, 16),
                   (1, 130, 1, 16), (2, 1000, 3, 16), (1, 8192, 4, 16),
                   (1, 6144, 5, 64), (1, 1536, 10, 64), (2, 4096, 5, 64),
                   (2, 1024, 10, 64), (2, 40, 3, 64), (1, 130, 2, 64),
                   (2, 1000, 3, 64), (1, 8192, 2, 64), (1, 6144, 1, 512),
                   (2, 4096, 1, 512), (1, 1024, 1, 512), (1, 20, 2, 512),
                   (1, 130, 1, 512), (2, 1000, 2, 512), (1, 8192, 1, 512)]
# the bf16 backward at d = 64 (flash_dq_d64_bf16, flash_dkv_d64_bf16): the
# training path shapes, tails (an L inside one 64-row tile, one two rows
# past two tiles, an L of no tile multiple with B = 2, H > 1) and L = 8192
D64_BF16_BWD_SHAPES = [(2, 4096, 5, 64), (2, 1024, 10, 64), (2, 40, 3, 64),
                       (1, 130, 2, 64), (2, 1000, 3, 64), (1, 8192, 2, 64)]
# the fp32 backward at d = 64 (flash_dq_d64, flash_dkv_d64 on TF32 wgmma):
# every fp32 shape a path gives it (training's two; the card-vs-CPU and tp
# micro-steps' [B, 1024, 5, 64] at 256x256; the serving, batched and tiled
# forwards' shapes, which the lse forward would give it), tails (an L
# inside one 32-row streamed tile and one 128-row kept tile, one two rows
# past a kept tile, an L of no tile multiple with B = 2, H > 1) and
# L = 8192
D64_FP32_BWD_SHAPES = [(2, 4096, 5, 64), (2, 1024, 10, 64), (1, 1024, 5, 64),
                       (2, 1024, 5, 64), (1, 6144, 5, 64), (1, 1536, 10, 64),
                       (4, 1024, 10, 64), (2, 40, 3, 64), (1, 130, 2, 64),
                       (2, 1000, 3, 64), (1, 8192, 2, 64)]
# the fp32 backward at d = 512 (flash_dq_d512, flash_dkv_d512: clusters of
# eight blocks along d): the path shapes (the refine micro-step's and the
# 256x256 refine reference's), L inside one 64-row tile, past two rows of a
# 32-row tile, ragged with B = 2 and H = 2, and twice the longest path L
D512_FP32_BWD_SHAPES = [(2, 4096, 1, 512), (1, 1024, 1, 512), (1, 10, 1, 512),
                        (1, 130, 1, 512), (2, 1000, 2, 512), (2, 4097, 2, 512),
                        (1, 8192, 1, 512)]
# the bf16 backward at d = 16 (flash_dq_d16_bf16, flash_dkv_d16_bf16): every
# d = 16 path shape (training's two, and serving's, whose L the lse forward
# would give it), tails (an L inside one 64-row tile, one past the first
# 64 rows of a 128-row streamed tile, one two rows past two 64-row tiles, an
# L of no tile multiple with B = 2, H > 1) and L = 8192
D16_BF16_BWD_SHAPES = [(2, 4096, 4, 16), (2, 1024, 8, 16), (1, 6144, 4, 16),
                       (1, 1536, 8, 16), (1, 20, 2, 16), (1, 77, 2, 16),
                       (1, 130, 1, 16), (2, 1000, 3, 16), (1, 8192, 4, 16)]
# the bf16 backward at d = 512 (flash_dq_d512_bf16, flash_dkv_d512_bf16):
# the refine path's shape, [1, 1024, 1, 512], tails (an L inside one
# 16-key tile, one two rows past two 64-row q tiles) and D512_SHAPES (B = 2,
# H = 2, an L of no tile multiple, and one past 4096), and L = 8192
D512_BF16_BWD_SHAPES = [(2, 4096, 1, 512), (1, 1024, 1, 512), (1, 10, 2, 512),
                        (1, 130, 1, 512), *D512_SHAPES, (1, 8192, 1, 512)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 values (8 significant bits) at magnitude x."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def _rand(shape, dtype, device, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        device=device, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_kernel_matches_plain(cuda, shape, dtype):
    q, k, v = (_rand(shape, dtype, cuda, s) for s in range(3))
    before = flash_attention.launches
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(q, k, v).float()
    if dtype == torch.float32:  # both sum in fp32, in different orders
        torch.testing.assert_close(out, want, atol=2e-5, rtol=2e-5)
    else:  # fp32 results ~1e-6 apart round to bf16: at most one ulp apart
        tol = 2 * bf16_ulp(want.abs().max().item())
        assert (out.float() - want).abs().max().item() <= tol


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("shape", GN_SHAPES)
def test_groupnorm_kernel_matches_plain(cuda, shape, eps, silu):
    c = shape[1]
    groups = 32 if c % 32 == 0 else 16
    x = _rand(shape, torch.float32, cuda, 0) * 3 + 1
    w = _rand((c,), torch.float32, cuda, 1)
    b = _rand((c,), torch.float32, cuda, 2)
    before = group_norm.launches
    out = group_norm(x, w, b, groups, eps, silu)
    torch.cuda.synchronize()
    assert group_norm.launches == before + 1  # one cluster launch
    want = group_norm_plain(x, w, b, groups, eps, silu)
    torch.testing.assert_close(out, want, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("shape", [(1, 640, 48, 32), (2, 32, 17, 19),
                                   (1, 2560, 8, 12), GN_STREAM_SHAPE])
def test_groupnorm_kernel_bf16(cuda, shape, eps, silu):
    """bf16 in and out, fp32 statistics: against the plain version on the
    same values in fp32, unrounded (rounding to bf16 moves a value by at
    most 2^-8 of it; 1e-4 of max for the fp32 sums)."""
    c = shape[1]
    x = _rand(shape, torch.bfloat16, cuda, 0) * 3 + 1
    w = _rand((c,), torch.float32, cuda, 1)
    b = _rand((c,), torch.float32, cuda, 2)
    y, mean, inv = group_norm_fwd(x, w, b, 32, eps, silu)
    assert y.dtype == torch.bfloat16
    want, want_mean, want_inv = group_norm_fwd_plain(x.float(), w, b, 32, eps,
                                                     silu)
    assert _rel_err(y, want) <= 2.0 ** -8 + 1e-4
    torch.testing.assert_close(mean, want_mean, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(inv, want_inv, atol=0, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,smem_limit", [
    ((2, 256, 64, 64), 8192),       # vector path, 8 CTAs (bf16: 4), streamed
    ((2, 256, 64, 64), 20000),      # vector path, resident
    ((2, 1024, 17, 19), 600),       # element path, 3 CTAs (bf16: 2), streamed
    ((2, 1024, 17, 19), 232448),    # element path, resident
])
def test_groupnorm_kernel_plans_match_plain(cuda, shape, smem_limit, dtype):
    """Plans the path's shapes do not reach (a multi-CTA cluster streaming a
    small span), forced by a low shared-memory limit: y, mean and 1/std
    against the plain version."""
    c = shape[1]
    x = _rand(shape, dtype, cuda, 0) * 3 + 1
    w, b = (_rand((c,), torch.float32, cuda, s) for s in (1, 2))
    plan = group_norm_plan(shape, 32, x.element_size(), True, smem_limit)
    assert plan.cluster > 1
    y, mean, inv = _launch_fwd(x, w, b, 32, 1e-5, True, stats=True, plan=plan)
    want, want_mean, want_inv = group_norm_fwd_plain(x.float(), w, b, 32, 1e-5,
                                                     True)
    assert _rel_err(y, want) <= _limit(dtype)
    torch.testing.assert_close(mean, want_mean, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(inv, want_inv, atol=0, rtol=1e-5)


def test_groupnorm_serving_call_stores_no_statistics(cuda):
    """Without autograd the wrapper asks the kernel for no mean / 1/std, and
    gives the same output as the call that stores them."""
    x = _rand((1, 320, 24, 16), torch.float32, cuda, 0)
    w, b = (_rand((320,), torch.float32, cuda, s) for s in (1, 2))
    y, mean, inv = _launch_fwd(x, w, b, 32, 1e-5, True, stats=False)
    assert mean is None and inv is None
    torch.testing.assert_close(y, group_norm_fwd(x, w, b, 32, 1e-5, True)[0],
                               atol=0, rtol=0)


def _rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    want = want.float()
    return ((got.float() - want).abs().max() / want.abs().max()).item()


def _limit(dtype) -> float:
    """fp32: the kernel and the plain version sum in fp32 in other orders,
    ~1e-6 of max apart. bf16: the kernel's output against the plain
    version's unrounded fp32 result (the plain version on the same values
    upcast); rounding to nearest bf16 moves a value by at most 2^-8 of its
    magnitude, so the limit is that plus the fp32 one."""
    return 1e-4 if dtype == torch.float32 else 2.0 ** -8 + 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", FLASH_TRAIN_SHAPES)
def test_flash_lse_and_backward_kernels_match_plain(cuda, shape, dtype):
    """The lse forward and the dq and dkv kernels: one launch each, within
    the limits of the plain versions, each reading a planted x1.05 fault;
    the backward gives the same bits on a second launch (no atomics)."""
    q, k, v, do = (_rand(shape, dtype, cuda, s) for s in range(4))
    counts = [f.launches for f in (flash_attention_lse, flash_attention_dq,
                                   flash_attention_dkv)]
    o, lse = flash_attention_lse(q, k, v)
    grads = flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert [f.launches for f in (flash_attention_lse, flash_attention_dq,
                                 flash_attention_dkv)] == [c + 1 for c in counts]
    again = flash_attention_bwd(q, k, v, o, lse, do)
    assert all(torch.equal(g, a) for g, a in zip(grads, again))
    want_o, want_lse = flash_attention_lse_plain(q.float(), k.float(), v.float())
    assert _rel_err(o, want_o) <= _limit(dtype)
    assert (lse - want_lse).abs().max().item() <= 1e-4  # fp32 in both
    # the backward from the same o and lse, so only the backward is compared
    plain = flash_attention_bwd_plain(*(x.float() for x in (q, k, v, o)), lse,
                                      do.float())
    for got, want in zip(grads, plain):
        assert got.dtype == dtype
        assert _rel_err(got, want) <= _limit(dtype)
        assert _rel_err(got.float() * FAULT_SCALE, want) > _limit(dtype)


@pytest.mark.parametrize("shape", [(2, 1024, 10, 64), (1, 1000, 4, 16),
                                   (1, 1024, 1, 512)])
def test_flash_autograd_on_cuda_matches_plain_autograd(cuda, shape):
    """The gradient that reaches q, k and v through autograd: the kernels'
    Function against autograd through the plain forward."""
    inputs = [_rand(shape, torch.float32, cuda, s).requires_grad_()
              for s in range(3)]
    do = _rand(shape, torch.float32, cuda, 3)
    out = flash_attention(*inputs)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, inputs, do)
    want = torch.autograd.grad(flash_attention_plain(*inputs), inputs, do)
    for g, w in zip(got, want):
        assert _rel_err(g, w) <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", D512_SHAPES)
def test_flash_autograd_d512_matches_plain_autograd(cuda, shape, dtype):
    """The tensor-core d = 512 kernels under autograd: the gradient through
    the kernels' Function against autograd through the plain forward on the
    same values in fp32 (a bf16 gradient against the unrounded result)."""
    inputs = [_rand(shape, dtype, cuda, s).requires_grad_() for s in range(3)]
    do = _rand(shape, dtype, cuda, 3)
    out = flash_attention(*inputs)
    assert out.grad_fn is not None and out.dtype == dtype
    got = torch.autograd.grad(out, inputs, do)
    ref = [x.detach().float().requires_grad_() for x in inputs]
    want = torch.autograd.grad(flash_attention_plain(*ref), ref, do.float())
    for g, w in zip(got, want):
        assert g.dtype == dtype
        assert _rel_err(g, w) <= _limit(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("shape", GN_TRAIN_SHAPES)
def test_groupnorm_backward_kernel_matches_plain(cuda, shape, silu, dtype):
    *xs, groups = shape
    c = xs[1]
    x = _rand(xs, dtype, cuda, 0) * 3 + 1
    dy = _rand(xs, dtype, cuda, 3)
    w, b = (_rand((c,), torch.float32, cuda, s) for s in (1, 2))
    _, mean, inv = group_norm_fwd(x, w, b, groups, 1e-5, silu)
    assert mean.shape == inv.shape == (xs[0], groups)
    before = group_norm_bwd.launches
    got = group_norm_bwd(x, w, b, mean, inv, dy, groups, silu)
    torch.cuda.synchronize()
    assert group_norm_bwd.launches == before + 1  # one cluster launch
    want = group_norm_bwd_plain(x.float(), w, b, mean, inv, dy.float(), groups,
                                silu)
    for g, ref, lim in zip(got, want, (_limit(dtype), 1e-4, 1e-4)):
        assert _rel_err(g, ref) <= lim  # dscale, dbias are fp32 sums
        assert _rel_err(g.float() * FAULT_SCALE, ref) > lim


def _gn_bwd_inputs(shape, dtype, device, silu):
    """x, dy, weight, bias and the forward kernel's mean and 1/std."""
    *xs, groups = shape
    c = xs[1]
    x = _rand(xs, dtype, device, 0) * 3 + 1
    dy = _rand(xs, dtype, device, 3)
    w, b = (_rand((c,), torch.float32, device, s) for s in (1, 2))
    _, mean, inv = group_norm_fwd(x, w, b, groups, 1e-5, silu)
    return x, dy, w, b, mean, inv


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("shape", GN_BWD_PATH_SHAPES)
def test_groupnorm_backward_at_every_training_shape(cuda, shape, silu, dtype):
    """One launch per call, within the limits of the plain backward, and the
    same bits on a second run (no float atomics: fixed-order sums)."""
    x, dy, w, b, mean, inv = _gn_bwd_inputs(shape, dtype, cuda, silu)
    groups = shape[-1]
    assert group_norm_bwd_plan(tuple(shape[:4]), groups,
                               x.element_size()).resident
    before = group_norm_bwd.launches
    got = group_norm_bwd(x, w, b, mean, inv, dy, groups, silu)
    again = group_norm_bwd(x, w, b, mean, inv, dy, groups, silu)
    torch.cuda.synchronize()
    assert group_norm_bwd.launches == before + 2  # one a call
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    want = group_norm_bwd_plain(x.float(), w, b, mean, inv, dy.float(), groups,
                                silu)
    for g, ref, lim in zip(got, want, (_limit(dtype), 1e-4, 1e-4)):
        assert _rel_err(g, ref) <= lim
        assert _rel_err(g.float() * FAULT_SCALE, ref) > lim


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,smem_limit", [
    ((*GN_STREAM_SHAPE, 32), 232448),   # larger than 8 CTAs: streamed
    ((2, 960, 64, 64, 32), 16384),      # 8 CTAs, forced to stream
    ((2, 1024, 17, 19, 32), 232448),    # element path, resident
    ((2, 1024, 17, 19, 32), 1024),      # element path, streamed
])
def test_groupnorm_backward_plans_match_plain(cuda, shape, smem_limit, dtype):
    """The backward's streaming variant (a span larger than a cluster's
    shared memory, or a plan forced by a low limit) and its element path,
    against the plain backward, with the same bits on a second run."""
    x, dy, w, b, mean, inv = _gn_bwd_inputs(shape, dtype, cuda, True)
    groups = shape[-1]
    plan = group_norm_bwd_plan(tuple(shape[:4]), groups, x.element_size(),
                               True, smem_limit)
    assert plan.resident == (smem_limit > 16384 and shape[1] != 512)
    got = _launch_bwd(x, w, b, mean, inv, dy, groups, True, plan)
    again = _launch_bwd(x, w, b, mean, inv, dy, groups, True, plan)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    want = group_norm_bwd_plain(x.float(), w, b, mean, inv, dy.float(), groups,
                                True)
    for g, ref, lim in zip(got, want, (_limit(dtype), 1e-4, 1e-4)):
        assert _rel_err(g, ref) <= lim
        assert _rel_err(g.float() * FAULT_SCALE, ref) > lim


@pytest.mark.parametrize("lse", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", D16_SHAPES)
def test_flash_d16_forward_at_the_path_shapes(cuda, shape, dtype, lse):
    """The d = 16 forward on wgmma (fp32: flash_fwd_d16_split, then
    flash_fwd_d16, 3xTF32; bf16: flash_fwd_d16_bf16) with and without lse,
    as the d = 64 and 512 kernels below: one launch a call, the same bits
    on a second, the output within 2e-5 (fp32) or two bf16 ulps of
    max|plain| (bf16) of the plain version's unrounded fp32 result (and, in
    bf16, of its bf16 output), the lse within 1e-4 of max; a planted x1.05
    fault reads beyond each limit."""
    _check_hopper_forward(cuda, shape, dtype, lse)


def test_flash_d16_fp32_forward_error_is_flat_in_l(cuda):
    """Each 64-key tile's P V sums from zero on wgmma and joins the output
    by one fma: against float64 on the same fp32 inputs, the output's
    largest error at L = 8192 is at most twice that at L = 1024 and below
    chip_smoke.py's FWD16_F64_TOL (4e-6)."""
    reads = {}
    for seq in (1024, 8192):
        q, k, v = (_rand((1, seq, 4, 16), torch.float32, cuda, s)
                   for s in range(3))
        want = flash_attention_plain(*(x.double() for x in (q, k, v)))
        reads[seq] = (flash_attention(q, k, v).double() - want).abs().max().item()
    assert reads[8192] <= 2 * reads[1024] and reads[8192] < 4e-6, reads


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_d16_launches_from_a_fresh_thread(cuda, dtype):
    """The d = 16 forward encodes its bf16 TMA tensor maps and allocates
    its fp32 scratch per call: a new thread's first launch gives the main
    thread's bits, with and without lse."""
    q, k, v = (_rand((2, 1000, 3, 16), dtype, cuda, s) for s in range(3))
    want = (flash_attention(q, k, v), *flash_attention_lse(q, k, v))
    got, errors = [], []

    def body():
        try:
            got.append((flash_attention(q, k, v),
                        *flash_attention_lse(q, k, v)))
            torch.cuda.synchronize()
        except Exception as exc:  # noqa: BLE001 (reported below)
            errors.append(exc)

    thread = threading.Thread(target=body)
    thread.start()
    thread.join()
    assert not errors, errors
    assert all(torch.equal(a, b) for a, b in zip(got[0], want))


def test_flash_d16_fp32_needs_its_scratch(cuda):
    """The fp32 d = 16 call asks for its scratch (every (b, h, 64-key
    tile)'s 16 KB operand image) and refuses a launch without it; other
    head dims and bf16 take none."""
    from rdeic_torch.ops.flash_attention import _fwd_library

    lib = _fwd_library()
    assert lib.rdeic_flash_attn_fwd_scratch_bytes(1, 6144, 4, 16, 0) == \
        4 * 96 * 16384
    assert lib.rdeic_flash_attn_fwd_scratch_bytes(2, 1000, 3, 16, 0) == \
        6 * 16 * 16384
    for d, dtype in ((16, 1), (64, 0), (512, 0)):
        assert lib.rdeic_flash_attn_fwd_scratch_bytes(1, 1024, 2, d, dtype) == 0
    q, k, v = (_rand((1, 200, 2, 16), torch.float32, cuda, s) for s in range(3))
    o = torch.empty_like(q)
    err = lib.rdeic_flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None, 1, 200,
        2, 16, 0, 0.25, torch.cuda.current_stream().cuda_stream, None)
    assert err != 0


@pytest.mark.parametrize("lse", [False, True])
@pytest.mark.parametrize("shape", BF16_FWD_SHAPES)
def test_flash_bf16_forward_kernels(cuda, shape, lse):
    """flash_fwd_d16_bf16, flash_fwd_d64_bf16 and flash_fwd_d512_bf16 (bf16
    wgmma), with and without lse: one launch a call; the output within two bf16 ulps of
    max|plain| of the plain version's bf16 output and of its unrounded fp32
    result; the lse within 1e-4 of max; a planted x1.05 fault reads beyond
    each limit; a second launch gives the same bits."""
    q, k, v = (_rand(shape, torch.bfloat16, cuda, s) for s in range(3))
    fn = flash_attention_lse if lse else flash_attention
    before = fn.launches
    got = fn(q, k, v)
    again = fn(q, k, v)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    out = got[0] if lse else got
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, again[0] if lse else again)
    want, want_lse = flash_attention_lse_plain(q.float(), k.float(), v.float())
    for ref in (flash_attention_plain(q, k, v).float(), want):
        tol = 2 * bf16_ulp(ref.abs().max().item())
        assert (out.float() - ref).abs().max().item() <= tol
        assert (out.float() * FAULT_SCALE - ref).abs().max().item() > tol
    if lse:
        assert torch.equal(got[1], again[1])
        assert _rel_err(got[1], want_lse) <= 1e-4
        assert _rel_err(got[1] * FAULT_SCALE, want_lse) > 1e-4


# the Hopper d = 64 forward (flash_fwd_d64 on TF32 wgmma, 3xTF32;
# flash_fwd_d64_bf16 on bf16 wgmma; both TMA-fed): every path shape
# (serving, batched serving, tiled serving, training), ragged L (L = 1000
# with B = 2, H = 3; L = 130, two rows past a 128-row q tile) and L = 8192
D64_HOPPER_SHAPES = [(1, 6144, 5, 64), (1, 1536, 10, 64), (2, 6144, 5, 64),
                     (2, 1536, 10, 64), (4, 4096, 5, 64), (4, 1024, 10, 64),
                     (15, 4096, 5, 64), (2, 4096, 5, 64), (2, 1024, 10, 64),
                     (2, 1000, 3, 64), (1, 130, 2, 64), (1, 8192, 2, 64)]


def _check_hopper_forward(device, shape, dtype, lse):
    """One forward kernel on wgmma and TMA, with or without lse: one launch
    a call and the same bits on a second; the output within 2e-5 (fp32) or
    two bf16 ulps of max|plain| (bf16) of the plain version's unrounded fp32
    result (and, in bf16, of its bf16 output), the lse within 1e-4 of max;
    a planted x1.05 fault reads beyond each limit."""
    q, k, v = (_rand(shape, dtype, device, s) for s in range(3))
    fn = flash_attention_lse if lse else flash_attention
    before = fn.launches
    got = fn(q, k, v)
    again = fn(q, k, v)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    out = got[0] if lse else got
    assert out.dtype == dtype
    assert torch.equal(out, again[0] if lse else again)
    want, want_lse = flash_attention_lse_plain(q.float(), k.float(), v.float())
    refs = [want] + ([flash_attention_plain(q, k, v).float()]
                     if dtype == torch.bfloat16 else [])
    for ref in refs:
        tol = 2e-5 if dtype == torch.float32 else 2 * bf16_ulp(
            ref.abs().max().item())
        assert (out.float() - ref).abs().max().item() <= tol
        assert (out.float() * FAULT_SCALE - ref).abs().max().item() > tol
    if lse:
        assert torch.equal(got[1], again[1])
        assert _rel_err(got[1], want_lse) <= 1e-4
        assert _rel_err(got[1] * FAULT_SCALE, want_lse) > 1e-4


@pytest.mark.parametrize("lse", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", D64_HOPPER_SHAPES)
def test_flash_d64_hopper_forward_kernels(cuda, shape, dtype, lse):
    """flash_fwd_d64 and flash_fwd_d64_bf16 (wgmma, TMA), with and without
    lse: one launch a call and the same bits on a second; the output within
    2e-5 (fp32) or two bf16 ulps of max|plain| (bf16) of the plain
    version's unrounded fp32 result (and, in bf16, of its bf16 output), the
    lse within 1e-4 of max; a planted x1.05 fault reads beyond each
    limit."""
    _check_hopper_forward(cuda, shape, dtype, lse)


# the Hopper d = 512 forward (flash_fwd_d512: a cluster of four blocks
# along d on TF32 wgmma, 3xTF32; flash_fwd_d512_bf16 on bf16 wgmma; both
# TMA-fed): every path shape (serving, refine training, validation, batched
# and tiled serving, the 256x256 checks) and L = 20 (under one key tile),
# 130, 1000 and 4097 (B = 2, H = 2) and 8192
D512_HOPPER_SHAPES = [(1, 6144, 1, 512), (2, 4096, 1, 512), (1, 4096, 1, 512),
                      (2, 6144, 1, 512), (4, 6144, 1, 512), (4, 4096, 1, 512),
                      (7, 4096, 1, 512), (8, 4096, 1, 512), (15, 4096, 1, 512),
                      (1, 1024, 1, 512), (1, 20, 1, 512), (1, 130, 1, 512),
                      (2, 1000, 2, 512), (2, 4097, 2, 512), (1, 8192, 1, 512)]


@pytest.mark.parametrize("lse", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", D512_HOPPER_SHAPES)
def test_flash_d512_hopper_forward_kernels(cuda, shape, dtype, lse):
    """flash_fwd_d512 and flash_fwd_d512_bf16 (wgmma, TMA), with and without
    lse, as the d = 64 kernels above: one launch a call, the same bits on a
    second, the output and lse within the limits of the plain version, a
    planted x1.05 fault beyond them."""
    _check_hopper_forward(cuda, shape, dtype, lse)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 6144, 1, 512), (1, 1024, 1, 512),
                                   (2, 1000, 2, 512)])
def test_flash_d512_backward_on_the_hopper_lse(cuda, shape, dtype):
    """The d = 512 dq and dkv kernels from the Hopper forward's o and lse:
    within the limits of the plain backward from the same o and lse, each
    reading a planted x1.05 fault."""
    q, k, v, do = (_rand(shape, dtype, cuda, s) for s in range(4))
    o, lse = flash_attention_lse(q, k, v)
    grads = flash_attention_bwd(q, k, v, o, lse, do)
    plain = flash_attention_bwd_plain(*(x.float() for x in (q, k, v, o)), lse,
                                      do.float())
    for got, want in zip(grads, plain):
        assert got.dtype == dtype
        assert _rel_err(got, want) <= _limit(dtype)
        assert _rel_err(got.float() * FAULT_SCALE, want) > _limit(dtype)


def test_flash_d512_fp32_forward_error_is_flat_in_l(cuda):
    """Each 32-key tile's P V sums from zero on wgmma and joins the output
    by one fma, so wgmma's rounding toward zero does not pile up over L:
    against float64 on the same fp32 inputs, the output's largest error at
    L = 8192 is at most twice that at L = 1024 and below chip_smoke.py's
    FWD512_F64_TOL (4e-6)."""
    reads = {}
    for seq in (1024, 8192):
        q, k, v = (_rand((1, seq, 1, 512), torch.float32, cuda, s)
                   for s in range(3))
        want = flash_attention_plain(*(x.double() for x in (q, k, v)))
        reads[seq] = (flash_attention(q, k, v).double() - want).abs().max().item()
    assert reads[8192] <= 2 * reads[1024] and reads[8192] < 4e-6, reads


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_d512_launches_from_a_fresh_thread(cuda, dtype):
    """The d = 512 forward encodes its TMA tensor maps per call too: a new
    thread's first launch gives the main thread's bits, with and without
    lse."""
    q, k, v = (_rand((1, 1024, 1, 512), dtype, cuda, s) for s in range(3))
    want = (flash_attention(q, k, v), *flash_attention_lse(q, k, v))
    got, errors = [], []

    def body():
        try:
            got.append((flash_attention(q, k, v),
                        *flash_attention_lse(q, k, v)))
            torch.cuda.synchronize()
        except Exception as exc:  # noqa: BLE001 (reported below)
            errors.append(exc)

    thread = threading.Thread(target=body)
    thread.start()
    thread.join()
    assert not errors, errors
    assert all(torch.equal(a, b) for a, b in zip(got[0], want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 6144, 5, 64), (1, 1536, 10, 64),
                                   (4, 1024, 10, 64)])
def test_flash_d64_backward_on_the_hopper_lse(cuda, shape, dtype):
    """The dq and dkv kernels from the Hopper forward's o and lse at the
    serving and tiled shapes (the training shapes are in
    FLASH_TRAIN_SHAPES): within the limits of the plain backward from the
    same o and lse, each reading a planted x1.05 fault."""
    q, k, v, do = (_rand(shape, dtype, cuda, s) for s in range(4))
    o, lse = flash_attention_lse(q, k, v)
    grads = flash_attention_bwd(q, k, v, o, lse, do)
    plain = flash_attention_bwd_plain(*(x.float() for x in (q, k, v, o)), lse,
                                      do.float())
    for got, want in zip(grads, plain):
        assert got.dtype == dtype
        assert _rel_err(got, want) <= _limit(dtype)
        assert _rel_err(got.float() * FAULT_SCALE, want) > _limit(dtype)


def test_wgmma_rounds_as_the_emulation_models(cuda):
    """`rdeic_torch.tools.wgmma_probe` on the card, against the model of
    wgmma that the CPU emulation of the d = 64 forward takes
    (`tests/torch_port_tf32.py`): sums rounded toward zero (a tie too),
    C + A B likewise, each term cut WGMMA_GUARD_BITS bits below the largest
    one's ulp (so 1 - 2^-e ulp reads 1 first at e = WGMMA_GUARD_BITS + 1,
    and k - 1 products of 2^-e ulp beside a 1 add floor((k - 1) 2^-e) ulps
    while e <= WGMMA_GUARD_BITS, none after), an fp32 operand read as TF32
    truncated, and a random product within four fp32 ulps of its float64
    sum (which also holds the fragment layouts)."""
    from rdeic_torch.tools.wgmma_probe import KINDS, SMALL, rounding
    # tests/ is on sys.path: a top-level import, as torch_port_rans below
    from torch_port_tf32 import (  # noqa: PLC0415
        WGMMA_GUARD_BITS,
        WGMMA_ROUNDING,
    )

    r = rounding()
    for kind, (_, k) in KINDS.items():
        got = r[kind]
        assert got["sum"] == [WGMMA_ROUNDING] * 2, got
        assert got["accumulate"] == [WGMMA_ROUNDING] * 2, got
        assert got["tie"] == got["tie_accumulate"] == "rz or rne", got
        assert got["window"] == WGMMA_GUARD_BITS + 1, got
        for e in SMALL:
            kept = (k - 1) * 2.0 ** -e if e <= WGMMA_GUARD_BITS else 0.0
            assert got["small"][e] == math.floor(kept), (e, got)
        # sums of 16 or 8 normal products and C, under 16 in magnitude:
        # four fp32 ulps there
        assert got["random_max_abs_err"] <= 4e-6, got
    assert r["tf32"]["operand_a"] == r["tf32"]["operand_b"] == "truncate"


@pytest.mark.parametrize("shape", D64_BF16_BWD_SHAPES)
def test_flash_d64_bf16_backward_kernels(cuda, shape):
    """flash_dq_d64_bf16 and flash_dkv_d64_bf16 (bf16 wgmma fed by TMA, a
    consumer warpgroup of 64 kept rows and a producer warp a block, two
    blocks an SM, P and dS as two bf16 terms from registers, one
    accumulator): `_check_bf16_backward` at every shape: the limit, the
    planted x1.05 fault, di and the same bits on a second launch."""
    _check_bf16_backward(cuda, shape)


@pytest.mark.parametrize("shape", D64_FP32_BWD_SHAPES)
def test_flash_d64_fp32_backward_kernels(cuda, shape):
    """flash_dq_d64 and flash_dkv_d64 (TF32 wgmma, three passes a product,
    fed by TMA and a splitting producer warpgroup, two consumer warpgroups
    a block, per-tile partials): one launch each a call; dq, dk and dv
    within 1e-4 of max of the plain version from the same o and lse, each
    reading a planted x1.05 fault beyond it; di = rowsum(dO O) within 1e-5
    of max of the plain sum; the same bits (dq, di, dk, dv) on a second
    launch."""
    q, k, v, do = (_rand(shape, torch.float32, cuda, s) for s in range(4))
    o, lse = flash_attention_lse(q, k, v)
    before = (flash_attention_dq.launches, flash_attention_dkv.launches)
    dq, di = flash_attention_dq(q, k, v, o, lse, do)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, di)
    torch.cuda.synchronize()
    assert (flash_attention_dq.launches, flash_attention_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    again = (*flash_attention_dq(q, k, v, o, lse, do),
             *flash_attention_dkv(q, k, v, do, lse, di))
    assert all(torch.equal(a, b) for a, b in zip((dq, di, dk, dv), again))
    plain = flash_attention_bwd_plain(q, k, v, o, lse, do)
    limit = _limit(torch.float32)
    for got, want in zip((dq, dk, dv), plain):
        assert got.dtype == torch.float32
        assert _rel_err(got, want) <= limit
        assert _rel_err(got * FAULT_SCALE, want) > limit
    want_di = (do * o).sum(-1).transpose(1, 2).reshape(di.shape)
    assert _rel_err(di, want_di) <= 1e-5


@pytest.mark.parametrize("shape", D512_FP32_BWD_SHAPES)
def test_flash_d512_fp32_backward_kernels(cuda, shape):
    """flash_dq_d512 and flash_dkv_d512 (clusters of eight blocks along d,
    TF32 wgmma, three passes a product, fed by TMA and splitting warps, the
    partial scores exchanged by st.async, per-tile partials): one launch
    each a call; dq, dk and dv within 1e-4 of max of the plain version
    from the same o and lse, each reading a planted x1.05 fault beyond it;
    di within 1e-5 of max of the plain sum; the same bits (dq, di, dk, dv)
    on a second launch and on a launch from a fresh thread (the tensor
    maps are encoded per call, after binding the device's context)."""
    q, k, v, do = (_rand(shape, torch.float32, cuda, s) for s in range(4))
    o, lse = flash_attention_lse(q, k, v)
    before = (flash_attention_dq.launches, flash_attention_dkv.launches)
    dq, di = flash_attention_dq(q, k, v, o, lse, do)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, di)
    torch.cuda.synchronize()
    assert (flash_attention_dq.launches, flash_attention_dkv.launches) == (
        before[0] + 1, before[1] + 1)

    def run():
        dq2, di2 = flash_attention_dq(q, k, v, o, lse, do)
        return (dq2, di2, *flash_attention_dkv(q, k, v, do, lse, di2))

    again = run()
    assert all(torch.equal(a, b) for a, b in zip((dq, di, dk, dv), again))
    got, errors = [], []

    def body():
        try:
            got.append(run())
            torch.cuda.synchronize()
        except Exception as exc:  # noqa: BLE001 (reported below)
            errors.append(exc)

    thread = threading.Thread(target=body)
    thread.start()
    thread.join()
    assert not errors, errors
    assert all(torch.equal(a, b) for a, b in zip((dq, di, dk, dv), got[0]))
    plain = flash_attention_bwd_plain(q, k, v, o, lse, do)
    limit = _limit(torch.float32)
    for g, want in zip((dq, dk, dv), plain):
        assert g.dtype == torch.float32
        assert _rel_err(g, want) <= limit
        assert _rel_err(g * FAULT_SCALE, want) > limit
    want_di = (do * o).sum(-1).transpose(1, 2).reshape(di.shape)
    assert _rel_err(di, want_di) <= 1e-5


def test_flash_d512_fp32_backward_error_is_flat_in_l(cuda):
    """Each 32-row tile's dq, dk and dv products sum from zero on wgmma and
    join the running sums in fp32: against float64 on the same fp32
    inputs, the largest error of dq, dk and dv over max at L = 8192 is at
    most twice that at L = 1024 and below chip_smoke.py's BWD512_F64_TOL
    (2e-5; the mma.sync design it replaced summed every tile into one
    accumulator)."""
    reads = {}
    for seq in (1024, 8192):
        shape = (1, seq, 1, 512)
        q, k, v, do = (_rand(shape, torch.float32, cuda, s) for s in range(4))
        o, lse = flash_attention_lse(q, k, v)
        got = flash_attention_bwd(q, k, v, o, lse, do)
        want = flash_attention_bwd_plain(
            *(x.double() for x in (q, k, v, o)), lse.double(), do.double())
        reads[seq] = max(_rel_err(g.double(), w) for g, w in zip(got, want))
        del want
    assert reads[8192] <= 2 * reads[1024] and reads[8192] < 2e-5, reads


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_d64_launches_from_a_fresh_thread(cuda, dtype):
    """The d = 64 kernels encode their TMA tensor maps through the driver,
    which needs a context current on the calling thread. A thread whose
    first call into the libraries is a launch, after the main thread's
    (as autograd's worker thread is), must get one first: the forward with
    lse and the backward from a new thread give the main thread's bits."""
    q, k, v, do = (_rand((2, 1024, 5, 64), dtype, cuda, s) for s in range(4))

    def run():
        o, lse = flash_attention_lse(q, k, v)
        return (o, lse, *flash_attention_bwd(q, k, v, o, lse, do))

    want = run()
    got, errors = [], []

    def body():
        try:
            got.append(run())
            torch.cuda.synchronize()
        except Exception as exc:  # noqa: BLE001 (reported below)
            errors.append(exc)

    thread = threading.Thread(target=body)
    thread.start()
    thread.join()
    assert not errors, errors
    assert all(torch.equal(a, b) for a, b in zip(got[0], want))


def test_flash_d64_fp32_backward_error_is_flat_in_l(cuda):
    """Each 32-row tile's dq, dk and dv products sum from zero on wgmma and
    join the running sums in fp32, so wgmma's rounding toward zero does not
    pile up over L: against float64 on the same fp32 inputs, the largest
    error of dq, dk and dv over max at L = 8192 is at most twice that at
    L = 1024 and below 5e-5 (the mma.sync design it replaced read 7.2e-5
    there)."""
    reads = {}
    for seq in (1024, 8192):
        shape = (1, seq, 2, 64)
        q, k, v, do = (_rand(shape, torch.float32, cuda, s) for s in range(4))
        o, lse = flash_attention_lse(q, k, v)
        got = flash_attention_bwd(q, k, v, o, lse, do)
        want = flash_attention_bwd_plain(
            *(x.double() for x in (q, k, v, o)), lse.double(), do.double())
        reads[seq] = max(_rel_err(g.double(), w) for g, w in zip(got, want))
        del want
    assert reads[8192] <= 2 * reads[1024] and reads[8192] < 5e-5, reads


@pytest.mark.parametrize("shape", D16_BF16_BWD_SHAPES)
def test_flash_d16_bf16_backward_kernels(cuda, shape):
    """flash_dq_d16_bf16 and flash_dkv_d16_bf16 (bf16 mma.sync, P and dS
    as two bf16 terms, one accumulator): `_check_bf16_backward`."""
    _check_bf16_backward(cuda, shape)


@pytest.mark.parametrize("shape", D512_BF16_BWD_SHAPES)
def test_flash_d512_bf16_backward_kernels(cuda, shape):
    """flash_dq_d512_bf16 and flash_dkv_d512_bf16 (bf16 mma.sync, P and dS
    as two bf16 terms, one accumulator): `_check_bf16_backward`."""
    _check_bf16_backward(cuda, shape)


def _check_bf16_backward(cuda, shape):
    """The bf16 dq and dkv kernels: one launch each a call; dq, dk and dv
    within 2^-8 + 1e-4 of max of the plain version's unrounded fp32 result
    from the same o and lse, each reading a planted x1.05 fault beyond it;
    di = rowsum(dO O) within 1e-5 of max of the plain sum; the same bits
    (dq, di, dk, dv) on a second launch."""
    q, k, v, do = (_rand(shape, torch.bfloat16, cuda, s) for s in range(4))
    o, lse = flash_attention_lse(q, k, v)
    before = (flash_attention_dq.launches, flash_attention_dkv.launches)
    dq, di = flash_attention_dq(q, k, v, o, lse, do)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, di)
    torch.cuda.synchronize()
    assert (flash_attention_dq.launches, flash_attention_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    again = (*flash_attention_dq(q, k, v, o, lse, do),
             *flash_attention_dkv(q, k, v, do, lse, di))
    assert all(torch.equal(a, b) for a, b in zip((dq, di, dk, dv), again))
    plain = flash_attention_bwd_plain(*(x.float() for x in (q, k, v, o)), lse,
                                      do.float())
    limit = _limit(torch.bfloat16)
    for got, want in zip((dq, dk, dv), plain):
        assert got.dtype == torch.bfloat16
        assert _rel_err(got, want) <= limit
        assert _rel_err(got.float() * FAULT_SCALE, want) > limit
    want_di = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(di.shape)
    assert _rel_err(di, want_di) <= 1e-5


def test_flash_d16_backward_error_is_flat_in_l(cuda):
    """Each 32-row chunk's products sum from zero and join the accumulators
    in fp32, so mma.sync's rounding toward zero does not pile up over L:
    against float64 on the same fp32 inputs, the largest error of dq, dk
    and dv over max at L = 8192 is at most twice that at L = 1024."""
    reads = {}
    for seq in (1024, 8192):
        shape = (1, seq, 2, 16)
        q, k, v, do = (_rand(shape, torch.float32, cuda, s) for s in range(4))
        o, lse = flash_attention_lse(q, k, v)
        got = flash_attention_bwd(q, k, v, o, lse, do)
        want = flash_attention_bwd_plain(
            *(x.double() for x in (q, k, v, o)), lse.double(), do.double())
        reads[seq] = max(_rel_err(g.double(), w) for g, w in zip(got, want))
        del want
    assert reads[8192] <= 2 * reads[1024], reads


@pytest.mark.parametrize("silu", [False, True])
def test_groupnorm_autograd_on_cuda_matches_plain_autograd(cuda, silu):
    x = (_rand((2, 96, 16, 16), torch.float32, cuda, 0) * 3 + 1).requires_grad_()
    w, b = (_rand((96,), torch.float32, cuda, s).requires_grad_() for s in (1, 2))
    dy = _rand((2, 96, 16, 16), torch.float32, cuda, 3)
    out = group_norm(x, w, b, 24, 1e-6, silu)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (x, w, b), dy)
    want = torch.autograd.grad(group_norm_plain(x, w, b, 24, 1e-6, silu),
                               (x, w, b), dy)
    for g, ref in zip(got, want):
        assert _rel_err(g, ref) <= 1e-4


@pytest.mark.parametrize("shape", [(2, 960, 64, 64), (2, 320, 64, 64),
                                   (2, 2560, 8, 8)])
def test_groupnorm_autograd_at_training_shapes(cuda, shape):
    """The CUDA forward (one launch, statistics stored) feeding the CUDA
    backward (one launch) under autograd, at training shapes (the first is the largest
    training span, 30 x 4096), against autograd through the plain version."""
    c = shape[1]
    x = (_rand(shape, torch.float32, cuda, 0) * 3 + 1).requires_grad_()
    w, b = (_rand((c,), torch.float32, cuda, s).requires_grad_() for s in (1, 2))
    dy = _rand(shape, torch.float32, cuda, 3)
    before = (group_norm.launches, group_norm_bwd.launches)
    out = group_norm(x, w, b, 32, 1e-5, True)
    got = torch.autograd.grad(out, (x, w, b), dy)
    torch.cuda.synchronize()
    assert (group_norm.launches, group_norm_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    want = torch.autograd.grad(group_norm_plain(x, w, b, 32, 1e-5, True),
                               (x, w, b), dy)
    for g, ref in zip(got, want):
        assert _rel_err(g, ref) <= 1e-4


def test_modules_on_cuda_keep_the_graph(cuda):
    """A GroupNorm32 and a long self-attention on the card give outputs
    with a grad_fn, and the gradient reaches the module's weights."""
    torch.manual_seed(0)
    norm = GroupNorm32(64, silu=True).to(cuda)
    attn = CrossAttention(64, 64, heads=4, dim_head=16).to(cuda)
    x = torch.randn(1, 64, 32, 32, device=cuda, requires_grad=True)
    h = norm(x)
    assert h.grad_fn is not None
    before = flash_attention_lse.launches
    y = attn(h.flatten(2).transpose(1, 2))  # L = 1024 reaches the kernel
    assert y.grad_fn is not None
    assert flash_attention_lse.launches == before + 1
    y.square().sum().backward()
    for p in (x, norm.GroupNorm_0.weight, attn.to_q.weight):
        assert p.grad is not None and p.grad.abs().sum() > 0


def test_backward_kernels_run_at_d512(cuda):
    """The VAE decoder's head dim, which the refine phase differentiates:
    dq and dkv launch and match the plain backward."""
    shape = (1, 64, 1, 512)
    q, k, v, do = (_rand(shape, torch.float32, cuda, s) for s in range(4))
    o, lse = flash_attention_lse(q, k, v)
    before = (flash_attention_dq.launches, flash_attention_dkv.launches)
    dq, di = flash_attention_dq(q, k, v, o, lse, do)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, di)
    torch.cuda.synchronize()
    assert (flash_attention_dq.launches, flash_attention_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    for got, want in zip((dq, dk, dv),
                         flash_attention_bwd_plain(q, k, v, o, lse, do)):
        assert _rel_err(got, want) <= 1e-4


def test_kernels_raise_on_what_they_do_not_take(cuda):
    q = torch.zeros((1, 64, 2, 32), device=cuda)
    with pytest.raises(ValueError):
        flash_attention(q, q, q)  # head dim 32 is not built
    q64 = torch.zeros((1, 64, 2, 64), device=cuda)
    with pytest.raises(ValueError):
        flash_attention(q64.half(), q64.half(), q64.half())  # fp16
    with pytest.raises(ValueError):
        flash_attention(q64, q64, q64.transpose(1, 2).contiguous().transpose(1, 2))
    x = torch.zeros((1, 30, 4, 4), device=cuda)
    with pytest.raises(ValueError):
        group_norm(x, torch.ones(30, device=cuda), torch.zeros(30, device=cuda),
                   32, 1e-5)
    x = torch.zeros((1, 64, 4, 4), device=cuda)
    w, b = torch.ones(64, device=cuda), torch.zeros(64, device=cuda)
    before = group_norm.launches
    for bad in (x.half(), x.transpose(2, 3), x[:, :, :, :3]):  # fp16, strided
        with pytest.raises(ValueError):
            group_norm(bad, w, b, 32, 1e-5)
    with pytest.raises(ValueError):  # weight and bias of two dtypes
        group_norm(x, w.bfloat16(), b, 32, 1e-5)
    with pytest.raises(ValueError):
        group_norm(x, w.half(), b.half(), 32, 1e-5)
    assert group_norm.launches == before
    _, mean, inv = group_norm_fwd(x, w, b, 32, 1e-5)
    before = group_norm_bwd.launches
    for bad in (mean.double(), mean[:, :16], mean.cpu()):  # not (B, G) fp32
        with pytest.raises(ValueError):
            group_norm_bwd(x, w, b, bad, inv, x, 32)
    assert group_norm_bwd.launches == before


# -- the serving options on the card: DDIM, classifier-free guidance, bf16 ----

# A micro RDEIC whose attention head dims are ones the flash kernels take:
# at 128x128 the VAE's mid-block (L = 4096, d = 16) and every UNet and
# control SpatialTransformer (L = 1024 at the 32x32 level, d = 16) reach the
# flash kernel, and every GroupNorm32 the GroupNorm kernel
CARD_MICRO = dict(
    control_stage_config=dict(params=dict(
        in_channels=4, out_channels=4, hint_channels=8, model_channels=32,
        num_res_blocks=1, attention_resolutions=[2], channel_mult=[1, 2],
        num_head_channels=16, context_dim=16, control_model_ratio=0.5,
        control_scale=1.0)),
    unet_config=dict(params=dict(num_head_channels=16)),
    first_stage_config=dict(params=dict(
        embed_dim=4, ddconfig=dict(ch=8, ch_mult=[1, 2], num_res_blocks=1))),
    preprocess_config=dict(params=dict(
        in_nc=16, out_nc=4, N=8, M=8, slice_num=2, slice_ch=[4, 4],
        codebook_size=32)),
    fixed_step=2, used_timesteps=300, timesteps=1000,
)
CARD_LATENT = (1, 64, 64, 4)  # of a 128x128 image
SERVE_STEPS = 2
# bf16, card vs CPU: the RMS of the difference over the RMS of the CPU's
# result. The two bf16 runs round other ways (their products sum in other
# orders) and land about as far apart as each from the fp32 result, ~2e-2
# of max at the worst element at full width (chip_smoke.py's BF16_REF_TOL)
BF16_PAIR_TOL = 2.0 ** -6


def _serving_models(cuda, bf16: bool = False):
    """(CPU model, card copy) of CARD_MICRO from seed 0, in bf16 when
    asked."""
    from rdeic_torch.pipeline.rdeic import RDEIC  # noqa: PLC0415

    torch.manual_seed(0)
    cpu = RDEIC(**CARD_MICRO, device="cpu").eval()
    if bf16:
        cpu.set_compute_dtype(torch.bfloat16)
    card = RDEIC(**CARD_MICRO, device="meta").eval()
    card.load_state_dict({k: v.to(cuda) for k, v in cpu.state_dict().items()},
                         assign=True)
    if bf16:  # the compute dtype is the modules', not the weights'
        card.set_compute_dtype(torch.bfloat16)
    return cpu, card


def _serving_inputs(device):
    rng = np.random.default_rng(1)
    shapes = [CARD_LATENT, (*CARD_LATENT[:3], 8)] + [CARD_LATENT] * (1 + SERVE_STEPS)
    c_latent, hint, relay, *steps = (
        torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device)
        for s in shapes)
    return c_latent, hint, dict(relay_noise=relay, step_noise=steps)


def _decode(model, device, **kw):
    c_latent, hint, noise = _serving_inputs(device)
    return model.decode_pipeline(c_latent, hint, SERVE_STEPS, **noise, **kw)


@pytest.mark.parametrize("sampler,guidance", [("ddim", 1.0), ("ddpm", 2.0),
                                              ("ddim", 2.0)])
def test_sampler_options_on_cuda_match_cpu(cuda, sampler, guidance):
    cpu, card = _serving_models(cuda)
    before = (flash_attention.launches, group_norm.launches)
    got = _decode(card, cuda, sampler=sampler, guidance_scale=guidance).cpu()
    assert flash_attention.launches > before[0]
    assert group_norm.launches > before[1]
    want = _decode(cpu, torch.device("cpu"), sampler=sampler,
                   guidance_scale=guidance)
    assert got.shape == (1, 128, 128, 3) and torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    assert err <= 2e-3 < (got * FAULT_SCALE - want).abs().max().item(), err


def test_bf16_decode_on_cuda_matches_cpu(cuda):
    cpu, card = _serving_models(cuda, bf16=True)
    flash_attention.shapes.clear()
    group_norm.shapes.clear()
    got = _decode(card, cuda, sampler="ddim", guidance_scale=2.0).cpu()
    for fn in (flash_attention, group_norm):
        assert fn.shapes and {k[-1] for k in fn.shapes} == {"bfloat16"}
    want = _decode(cpu, torch.device("cpu"), sampler="ddim",
                   guidance_scale=2.0)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()

    def rel_rms(a, b):
        return ((a - b).square().mean() / b.square().mean()).sqrt().item()

    err, fault = rel_rms(got, want), rel_rms(got * FAULT_SCALE, want)
    assert err <= BF16_PAIR_TOL < fault, (err, fault)


def test_bf16_stream_round_trip_is_bit_exact(cuda, tmp_path):
    """A bf16 model's stream decodes to its encoder's own synthesis bit for
    bit, and to the same latents under the fp32 model: the compression model
    and the codec stay fp32."""
    _, card16 = _serving_models(cuda, bf16=True)
    _, card32 = _serving_models(cuda)
    img = torch.from_numpy(np.random.default_rng(2).uniform(
        size=(1, 128, 128, 3)).astype(np.float32)).to(cuda)
    stream = tmp_path / "bf16.rdeic"
    card16.apply_condition_compress(img, stream, 128, 128)
    c_latent, hint = card16.apply_condition_decompress(stream)
    with torch.no_grad():
        _, feature = card16.encode_first_stage(img * 2 - 1)
        enc = card16.codec().compress(feature)["latents"]
    assert feature.dtype == torch.float32
    assert torch.equal(c_latent, enc[0]) and torch.equal(hint, enc[1])
    for a, b in zip((c_latent, hint), card32.apply_condition_decompress(stream)):
        assert torch.equal(a, b)


def test_guidance_launch_counts_follow_the_structure(cuda):
    """Each guided step runs the base UNet alone once more: one more flash
    launch per base SpatialTransformer (all at L = 1024 here) and one more
    GroupNorm launch per base GroupNorm32; the VAE decoder adds one flash
    launch."""
    from rdeic_torch.models.unet import SpatialTransformer  # noqa: PLC0415

    _, card = _serving_models(cuda)
    den = card.denoiser
    counts = {}
    for guidance in (1.0, 2.0):
        before = (flash_attention.launches, group_norm.launches)
        _decode(card, cuda, guidance_scale=guidance)
        counts[guidance] = (flash_attention.launches - before[0],
                            group_norm.launches - before[1])

    def count(kind, module):
        return sum(isinstance(m, kind) for m in module.modules())

    assert counts[1.0] == (SERVE_STEPS * count(SpatialTransformer, den) + 1,
                           SERVE_STEPS * count(GroupNorm32, den))
    assert counts[2.0] == (
        counts[1.0][0] + SERVE_STEPS * count(SpatialTransformer, den.base),
        counts[1.0][1] + SERVE_STEPS * count(GroupNorm32, den.base))


# -- bf16 training on the card ---------------------------------------------------
def _bf16_training_model(device, is_refine: bool, head_channels: int = 16):
    """CARD_MICRO as the bf16 recipes build it: on meta, computing in bf16,
    the frozen tensors cast to bf16, then fast_init on `device` (seed 0);
    the refine phase with use_checkpoint and remat_policy "dots"; the base
    UNet's attention heads `head_channels` wide (the control module's, 32
    channels at the attention level, stay 16 wide)."""
    import copy  # noqa: PLC0415

    from rdeic_torch.pipeline.rdeic import RDEIC  # noqa: PLC0415
    from rdeic_torch.train.trainer import cast_frozen  # noqa: PLC0415
    from rdeic_torch.utils.fast_init import fast_random_init  # noqa: PLC0415

    cfg = copy.deepcopy(CARD_MICRO)
    cfg["unet_config"]["params"]["num_head_channels"] = head_channels
    if is_refine:
        cfg["control_stage_config"]["params"].update(use_checkpoint=True,
                                                      remat_policy="dots")
    model = RDEIC(**cfg, is_refine=is_refine, device="meta")
    model.set_compute_dtype(torch.bfloat16, cast_weights=False)
    cast_frozen(model, torch.bfloat16)
    return fast_random_init(model, device, seed=0)


def _train_launches(model) -> dict:
    """Launches of one micro-step from the structure (chip_smoke.py's
    train_launches_per_step at this config): one flash call per
    SpatialTransformer (all at L = 1024) per denoiser call, again in a
    recompute, the VAE encoder's mid-block (no grad) and, in the refine
    phase, the decoder's (under grad); one GroupNorm launch per GroupNorm32
    call, forward and backward."""
    from rdeic_torch.models.unet import SpatialTransformer  # noqa: PLC0415

    den = model.denoiser
    n_st = sum(isinstance(m, SpatialTransformer) for m in den.modules())
    n_gn = sum(isinstance(m, GroupNorm32) for m in den.modules())
    blocks = [*den.base.input_blocks, den.base.mid, *den.base.output_blocks,
              *den.control.input_blocks, den.control.mid]
    n_gn_blocks = sum(isinstance(m, GroupNorm32) for b in blocks
                      for m in b.modules())
    ckpt = int(den.use_checkpoint)
    calls, decoder = (model.fixed_step, 1) if model.is_refine else (1, 0)
    return {"flash_attention": 1,
            "flash_attention_lse": calls * n_st * (1 + ckpt) + decoder,
            "flash_attention_dq": calls * n_st + decoder,
            "flash_attention_dkv": calls * n_st + decoder,
            "group_norm": calls * (n_gn + ckpt * n_gn_blocks),
            "group_norm_bwd": calls * n_gn}


@pytest.mark.parametrize("is_refine", [False, True])
def test_bf16_training_step_on_cuda(cuda, is_refine):
    """One bf16 `Trainer` micro-step (frozen_dtype bf16) of CARD_MICRO at
    128x128 on the card: every kernel launches as often as the structure
    says, every flash call in bf16; the frozen tensors stay bf16 and
    bit-equal, the trainable ones fp32; the loss within 2^-6 of the same
    step on the CPU (bf16 rounding differs between the two); and the bf16
    dq and dkv kernels give the same bits on a second launch at each shape
    the step ran."""
    _bf16_training_step(cuda, is_refine)


@pytest.mark.parametrize("is_refine", [False, True])
def test_bf16_training_step_at_d64_on_cuda(cuda, is_refine):
    """The same step with 64-channel heads in the base UNet: its
    SpatialTransformers run at d = 64 (L = 1024), the control module's and
    the VAE decoder's mid-block (refine) at d = 16. The dq and dkv tallies
    hold the step's
    d = 64 bf16 calls, which the library sends to flash_dq_d64_bf16 and
    flash_dkv_d64_bf16, one each a SpatialTransformer call; at each such
    shape those kernels land within 2^-8 + 1e-4 of max of the plain
    version's unrounded fp32 result, beyond which a x1.05 fault reads."""
    tallies = _bf16_training_step(cuda, is_refine, head_channels=64)
    d64 = {name: {k: n for k, n in tallies[name].items()
                  if k[3] == 64 and k[-1] == "bfloat16"}
           for name in ("flash_attention_dq", "flash_attention_dkv")}
    assert d64["flash_attention_dq"] and (d64["flash_attention_dq"]
                                          == d64["flash_attention_dkv"])
    limit = _limit(torch.bfloat16)
    for shape in d64["flash_attention_dq"]:
        q, k, v, do = (_rand(shape[:4], torch.bfloat16, cuda, s) for s in range(4))
        o, lse = flash_attention_lse(q, k, v)
        plain = flash_attention_bwd_plain(*(x.float() for x in (q, k, v, o)),
                                          lse, do.float())
        for got, want in zip(flash_attention_bwd(q, k, v, o, lse, do), plain):
            assert _rel_err(got, want) <= limit
            assert _rel_err(got.float() * FAULT_SCALE, want) > limit


def _bf16_training_step(cuda, is_refine: bool, head_channels: int = 16) -> dict:
    """The checks of `test_bf16_training_step_on_cuda` at `head_channels`;
    returns the step's tallies by kernel wrapper name."""
    from rdeic_torch.train.trainer import Trainer  # noqa: PLC0415

    fns = {f.__name__: f for f in (flash_attention, flash_attention_lse,
                                   flash_attention_dq, flash_attention_dkv,
                                   group_norm, group_norm_bwd)}
    model = _bf16_training_model(cuda, is_refine, head_channels)
    cpu = _bf16_training_model(torch.device("cpu"), is_refine, head_channels)
    img = torch.from_numpy(np.random.default_rng(3).uniform(
        -1, 1, (1, 128, 128, 3)).astype(np.float32))
    noise = cpu.train_noise(img, torch.Generator().manual_seed(0))
    on_card = {k: [u.to(cuda) for u in v] if isinstance(v, list) else v.to(cuda)
               for k, v in noise.items()}
    before = {k: v.clone() for k, v in model.state_dict().items()}
    trainer = Trainer(model, frozen_dtype=torch.bfloat16)
    for f in fns.values():
        f.launches, f.shapes = 0, {}
    logs = trainer.step(img.to(cuda), noise=on_card)
    torch.cuda.synchronize()
    assert {k: f.launches for k, f in fns.items()} == _train_launches(model)
    for name in ("flash_attention", "flash_attention_lse", "flash_attention_dq",
                 "flash_attention_dkv"):
        assert {k[-1] for k in fns[name].shapes} == {"bfloat16"}, name
    now = model.state_dict()
    for k, v in now.items():
        if k in trainer.params or k == "vq_embed_prob":
            assert v.dtype == torch.float32, k
        else:
            assert v.dtype == torch.bfloat16 and torch.equal(v, before[k]), k
    tallies = {name: dict(f.shapes) for name, f in fns.items()}
    want = Trainer(cpu, frozen_dtype=torch.bfloat16).step(img, noise=noise)
    got, ref = logs["loss"].item(), want["loss"].item()
    assert np.isfinite(got) and abs(got - ref) <= 2.0 ** -6 * abs(ref)
    for shape in fns["flash_attention_dq"].shapes:
        q, k, v, do = (_rand(shape[:4], torch.bfloat16, cuda, s) for s in range(4))
        o, lse = flash_attention_lse(q, k, v)
        dq, di = flash_attention_dq(q, k, v, o, lse, do)
        dk, dv = flash_attention_dkv(q, k, v, do, lse, di)
        again = (*flash_attention_dq(q, k, v, o, lse, do),
                 *flash_attention_dkv(q, k, v, do, lse, di))
        assert all(torch.equal(a, b) for a, b in zip((dq, di, dk, dv), again))
    return tallies


# -- validation and the image logger on the card -------------------------------
VAL_HW = 192  # MS-SSIM is defined from 176 px a side
# card vs CPU, |card - cpu| / |cpu| of a pass's averages: the samples agree
# within 2e-3 at the worst pixel (test_sampler_options_on_cuda_match_cpu),
# far less on average; usage counts the same codebook indices
VAL_PAIR_TOL = {"avg_bpp": 1e-3, "avg_psnr": 1e-3, "avg_ms_ssim": 1e-3,
                "avg_lpips": 2e-3, "usage": 0.0}


def _val_inputs(hw: int, steps: int, seed: int):
    """One [-1, 1] image and the sampler's noise for CARD_MICRO, on the CPU."""
    rng = np.random.default_rng(seed)
    img = torch.from_numpy(rng.uniform(-1, 1, (1, hw, hw, 3)).astype(np.float32))
    latent = (1, hw // 2, hw // 2, 4)
    noise = [torch.from_numpy(rng.normal(size=latent).astype(np.float32))
             for _ in range(1 + steps)]
    return img, {"relay_noise": noise[0], "step_noise": noise[1:]}


def _on(noise: dict, device) -> dict:
    return {"relay_noise": noise["relay_noise"].to(device),
            "step_noise": [x.to(device) for x in noise["step_noise"]]}


def test_run_validation_on_cuda_matches_cpu(cuda):
    """run_validation of CARD_MICRO on one 192x192 image, card against CPU,
    with the same noise and LPIPS weights (random, seed 0): every average
    within VAL_PAIR_TOL, which a x1.05 fault reads outside of; flash and
    GroupNorm launched on the card."""
    from rdeic_torch.models.lpips import LPIPS  # noqa: PLC0415
    from rdeic_torch.train.validation import run_validation  # noqa: PLC0415
    from rdeic_torch.utils.fast_init import fast_random_init  # noqa: PLC0415
    from rdeic_torch.utils.metrics import MetricSuite  # noqa: PLC0415

    cpu, card = _serving_models(cuda)
    img, noise = _val_inputs(VAL_HW, 2, seed=3)
    with torch.device("meta"):
        lpips = LPIPS("alex")
    weights = fast_random_init(lpips, "cpu", seed=0).state_dict()
    before = (flash_attention.launches, group_norm.launches)
    got = run_validation(card, [{"jpg": img.to(cuda)}], sample_steps=2,
                         noise=[_on(noise, cuda)],
                         suite=MetricSuite({k: v.to(cuda)
                                            for k, v in weights.items()}))
    assert flash_attention.launches > before[0]
    assert group_norm.launches > before[1]
    want = run_validation(cpu, [{"jpg": img}], sample_steps=2, noise=[noise],
                          suite=MetricSuite(weights))
    assert set(got) == set(want) == set(VAL_PAIR_TOL)
    for key, tol in VAL_PAIR_TOL.items():
        err = abs(got[key] - want[key]) / abs(want[key])
        fault = abs(got[key] * FAULT_SCALE - want[key]) / abs(want[key])
        assert err <= tol < fault, (key, got[key], want[key])


def test_log_images_on_cuda_matches_cpu(cuda):
    """log_images' panels and bpp of CARD_MICRO at 128x128, card against
    CPU, the same noise: target equal, vae_rec and samples within 2e-3,
    bpp within 1e-3 of itself."""
    from rdeic_torch.train.callbacks import log_images  # noqa: PLC0415

    cpu, card = _serving_models(cuda)
    img, noise = _val_inputs(128, 5, seed=4)
    got, got_bpp = log_images(card, img.to(cuda), **_on(noise, cuda))
    want, want_bpp = log_images(cpu, img, **noise)
    assert torch.equal(got["target"].cpu(), want["target"])
    for key in ("vae_rec", "samples"):
        err = (got[key].cpu() - want[key]).abs().max().item()
        assert err <= 2e-3 < (got[key].cpu() * FAULT_SCALE - want[key]
                              ).abs().max().item(), key
    assert abs(got_bpp - want_bpp) <= 1e-3 * want_bpp


def test_png_encoder_bytes():
    """encode_png's file read with zlib and struct alone (the card's machine
    has no PIL): the signature, an 8-bit RGB header, every chunk's CRC,
    filter 0 on every row, and the pixels."""
    import struct  # noqa: PLC0415
    import zlib  # noqa: PLC0415

    from rdeic_torch.utils.image import encode_png  # noqa: PLC0415

    img = np.random.default_rng(5).integers(0, 256, (7, 13, 3), dtype=np.uint8)
    data = encode_png(img)
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, []
    while pos < len(data):
        (size,) = struct.unpack(">I", data[pos: pos + 4])
        tag, body = data[pos + 4: pos + 8], data[pos + 8: pos + 8 + size]
        assert struct.unpack(">I", data[pos + 8 + size: pos + 12 + size])[0] \
            == zlib.crc32(tag + body)
        chunks.append((tag, body))
        pos += 12 + size
    assert [tag for tag, _ in chunks] == [b"IHDR", b"IDAT", b"IEND"]
    assert struct.unpack(">IIBBBBB", chunks[0][1]) == (13, 7, 8, 2, 0, 0, 0)
    rows = np.frombuffer(zlib.decompress(chunks[1][1]), np.uint8).reshape(7, -1)
    assert not rows[:, 0].any()
    np.testing.assert_array_equal(rows[:, 1:].reshape(7, 13, 3), img)


# -- the interleaved-lane rANS kernels (csrc/device_rans.cu) -----------------
# Each kernel against its plain version on the same inputs: integers, so
# equal, not close; beside a planted fault (one flipped word of the stream,
# or one flipped symbol for the encoder) that must change the output.
# Passes of one image (a ragged last step at every K), B images a call.
RANS_SIZES = [257, 64, 1000, 31]


@pytest.fixture(scope="module")
def rans_tabs():
    from rdeic_torch.entropy.coder import CdfTable  # noqa: PLC0415
    from rdeic_torch.ops import gaussian as g  # noqa: PLC0415

    table = CdfTable(*g.build_cdf_tables(g.get_scale_table()))
    from rdeic_torch.entropy import device_rans as dr  # noqa: PLC0415

    return table, dr.DeviceRansTables(table), (
        dr.DeviceRansTables(table, "cuda") if torch.cuda.is_available()
        else None)


def _rans_cases(table, b, esc, seed):
    # tests/ is on sys.path (pytest's rootdir-less import): the card's
    # machine may hold another package named `tests`
    from torch_port_rans import random_case  # noqa: PLC0415

    rng = np.random.default_rng(seed)
    return [random_case(table, rng, RANS_SIZES, esc) for _ in range(b)]


def _decode_both(rans_tabs, cuda, k, cases, shared, words=None):
    from torch_port_rans import decode_passes, lane_batch  # noqa: PLC0415

    table, cpu_tabs, gpu_tabs = rans_tabs
    w, nw = lane_batch(table, k, cases, shared)
    if words is not None:
        w = words(w, nw)
    idxs = [np.stack([c[1][p] for c in cases]) for p in range(len(RANS_SIZES))]
    want = decode_passes(cpu_tabs, w, nw, k, idxs, shared)
    got = decode_passes(gpu_tabs, w.to(cuda), nw.to(cuda), k, idxs, shared)
    torch.cuda.synchronize()
    return got, want


def _flip(w, nw):
    """One word flipped in the middle of image 0's stream (v2), or of its
    lane 0 (v1)."""
    w = w.clone()
    if w.dim() == 2:
        w[0, nw[0] // 2] ^= 0x5A5A
    else:
        w[0, 0, nw[0, 0] // 2] ^= 0x5A5A
    return w


@pytest.mark.parametrize("shared", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize("k,esc,b", [(4, 0.0, 1), (7, 0.05, 2), (32, 0.0, 1),
                                     (33, 0.1, 3), (128, 0.05, 2),
                                     (128, 0.0, 1)])
def test_rans_decode_kernels_match_plain(cuda, rans_tabs, k, esc, b, shared):
    from rdeic_torch.entropy import device_rans as dr  # noqa: PLC0415

    fn = dr.decode_pass_shared if shared else dr.decode_pass
    cases = _rans_cases(rans_tabs[0], b, esc, seed=k * 10 + b)
    before = fn.launches
    got, want = _decode_both(rans_tabs, cuda, k, cases, shared)
    assert fn.launches == before + len(RANS_SIZES)
    for p, ((gs, gst, gpt), (ws, wst, wpt)) in enumerate(zip(got, want)):
        assert torch.equal(gs, ws) and torch.equal(gst, wst)
        assert torch.equal(gpt, wpt)
        for i, (syms, _) in enumerate(cases):  # what was encoded
            np.testing.assert_array_equal(gs[i].numpy(), syms[p])
    # a flipped word: the kernel follows the plain version off the stream
    bad, bad_want = _decode_both(rans_tabs, cuda, k, cases, shared, _flip)
    assert all(torch.equal(g_[0], w_[0]) for g_, w_ in zip(bad, bad_want))
    assert not all(torch.equal(g_[0], w_[0]) for g_, w_ in zip(bad, got))


@pytest.mark.parametrize("shared", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize("k", [8, 128])
def test_rans_decode_kernels_on_garbage(cuda, rans_tabs, k, shared):
    """Random words: the kernel gives the plain version's symbols, clamping
    every gather, and never faults."""
    cases = _rans_cases(rans_tabs[0], 2, 0.1, seed=k)
    rng = np.random.default_rng(k + 1)

    def garbage(w, nw):
        return torch.from_numpy(rng.integers(0, 1 << 16, tuple(w.shape),
                                             dtype=np.int32))

    got, want = _decode_both(rans_tabs, cuda, k, cases, shared, garbage)
    for g_, w_ in zip(got, want):
        assert all(torch.equal(a, b) for a, b in zip(g_, w_))


@pytest.mark.parametrize("k,esc,b", [(4, 0.0, 1), (7, 0.08, 3), (33, 0.05, 2),
                                     (128, 0.05, 4)])
def test_rans_encode_kernel_matches_plain_and_host(cuda, rans_tabs, k, esc, b):
    from rdeic_torch.entropy import device_rans as dr  # noqa: PLC0415
    from rdeic_torch.entropy.coder import rans_encode_interleaved  # noqa: PLC0415

    table, cpu_tabs, gpu_tabs = rans_tabs
    cases = _rans_cases(table, b, esc, seed=100 + k)
    syms = [torch.from_numpy(np.stack([c[0][p] for c in cases]))
            for p in range(len(RANS_SIZES))]
    idxs = [torch.from_numpy(np.stack([c[1][p] for c in cases]))
            for p in range(len(RANS_SIZES))]
    steps = dr.build_pass_steps(syms, idxs, k)
    wcap = max(64, 4 * steps[0].shape[0])
    before = dr.encode_lanes.launches
    got = dr.encode_lanes(gpu_tabs, *(s.to(cuda) for s in steps), wcap)
    torch.cuda.synchronize()
    assert dr.encode_lanes.launches == before + 1
    want = dr.encode_lanes_plain(cpu_tabs, *steps, wcap)
    assert all(torch.equal(a.cpu(), w) for a, w in zip(got, want))
    assert not bool(got[2])
    for i, (s, ix) in enumerate(cases):
        payload = dr.assemble_lane_payloads(got[0][i].cpu().numpy(),
                                            got[1][i].cpu().numpy())
        host = rans_encode_interleaved(np.concatenate(s), np.concatenate(ix),
                                       RANS_SIZES, k, table)
        assert payload[0] == host[0]
        np.testing.assert_array_equal(payload[1], host[1])
    # a flipped symbol changes the words
    bad = steps[0].clone()
    bad[0, 0, 0] += 1
    faulty = dr.encode_lanes(gpu_tabs, bad.to(cuda), steps[1].to(cuda),
                             steps[2].to(cuda), wcap)
    assert not torch.equal(faulty[0].cpu(), want[0])


def test_rans_encode_kernel_overflow_flag(cuda, rans_tabs):
    """Too few words a lane, and an escape payload past 2^18: the flag,
    and the words the plain version writes up to the capacity."""
    from rdeic_torch.entropy import device_rans as dr  # noqa: PLC0415

    table, cpu_tabs, gpu_tabs = rans_tabs
    cases = _rans_cases(table, 2, 0.0, seed=5)
    for syms, wcap in (
            ([torch.from_numpy(np.stack([c[0][0] for c in cases]))], 4),
            ([torch.tensor([[10_000_000], [3]], dtype=torch.int32)], 64)):
        idxs = [torch.zeros_like(syms[0]) if wcap == 64 else torch.from_numpy(
            np.stack([c[1][0] for c in cases]))]
        steps = dr.build_pass_steps(syms, idxs, 2)
        got = dr.encode_lanes(gpu_tabs, *(s.to(cuda) for s in steps), wcap)
        want = dr.encode_lanes_plain(cpu_tabs, *steps, wcap)
        assert bool(got[2]) and bool(want[2])
        assert all(torch.equal(a.cpu(), w) for a, w in zip(got, want))


# the tiled path's shapes (512x512 tiles, 64x64 latents): the sampler's
# flash calls at tile batches of 4, 3 (a ragged tail) and 15 (all tiles),
# the VAE encoder's mid-block at 8 tiles; GroupNorm32 at the denoiser's
# widths of each latent level at 4 and 15 tiles
TILE_FLASH_SHAPES = [(4, 4096, 5, 64), (3, 1024, 10, 64), (15, 4096, 4, 16),
                     (4, 1024, 8, 16), (8, 4096, 1, 512), (3, 4096, 1, 512)]
TILE_GN_SHAPES = [(4, 320, 64, 64), (15, 640, 32, 32), (3, 1280, 16, 16),
                  (4, 2560, 8, 8)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", TILE_FLASH_SHAPES)
def test_flash_kernel_at_the_tile_shapes(cuda, shape, dtype):
    test_flash_kernel_matches_plain(cuda, shape, dtype)


@pytest.mark.parametrize("shape", TILE_GN_SHAPES)
def test_groupnorm_kernel_at_the_tile_shapes(cuda, shape):
    test_groupnorm_kernel_matches_plain(cuda, shape, 1e-5, True)


# -- multi-device ------------------------------------------------------------------
def _world_of_one(tmp_path, backend: str):
    """A process group of this process alone (a FileStore: no port)."""
    import torch.distributed as dist  # noqa: PLC0415

    dist.init_process_group(backend, init_method=f"file://{tmp_path / 'store'}",
                            world_size=1, rank=0)


def test_nccl_world_of_one_step_is_the_plain_step(cuda, tmp_path):
    """Two fp32 micro-steps (accumulation 2, so AdamW steps once) of
    CARD_MICRO at 128x128, B = 2: the data-parallel `Trainer` over a world
    of one NCCL rank (its all-reduce and its gather of the hyper latent
    run, over one rank) gives the plain `Trainer`'s logs, weights and
    codebook bit for bit, both under cuDNN's deterministic algorithms."""
    import torch.distributed as dist  # noqa: PLC0415

    from rdeic_torch.parallel.mesh import make_mesh  # noqa: PLC0415
    from rdeic_torch.train.trainer import Trainer  # noqa: PLC0415
    from rdeic_torch.utils.backend import full_fp32  # noqa: PLC0415

    _, card = _serving_models(cuda)
    start = {k: v.clone() for k, v in card.state_dict().items()}
    imgs = [torch.from_numpy(np.random.default_rng(s).uniform(
        -1, 1, (2, 128, 128, 3)).astype(np.float32)).to(cuda) for s in (5, 6)]

    def run(mesh) -> tuple:
        card.load_state_dict(start)
        trainer = Trainer(card, accumulate_grad_batches=2, mesh=mesh)
        gen = torch.Generator(device=cuda).manual_seed(0)
        with full_fp32(deterministic=True):
            logs = [trainer.step(img, generator=gen) for img in imgs]
        return logs, {k: v.clone() for k, v in card.state_dict().items()}

    plain_logs, plain = run(None)
    _world_of_one(tmp_path, "nccl")
    try:
        mesh = make_mesh()
        assert mesh.distributed and mesh.shape == {"dp": 1, "tp": 1}
        logs, state = run(mesh)
    finally:
        dist.destroy_process_group()
    for got, want in zip(logs, plain_logs):
        assert got.keys() == want.keys()
        for key in want:
            assert torch.equal(got[key], want[key]), key
    for key, v in plain.items():
        assert torch.equal(state[key], v), key
    assert not torch.equal(plain["compression.quantize.embedding"],
                           start["compression.quantize.embedding"])


def test_lane_wrappers_launch_on_their_tensors_device(cuda, rans_tabs):
    """The three lane kernels on the last card while the first is current:
    each wrapper enters its tensors' device, so its launch goes there, and
    matches the plain version; the current device stays the first."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    from rdeic_torch.entropy import device_rans as dr  # noqa: PLC0415
    from torch_port_rans import decode_passes, lane_batch  # noqa: PLC0415

    other = torch.device("cuda", torch.cuda.device_count() - 1)
    table, cpu_tabs, _ = rans_tabs
    tabs = dr.DeviceRansTables(table, other)
    cases = _rans_cases(table, 2, 0.05, seed=3)
    torch.cuda.set_device(0)
    idxs = [np.stack([c[1][p] for c in cases]) for p in range(len(RANS_SIZES))]
    for shared in (False, True):
        w, nw = lane_batch(table, 32, cases, shared)
        want = decode_passes(cpu_tabs, w, nw, 32, idxs, shared)
        got = decode_passes(tabs, w.to(other), nw.to(other), 32, idxs, shared)
        for (gs, gst, gpt), (ws, wst, wpt) in zip(got, want):
            assert torch.equal(gs, ws) and torch.equal(gst, wst)
            assert torch.equal(gpt, wpt)
    syms = [torch.from_numpy(np.stack([c[0][p] for c in cases]))
            for p in range(len(RANS_SIZES))]
    steps = dr.build_pass_steps(syms, [torch.from_numpy(i) for i in idxs], 32)
    wcap = max(64, 4 * steps[0].shape[0])
    got = dr.encode_lanes(tabs, *(x.to(other) for x in steps), wcap)
    assert got[0].device == other
    want = dr.encode_lanes_plain(cpu_tabs, *steps, wcap)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    assert torch.cuda.current_device() == 0


def test_d16_bf16_backward_is_prepared_on_each_device(cuda):
    """flash_dq_d16_bf16 / flash_dkv_d16_bf16 set their shared-memory
    carveout on every device that launches them (the attribute belongs to
    the current device): after a launch on each card, each reads 100
    (cudaSharedmemCarveoutMaxShared), and the results match the plain
    version there."""
    from rdeic_torch.ops.flash_attention import d16_bf16_carveout  # noqa: PLC0415

    shape = (1, 130, 1, 16)
    for index in range(torch.cuda.device_count()):
        dev = torch.device("cuda", index)
        q, k, v, do = (_rand(shape, torch.bfloat16, dev, s) for s in range(4))
        o, lse = flash_attention_lse(q, k, v)
        plain = flash_attention_bwd_plain(*(x.float() for x in (q, k, v, o)),
                                          lse, do.float())
        for got, want in zip(flash_attention_bwd(q, k, v, o, lse, do), plain):
            assert got.device == dev
            assert _rel_err(got, want) <= _limit(torch.bfloat16)
        assert d16_bf16_carveout(index) == (100, 100), index


@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_column_parallel_linear_over_one_rank_is_f_linear(cuda, tmp_path,
                                                           backend):
    """`ColumnParallelLinear` on the card over a tp group of one rank (NCCL,
    and gloo, which moves CUDA tensors through the host): the forward and
    the gradients of x, W and b against autograd through `F.linear` on the
    whole weight, within 1e-6 of max (the bias is added after the gather,
    so the forward may round once more)."""
    import torch.distributed as dist  # noqa: PLC0415
    import torch.nn.functional as F  # noqa: PLC0415

    from rdeic_torch.models.blocks import per_image  # noqa: PLC0415
    from rdeic_torch.parallel.tensor import (  # noqa: PLC0415
        ColumnParallelLinear, TensorParallel)

    gen = torch.Generator(device=cuda).manual_seed(0)
    x, w, b, dy = (torch.randn(s, device=cuda, generator=gen)
                   for s in ((2, 1024, 320), (2560, 320), (2560,),
                             (2, 1024, 2560)))
    _world_of_one(tmp_path, backend)
    try:
        tp = TensorParallel(dist.group.WORLD, 1, 0)
        leaves = [t.clone().requires_grad_() for t in (x, w, b)]
        got = ColumnParallelLinear.apply(*leaves, tp, per_image)
        got.backward(dy)
    finally:
        dist.destroy_process_group()
    ref = [t.clone().requires_grad_() for t in (x, w, b)]
    want = F.linear(*ref)
    want.backward(dy)
    for a, e in [(got, want)] + [(g.grad, r.grad) for g, r in zip(leaves, ref)]:
        assert a.shape == e.shape and a.is_cuda
        assert (a - e).abs().max() <= 1e-6 * e.abs().max()


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_export_round_trip_of_card_tensors(cuda, tmp_path, bf16):
    """`save_params_npz` of CARD_MICRO's tensors on the card (bf16 storage
    for the VAE and the denoiser when asked), then `load_npz_weights` into
    a fresh card model of the same dtypes: every tensor bit-equal; the
    file holds fp32 only."""
    from rdeic_torch.pipeline.rdeic import RDEIC  # noqa: PLC0415
    from rdeic_torch.utils.checkpoint_io import (  # noqa: PLC0415
        load_npz_weights, save_params_npz)

    _, card = _serving_models(cuda, bf16=bf16)
    path = tmp_path / "params.npz"
    save_params_npz(path, card)
    fresh = RDEIC(**CARD_MICRO, device="meta").eval()
    if bf16:
        fresh.set_compute_dtype(torch.bfloat16)
    fresh.to_empty(device=cuda)
    load_npz_weights(fresh, path)
    with np.load(path) as data:
        assert {data[k].dtype for k in data.files} == {np.dtype(np.float32)}
    got, want = fresh.state_dict(), card.state_dict()
    assert got.keys() == want.keys()
    assert bf16 == any(v.dtype == torch.bfloat16 for v in want.values())
    for key, v in want.items():
        assert got[key].dtype == v.dtype and torch.equal(got[key], v), key


# -- profiling and corrupt lane streams (the evaluation harnesses' slice) ---------
def test_phase_timer_block_waits_for_a_queued_kernel(cuda):
    """`block=True` times a phase until the card has run what it queued: a
    kernel that sleeps >= 50 ms (1e8 cycles at the H100's <= 1.98 GHz)
    reads >= 50 ms blocked and far less unblocked."""
    from rdeic_torch.utils.profiling import PhaseTimer  # noqa: PLC0415

    timer = PhaseTimer()
    torch.cuda.synchronize()
    with timer.phase("queued"):
        torch.cuda._sleep(100_000_000)
    torch.cuda.synchronize()
    with timer.phase("blocked", block=True):
        torch.cuda._sleep(100_000_000)
    assert timer.totals["blocked"] >= 0.05 > 0.01 > timer.totals["queued"]
    assert timer.summary()["blocked"]["count"] == 1


def test_memory_stats_read_the_allocator(cuda):
    from rdeic_torch.utils.profiling import memory_stats  # noqa: PLC0415

    torch.cuda.reset_peak_memory_stats()
    block = torch.empty(64 << 20, dtype=torch.uint8, device=cuda)
    del block
    stats = memory_stats()
    assert len(stats) == torch.cuda.device_count()
    card = stats[f"cuda:{torch.cuda.current_device()}"]
    assert card["peak_bytes_in_use"] >= 64 << 20
    assert card["peak_bytes_in_use"] == torch.cuda.max_memory_allocated()
    assert card["bytes_in_use"] == torch.cuda.memory_allocated()
    assert card["bytes_limit"] == torch.cuda.get_device_properties(
        torch.cuda.current_device()).total_memory
    assert card["allocated_bytes.all.peak"] == card["peak_bytes_in_use"]


def test_device_trace_records_the_kernels(cuda, tmp_path):
    """The trace of a flash and a GroupNorm launch holds their device time
    under the kernels' names, and is written as a Chrome trace."""
    from rdeic_torch.utils.profiling import device_trace  # noqa: PLC0415

    q = _rand((1, 1536, 8, 16), torch.float32, cuda, 0)
    x = _rand((1, 320, 96, 64), torch.float32, cuda, 1)
    w = torch.ones(320, device=cuda)
    group_norm(x, w, w * 0, 32, 1e-5, True)  # built and loaded outside
    flash_attention(q, q, q)
    with device_trace(tmp_path) as prof:
        flash_attention(q, q, q)
        group_norm(x, w, w * 0, 32, 1e-5, True)
        torch.cuda.synchronize()
    (trace,) = tmp_path.glob("*.pt.trace.json")
    assert trace.stat().st_size > 0
    timed = {e.key: e.self_device_time_total for e in prof.key_averages()
             if e.self_device_time_total > 0}
    assert any("flash" in k for k in timed), sorted(timed)
    assert any("gn_fwd" in k for k in timed), sorted(timed)


@pytest.mark.parametrize("shared", ["1", "0"], ids=["v2", "v1"])
def test_corrupt_lane_streams_fail_in_python_not_on_the_card(
        cuda, tmp_path, monkeypatch, shared):
    """Lane streams (K = 64) with their payload's bits flipped at
    run_robustness's rates (the 12-byte header kept), and with words of
    the lanes' own string flipped: each decode raises a Python exception or
    returns latents of the clean shape, no launch faults the context, and
    the clean stream then decodes as before, bit for bit."""
    from rdeic_torch.entropy import device_rans as dr  # noqa: PLC0415
    from rdeic_torch.experiments.corruptors import Corruptor  # noqa: PLC0415

    for key, value in {"RDEIC_RANS_LANES": "64", "RDEIC_RANS_SHARED": shared,
                       "RDEIC_RANS_OVERHEAD_PCT": "0"}.items():
        monkeypatch.setenv(key, value)
    _, card = _serving_models(cuda)
    img = torch.from_numpy(np.random.default_rng(3).uniform(
        size=(1, 128, 128, 3)).astype(np.float32)).to(cuda)
    clean = tmp_path / "clean.rdeic"
    card.apply_condition_compress(img, clean, 128, 128)
    want = card.apply_condition_decompress(clean)
    raw = clean.read_bytes()
    fn = dr.decode_pass_shared if shared == "1" else dr.decode_pass
    before, outcomes = fn.launches, []
    (n_lanes,) = struct.unpack(">I", raw[12:16])  # the lanes' string first
    rng = np.random.default_rng(4)
    streams = [raw[:12] + Corruptor("bitstream", "random", rate, seed)
               .apply_bytes(raw[12:])
               for rate in (1e-3, 1e-2, 1e-1) for seed in range(4)]
    for _ in range(4):
        data = bytearray(raw)
        for pos in rng.integers(16, 16 + n_lanes, 8):
            data[pos] ^= 0xFF
        streams.append(bytes(data))
    for stream in streams:
        bad = tmp_path / "bad.rdeic"
        bad.write_bytes(stream)
        try:
            c_latent, _ = card.apply_condition_decompress(bad)
            torch.cuda.synchronize()
            assert c_latent.shape == want[0].shape
            outcomes.append("decoded")
        except (ValueError, OverflowError, struct.error, RuntimeError) as e:
            assert "CUDA" not in str(e) and "illegal" not in str(e), e
            outcomes.append(type(e).__name__)
    torch.cuda.synchronize()
    assert fn.launches > before and "decoded" in outcomes
    got = card.apply_condition_decompress(clean)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
