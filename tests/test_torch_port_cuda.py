"""The port's kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with nvcc and triton, and skip elsewhere.
This file imports no JAX, so it also runs where JAX is not installed; there,
skip the repository's conftest (it configures JAX):

    python -m pytest --noconftest -q -m cuda tests/test_torch_port_cuda.py
"""
import math

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
    _launch_fwd,
    group_norm,
    group_norm_bwd,
    group_norm_bwd_plain,
    group_norm_fwd,
    group_norm_fwd_plain,
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
# an L past one 64-row tile, inside one, and below one 32-row chunk), and
# at d = 64 twice the paths' longest L (the dq, dk and dv sums run over L)
FLASH_TRAIN_SHAPES = [(2, 4096, 5, 64), (2, 1024, 10, 64), (2, 4096, 4, 16),
                      (2, 1024, 8, 16), (2, 4096, 1, 512), (1, 1024, 1, 512),
                      (2, 1000, 3, 64), (1, 130, 2, 64), (2, 40, 3, 64),
                      (1, 8192, 2, 64), (1, 77, 2, 16), (1, 130, 1, 512),
                      *D512_SHAPES]
FAULT_SCALE = 1.05  # a planted output-scale error each check must read
# (B, C, H, W, groups) of GroupNorm backward: denoiser widths at 512x512
# (64x64 latents), a 48-channel control width (find_denominator gives 24
# groups), and ragged spans
GN_TRAIN_SHAPES = [(2, 320, 64, 64, 32), (2, 1280, 8, 8, 32),
                   (2, 64, 64, 64, 32), (2, 48, 32, 32, 24),
                   (2, 256, 16, 16, 32), (1, 96, 7, 9, 32)]


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
    q, k, v, do = (_rand(shape, dtype, cuda, s) for s in range(4))
    counts = [f.launches for f in (flash_attention_lse, flash_attention_dq,
                                   flash_attention_dkv)]
    o, lse = flash_attention_lse(q, k, v)
    grads = flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert [f.launches for f in (flash_attention_lse, flash_attention_dq,
                                 flash_attention_dkv)] == [c + 1 for c in counts]
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
    assert group_norm_bwd.launches == before + 2  # moments, then dx
    want = group_norm_bwd_plain(x.float(), w, b, mean, inv, dy.float(), groups,
                                silu)
    for g, ref, lim in zip(got, want, (_limit(dtype), 1e-4, 1e-4)):
        assert _rel_err(g, ref) <= lim  # dscale, dbias are fp32 sums


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
    """The CUDA forward (one launch, statistics stored) feeding the Triton
    backward under autograd, at training shapes (the first is the largest
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
        before[0] + 1, before[1] + 2)
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
