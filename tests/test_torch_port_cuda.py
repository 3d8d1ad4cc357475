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

from rdeic_torch.ops.flash_attention import flash_attention, flash_attention_plain
from rdeic_torch.ops.fused_groupnorm import group_norm, group_norm_plain

pytestmark = pytest.mark.cuda

# (B, L, H, D) of every main-path flash launch at 768x512, plus ragged L
FLASH_SHAPES = [(1, 6144, 5, 64), (1, 6144, 4, 16), (1, 6144, 1, 512),
                (1, 1536, 10, 64), (1, 1536, 8, 16),
                (2, 1000, 3, 64), (1, 77, 2, 16), (1, 130, 1, 512)]
# (B, C, H, W) of GroupNorm32 inputs: UNet and control at 96x64 latents
GN_SHAPES = [(1, 320, 96, 64), (1, 2560, 12, 8), (1, 1920, 24, 16),
             (1, 960, 48, 32), (1, 640, 96, 64), (1, 64, 96, 64),
             (1, 256, 12, 8), (2, 128, 7, 9)]


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
    assert group_norm.launches == before + 2  # stats, then apply
    want = group_norm_plain(x, w, b, groups, eps, silu)
    torch.testing.assert_close(out, want, atol=1e-4, rtol=1e-5)


def test_groupnorm_kernel_bf16(cuda):
    x = _rand((1, 640, 48, 32), torch.bfloat16, cuda, 0)
    w = _rand((640,), torch.float32, cuda, 1)
    b = _rand((640,), torch.float32, cuda, 2)
    out = group_norm(x, w, b, 32, 1e-5, True)
    assert out.dtype == torch.bfloat16
    want = group_norm_plain(x, w, b, 32, 1e-5, True)
    torch.testing.assert_close(out.float(), want.float(), atol=3e-2, rtol=2e-2)


def test_kernels_raise_on_what_they_do_not_take(cuda):
    q = torch.zeros((1, 64, 2, 32), device=cuda)
    with pytest.raises(ValueError):
        flash_attention(q, q, q)  # head dim 32 is not built
    x = torch.zeros((1, 30, 4, 4), device=cuda)
    with pytest.raises(ValueError):
        group_norm(x, torch.ones(30, device=cuda), torch.zeros(30, device=cuda),
                   32, 1e-5)
