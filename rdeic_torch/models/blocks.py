"""Shared building blocks (counterpart of rdeic_tpu/models/blocks.py).

Modules work in NCHW. Their attribute names mirror the flax parameter paths
(`Conv.Conv_0`, `GroupNorm32.GroupNorm_0`) so that
rdeic_torch.utils.convert maps a flax checkpoint leaf by leaf.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from rdeic_torch.ops.fused_groupnorm import group_norm


def find_denominator(number: int, start: int) -> int:
    """Largest divisor of `number` that is <= start."""
    if start >= number:
        return number
    while start != 0:
        if number % start == 0:
            return start
        start -= 1
    return 1


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal embedding [B, dim] in fp32: cat(cos, sin)."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """Depth-to-space on NCHW with torch's channel order (c, i, j), the
    order the JAX package reproduces on NHWC."""
    return F.pixel_shuffle(x, r)


class Conv(nn.Module):
    """k x k convolution with symmetric padding k // 2 (flax `blocks.Conv`,
    whose flax child is named Conv_0)."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1):
        super().__init__()
        self.Conv_0 = nn.Conv2d(cin, cout, kernel, stride=stride,
                                padding=kernel // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Conv_0(x)


class PromotedConv(Conv):
    """A Conv that computes in the wider of its input's and its weights'
    dtypes, as a flax Conv without `dtype` does: with bf16 weights an fp32
    input stays fp32 and the weights are taken up to it."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = self.Conv_0
        ct = torch.promote_types(x.dtype, conv.weight.dtype)
        return F.conv2d(x.to(ct), conv.weight.to(ct), conv.bias.to(ct),
                        conv.stride, conv.padding)


class GroupNorm32(nn.Module):
    """GroupNorm with fp32 statistics and the input dtype on output, groups =
    the largest divisor of C that is <= 32, optionally fused with the SiLU
    that follows it. Every call goes through ops.fused_groupnorm (on the
    card, the CUDA forward kernel and, under autograd, the CUDA
    backward), whose kernel and plain version both take fp32 or bf16 scale
    and bias and compute in fp32, rounding once at the end."""

    def __init__(self, channels: int, eps: float = 1e-5, silu: bool = False):
        super().__init__()
        self.groups = find_denominator(channels, 32)
        self.eps = eps
        self.silu = silu
        self.GroupNorm_0 = nn.GroupNorm(self.groups, channels, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gn = self.GroupNorm_0
        return group_norm(x, gn.weight, gn.bias, self.groups, self.eps, self.silu)


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()
