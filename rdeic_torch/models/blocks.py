"""Shared building blocks (counterpart of rdeic_tpu/models/blocks.py).

Modules work in NCHW. Their attribute names mirror the flax parameter paths
(`Conv.Conv_0`, `GroupNorm32.GroupNorm_0`) so that
rdeic_torch.utils.convert maps a flax checkpoint leaf by leaf.

Compute dtype apart from storage dtype, as flax does it. A layer the JAX
package builds with `dtype` is a `Linear`, `Conv2d` or `LayerNorm` here: it
casts its weights and its input to its `compute_dtype` (fp32 unless
`set_compute_dtype` sets it) inside `forward`, so the cast sits in the
autograd graph (an fp32 weight computing in bf16 gets an fp32 gradient, and
a checkpointed block's recompute casts again). A layer built without
`dtype` promotes instead (`PromotedConv2d`): it computes in the wider of
its input's and its weights' dtypes.

Batch invariance (`image_by_image`): inside that scope, in the thread that
opened it, every `Linear`, `Conv2d` and `PromotedConv2d` runs image by image,
so an image gets the same bits whatever batch it comes in. A library
convolution or product may pick another algorithm, and so sum in another
order, for another batch size (cuDNN by its heuristics, oneDNN by its
blocking); the codec's streams must not depend on that.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Callable, Iterator

import torch
import torch.nn.functional as F
from torch import nn

from rdeic_torch.ops.fused_groupnorm import group_norm
from rdeic_torch.parallel.tensor import ColumnParallelLinear, TensorParallel


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


_LOCAL = threading.local()


@contextlib.contextmanager
def image_by_image() -> Iterator[None]:
    """Inside the block, in this thread, the layers of this module run one
    image at a time (see the module's docstring)."""
    prev = getattr(_LOCAL, "on", False)
    _LOCAL.on = True
    try:
        yield
    finally:
        _LOCAL.on = prev


def per_image(fn: Callable[[torch.Tensor], torch.Tensor],
              x: torch.Tensor) -> torch.Tensor:
    """fn(x), or, inside `image_by_image`, fn of each image of x in turn."""
    if getattr(_LOCAL, "on", False) and x.shape[0] > 1:
        return torch.cat([fn(x[i:i + 1]) for i in range(x.shape[0])])
    return fn(x)


class Linear(nn.Linear):
    """A flax Dense with `dtype`: weight, bias and input cast to
    `compute_dtype`. After `parallel.mesh.shard_params` marked it (`tp`),
    `weight` is this rank's block of the output rows and the layer runs as
    `parallel.tensor.ColumnParallelLinear`."""

    compute_dtype = torch.float32
    tp: TensorParallel | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ct = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(ct)
        weight = self.weight.to(ct)
        if self.tp is not None:
            return ColumnParallelLinear.apply(x.to(ct), weight, bias, self.tp,
                                              per_image)
        return per_image(lambda v: F.linear(v, weight, bias), x.to(ct))


class Conv2d(nn.Conv2d):
    """A flax Conv with `dtype`: weight, bias and input cast to
    `compute_dtype`."""

    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ct = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(ct)
        weight = self.weight.to(ct)
        return per_image(lambda v: self._conv_forward(v, weight, bias),
                         x.to(ct))


class PromotedConv2d(nn.Conv2d):
    """A flax Conv without `dtype`: it computes in the wider of its input's
    and its weights' dtypes (bf16 weights take an fp32 input's fp32; fp32
    weights take a bf16 input up to fp32)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ct = torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(ct)
        weight = self.weight.to(ct)
        return per_image(lambda v: self._conv_forward(v, weight, bias),
                         x.to(ct))


class LayerNorm(nn.LayerNorm):
    """A flax LayerNorm with `dtype`: fp32 statistics, output in
    `compute_dtype` (its input is already in it on every path)."""

    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ct = self.compute_dtype
        return F.layer_norm(x.to(ct), self.normalized_shape,
                            self.weight.to(ct), self.bias.to(ct), self.eps)


CAST_LAYERS = (Linear, Conv2d, LayerNorm)


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> None:
    """Every cast layer of `module` computes in `dtype`; the weights keep
    their storage dtype."""
    for m in module.modules():
        if isinstance(m, CAST_LAYERS):
            m.compute_dtype = dtype


class Conv(nn.Module):
    """k x k convolution with symmetric padding k // 2 (flax `blocks.Conv`,
    whose flax child is named Conv_0), built with `dtype`."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1):
        super().__init__()
        self.Conv_0 = Conv2d(cin, cout, kernel, stride=stride,
                             padding=kernel // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Conv_0(x)


class PromotedConv(nn.Module):
    """`Conv` built without `dtype` (`PromotedConv2d`)."""

    def __init__(self, cin: int, cout: int, kernel: int = 3):
        super().__init__()
        self.Conv_0 = PromotedConv2d(cin, cout, kernel, padding=kernel // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Conv_0(x)


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
