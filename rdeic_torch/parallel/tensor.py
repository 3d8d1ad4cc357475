"""Column-parallel linear layers: the port's form of a Dense kernel that the
JAX package's `shard_params` places on the "tp" axis (its output features
split in tp blocks; rdeic_tpu/parallel/mesh.py).

XLA partitions such a Dense over the mesh by itself. Here the layer does it
over the tp process group of `parallel.mesh.make_mesh`, as a
`torch.autograd.Function` (`ColumnParallelLinear`). Each rank of a tp group
holds one contiguous block of the output features, in tp order, and the
whole bias:

    forward   y      = all_gather_tp(x W_shardᵀ) + b   (along the features)
    backward  dW     = dY_blockᵀ x                     (this rank's block)
              dX     = all_reduce_tp(dY_block W_shard) (summed over tp)
              db     = Σ_rows dY                       (the same on every rank)

The layers after it (GEGLU's chunk, the attention's head reshape) see the
gathered tensor, so heads are never split. Gloo moves a CUDA tensor through
the host, as `Mesh.gather_rows` does. `all_gather_features` and
`all_reduce_sum` are looked up at call time, so a caller may wrap them to
time the collectives.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch
import torch.distributed as dist
import torch.nn.functional as F


@dataclass(frozen=True)
class TensorParallel:
    """A rank's place in its tp group: the group, its size and this rank's
    index in it (the block of the output features it holds)."""

    group: Any
    size: int
    index: int

    def block(self, n: int, index: int | None = None) -> slice:
        """The contiguous block of `n` features that tp index `index` (this
        rank's by default) holds."""
        i = self.index if index is None else index
        step = n // self.size
        return slice(i * step, (i + 1) * step)


def _via_host(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def gather_blocks(x: torch.Tensor, tp: TensorParallel,
                  dim: int = 0) -> torch.Tensor:
    """The tp group's blocks of `x`, joined along `dim` in tp order. Every
    rank of the group must call it."""
    src = (x.cpu() if _via_host(x, tp.group) else x).contiguous()
    parts = [torch.empty_like(src) for _ in range(tp.size)]
    dist.all_gather(parts, src, group=tp.group)
    return torch.cat(parts, dim=dim).to(x.device)


def all_gather_features(y: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """The forward's gather: the tp group's output blocks, joined along the
    feature (last) axis."""
    return gather_blocks(y, tp, dim=-1)


def all_reduce_sum(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """`x` summed over the tp group."""
    host = _via_host(x, tp.group)
    buf = (x.cpu() if host else x).contiguous()
    dist.all_reduce(buf, group=tp.group)
    return buf.to(x.device) if host else buf


class ColumnParallelLinear(torch.autograd.Function):
    """`F.linear(x, W, b)` with W's output rows split over a tp group (see
    the module's docstring). `rows_fn(fn, x)` applies the shard's product to
    x (`blocks.per_image`: image by image inside `blocks.image_by_image`)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor | None, tp: TensorParallel,
                rows_fn: Callable) -> torch.Tensor:
        ctx.tp = tp
        ctx.has_bias = bias is not None
        ctx.save_for_backward(x, weight)
        y = all_gather_features(rows_fn(lambda v: F.linear(v, weight), x), tp)
        return y if bias is None else y + bias

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        x, weight = ctx.saved_tensors
        tp = ctx.tp
        dy_block = dy[..., tp.block(dy.shape[-1])]
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = all_reduce_sum(dy_block.matmul(weight), tp)
        if ctx.needs_input_grad[1]:
            dw = (dy_block.reshape(-1, dy_block.shape[-1]).t()
                  .matmul(x.reshape(-1, x.shape[-1])))
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = dy.reshape(-1, dy.shape[-1]).sum(0)
        return dx, dw, db, None, None

