"""Device mesh and data-parallel placement (counterpart of
rdeic_tpu/parallel/mesh.py).

The JAX package spreads its work over a `dp x tp` mesh: the batch is
sharded over "dp" and replicated over "tp", the weights are replicated,
and XLA inserts the all-reduce of the gradients. Here a `Mesh` is the grid
of its members in the JAX order (`reshape(dp, tp)`), of one of two kinds:

- ranks: under torch.distributed (launched by torchrun; NCCL on CUDA, gloo
  on the CPU) each member is a process with one device. Training runs so:
  every rank reads the global batch, keeps the rows its dp index owns
  (`Mesh.rows`), and `train.trainer.Trainer` all-reduces the gradients.
  The ranks of a tp group keep the same rows.
- devices of one process: each member a `torch.device` holding a serving
  replica, driven from a thread of its own (`pipeline.rdeic.decode_rows`).
  On the CPU, tests and `--device cpu` pass `dp` copies of
  torch.device("cpu"): they stand where JAX's virtual host devices stand.

Rows go to dp indices in contiguous blocks, in dp order (`shard_rows`), as
`batch_sharding` places them; every member holds the whole weights, as
`replicated` places them. Tensor-parallel placement of weights
(`param_spec`, `shard_params`, `params_shardings`) is not ported here:
ROADMAP Queue 1, tensor-parallel placement.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """A `[dp][tp]` grid of ranks (a process mesh: `rank` set, `dp_group`
    the process group of this rank's dp axis) or of `torch.device`s (one
    process)."""

    grid: tuple
    rank: Optional[int] = None
    dp_group: Any = None

    @property
    def shape(self) -> dict:
        return {"dp": len(self.grid), "tp": len(self.grid[0])}

    @property
    def distributed(self) -> bool:
        """Whether the members are the ranks of a process group."""
        return self.rank is not None

    @property
    def dp_index(self) -> int:
        """This rank's row of the grid (0 on a mesh of one process)."""
        return 0 if self.rank is None else self.rank // self.shape["tp"]

    def devices(self) -> list:
        """The first member of each dp row: the device of each replica."""
        return [row[0] for row in self.grid]

    def rows(self, batch: int) -> slice:
        """The rows of a global batch of `batch` that this rank owns."""
        return shard_rows(batch, self.shape["dp"], self.dp_index)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The rows `x` holds on every rank of this rank's dp group, in dp
        order: the whole batch's (the ranks of a tp group hold the same
        rows, so the gather runs over dp alone). Gloo gathers on the host."""
        if not self.distributed:
            raise ValueError("gather_rows runs on a process mesh")
        via_host = x.is_cuda and dist.get_backend(self.dp_group) == "gloo"
        src = (x.cpu() if via_host else x).contiguous()
        parts = [torch.empty_like(src)
                 for _ in range(dist.get_world_size(self.dp_group))]
        dist.all_gather(parts, src, group=self.dp_group)
        return torch.cat(parts).to(x.device)

    def barrier(self) -> None:
        if self.distributed:
            dist.barrier()


def shard_rows(batch: int, dp: int, index: int) -> slice:
    """Rows [index * batch / dp, (index + 1) * batch / dp) of a batch: the
    block that dp index `index` owns under `batch_sharding`."""
    if batch % dp:
        raise ValueError(f"a batch of {batch} does not divide by dp = {dp}")
    n = batch // dp
    return slice(index * n, (index + 1) * n)


def make_mesh(dp: int | None = None, tp: int = 1,
              devices: Sequence | None = None) -> Mesh:
    """A `dp x tp` mesh over `devices`; without them, over the ranks of the
    process group when torch.distributed is up, else over this process's
    CUDA devices (or the one CPU). `dp` None takes every member; dp * tp
    must be their count. On a process mesh every rank must call this (it
    makes the dp groups when tp > 1)."""
    process = devices is None and dist.is_available() and dist.is_initialized()
    if devices is None:
        if process:
            devices = list(range(dist.get_world_size()))
        elif torch.cuda.is_available():
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        else:
            devices = [torch.device("cpu")]
    n = len(devices)
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp={dp*tp} != #devices={n}")
    grid = tuple(tuple(devices[i * tp:(i + 1) * tp]) for i in range(dp))
    if not process:
        return Mesh(grid)
    rank = dist.get_rank()
    group = dist.group.WORLD
    if tp > 1:  # a group over each tp index's ranks; every rank makes all
        groups = [dist.new_group([t + i * tp for i in range(dp)])
                  for t in range(tp)]
        group = groups[rank % tp]
    return Mesh(grid, rank=rank, dp_group=group)


def local_rank() -> int:
    """This process's device index on its host (torchrun's LOCAL_RANK)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     device: str | torch.device = "cuda") -> bool:
    """Start torch.distributed (NCCL for a CUDA `device`, gloo for the
    CPU): with explicit arguments at `tcp://coordinator`, else from
    torchrun's environment (WORLD_SIZE, RANK, MASTER_ADDR, MASTER_PORT);
    without either it does nothing (a world of one). Whether a process
    group is up. Unlike the JAX function, a start that was asked for and
    fails raises."""
    if dist.is_initialized():
        return True
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if coordinator is not None:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id)
        return True
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        dist.init_process_group(backend, init_method="env://")
        return True
    return False
