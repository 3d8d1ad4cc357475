"""Device mesh, data-parallel rows and tensor-parallel placement of the
weights (counterpart of rdeic_tpu/parallel/mesh.py).

The JAX package spreads its work over a `dp x tp` mesh: the batch is
sharded over "dp" and replicated over "tp"; the kernels of the attention
projections and MLP up-projections are sharded over "tp" on their output
features (`param_spec`), the rest replicated; XLA inserts the collectives.
Here a `Mesh` is the grid of its members in the JAX order
(`reshape(dp, tp)`), of one of two kinds:

- ranks: under torch.distributed (launched by torchrun; NCCL on CUDA, gloo
  on the CPU) each member is a process with one device. Training runs so:
  every rank reads the global batch, keeps the rows its dp index owns
  (`Mesh.rows`), and `train.trainer.Trainer` all-reduces the gradients.
  The ranks of a tp group keep the same rows. `make_mesh` builds the dp
  group of each rank (ranks t, t + tp, ...) and its tp group (ranks
  i tp ... i tp + tp - 1).
- devices of one process: each member a `torch.device` holding a serving
  replica, driven from a thread of its own (`pipeline.rdeic.decode_rows`).
  On the CPU, tests and `--device cpu` pass `dp` copies of
  torch.device("cpu"): they stand where JAX's virtual host devices stand.
  Such a mesh holds whole weights: `shard_params` refuses it at tp > 1.

Rows go to dp indices in contiguous blocks, in dp order (`shard_rows`), as
`batch_sharding` places them. `shard_params` applies the JAX rule to the
port's parameter names (they mirror the flax paths): each rank keeps the
block of a sharded kernel's output rows that its tp index owns, in tp
order, as `P(None, "tp")` places a flax kernel's last axis, and the layer
runs as a column-parallel linear over the tp group (`parallel.tensor`). A
kernel whose output axis does not divide by tp stays whole, as in JAX.
`params_shardings` reports the placement of every parameter;
`gather_state_dict` gathers the shards back into whole tensors.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from rdeic_torch.parallel.tensor import TensorParallel, gather_blocks
from rdeic_torch.utils.fast_init import flax_path


@dataclass(frozen=True)
class Mesh:
    """A `[dp][tp]` grid of ranks (a process mesh: `rank` set, `dp_group`
    and `tp_group` the process groups of this rank's dp and tp axes; no tp
    group at tp = 1) or of `torch.device`s (one process)."""

    grid: tuple
    rank: Optional[int] = None
    dp_group: Any = None
    tp_group: Any = None

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

    @property
    def tp_index(self) -> int:
        """This rank's column of the grid (0 on a mesh of one process)."""
        return 0 if self.rank is None else self.rank % self.shape["tp"]

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
    group, tp_group = dist.group.WORLD, None
    if tp > 1:  # every rank makes every group, in this order
        dp_groups = [dist.new_group([t + i * tp for i in range(dp)])
                     for t in range(tp)]
        tp_groups = [dist.new_group(list(range(i * tp, (i + 1) * tp)))
                     for i in range(dp)]
        group, tp_group = dp_groups[rank % tp], tp_groups[rank // tp]
    return Mesh(grid, rank=rank, dp_group=group, tp_group=tp_group)


# the flax layer names whose kernel's output feature axis is sharded over tp
# (rdeic_tpu/parallel/mesh.py's _TP_SHARDED_SUFFIXES)
TP_SHARDED_SUFFIXES = (
    "to_q", "to_k", "to_v", "proj", "fc1", "mlp_fc", "in_proj",
)


def param_spec(name: str, tensor: torch.Tensor) -> Optional[int]:
    """The JAX rule on the port's parameter `name`: 0, the output features
    (a torch weight's dim 0, a flax kernel's last axis), for the kernel of
    a layer whose name ends in one of TP_SHARDED_SUFFIXES; None
    (replicated) for everything else. The caller replicates a kernel whose
    output axis does not divide by tp."""
    path, _ = flax_path(name, tensor)
    if (len(path) >= 2 and path[-1] == "kernel"
            and path[-2].endswith(TP_SHARDED_SUFFIXES)):
        return 0
    return None


@dataclass(frozen=True)
class ParamSharding:
    """A parameter's placement on a mesh: `dim` the axis split over the tp
    ranks (None: replicated), `shape` the whole tensor's, `tp` the tp size
    and `index` this rank's tp index (0 on a mesh of one process)."""

    dim: Optional[int]
    shape: tuple
    tp: int
    index: int

    @property
    def sharded(self) -> bool:
        return self.dim is not None

    def block(self, index: Optional[int] = None) -> slice:
        """The rows of `dim` that tp index `index` (this rank's by
        default) holds; every row of a replicated tensor."""
        if not self.sharded:
            return slice(None)
        step = self.shape[self.dim] // self.tp
        i = self.index if index is None else index
        return slice(i * step, (i + 1) * step)


def tp_layers(model: nn.Module) -> dict:
    """{weight name: TensorParallel} of every layer `shard_params` marked."""
    return {f"{name}.weight" if name else "weight": m.tp
            for name, m in model.named_modules()
            if getattr(m, "tp", None) is not None}


def params_shardings(model: nn.Module, mesh: Mesh) -> dict:
    """{name: ParamSharding} for every parameter of `model`, by
    `param_spec` (a kernel whose output axis does not divide by tp is
    replicated), before or after `shard_params`."""
    tp = mesh.shape["tp"]
    marked = tp_layers(model)
    out = {}
    for name, p in model.named_parameters():
        shape = tuple(p.shape)
        if name in marked:
            dim = 0
            shape = (shape[0] * marked[name].size,) + shape[1:]
        else:
            dim = param_spec(name, p)
            if dim is not None and shape[dim] % tp:
                dim = None
        out[name] = ParamSharding(dim if tp > 1 else None, shape, tp,
                                  mesh.tp_index)
    return out


@torch.no_grad()
def shard_params(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Apply the tensor-parallel rule to `model` in place (the JAX
    `shard_params`): each sharded kernel keeps this rank's block of its
    output rows and its layer (a `models.blocks.Linear`) runs column-
    parallel over the mesh's tp group. Every rank of the tp group must call
    it, on the same weights, before a `Trainer` is built on the model.
    Nothing changes at tp = 1; a mesh of one process refuses tp > 1."""
    tp = mesh.shape["tp"]
    if tp == 1:
        return model
    if not mesh.distributed:
        raise ValueError(
            "tensor-parallel placement runs on a process mesh (one rank a "
            "device under torch.distributed, e.g. torchrun); a mesh of the "
            f"devices of one process holds whole weights, not tp = {tp}")
    info = TensorParallel(mesh.tp_group, tp, mesh.tp_index)
    modules = dict(model.named_modules())
    marked = tp_layers(model)
    for name, place in params_shardings(model, mesh).items():
        if not place.sharded or name in marked:
            continue
        owner, _, leaf = name.rpartition(".")
        layer = modules[owner]
        if leaf != "weight" or not hasattr(layer, "tp"):
            raise NotImplementedError(
                f"{name}: tensor-parallel placement of a "
                f"{type(layer).__name__} (only blocks.Linear runs sharded)")
        w = layer.weight
        layer.weight = nn.Parameter(w[place.block()].clone(),
                                    requires_grad=w.requires_grad)
        layer.tp = info
    return model


@torch.no_grad()
def gather_state_dict(model: nn.Module) -> dict:
    """`model.state_dict()` with every tp-sharded weight gathered whole (the
    same at any tp); every rank of each tp group must call it."""
    marked = tp_layers(model)
    return {k: gather_blocks(v, marked[k]) if k in marked else v
            for k, v in model.state_dict().items()}


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
