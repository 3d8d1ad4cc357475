"""Training runtime (counterpart of rdeic_tpu/train/trainer.py): which
parameters train, AdamW with gradient accumulation, the CVQ codebook update,
an optional EMA, and save/load of the full train state.

The port's dotted parameter names mirror the flax paths, so the JAX rule of
what trains carries over unchanged. Frozen parameters get
`requires_grad=False`: autograd computes no gradient for them, as the JAX
step differentiates only the trainable subtree. With `frozen_dtype` (bf16)
the frozen tensors are stored in it (`cast_frozen`); the trainable weights,
their gradients, the gradient sum and AdamW stay fp32.

Data parallel (the JAX Trainer under a `dp x tp` mesh): with a process mesh
(`parallel.mesh.make_mesh` under torch.distributed, one rank a device) each
rank steps on its rows of the global batch. After the backward the
trainable gradients are summed over the ranks in one flat buffer a dtype,
in the order of `params`, and divided by the world size, so every rank
holds the same mean gradient and applies the same AdamW update; this comes
before `grad_norm`, which is then the global norm, as optax's is under the
JAX mesh. The ranks of a tp group hold the same rows, so the mean over the
world is the mean over dp. The logs are averaged over the ranks. The
terms that span the batch (the CVQ contrastive loss and the codebook
update) see the whole batch's hyper latent (`RDEIC.loss_fn`).
Tensor parallel (the JAX Trainer after `shard_params` under a `dp x tp`
mesh): after `parallel.mesh.shard_params` each rank holds its tp block of
every sharded kernel, and AdamW's moments, the partial gradient sum and the
EMA of such a leaf live on that block. Its gradient is averaged over the dp
group alone (the ranks that hold the same block), in a flat buffer of its
own; the replicated leaves keep the reduction above. `grad_norm` stays the
global norm: the sharded blocks' sum of squares is summed over the tp group
once and added to the replicated leaves'. `save` gathers the blocks, so a
checkpoint holds whole tensors at any tp (every rank calls it, rank 0
writes), and `load` cuts them again: a run resumes at another tp.
`torch.nn.parallel.DistributedDataParallel` does not fit: its reducer
hooks the gradients that `.backward()` accumulates into `.grad`, and the
step takes them from `torch.autograd.grad`, which leaves `.grad` alone, so
the wrapper would never see them.
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Callable

import torch
import torch.distributed as dist

from rdeic_torch.models.compression import vq_codebook_update
from rdeic_torch.parallel.mesh import gather_state_dict, tp_layers
from rdeic_torch.parallel.tensor import gather_blocks
from rdeic_torch.train.ema import ema_init, ema_update
from rdeic_torch.utils.backend import full_fp32

WEIGHT_DECAY = 0.01  # optax.adamw's default, as rdeic_tpu's Trainer uses it
EMA_DECAY = 0.9999


def trainable_predicate(sd_locked: bool) -> Callable[[tuple], bool]:
    """Which parameter paths train: the compression model, the control
    module and every bridge (and, unlocked, the base UNet's decoder blocks
    and output head)."""

    def pred(path: tuple) -> bool:
        if not path:
            return False
        top = path[0]
        if top == "compression":
            return True
        if top == "denoiser":
            sub = path[1] if len(path) > 1 else ""
            if sub == "base":
                if sd_locked:
                    return False
                nxt = path[2] if len(path) > 2 else ""
                return nxt.startswith("out")
            return True
        return False

    return pred


def trainable_parameters(model) -> dict:
    """The parameters that train, by dotted name; every other parameter is
    set to `requires_grad=False`."""
    pred = trainable_predicate(model.sd_locked)
    params = {}
    for name, p in model.named_parameters():
        p.requires_grad_(pred(tuple(name.split("."))))
        if p.requires_grad:
            params[name] = p
    return params


def is_frozen_float(name: str, tensor: torch.Tensor, pred) -> bool:
    """Whether `cast_frozen` casts this parameter or buffer: a float tensor
    that does not train, but for the codebook usage EMA `vq_embed_prob`
    (updated every step; its small decays underflow in bf16)."""
    return (name != "vq_embed_prob" and tensor.is_floating_point()
            and not pred(tuple(name.split("."))))


@torch.no_grad()
def cast_frozen(model, dtype: torch.dtype) -> None:
    """Store every frozen float parameter and buffer of `model` in `dtype`
    (the JAX `cast_frozen`; the trainable ones keep theirs). The tensors
    are replaced in place, so a `meta` model casts for nothing."""
    pred = trainable_predicate(model.sd_locked)
    for name, p in model.named_parameters():
        if is_frozen_float(name, p, pred):
            p.data = p.data.to(dtype)
    for name, b in list(model.named_buffers()):
        if is_frozen_float(name, b, pred):
            mod, _, leaf = name.rpartition(".")
            owner = model.get_submodule(mod) if mod else model
            setattr(owner, leaf, b.to(dtype))


def list_checkpoints(ckpt_dir: str | Path) -> list[int]:
    """The steps N of the `step_N.pt` files that `Trainer.save` wrote under
    `ckpt_dir`, in numeric order (step_10 after step_9); none for an absent
    or empty directory."""
    path = Path(ckpt_dir)
    if not path.is_dir():
        return []
    found = (re.fullmatch(r"step_(\d+)\.pt", f.name) for f in path.iterdir()
             if f.is_file())
    return sorted(int(m[1]) for m in found if m)


def latest_checkpoint(path: str | Path) -> Path:
    """A `Trainer.save` file as it is; for a directory, its `step_N.pt` of
    the largest N. A directory without one (an orbax checkpoint of the JAX
    package, or nothing) is refused."""
    path = Path(path)
    if not path.is_dir():
        return path
    steps = list_checkpoints(path)
    if not steps:
        raise NotImplementedError(
            f"{path}: no step_N.pt file that Trainer.save wrote; orbax "
            "checkpoints of the JAX package do not load here (ROADMAP "
            "Queue 1, the rest)")
    return path / f"step_{steps[-1]}.pt"


def prune_checkpoints(ckpt_dir: str | Path, keep: int) -> list[int]:
    """Delete every `step_N.pt` under `ckpt_dir` but the `keep` newest
    (`trainer.ckpt_keep`; keep <= 0 keeps all, as -1 does in train.py);
    the steps deleted."""
    if keep <= 0:
        return []
    gone = list_checkpoints(ckpt_dir)[:-keep]
    for step in gone:
        (Path(ckpt_dir) / f"step_{step}.pt").unlink()
    return gone


class Trainer:
    """One `step` per micro-batch: forward and backward in full fp32 (or in
    the model's compute dtype where `RDEIC.set_compute_dtype` set one), then
    AdamW on every `accumulate_grad_batches`-th call with the mean of the
    micro-batch gradients (optax.MultiSteps), then the CVQ codebook update
    on every call, then the EMA. `frozen_dtype` stores the frozen tensors
    in that dtype (`cast_frozen`). `mesh`: a process mesh of
    `parallel.mesh` (data parallel over its ranks; see the module's
    docstring), or None for one process."""

    def __init__(self, model, learning_rate: float | None = None,
                 accumulate_grad_batches: int = 1, use_ema: bool = False,
                 frozen_dtype: torch.dtype | None = None, mesh=None):
        if mesh is not None and not mesh.distributed:
            raise ValueError("a training mesh is a process mesh: one rank a "
                             "device under torch.distributed (torchrun)")
        self.model = model
        self.mesh = mesh
        if frozen_dtype is not None:
            cast_frozen(model, frozen_dtype)
        self.params = trainable_parameters(model)
        # the tp group of each tp-sharded trainable leaf (`shard_params`)
        self.sharded = {k: v for k, v in tp_layers(model).items()
                        if k in self.params}
        if self.sharded and mesh is None:
            raise ValueError("a model after shard_params trains on its mesh")
        # optax.adamw's defaults: betas (0.9, 0.999), eps 1e-8, decoupled decay
        self.optimizer = torch.optim.AdamW(
            self.params.values(), lr=learning_rate or model.learning_rate,
            betas=(0.9, 0.999), eps=1e-8, weight_decay=WEIGHT_DECAY)
        if accumulate_grad_batches < 1:
            raise ValueError("accumulate_grad_batches must be >= 1")
        self.accumulate = accumulate_grad_batches
        self.step_count = 0
        self._grad_sum: list[torch.Tensor] | None = None
        self.ema = ema_init(self.params) if use_ema else None

    def step(self, img: torch.Tensor, noise: dict | None = None,
             generator: torch.Generator | None = None) -> dict:
        """One micro-step on images [B, H, W, 3] in [-1, 1]; returns the
        logs (0-dim tensors) with `grad_norm`, the global norm of this
        micro-batch's gradients. On a mesh, `img` is this rank's rows and
        `noise` (if given) the global batch's."""
        params = list(self.params.values())
        with full_fp32():
            loss, logs = self.model.loss_fn(img, noise=noise,
                                            generator=generator,
                                            mesh=self.mesh)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        logs = {k: v.detach() for k, v in logs.items()}
        whole = [g for k, g in zip(self.params, grads) if k not in self.sharded]
        blocks = [g for k, g in zip(self.params, grads) if k in self.sharded]
        if self.mesh is not None:
            self._mean_over_ranks(whole)
            if blocks and self.mesh.shape["dp"] > 1:
                self._mean_over_ranks(blocks, self.mesh.dp_group)
            z_hyper = logs.pop("_z_hyper")
            logs = dict(zip(logs, self._mean_over_ranks(list(logs.values()))))
            logs["_z_hyper"] = z_hyper
        norms = torch.stack([torch.linalg.vector_norm(g) for g in whole])
        if blocks:  # the blocks' sum of squares over the tp group, once
            sq = torch.stack([g.square().sum() for g in blocks]).sum()
            self._all_reduce(sq, self.mesh.tp_group)
            logs["grad_norm"] = (norms.square().sum() + sq).sqrt()
        else:
            logs["grad_norm"] = torch.linalg.vector_norm(norms)
        if self._grad_sum is None:
            self._grad_sum = grads
        else:
            for acc, g in zip(self._grad_sum, grads):
                acc.add_(g)
        if (self.step_count + 1) % self.accumulate == 0:
            for p, acc in zip(params, self._grad_sum):
                p.grad = acc.div_(self.accumulate)
            self.optimizer.step()
            self.optimizer.zero_grad(set_to_none=True)
            self._grad_sum = None
        self._codebook_update(logs.pop("_z_hyper"))
        if self.ema is not None:
            ema_update(self.ema, self.params, EMA_DECAY, self.step_count)
        self.step_count += 1
        return logs

    @torch.no_grad()
    def _mean_over_ranks(self, tensors: list, group=None) -> list:
        """`tensors`, each replaced in place by its mean over the ranks of
        `group` (the world by default): one flat buffer a dtype, in list
        order, all-reduced (`_all_reduce`) and divided by the group's
        size."""
        world = dist.get_world_size(group)
        for dtype in dict.fromkeys(t.dtype for t in tensors):
            same = [t for t in tensors if t.dtype == dtype]
            flat = torch.cat([t.reshape(-1) for t in same])
            self._all_reduce(flat, group)
            flat.div_(world)
            for t, part in zip(same, flat.split([t.numel() for t in same])):
                t.copy_(part.view_as(t))
        return tensors

    def _all_reduce(self, flat: torch.Tensor, group=None) -> None:
        """Sum `flat` over the ranks of `group` (the world by default):
        NCCL, or gloo (which takes a CUDA tensor for an all-reduce)."""
        dist.all_reduce(flat, group=group)

    @torch.no_grad()
    def _codebook_update(self, z_hyper: torch.Tensor) -> None:
        comp = self.model.compression
        emb = comp.quantize.embedding
        new_emb, new_prob = vq_codebook_update(
            emb, self.model.vq_embed_prob, z_hyper.reshape(-1, comp.N))
        emb.copy_(new_emb)
        self.model.vq_embed_prob.copy_(new_prob)

    @torch.no_grad()
    def _map_moments(self, state: dict, fn) -> dict:
        """An AdamW state dict with `fn(name, tensor)` applied to the moments
        of every tp-sharded leaf (new dicts: the optimizer's own state
        dicts stay as they are)."""
        state = dict(state, state=dict(state["state"]))
        for i, name in enumerate(self.params):
            if name in self.sharded and i in state["state"]:
                st = state["state"][i]
                state["state"][i] = {
                    **st, **{k: fn(name, st[k]) for k in ("exp_avg", "exp_avg_sq")}}
        return state

    def _by_leaf(self, fn):
        """The grad sum and the EMA with `fn(name, tensor)` applied to each
        tp-sharded leaf."""
        names = list(self.params)
        grad_sum = None if self._grad_sum is None else [
            fn(k, g) if k in self.sharded else g
            for k, g in zip(names, self._grad_sum)]
        ema = None if self.ema is None else {
            k: fn(k, v) if k in self.sharded else v for k, v in self.ema.items()}
        return grad_sum, ema

    def save(self, path: str | Path) -> None:
        """The full train state (weights, AdamW moments, the partial
        gradient sum, EMA, step) in one torch.save file, every tp-sharded
        tensor gathered whole: every rank of a mesh calls it, rank 0
        writes."""
        def whole(name, x):
            return gather_blocks(x, self.sharded[name])

        model = gather_state_dict(self.model)
        optimizer = self._map_moments(self.optimizer.state_dict(), whole)
        grad_sum, ema = self._by_leaf(whole)
        if self.mesh is not None and self.mesh.rank != 0:
            return
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        torch.save({"step": self.step_count, "model": model,
                    "optimizer": optimizer, "grad_sum": grad_sum,
                    "ema": ema}, path)

    def load(self, path: str | Path) -> None:
        """The train state of a `Trainer.save` file, or of the latest
        `step_N.pt` in a directory of them (`latest_checkpoint`). Each
        weight is copied into the model's tensor in that tensor's dtype, so
        an fp32 file resumes into a bf16-frozen trainer, and the reverse;
        a tp-sharded leaf takes its block of the whole tensor, so a file
        resumes at any tp."""
        dev = next(self.model.parameters()).device
        state = torch.load(latest_checkpoint(path), map_location=dev,
                           weights_only=True)
        marked = tp_layers(self.model)

        def block(name, x):
            tp = marked[name]
            return x[tp.block(x.shape[0])].clone()

        self.model.load_state_dict(
            {k: block(k, v) if k in marked else v
             for k, v in state["model"].items()}, strict=True)
        self.optimizer.load_state_dict(
            self._map_moments(state["optimizer"], block))
        if (self.ema is None) != (state["ema"] is None):
            raise ValueError("the checkpoint's EMA setting differs from the "
                             "trainer's")
        self._grad_sum, self.ema = state["grad_sum"], state["ema"]
        self._grad_sum, self.ema = self._by_leaf(block)
        self.step_count = int(state["step"])
