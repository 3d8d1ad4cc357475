"""Training runtime (counterpart of rdeic_tpu/train/trainer.py): which
parameters train, AdamW with gradient accumulation, the CVQ codebook update,
an optional EMA, and save/load of the full train state.

The port's dotted parameter names mirror the flax paths, so the JAX rule of
what trains carries over unchanged. Frozen parameters get
`requires_grad=False`: autograd computes no gradient for them, as the JAX
step differentiates only the trainable subtree.
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Callable

import torch

from rdeic_torch.models.compression import vq_codebook_update
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


class Trainer:
    """One `step` per micro-batch: forward and backward in full fp32, then
    AdamW on every `accumulate_grad_batches`-th call with the mean of the
    micro-batch gradients (optax.MultiSteps), then the CVQ codebook update
    on every call, then the EMA."""

    def __init__(self, model, learning_rate: float | None = None,
                 accumulate_grad_batches: int = 1, use_ema: bool = False):
        self.model = model
        self.params = trainable_parameters(model)
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
        micro-batch's gradients."""
        params = list(self.params.values())
        with full_fp32():
            loss, logs = self.model.loss_fn(img, noise=noise, generator=generator)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        logs = {k: v.detach() for k, v in logs.items()}
        logs["grad_norm"] = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
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
    def _codebook_update(self, z_hyper: torch.Tensor) -> None:
        comp = self.model.compression
        emb = comp.quantize.embedding
        new_emb, new_prob = vq_codebook_update(
            emb, self.model.vq_embed_prob, z_hyper.reshape(-1, comp.N))
        emb.copy_(new_emb)
        self.model.vq_embed_prob.copy_(new_prob)

    def save(self, path: str | Path) -> None:
        """The full train state (weights, AdamW moments, the partial
        gradient sum, EMA, step) in one torch.save file."""
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        torch.save({"step": self.step_count, "model": self.model.state_dict(),
                    "optimizer": self.optimizer.state_dict(),
                    "grad_sum": self._grad_sum, "ema": self.ema}, path)

    def load(self, path: str | Path) -> None:
        """The train state of a `Trainer.save` file, or of the latest
        `step_N.pt` in a directory of them (`latest_checkpoint`)."""
        dev = next(self.model.parameters()).device
        state = torch.load(latest_checkpoint(path), map_location=dev,
                           weights_only=True)
        self.model.load_state_dict(state["model"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        self._grad_sum = state["grad_sum"]
        if (self.ema is None) != (state["ema"] is None):
            raise ValueError("the checkpoint's EMA setting differs from the "
                             "trainer's")
        self.ema = state["ema"]
        self.step_count = int(state["step"])
