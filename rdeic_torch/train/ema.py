"""Exponential moving average of parameters (counterpart of
rdeic_tpu/train/ema.py). The shadow is a dict of tensors, updated in place."""
from __future__ import annotations

import torch


def ema_init(params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in params.items()}


@torch.no_grad()
def ema_update(shadow: dict[str, torch.Tensor], params: dict[str, torch.Tensor],
               decay: float, step: int | None = None) -> None:
    """shadow <- shadow * d + params * (1 - d), with d warming up as LitEma's:
    d = min(decay, (1 + step) / (10 + step))."""
    d = decay if step is None else min(decay, (1.0 + step) / (10.0 + step))
    for k, s in shadow.items():
        s.mul_(d).add_(params[k].to(s.dtype), alpha=1 - d)
