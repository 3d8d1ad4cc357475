"""Fast full-width weights (counterpart of rdeic_tpu/utils/fast_init.py
`fast_random_params`).

Build the model on `device="meta"` (no memory), then `fast_random_init`
allocates every parameter and buffer on the device, each in the dtype it
already has (so frozen tensors cast to bf16 on the meta model are made in
bf16 directly: no fp32 copy of the model is made and thrown away), and fills
it by the JAX rule:

- norm scales = 1, biases and the codebook usage `vq_embed_prob` = 0;
- leaves of rank >= 2 (conv and dense kernels, embeddings, the stored
  context): LeCun normal, std = 1 / sqrt(fan-in) over the flax shape's
  leading dims;
- the rest: N(0, 0.02).

The values equal the JAX package's `fast_random_params(model, hw, seed=seed,
device=False)` bit for bit: one `np.random.default_rng(seed)` drawn leaf by
leaf in the order `jax.tree_util` flattens the flax tree (sorted keys at
every level), in the flax shapes (HWIO, (in, out)), then laid out by
utils/convert.py's rule.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from rdeic_torch.utils.convert import convert_leaf


def flax_path(name: str, tensor: torch.Tensor) -> tuple[tuple[str, ...], tuple]:
    """The flax path and shape of the port's tensor `name`: the inverse of
    `convert_leaf` (a rank-4 or rank-2 `weight` is a `kernel` in HWIO or
    (in, out); another `weight` is a norm's `scale`)."""
    parts = name.split(".")
    shape = tuple(tensor.shape)
    if parts[-1] == "weight":
        if tensor.dim() == 4:
            parts[-1] = "kernel"
            shape = (shape[2], shape[3], shape[1], shape[0])
        elif tensor.dim() == 2:
            parts[-1] = "kernel"
            shape = (shape[1], shape[0])
        else:
            parts[-1] = "scale"
    return tuple(parts), shape


def jax_leaf(path: tuple[str, ...], shape: tuple,
             rng: np.random.Generator) -> np.ndarray:
    """One leaf's fp32 values in the flax shape, by `fast_random_params`'s
    rule and draw order."""
    leaf = path[-1]
    if leaf == "scale":
        return np.ones(shape, np.float32)
    if leaf in ("bias", "vq_embed_prob"):
        return np.zeros(shape, np.float32)
    if len(shape) >= 2:
        fan_in = int(np.prod(shape[:-1]))
        std = 1.0 / np.sqrt(max(fan_in, 1))
        return (rng.standard_normal(shape) * std).astype(np.float32)
    return (rng.standard_normal(shape) * 0.02).astype(np.float32)


@torch.no_grad()
def fast_random_init(model: nn.Module, device: str | torch.device,
                     seed: int = 0) -> nn.Module:
    """Allocate `model`'s tensors on `device` (from `meta`, or move them
    there) and fill them by `fast_random_params`'s rule from `seed`; each
    keeps its dtype. Returns the model."""
    model.to_empty(device=device)
    tensors = dict(model.named_parameters())
    tensors.update(model.named_buffers())
    order = sorted((flax_path(name, t) + (name,) for name, t in tensors.items()),
                   key=lambda x: x[0])
    rng = np.random.default_rng(seed)
    for path, shape, name in order:
        _, value = convert_leaf("/".join(path), jax_leaf(path, shape, rng))
        tensors[name].copy_(value)
    return model
