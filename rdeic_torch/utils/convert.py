"""JAX (flax) parameters -> the port's state dict, and the weights of the
port's own train state (`load_train_state_weights`).

The port's module tree mirrors the flax parameter paths, so one rule maps
every leaf of the flat "/"-joined dict that rdeic_tpu's `save_params_npz`
writes: the path's "/" becomes ".", and

    conv  `kernel` [kh, kw, in, out]  -> `weight` [out, in, kh, kw]
    dense `kernel` [in, out]          -> `weight` [out, in]
    norm  `scale`                     -> `weight`
    `bias`, `embedding` and top-level arrays (`uncond_context`,
    `vq_embed_prob`)                  -> unchanged
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


def convert_leaf(path: str, value: np.ndarray) -> tuple[str, torch.Tensor]:
    parts = path.split("/")
    leaf = parts[-1]
    arr = np.asarray(value)
    if leaf == "kernel":
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        elif arr.ndim == 2:
            arr = arr.T
        else:
            raise ValueError(f"{path}: kernel of rank {arr.ndim}")
        parts[-1] = "weight"
    elif leaf == "scale":
        parts[-1] = "weight"
    return ".".join(parts), torch.from_numpy(np.array(arr, order="C"))


def load_jax_params(flat: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Flat flax params {"a/b/kernel": array} -> a state dict for the port's
    modules (load it with `load_state_dict(strict=True)`, which raises on any
    missing or unexpected key)."""
    out = {}
    for path, value in flat.items():
        key, tensor = convert_leaf(path, value)
        if key in out:
            raise ValueError(f"two leaves map to {key}")
        out[key] = tensor
    return out


def load_npz(path: str | Path) -> dict[str, np.ndarray]:
    """The flat dict of a `save_params_npz` file."""
    with np.load(path) as data:
        if any(data[k].dtype.kind == "V" for k in data.files):
            raise ValueError(f"{path}: a leaf is stored as an opaque record "
                             "(an old bfloat16 export); re-export it in fp32")
        return {k: data[k] for k in data.files}


def load_npz_weights(model: torch.nn.Module, path: str | Path) -> list[str]:
    """Load a `save_params_npz` file into the port's RDEIC, strictly. The
    CLIP subtree is skipped (the port does not build CLIP), and so is the
    LPIPS subtree unless the model has one (refine). A refine model loaded
    from a file without LPIPS weights (an independent-phase export) keeps
    its own, as the JAX package's warm start does; returns the top-level
    names of such kept subtrees."""
    has_lpips = hasattr(model, "lpips")
    skip = ("clip/",) if has_lpips else ("clip/", "lpips/")
    flat = {k: v for k, v in load_npz(path).items() if not k.startswith(skip)}
    state = load_jax_params(flat)
    kept = []
    if has_lpips and not any(k.startswith("lpips/") for k in flat):
        state.update({f"lpips.{k}": v for k, v in model.lpips.state_dict().items()})
        kept.append("lpips")
    model.load_state_dict(state, strict=True)
    return kept


def load_train_state_weights(model: torch.nn.Module, path: str | Path) -> None:
    """Load the weights of a `Trainer.save` file into the port's RDEIC,
    strictly. The LPIPS subtree of a refine run is dropped for a model
    without LPIPS, as `load_npz_weights` drops `lpips/`."""
    state = torch.load(path, map_location="cpu", weights_only=True)["model"]
    if not hasattr(model, "lpips"):
        state = {k: v for k, v in state.items() if not k.startswith("lpips.")}
    model.load_state_dict(state, strict=True)
