"""The port's weights out to the JAX package, and back in (counterpart of
rdeic_tpu/utils/checkpoint_io.py's flat `.npz` functions).

`save_params_npz(path, model)` writes the flat "/"-joined flax-path `.npz`
that every CLI of the JAX package reads (`load_params_npz`): the inverse of
utils/convert.py's `load_jax_params`, leaf by leaf,

    `weight` [out, in, kh, kw] -> conv  `kernel` [kh, kw, in, out]
    `weight` [out, in]         -> dense `kernel` [in, out]
    another `weight`           -> norm  `scale`
    the rest                   -> unchanged (`fast_init.flax_path` names it)

bf16 tensors are written as fp32 (exactly), as the JAX function upcasts
its bf16 leaves, and tp-sharded kernels are gathered whole first
(`parallel.mesh.gather_state_dict`). The way in is utils/convert.py's:
`load_params_npz` is its `load_npz`, and `load_npz_weights` has the JAX
`warm_start_overlay`'s semantics for a phase switch (the subtrees the file
lacks stay as they are, and it returns their names). Orbax directories of
the JAX package are neither read nor written here.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from rdeic_torch.parallel.mesh import gather_state_dict
from rdeic_torch.utils.convert import load_npz as load_params_npz  # noqa: F401
from rdeic_torch.utils.convert import load_npz_weights  # noqa: F401
from rdeic_torch.utils.fast_init import flax_path


def jax_leaf(name: str, tensor: torch.Tensor) -> tuple[str, np.ndarray]:
    """The flat flax path and fp32 (or integer) array of the port's tensor
    `name`: the inverse of `convert_leaf`."""
    path, _ = flax_path(name, tensor)
    x = tensor.detach().cpu()
    if x.is_floating_point():
        x = x.float()
    arr = x.numpy()
    if path[-1] == "kernel":
        arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
    return "/".join(path), np.ascontiguousarray(arr)


def state_to_flat(state: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """A state dict of the port's modules -> the flat flax params dict."""
    flat = {}
    for name, tensor in state.items():
        key, arr = jax_leaf(name, tensor)
        if key in flat:
            raise ValueError(f"two tensors map to {key}")
        flat[key] = arr
    return flat


def save_params_npz(path: str | Path, model: torch.nn.Module) -> None:
    """Write `model`'s weights as the JAX package's `save_params_npz` file.
    On a tensor-parallel mesh every rank of each tp group must call it (the
    gather); rank 0 of the process group writes."""
    flat = state_to_flat(gather_state_dict(model))
    if dist.is_available() and dist.is_initialized() and dist.get_rank() != 0:
        return
    np.savez(path, **flat)
