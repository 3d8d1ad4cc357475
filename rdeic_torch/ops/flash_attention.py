"""Flash-attention forward: the hand-written CUDA kernel and its plain version.

Replaces ``rdeic_tpu/ops/flash_attention.py`` ``_flash_kernel`` (through
``_flash_forward(save_residuals=False)``). The kernel is
``rdeic_torch/csrc/flash_attn_fwd.cu``; its header states the design and the
bound. The backward kernels (``_dq_kernel``, ``_dkv_kernel``) and the
forward that saves the logsumexp belong to the training slice.

``flash_attention`` runs the plain version for a tensor on the CPU and the
kernel for a tensor on the card; on the card it never falls back.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from rdeic_torch import build

HEAD_DIMS = (16, 64, 512)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """softmax(Q K^T * d^-1/2) V in fp32, [B, L, H, D] -> [B, L, H, D] in the
    input dtype: the function the kernel computes, without tiling."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build.build_flash()))
    vp = ctypes.c_void_p
    lib.rdeic_flash_attn_fwd.restype = ctypes.c_int
    lib.rdeic_flash_attn_fwd.argtypes = [
        vp, vp, vp, vp, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, vp,
    ]
    lib.rdeic_cuda_error_string.restype = ctypes.c_char_p
    lib.rdeic_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError("flash_attention takes self-attention q/k/v of one "
                         f"[B, L, H, D] shape, got {q.shape}, {k.shape}, "
                         f"{v.shape}")
    if q.dtype not in _DTYPE_CODES or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash_attention takes fp32 or bf16, got {q.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[-1]} not in {HEAD_DIMS}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention takes contiguous [B, L, H, D]")


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Self-attention q/k/v [B, L, H, D] -> [B, L, H, D].

    CPU tensors take the plain version; CUDA tensors launch the kernel (or
    raise). `flash_attention.launches` counts kernel launches and
    `flash_attention.shapes` tallies them by (B, L, H, D, dtype).
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    _check(q, k, v)
    b, seq, h, d = q.shape
    o = torch.empty_like(q)
    lib = _library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.rdeic_flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            b, seq, h, d, _DTYPE_CODES[q.dtype], d ** -0.5, stream)
    if err != 0:
        msg = (lib.rdeic_cuda_error_string(err).decode() if err > 0
               else "unsupported head dim or dtype")
        raise RuntimeError(f"flash_attn_fwd launch failed: {msg}")
    flash_attention.launches += 1
    key = (b, seq, h, d, str(q.dtype).removeprefix("torch."))
    flash_attention.shapes[key] = flash_attention.shapes.get(key, 0) + 1
    return o


flash_attention.launches = 0
flash_attention.shapes = {}
