"""Flash attention: the hand-written CUDA kernels, their plain versions, and
the autograd function that joins them.

Replaces ``rdeic_tpu/ops/flash_attention.py``: ``_flash_kernel`` (through
``_flash_forward``, with and without ``save_residuals``) by
``rdeic_torch/csrc/flash_attn_fwd.cu``, and ``_dq_kernel`` / ``_dkv_kernel``
(``_flash_backward``) by ``rdeic_torch/csrc/flash_attn_bwd.cu``; each file's
header states the design and the bound.

``flash_attention`` is differentiable. When autograd needs it (grad enabled
and an input that requires grad), it runs the forward that also writes the
row logsumexp, and its backward runs the dq and dkv kernels; otherwise it
runs the plain forward kernel. A tensor on the CPU takes the plain versions;
a tensor on the card launches the kernels, never falls back, and raises
what they do not take.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch

from rdeic_torch import build

HEAD_DIMS = (16, 64, 512)  # forward and backward
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """fp32 arithmetic for fp32 and bf16; float64 stays float64 (gradcheck)."""
    return torch.promote_types(dtype, torch.float32)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """softmax(Q K^T * d^-1/2) V in fp32, [B, L, H, D] -> [B, L, H, D] in the
    input dtype: the function the kernel computes, without tiling."""
    ct = _compute_dtype(q.dtype)
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(ct) * scale, k.to(ct))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.to(ct)).to(q.dtype)


def flash_attention_lse_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor):
    """(output [B, L, H, D], lse [B*H, L] fp32): the forward that saves the
    row logsumexp of the scaled scores for the backward."""
    ct = _compute_dtype(q.dtype)
    b, seq, h, _ = q.shape
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(ct) * scale, k.to(ct))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.to(ct)).to(q.dtype)
    return o, lse.reshape(b * h, seq)


def flash_attention_bwd_plain(q, k, v, o, lse, do):
    """(dq, dk, dv) from the saved output and lse, by the formulas of the
    dq and dkv kernels (not through autograd): P = exp(S - lse),
    dS = P (dO V^T - rowsum(dO O)) scale, dq = dS K, dk = dS^T Q, dv = P^T dO."""
    ct = _compute_dtype(q.dtype)
    b, seq, h, d = q.shape
    scale = d ** -0.5
    qf, kf, vf, dof = (x.to(ct) for x in (q, k, v, do))
    s = scale * torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    p = torch.exp(s - lse.to(ct).reshape(b, h, seq)[..., None])
    di = (dof * o.to(ct)).sum(-1).transpose(1, 2)  # [B, H, L]
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - di[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@functools.lru_cache(maxsize=None)
def _fwd_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build.build_flash()))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.rdeic_flash_attn_fwd.restype = i
    lib.rdeic_flash_attn_fwd.argtypes = [
        vp, vp, vp, vp, vp, i, i, i, i, i, ctypes.c_float, vp]
    lib.rdeic_cuda_error_string.restype = ctypes.c_char_p
    lib.rdeic_cuda_error_string.argtypes = [i]
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build.build_flash_bwd()))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.rdeic_flash_attn_bwd_dq.restype = i
    lib.rdeic_flash_attn_bwd_dq.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, vp, i, i, i, i, i, ctypes.c_float, vp]
    lib.rdeic_flash_attn_bwd_dkv.restype = i
    lib.rdeic_flash_attn_bwd_dkv.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, vp, i, i, i, i, i, ctypes.c_float, vp]
    lib.rdeic_flash_bwd_error_string.restype = ctypes.c_char_p
    lib.rdeic_flash_bwd_error_string.argtypes = [i]
    lib.rdeic_flash_bwd_d16_bf16_carveout.restype = i
    lib.rdeic_flash_bwd_d16_bf16_carveout.argtypes = [
        i, ctypes.POINTER(i), ctypes.POINTER(i)]
    return lib


def d16_bf16_carveout(index: int) -> tuple[int, int]:
    """The shared-memory carveout (percent) that `flash_dq_d16_bf16` and
    `flash_dkv_d16_bf16` prefer on CUDA device `index`: 100 once a launch
    there prepared them, -1 (CUDA's default) before."""
    dq, dkv = ctypes.c_int(), ctypes.c_int()
    lib = _bwd_library()
    err = lib.rdeic_flash_bwd_d16_bf16_carveout(index, ctypes.byref(dq),
                                                ctypes.byref(dkv))
    _raise_on(err, "rdeic_flash_bwd_d16_bf16_carveout", lib,
              "rdeic_flash_bwd_error_string")
    return dq.value, dkv.value


def _check(*xs: torch.Tensor) -> None:
    q = xs[0]
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    if q.dim() != 4 or any(x.shape != q.shape for x in xs):
        raise ValueError("flash_attention takes self-attention tensors of one "
                         f"[B, L, H, D] shape, got {[tuple(x.shape) for x in xs]}")
    if q.dtype not in _DTYPE_CODES or any(x.dtype != q.dtype for x in xs):
        raise ValueError(f"flash_attention takes fp32 or bf16, got "
                         f"{[x.dtype for x in xs]}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[-1]} not in {HEAD_DIMS}")
    if any(x.device != q.device for x in xs):
        raise ValueError("flash_attention tensors must be on one device")
    if not all(x.is_contiguous() for x in xs):
        raise ValueError("flash_attention takes contiguous [B, L, H, D]")


def _check_rows(q: torch.Tensor, *rows: torch.Tensor) -> None:
    b, seq, h, _ = q.shape
    for r in rows:
        if (r.shape != (b * h, seq) or r.dtype != torch.float32
                or r.device != q.device or not r.is_contiguous()):
            raise ValueError(f"row terms must be contiguous fp32 [B*H, L] = "
                             f"{(b * h, seq)} on {q.device}, got "
                             f"{tuple(r.shape)} {r.dtype}")


def _raise_on(err: int, name: str, lib, to_string) -> None:
    if err != 0:
        msg = (getattr(lib, to_string)(err).decode() if err > 0
               else "unsupported head dim or dtype")
        raise RuntimeError(f"{name} launch failed: {msg}")


# serving replicas launch from one thread each: a count is a read and a write
_TALLY_LOCK = threading.Lock()


def _tally(fn, q: torch.Tensor) -> None:
    """One launch of `fn`'s kernel, tallied by (B, L, H, D, dtype)."""
    key = (*q.shape, str(q.dtype).removeprefix("torch."))
    with _TALLY_LOCK:
        fn.launches += 1
        fn.shapes[key] = fn.shapes.get(key, 0) + 1


def _forward_kernel(q, k, v, lse) -> torch.Tensor:
    _check(q, k, v)
    b, seq, h, d = q.shape
    o = torch.empty_like(q)
    lib = _fwd_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.rdeic_flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(),
            b, seq, h, d, _DTYPE_CODES[q.dtype], d ** -0.5, stream)
    _raise_on(err, "flash_attn_fwd", lib, "rdeic_cuda_error_string")
    return o


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """(output, lse [B*H, L] fp32) for the backward. CUDA tensors launch the
    forward kernel with its lse output (counted in
    `flash_attention_lse.launches`); CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return flash_attention_lse_plain(q, k, v)
    b, seq, h, _ = q.shape
    lse = torch.empty((b * h, seq), device=q.device, dtype=torch.float32)
    o = _forward_kernel(q, k, v, lse)
    _tally(flash_attention_lse, q)
    return o, lse


def flash_attention_dq(q, k, v, o, lse, do):
    """(dq, di): the dq kernel, which also writes di = rowsum(dO * O)
    [B*H, L] fp32 for the dkv kernel. CUDA only; counted in
    `flash_attention_dq.launches`."""
    _check(q, k, v, o, do)
    _check_rows(q, lse)
    b, seq, h, d = q.shape
    dq = torch.empty_like(q)
    di = torch.empty_like(lse)
    lib = _bwd_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.rdeic_flash_attn_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dq.data_ptr(), di.data_ptr(),
            b, seq, h, d, _DTYPE_CODES[q.dtype], d ** -0.5, stream)
    _raise_on(err, "flash_attn_bwd_dq", lib, "rdeic_flash_bwd_error_string")
    _tally(flash_attention_dq, q)
    return dq, di


def flash_attention_dkv(q, k, v, do, lse, di):
    """(dk, dv): the dkv kernel, from the lse of the forward and the di of
    the dq kernel. CUDA only; counted in `flash_attention_dkv.launches`."""
    _check(q, k, v, do)
    _check_rows(q, lse, di)
    b, seq, h, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _bwd_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.rdeic_flash_attn_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, seq, h, d, _DTYPE_CODES[q.dtype], d ** -0.5, stream)
    _raise_on(err, "flash_attn_bwd_dkv", lib, "rdeic_flash_bwd_error_string")
    _tally(flash_attention_dkv, q)
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do):
    """(dq, dk, dv): the dq then the dkv kernel on CUDA tensors, the plain
    backward on CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do)
    dq, di = flash_attention_dq(q, k, v, o, lse, do)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, di)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = flash_attention_lse(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return flash_attention_bwd(q, k, v, o, lse, do.contiguous())


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Self-attention q/k/v [B, L, H, D] -> [B, L, H, D], differentiable.

    Without autograd, CUDA tensors launch the plain forward kernel (counted
    in `flash_attention.launches`, tallied by (B, L, H, D, dtype) in
    `flash_attention.shapes`); CPU tensors take the plain version.
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    o = _forward_kernel(q, k, v, None)
    _tally(flash_attention, q)
    return o


for _fn in (flash_attention, flash_attention_lse, flash_attention_dq,
            flash_attention_dkv):
    _fn.launches = 0
    _fn.shapes = {}
