"""Attention dispatch (counterpart of rdeic_tpu/ops/attention.py).

Long self-attention on the card goes to the flash kernel; everything else
(short sequences, the 77-token cross-attention, the CPU) to `sdp_attention`.
"""
from __future__ import annotations

import torch

from rdeic_torch.ops.flash_attention import flash_attention

FLASH_MIN_TOKENS = 1024


def sdp_attention(q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """q [B, Lq, H, D], k/v [B, Lk, H, D] -> [B, Lq, H, D]: a plain product
    and an fp32 softmax."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    lq, lk = q.shape[1], k.shape[1]
    if q.is_cuda and lq == lk and lq >= FLASH_MIN_TOKENS:
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    return sdp_attention(q, k, v)
