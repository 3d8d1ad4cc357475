"""Checkerboard anchor / non-anchor packing, NHWC (counterpart of
rdeic_tpu/ops/ckbd.py).

Anchor = (even row, odd col) + (odd row, even col); non-anchor is the
complement. The masks zero one half in place (the training forward);
"squeeze" packs one half into a dense [B, H, W//2, C] tensor in the
row-major order the bitstream codes its symbols in; "unsqueeze" is the exact
inverse (zeros elsewhere).
"""
from __future__ import annotations

import torch


def _checkerboard(y: torch.Tensor, anchor: bool) -> torch.Tensor:
    """[H, W, 1] mask in y's dtype: 1 where (row + col) is odd for the
    anchor half, where it is even for the non-anchor half."""
    h, w = y.shape[1:3]
    parity = (torch.arange(h, device=y.device)[:, None]
              + torch.arange(w, device=y.device)[None, :]) % 2
    mask = parity if anchor else 1 - parity
    return mask[..., None].to(y.dtype)


def ckbd_anchor(y: torch.Tensor) -> torch.Tensor:
    """Zero the non-anchor positions of NHWC `y`."""
    return y * _checkerboard(y, anchor=True)


def ckbd_nonanchor(y: torch.Tensor) -> torch.Tensor:
    """Zero the anchor positions of NHWC `y`."""
    return y * _checkerboard(y, anchor=False)


def ckbd_split(y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return ckbd_anchor(y), ckbd_nonanchor(y)


def ckbd_merge(anchor: torch.Tensor, nonanchor: torch.Tensor) -> torch.Tensor:
    return anchor + nonanchor


def _interleave_rows(even_rows: torch.Tensor, odd_rows: torch.Tensor) -> torch.Tensor:
    b, h2, w2, c = even_rows.shape
    return torch.stack([even_rows, odd_rows], dim=2).reshape(b, 2 * h2, w2, c)


def ckbd_anchor_squeeze(y: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> anchor half [B, H, W//2, C]."""
    return _interleave_rows(y[:, 0::2, 1::2], y[:, 1::2, 0::2])


def ckbd_nonanchor_squeeze(y: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> non-anchor half [B, H, W//2, C]."""
    return _interleave_rows(y[:, 0::2, 0::2], y[:, 1::2, 1::2])


def _unsqueeze(half: torch.Tensor, even_col: int) -> torch.Tensor:
    b, h, w2, c = half.shape
    rows = half.reshape(b, h // 2, 2, w2, c)
    out = half.new_zeros((b, h, 2 * w2, c))
    out[:, 0::2, even_col::2] = rows[:, :, 0]
    out[:, 1::2, 1 - even_col::2] = rows[:, :, 1]
    return out


def ckbd_anchor_unsqueeze(anchor: torch.Tensor) -> torch.Tensor:
    """Inverse of ckbd_anchor_squeeze: [B, H, W2, C] -> [B, H, 2*W2, C]."""
    return _unsqueeze(anchor, 1)


def ckbd_nonanchor_unsqueeze(nonanchor: torch.Tensor) -> torch.Tensor:
    """Inverse of ckbd_nonanchor_squeeze."""
    return _unsqueeze(nonanchor, 0)
