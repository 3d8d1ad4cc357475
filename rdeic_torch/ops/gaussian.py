"""Conditional-Gaussian entropy tables (counterpart of rdeic_tpu/ops/gaussian.py).

The inference path needs the 64-level scale table, the scale -> table index
map, and the quantized CDFs the rANS coder reads, built once on the host in
float64. The training-only likelihood and lower bound come with the training
slice.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from scipy.special import erfc

SCALE_BOUND = 0.11
CDF_PRECISION = 16
TAIL_MASS = 1e-9


def get_scale_table(minimum: float = SCALE_BOUND, maximum: float = 256.0,
                    levels: int = 64) -> np.ndarray:
    return np.exp(np.linspace(math.log(minimum), math.log(maximum), levels))


def build_indexes(scales: torch.Tensor, scale_table: np.ndarray) -> torch.Tensor:
    """Index of the smallest table entry >= scale (after lower-bounding),
    compared in the scales' dtype."""
    scales = torch.clamp(scales, min=float(np.float32(scale_table[0])))
    table = torch.as_tensor(scale_table[:-1], dtype=scales.dtype,
                            device=scales.device)
    return (scales[..., None] > table).sum(dim=-1).to(torch.int32)


def _std_quantile(q: float) -> float:
    """Inverse standard normal CDF by bisection on erfc (float64)."""
    lo, hi = -40.0, 40.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if 0.5 * math.erfc(-mid / math.sqrt(2)) < q:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def pmf_to_quantized_cdf(pmf: np.ndarray, precision: int = CDF_PRECISION):
    """Quantize a PMF (tail mass last) to an integer CDF summing to
    2**precision with every symbol width >= 1; int32, cdf[0] = 0."""
    pmf = np.asarray(pmf, dtype=np.float64)
    if np.any(pmf < 0) or not np.all(np.isfinite(pmf)):
        raise ValueError("invalid pmf")
    total = 1 << precision
    freqs = np.maximum(1, np.round(pmf / max(pmf.sum(), 1e-300) * total)).astype(
        np.int64)
    # rebalance on the largest bins, which lose the least rate
    diff = int(freqs.sum()) - total
    while diff != 0:
        for i in np.argsort(-freqs):
            if diff == 0:
                break
            if diff > 0 and freqs[i] > 1:
                take = min(diff, int(freqs[i]) - 1)
                freqs[i] -= take
                diff -= take
            elif diff < 0:
                freqs[i] += -diff
                diff = 0
    cdf = np.zeros(len(pmf) + 1, dtype=np.int32)
    np.cumsum(freqs, out=cdf[1:])
    if cdf[-1] != total:
        raise ValueError("quantized cdf does not sum to 2**precision")
    return cdf


def build_cdf_tables(scale_table: np.ndarray, precision: int = CDF_PRECISION):
    """Per-scale quantized CDFs: (cdf int32 [L, max_len], cdf_length int32
    [L], offset int32 [L]). Symbol s of level l codes value s + offset[l];
    the last in-range symbol, cdf_length[l] - 2, is the escape."""
    scale_table = np.asarray(scale_table, dtype=np.float64)
    multiplier = -_std_quantile(TAIL_MASS / 2)
    pmf_center = np.ceil(scale_table * multiplier).astype(np.int64)
    pmf_length = 2 * pmf_center + 1
    max_length = int(pmf_length.max())
    samples = np.abs(
        np.arange(max_length, dtype=np.float64)[None, :] - pmf_center[:, None])
    scales = scale_table[:, None]
    upper = 0.5 * erfc(-((0.5 - samples) / scales) / math.sqrt(2))
    lower = 0.5 * erfc(-((-0.5 - samples) / scales) / math.sqrt(2))
    pmf = upper - lower
    tail = 2 * lower[:, :1]
    num = len(scale_table)
    cdf_length = (pmf_length + 2).astype(np.int32)
    quantized = np.zeros((num, max_length + 2), dtype=np.int32)
    for i in range(num):
        n = int(pmf_length[i])
        cdf = pmf_to_quantized_cdf(np.concatenate([pmf[i, :n], tail[i]]),
                                   precision)
        quantized[i, :len(cdf)] = cdf
    return quantized, cdf_length, (-pmf_center).astype(np.int32)
