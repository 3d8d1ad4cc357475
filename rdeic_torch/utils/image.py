"""Image conversions of the inference path (counterpart of the same functions
in rdeic_tpu/utils/image.py)."""
from __future__ import annotations

import numpy as np


def pad(img: np.ndarray, scale: int = 64) -> np.ndarray:
    """Zero-pad bottom/right so H and W are multiples of `scale` (HWC or
    NHWC)."""
    h, w = img.shape[-3], img.shape[-2]
    ph = (scale - h % scale) % scale
    pw = (scale - w % scale) % scale
    if ph == 0 and pw == 0:
        return img
    pad_width = [(0, 0)] * (img.ndim - 3) + [(0, ph), (0, pw), (0, 0)]
    return np.pad(img, pad_width)


def to_float01(img_uint8: np.ndarray) -> np.ndarray:
    return img_uint8.astype(np.float32) / 255.0


def to_uint8(img01: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(img01) * 255.0, 0, 255).astype(np.uint8)
