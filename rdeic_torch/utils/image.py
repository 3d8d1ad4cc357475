"""Image crops, augmentation and conversions (counterpart of the same
functions in rdeic_tpu/utils/image.py), an image reader and a PNG writer.
PIL is imported inside the functions that read or resize, because the
card's machine has no PIL; `encode_png` needs only zlib."""
from __future__ import annotations

import math
import random
import struct
import zlib

import numpy as np


def _halve_then_resize(pil_image, smaller: int):
    """Box-halve while the short side is >= 2 * smaller, then bicubic-resize
    it to `smaller`; returns an array."""
    from PIL import Image  # noqa: PLC0415

    while min(*pil_image.size) >= 2 * smaller:
        pil_image = pil_image.resize(tuple(x // 2 for x in pil_image.size),
                                     resample=Image.BOX)
    scale = smaller / min(*pil_image.size)
    pil_image = pil_image.resize(tuple(round(x * scale) for x in pil_image.size),
                                 resample=Image.BICUBIC)
    return np.array(pil_image)


def center_crop_arr(pil_image, image_size: int) -> np.ndarray:
    """Downscale so the short side is image_size, then center-crop."""
    arr = _halve_then_resize(pil_image, image_size)
    cy = (arr.shape[0] - image_size) // 2
    cx = (arr.shape[1] - image_size) // 2
    return arr[cy: cy + image_size, cx: cx + image_size]


def random_crop_arr(pil_image, image_size: int, min_crop_frac: float = 0.8,
                    max_crop_frac: float = 1.0,
                    rng: random.Random | None = None) -> np.ndarray:
    """Random-scale then random-crop (guided-diffusion semantics)."""
    rng = rng or random
    min_smaller = math.ceil(image_size / max_crop_frac)
    max_smaller = math.ceil(image_size / min_crop_frac)
    arr = _halve_then_resize(pil_image, rng.randrange(min_smaller, max_smaller + 1))
    cy = rng.randrange(arr.shape[0] - image_size + 1)
    cx = rng.randrange(arr.shape[1] - image_size + 1)
    return arr[cy: cy + image_size, cx: cx + image_size]


def augment(img: np.ndarray, hflip: bool = True, rotation: bool = True,
            rng: random.Random | None = None) -> np.ndarray:
    """Random horizontal flip and 90-degree rotations (HWC)."""
    rng = rng or random
    if hflip and rng.random() < 0.5:
        img = img[:, ::-1]
    if rotation:
        img = np.rot90(img, rng.randrange(4))
    return np.ascontiguousarray(img)


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


def rgb2ycbcr(img01: np.ndarray, y_only: bool = True) -> np.ndarray:
    """RGB [0,1] -> YCbCr (BT.601, as the reference's rgb2ycbcr_pt)."""
    m = np.array(
        [[65.481, 128.553, 24.966],
         [-37.797, -74.203, 112.0],
         [112.0, -93.786, -18.214]], dtype=np.float32,
    )
    out = img01 @ m.T + np.array([16.0, 128.0, 128.0], np.float32)
    out = out / 255.0
    return out[..., :1] if y_only else out


def usm_sharp(img01: np.ndarray, weight: float = 0.5, radius: int = 50,
              threshold: float = 10 / 255.0) -> np.ndarray:
    """Unsharp masking (role parity: utils/image/usm_sharp.py)."""
    from scipy.ndimage import gaussian_filter  # noqa: PLC0415

    blur = gaussian_filter(img01, sigma=(radius / 6, radius / 6, 0))
    residual = img01 - blur
    mask = (np.abs(residual) > threshold).astype(np.float32)
    soft_mask = gaussian_filter(mask, sigma=(radius / 6, radius / 6, 0))
    sharp = np.clip(img01 + weight * residual, 0, 1)
    return soft_mask * sharp + (1 - soft_mask) * img01


def read_rgb(path) -> np.ndarray:
    """An image file as uint8 [H, W, 3] RGB (PIL)."""
    from PIL import Image  # noqa: PLC0415

    return np.array(Image.open(path).convert("RGB"))


PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data)))


def encode_png(img: np.ndarray) -> bytes:
    """An 8-bit RGB image [H, W, 3] uint8 as a PNG file's bytes: one IDAT
    chunk, every row with filter 0 (none), zlib-compressed."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3] uint8, got {img.shape} {img.dtype}")
    h, w, _ = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, 3 * w)],
                          axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    return (PNG_SIGNATURE + _png_chunk(b"IHDR", header)
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _png_chunk(b"IEND", b""))
