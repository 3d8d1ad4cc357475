"""Image quality metrics: PSNR, SSIM, MS-SSIM, MSE, MAE and LPIPS
(counterpart of rdeic_tpu/utils/metrics.py).

All take NHWC float tensors in [0, 1] and give one value per image. The
filters run as depthwise `F.conv2d` inside, in full fp32 (`full_fp32`:
cuDNN convolutions would use TF32 on the card otherwise).
"""
from __future__ import annotations

from functools import partial

import numpy as np
import torch
import torch.nn.functional as F

from rdeic_torch.models.lpips import LPIPS, warn_random_backbone
from rdeic_torch.utils.backend import full_fp32
from rdeic_torch.utils.fast_init import fast_random_init

_MSSSIM_WEIGHTS = np.array([0.0448, 0.2856, 0.3001, 0.2363, 0.1333])
# the 11x11 window must fit the coarsest of the 5 levels: 11 * 2^4 px
MS_SSIM_MIN_SIDE = 11 * 2 ** (len(_MSSSIM_WEIGHTS) - 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def psnr(a: torch.Tensor, b: torch.Tensor, crop_border: int = 0) -> torch.Tensor:
    """Peak signal-to-noise ratio per image. a, b: [B, H, W, C] in [0, 1]."""
    if crop_border:
        a = a[:, crop_border:-crop_border, crop_border:-crop_border]
        b = b[:, crop_border:-crop_border, crop_border:-crop_border]
    mse_ = torch.mean((a - b) ** 2, dim=(1, 2, 3))
    return 10.0 * torch.log10(1.0 / torch.clamp(mse_, min=1e-12))


def _fspecial_gauss(size: int, sigma: float, device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    g2 = g[:, None] * g[None, :]
    return g2 / torch.sum(g2)


def _filter2(img: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Valid-mode depthwise 2D filter. img [B, C, H, W], window [k, k]."""
    c = img.shape[1]
    return F.conv2d(img, window.expand(c, 1, *window.shape), groups=c)


def _ssim_components(a, b, window):
    """(SSIM map, contrast-structure map) of NCHW images."""
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mu1 = _filter2(a, window)
    mu2 = _filter2(b, window)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = _filter2(a * a, window) - mu1_sq
    s2 = _filter2(b * b, window) - mu2_sq
    s12 = _filter2(a * b, window) - mu12
    cs = (2 * s12 + c2) / (s1 + s2 + c2)
    ssim_map = ((2 * mu12 + c1) / (mu1_sq + mu2_sq + c1)) * cs
    return ssim_map, cs


@full_fp32()
def ssim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Single-scale SSIM per image (11x11 gaussian window, sigma 1.5)."""
    window = _fspecial_gauss(11, 1.5, a.device)
    ssim_map, _ = _ssim_components(_nchw(a), _nchw(b), window)
    return torch.mean(ssim_map, dim=(1, 2, 3))


@full_fp32()
def ms_ssim(a: torch.Tensor, b: torch.Tensor, levels: int = 5) -> torch.Tensor:
    """Multi-scale SSIM per image: 2x2 average pooling between levels.
    Raises on an image under 11 * 2^(levels - 1) px a side, where the
    window does not fit the coarsest level."""
    side = 11 * 2 ** (levels - 1)
    if min(a.shape[1:3]) < side:
        raise ValueError(f"ms_ssim at {levels} levels needs H, W >= {side}, "
                         f"got {tuple(a.shape[1:3])}")
    window = _fspecial_gauss(11, 1.5, a.device)
    weights = torch.tensor(_MSSSIM_WEIGHTS[:levels], dtype=torch.float32,
                           device=a.device)
    a, b = _nchw(a), _nchw(b)
    vals = []
    for i in range(levels):
        ssim_map, cs = _ssim_components(a, b, window)
        if i == levels - 1:
            vals.append(torch.mean(ssim_map, dim=(1, 2, 3)))
        else:
            vals.append(torch.mean(cs, dim=(1, 2, 3)))
            a, b = F.avg_pool2d(a, 2), F.avg_pool2d(b, 2)
    vals = torch.stack(vals)  # [levels, B]
    return torch.prod(torch.clamp(vals, min=0) ** weights[:, None], dim=0)


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a - b) ** 2, dim=(1, 2, 3))


def mae(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(a - b), dim=(1, 2, 3))


class MetricSuite:
    """pyiqa-style registry: `create_metric(name)` -> callable(a, b) -> [B].

    LPIPS runs the port's net on `lpips_params` (a state dict of
    rdeic_torch.models.lpips.LPIPS, e.g. a JAX one carried across by
    utils/convert.py) when given, else on random weights made from seed 0,
    with `warn_random_backbone`: their values compare runs, not papers."""

    def __init__(self, lpips_params: dict | None = None, lpips_net: str = "alex"):
        self._lpips_params = lpips_params
        self._lpips_name = lpips_net
        self._lpips_net = None

    def create_metric(self, name: str, **opts):
        crop = int(opts.get("crop_border", 0) or 0)
        simple = {"psnr": partial(psnr, crop_border=crop), "ssim": ssim,
                  "ms_ssim": ms_ssim, "mse": mse, "mae": mae}
        if name in simple:
            return simple[name]
        if name == "lpips":
            return self._lpips
        if name == "niqe":
            raise NotImplementedError(
                "niqe: the pristine model fit of utils/niqe.py is not ported "
                "(ROADMAP Queue 1, the rest)")
        raise ValueError(f"unknown metric {name!r}")

    def _net(self, device: torch.device):
        """The LPIPS net, made on the first call's device."""
        if self._lpips_net is None:
            with torch.device("meta"):
                net = LPIPS(self._lpips_name)
            if self._lpips_params is None:
                warn_random_backbone("MetricSuite")
                fast_random_init(net, device, seed=0)
            else:
                net.load_state_dict(self._lpips_params, strict=True, assign=True)
            self._lpips_net = net.eval()
        return self._lpips_net.to(device)

    @torch.no_grad()
    @full_fp32()
    def _lpips(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """LPIPS of [0, 1] images (the net takes [-1, 1])."""
        return self._net(a.device)(a * 2 - 1, b * 2 - 1)
