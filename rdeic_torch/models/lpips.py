"""LPIPS perceptual distance: AlexNet and VGG16 backbones (counterpart of
rdeic_tpu/models/lpips.py).

Images are NHWC in [-1, 1], as in the JAX package; the networks run NCHW
inside. Attribute names mirror the flax paths (`backbone.conv1`, `lin0`, no
bias on the `lin{i}` heads), so a JAX checkpoint's `lpips/` subtree loads
through rdeic_torch.utils.convert. The refine loss uses the AlexNet version.
No backbone weights ship with the repository: the net runs on whatever
weights it is given (random ones warn, see `warn_random_backbone`). Every
convolution promotes, as the JAX package's (flax Convs without `dtype`):
bf16-stored weights compute in fp32 on the fp32 images.
"""
from __future__ import annotations

import warnings
from pathlib import Path

import torch
import torch.nn.functional as F
from torch import nn

from rdeic_torch.models.blocks import PromotedConv2d

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

_warned_contexts: set = set()


def warn_random_backbone(context: str) -> None:
    """Warn once per `context` that LPIPS runs on a random backbone: its
    values are a random-projection distance, usable for comparisons within
    one run, not comparable to published LPIPS numbers."""
    if context in _warned_contexts:
        return
    _warned_contexts.add(context)
    warnings.warn(
        f"LPIPS[{context}]: backbone weights are RANDOM-INIT; values are not "
        "comparable to published LPIPS numbers. Load a pretrained AlexNet/VGG "
        "backbone for real perceptual scores.", stacklevel=3)


def _normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """x over its channel norm (dim 1, NCHW)."""
    return x / (torch.sqrt(torch.sum(x ** 2, dim=1, keepdim=True)) + eps)


class AlexNetFeatures(nn.Module):
    """AlexNet feature extractor; the five post-ReLU taps."""

    def __init__(self):
        super().__init__()
        self.conv1 = PromotedConv2d(3, 64, 11, stride=4, padding=2)
        self.conv2 = PromotedConv2d(64, 192, 5, padding=2)
        self.conv3 = PromotedConv2d(192, 384, 3, padding=1)
        self.conv4 = PromotedConv2d(384, 256, 3, padding=1)
        self.conv5 = PromotedConv2d(256, 256, 3, padding=1)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        taps = [F.relu(self.conv1(x))]
        taps.append(F.relu(self.conv2(F.max_pool2d(taps[-1], 3, 2))))
        taps.append(F.relu(self.conv3(F.max_pool2d(taps[-1], 3, 2))))
        taps.append(F.relu(self.conv4(taps[-1])))
        taps.append(F.relu(self.conv5(taps[-1])))
        return taps


class VGG16Features(nn.Module):
    """VGG16 feature extractor; taps after relu1_2/2_2/3_3/4_3/5_3."""

    STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))

    def __init__(self):
        super().__init__()
        cin, idx = 3, 0
        for ch, n in self.STAGES:
            for _ in range(n):
                self.add_module(f"conv{idx}", PromotedConv2d(cin, ch, 3, padding=1))
                cin, idx = ch, idx + 1

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        taps, idx = [], 0
        for stage, (_, n) in enumerate(self.STAGES):
            if stage:
                x = F.max_pool2d(x, 2, 2)
            for _ in range(n):
                x = F.relu(getattr(self, f"conv{idx}")(x))
                idx += 1
            taps.append(x)
        return taps


class LPIPS(nn.Module):
    """Learned perceptual distance between two [-1, 1] RGB images (NHWC):
    [B]."""

    def __init__(self, net: str = "alex"):
        super().__init__()
        if net == "alex":
            self.backbone = AlexNetFeatures()
            widths = (64, 192, 384, 256, 256)
        elif net == "vgg":
            self.backbone = VGG16Features()
            widths = (64, 128, 256, 512, 512)
        else:
            raise ValueError(f"LPIPS net {net!r}: 'alex' or 'vgg'")
        self.net = net
        for i, c in enumerate(widths):
            self.add_module(f"lin{i}", PromotedConv2d(c, 1, 1, bias=False))

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        shift, scale = (torch.tensor(c, device=x.device, dtype=x.dtype)
                        .reshape(1, 3, 1, 1) for c in (_SHIFT, _SCALE))

        def feats(img):
            return self.backbone((img.permute(0, 3, 1, 2) - shift) / scale)

        total = 0.0
        for i, (fx, fy) in enumerate(zip(feats(x), feats(y))):
            diff = (_normalize(fx) - _normalize(fy)) ** 2
            total = total + getattr(self, f"lin{i}")(diff).mean(dim=(1, 2, 3))
        return total


@torch.no_grad()
def load_lin_weights(lpips: LPIPS, pth_path: str | Path) -> None:
    """Copy the published linear heads (`lin{i}.model.1.weight`, [1, C, 1,
    1], the only tensors of the lpips package's `alex.pth` / `vgg.pth`) into
    `lpips`. The backbone keeps the weights it has."""
    sd = torch.load(pth_path, map_location="cpu", weights_only=True)
    for i in range(5):
        lin = getattr(lpips, f"lin{i}").weight
        w = sd[f"lin{i}.model.1.weight"]
        if w.shape != lin.shape:
            raise ValueError(f"lin{i} shape mismatch: model {tuple(lin.shape)} "
                             f"vs pth {tuple(w.shape)}")
        lin.copy_(w)
