"""Validation loop: average bpp, PSNR, MS-SSIM and LPIPS, and the share of
the VQ codebook hit (counterpart of rdeic_tpu/train/validation.py)."""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from rdeic_torch.train.callbacks import (
    batch_bpp,
    log_inputs,
    model_device,
    sample_steps_of,
)
from rdeic_torch.utils.metrics import MS_SSIM_MIN_SIDE, MetricSuite


def _applies(name: str, img: torch.Tensor) -> bool:
    """Whether metric `name` is defined on images of `img`'s size: MS-SSIM
    is not under MS_SSIM_MIN_SIDE px a side (the reference reads NaN
    there)."""
    return name != "ms_ssim" or min(img.shape[1:3]) >= MS_SSIM_MIN_SIDE


@torch.no_grad()
def run_validation(model, loader, max_batches: int = 0, sample_steps: int = 5,
                   metric_names: Sequence[str] = ("psnr", "ms_ssim", "lpips"),
                   *, noise: Sequence[dict] | None = None,
                   generator: torch.Generator | None = None,
                   suite: MetricSuite | None = None) -> dict:
    """Up to `max_batches` batches (0: all) of `loader` through eval-mode
    `get_input` and the relay sampler (`fixed_step` steps when refining,
    else `sample_steps`), in the model's compute dtype: {"avg_bpp",
    "avg_<metric>", ..., "usage"}. Batch i's sampler noise is `noise[i]`
    (`relay_noise`, `step_noise`) or drawn from `generator`. A metric that
    is not defined on the images' size reads NaN; any other failure
    raises."""
    suite = suite or MetricSuite()
    fns = {name: suite.create_metric(name) for name in metric_names}
    device = model_device(model)
    usage = torch.zeros(model.compression.codebook_size, dtype=torch.long,
                        device=device)
    steps = sample_steps_of(model, sample_steps)
    rows = []
    for i, batch in enumerate(loader):
        if max_batches and i >= max_batches:
            break
        img = torch.as_tensor(batch["jpg"], dtype=torch.float32).to(device)
        cond, _ = log_inputs(model, img)
        usage += torch.bincount(cond["vq_indices"].reshape(-1),
                                minlength=usage.numel())
        batch_noise = noise[i] if noise is not None else {}
        samples = model.decode_pipeline(cond["c_latent"], cond["guide_hint"],
                                        steps, generator=generator,
                                        **batch_noise)
        a, b = (img + 1) / 2, samples.float()
        row = {"bpp": batch_bpp(model, cond, img)}
        for name, fn in fns.items():
            row[name] = (fn(a, b).mean().item() if _applies(name, a)
                         else float("nan"))
        rows.append(row)
    out = {f"avg_{k}": float(np.nanmean([r[k] for r in rows]))
           for k in rows[0]} if rows else {}
    out["usage"] = (usage > 0).float().mean().item()
    return out
