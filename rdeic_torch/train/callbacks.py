"""Training callbacks: periodic image logging (counterpart of
rdeic_tpu/train/callbacks.py).

`ImageLogger` writes target / VAE reconstruction / relay-sample panels every
N steps; the checkpoint cadence lives in the training CLI's loop, and
`ModelCheckpoint` only keeps the registry's name. Noise is explicit, as
everywhere in the port: the sampler's tensors (`relay_noise`, `step_noise`)
or a `torch.Generator` to draw them.
"""
from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from rdeic_torch.utils.backend import full_fp32
from rdeic_torch.utils.image import encode_png, to_uint8


def model_device(model) -> torch.device:
    return next(model.parameters()).device


@torch.no_grad()
@full_fp32()
def log_inputs(model, img: torch.Tensor):
    """Eval-mode `get_input` of [-1, 1] images, and the VAE's reconstruction
    of their latent: (cond, vae_rec NHWC in [0, 1])."""
    z, cond = model.get_input(img, training=False)
    vae_rec = torch.clamp((model.decode_first_stage(z) + 1) / 2, 0.0, 1.0)
    return cond, vae_rec


def batch_bpp(model, cond: dict, img: torch.Tensor) -> float:
    """The batch's rate: the coded latent's `q_bpp` plus the VQ indices at
    ceil(log2(codebook size)) bits each, over one image's pixels."""
    bits = max(1, math.ceil(math.log2(model.compression.codebook_size)))
    zh, zw = cond["vq_indices"].shape[1:3]
    return float(cond["q_bpp"]) + bits * zh * zw / (img.shape[1] * img.shape[2])


def sample_steps_of(model, sample_steps: int) -> int:
    """The relay sampler's steps: the refine phase's `fixed_step`, else
    `sample_steps`."""
    return model.fixed_step if model.is_refine else sample_steps


def log_images(model, img, sample_steps: int = 5, *,
               generator: torch.Generator | None = None, **noise):
    """({"target", "vae_rec", "samples"} NHWC panels in [0, 1], bpp) of
    [-1, 1] images `img` [B, H, W, 3]. `noise`: the sampler's `relay_noise`
    and `step_noise`; what is not given is drawn from `generator`."""
    img = torch.as_tensor(img, dtype=torch.float32).to(model_device(model))
    cond, vae_rec = log_inputs(model, img)
    samples = model.decode_pipeline(
        cond["c_latent"], cond["guide_hint"], sample_steps_of(model, sample_steps),
        generator=generator, **noise)
    log = {"target": (img + 1) / 2, "vae_rec": vae_rec, "samples": samples}
    return log, batch_bpp(model, cond, img)


def make_grid(batch01: torch.Tensor) -> np.ndarray:
    """[B, H, W, 3] in [0, 1] -> one row of the images, uint8 [H, B W, 3]."""
    arr = np.clip(batch01.detach().float().cpu().numpy(), 0, 1)
    return to_uint8(np.concatenate(list(arr), axis=1))


class ImageLogger:
    """Every `every_n_steps`, `log_images` on the first `max_images` of a
    batch, saved to `<save_dir>/image_log/step_N/{target,vae_rec,samples}.png`
    (each a row of the images) and `bpp.txt`."""

    def __init__(self, save_dir: str | Path, every_n_steps: int = 2000,
                 max_images: int = 4, sample_steps: int = 5):
        self.save_dir = Path(save_dir)
        self.every_n_steps = every_n_steps
        self.max_images = max_images
        self.sample_steps = sample_steps

    def maybe_log(self, model, batch_img, step: int, *,
                  generator: torch.Generator | None = None, write: bool = True,
                  **noise):
        """(the step's directory, `log_images`' panels, bpp) when the step
        logs, else None. Noise as in `log_images`. `write=False` computes
        the panels and writes nothing (a tp rank beside the writer)."""
        if step % self.every_n_steps != 0:
            return None
        log, bpp = log_images(model, batch_img[: self.max_images],
                              self.sample_steps, generator=generator, **noise)
        if not write:
            return None
        out_dir = self.save_dir / "image_log" / f"step_{step}"
        out_dir.mkdir(parents=True, exist_ok=True)
        for key, val in log.items():
            (out_dir / f"{key}.png").write_bytes(encode_png(make_grid(val)))
        (out_dir / "bpp.txt").write_text(f"{bpp:.6f}\n")
        return out_dir, log, bpp


class ModelCheckpoint:
    """Registry-compatible placeholder (the cadence lives in the CLI)."""

    def __init__(self, **kwargs):
        self.kwargs = kwargs
