"""RDEIC inference surface (counterpart of rdeic_tpu/pipeline/rdeic.py).

`RDEIC` is built from the same config dict as the JAX class. Its module tree
(`vae`, `compression`, `denoiser`, and the `uncond_context` and
`vq_embed_prob` buffers) mirrors the JAX params tree, so a JAX checkpoint
loads through rdeic_torch.utils.convert with one rule.

The main path: image -> VAE `encode_hc` -> compression + host rANS ->
bitstream file -> decompress to (c_latent, guide_hint) -> relay init at
t = used_timesteps - 1 -> spaced-DDPM over the dual UNet -> VAE decode.
Noise is explicit: pass the tensors, or a `torch.Generator` to draw them.

Numerics: the VAE and the denoiser run in full fp32 (`full_fp32`: no TF32,
which cuDNN convolutions would use by default), so the card computes what the
CPU reference computes; the codec adds its own deterministic settings.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Mapping, Optional, Sequence

import torch
from torch import nn

from rdeic_torch.diffusion import spaced
from rdeic_torch.diffusion.schedule import NoiseSchedule
from rdeic_torch.models.compression import CompressionModel
from rdeic_torch.models.unet import NoiseEstimator
from rdeic_torch.models.vae import AutoencoderKL
from rdeic_torch.pipeline.codec import CompressionCodec
from rdeic_torch.utils.backend import full_fp32, resolve_device
from rdeic_torch.utils.bitstream import filesize, read_body, write_body


def _cfg_params(cfg: Optional[Mapping[str, Any]]) -> dict:
    if cfg is None:
        return {}
    if "params" in cfg or "target" in cfg:
        return dict(cfg.get("params") or {})
    return dict(cfg)


class RDEIC(nn.Module):
    """Relay-residual diffusion extreme image compression (inference)."""

    def __init__(self, control_stage_config: Optional[Mapping] = None,
                 unet_config: Optional[Mapping] = None,
                 first_stage_config: Optional[Mapping] = None,
                 preprocess_config: Optional[Mapping] = None,
                 used_timesteps: int = 300, timesteps: int = 1000,
                 linear_start: float = 0.00085, linear_end: float = 0.0120,
                 scale_factor: float = 0.18215, parameterization: str = "eps",
                 device: str | torch.device = "cuda", **_: Any):
        """Build from the config dict of the JAX class. The weights are made
        on `device`: CUDA unless the caller asks for "cpu" (raises when CUDA
        is absent), or "meta" for a shell that `load_state_dict(...,
        assign=True)` fills."""
        super().__init__()
        device = torch.device(device)
        if device.type != "meta":
            device = resolve_device(device)
        if parameterization != "eps":
            raise NotImplementedError(
                f"parameterization {parameterization!r}: the port's sampler "
                "reads eps (ROADMAP Queue 1 item 9 brings the others)")
        ctrl = _cfg_params(control_stage_config)
        unet = _cfg_params(unet_config)
        vae_cfg = _cfg_params(first_stage_config)
        comp = _cfg_params(preprocess_config)
        self.schedule = NoiseSchedule.create(
            timesteps=timesteps, beta_schedule="linear",
            linear_start=linear_start, linear_end=linear_end)
        self.used_timesteps = used_timesteps
        self.scale_factor = scale_factor
        with device:
            self._build(ctrl, unet, vae_cfg, comp)
        self._codec: Optional[CompressionCodec] = None

    def _build(self, ctrl: dict, unet: dict, vae_cfg: dict, comp: dict) -> None:
        self.denoiser = NoiseEstimator(
            in_channels=ctrl.get("in_channels", 4),
            model_channels=ctrl.get("model_channels", 320),
            out_channels=ctrl.get("out_channels", 4),
            hint_channels=ctrl.get("hint_channels", 256),
            num_res_blocks=ctrl.get("num_res_blocks", 2),
            attention_resolutions=tuple(ctrl.get("attention_resolutions", (4, 2, 1))),
            channel_mult=tuple(ctrl.get("channel_mult", (1, 2, 4, 4))),
            num_head_channels=unet.get("num_head_channels", 64),
            ctrl_num_head_channels=ctrl.get("num_head_channels", 16),
            context_dim=ctrl.get("context_dim", 1024),
            control_model_ratio=ctrl.get("control_model_ratio", 0.2),
            control_scale=ctrl.get("control_scale", 1.0),
        )
        dd = vae_cfg.get("ddconfig", {})
        self.vae = AutoencoderKL(
            embed_dim=vae_cfg.get("embed_dim", 4), ch=dd.get("ch", 128),
            ch_mult=tuple(dd.get("ch_mult", (1, 2, 4, 4))),
            num_res_blocks=dd.get("num_res_blocks", 2))
        self.compression = CompressionModel(
            in_nc=comp.get("in_nc", 512), out_nc=comp.get("out_nc", 4),
            N=comp.get("N", 256), M=comp.get("M", 256),
            slice_num=comp.get("slice_num", 10),
            slice_ch=tuple(comp.get("slice_ch", (8, 8, 8, 8, 16, 16, 32, 32, 64, 64))),
            codebook_size=comp.get("codebook_size", 16384))
        context_dim = self.denoiser.context_dim
        self.register_buffer("uncond_context", torch.zeros(1, 77, context_dim))
        self.register_buffer("vq_embed_prob",
                             torch.zeros(self.compression.codebook_size))

    # -- first stage / conditioning ------------------------------------------
    @full_fp32()
    def encode_first_stage(self, img: torch.Tensor):
        """img NHWC in [-1, 1] -> (posterior mean * scale, feature * scale)."""
        mean, _, feature = self.vae.encode_hc(img)
        return mean * self.scale_factor, feature * self.scale_factor

    @full_fp32()
    def decode_first_stage(self, z: torch.Tensor) -> torch.Tensor:
        return self.vae.decode(z / self.scale_factor)

    def get_learned_conditioning(self, batch: int = 1) -> torch.Tensor:
        """The stored empty-prompt context, tiled to the batch (the main
        path never runs CLIP)."""
        return self.uncond_context.expand(batch, -1, -1)

    # -- sampling --------------------------------------------------------------
    def relay_init(self, c_latent: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """x_T = q_sample(c_latent, t = used_timesteps - 1, noise)."""
        t = torch.full((c_latent.shape[0],), self.used_timesteps - 1,
                       dtype=torch.long, device=c_latent.device)
        return self.schedule.q_sample(c_latent, t, noise)

    @full_fp32()
    def sample(self, c_latent, guide_hint, context, steps: int, *,
               relay_noise: torch.Tensor | None = None,
               step_noise: Sequence[torch.Tensor] | None = None,
               generator: torch.Generator | None = None):
        """Relay spaced-DDPM sampling from the decoded latent -> denoised
        latent (NHWC). Noise the caller does not pass is drawn from
        `generator`."""
        if relay_noise is None:
            relay_noise = torch.randn(c_latent.shape, generator=generator,
                                      device=c_latent.device, dtype=c_latent.dtype)
        x_T = self.relay_init(c_latent, relay_noise)
        coeffs = spaced.make_spaced_coefficients(self.schedule,
                                                 self.used_timesteps, steps)
        return spaced.sample(
            lambda x, t: self.denoiser(x, t, context, guide_hint), x_T, coeffs,
            noise=step_noise, generator=generator)

    @torch.no_grad()
    def decode_pipeline(self, c_latent, guide_hint, steps: int,
                        **noise) -> torch.Tensor:
        """(c_latent, guide_hint) -> RGB NHWC in [0, 1]. `noise`: the
        keyword arguments of `sample` (relay_noise, step_noise, generator)."""
        context = self.get_learned_conditioning(c_latent.shape[0])
        samples = self.sample(c_latent, guide_hint, context, steps, **noise)
        return torch.clamp((self.decode_first_stage(samples) + 1) / 2, 0.0, 1.0)

    # -- real bitstream --------------------------------------------------------
    def codec(self) -> CompressionCodec:
        if self._codec is None:
            self._codec = CompressionCodec(self.compression)
        return self._codec

    @torch.no_grad()
    def apply_condition_compress(self, img01: torch.Tensor, stream_path, H: int,
                                 W: int) -> float:
        """img01 [1, H, W, 3] in [0, 1] -> bitstream file; returns the bpp
        of the file over H x W."""
        _, h = self.encode_first_stage(img01 * 2 - 1)
        out = self.codec().compress(h)
        with Path(stream_path).open("wb") as f:
            write_body(f, out["shape"], out["strings"])
        return filesize(stream_path) * 8.0 / (H * W)

    @torch.no_grad()
    def apply_condition_decompress(self, stream_path):
        """Bitstream file -> (c_latent, guide_hint), NHWC."""
        with Path(stream_path).open("rb") as f:
            strings, shape = read_body(f)
        return self.codec().decompress(strings, shape)
