"""RDEIC model: the inference surface and both training losses (counterpart
of rdeic_tpu/pipeline/rdeic.py).

`RDEIC` is built from the same config dict as the JAX class. Its module tree
(`vae`, `compression`, `denoiser`, and the `uncond_context` and
`vq_embed_prob` buffers) mirrors the JAX params tree, so a JAX checkpoint
loads through rdeic_torch.utils.convert with one rule.

The main path: image -> VAE `encode_hc` -> compression + host rANS ->
bitstream file -> decompress to (c_latent, guide_hint) -> relay init at
t = used_timesteps - 1 -> spaced DDPM or DDIM over the dual UNet (with
classifier-free guidance, the base UNet alone a second time each step) ->
VAE decode. Noise is explicit: pass the tensors, or a `torch.Generator` to
draw them.

Batched serving (the root inference_partition.py's path): B images of one
padded size are coded in one run of the codec's passes to one stream file
each, every file the one the single-image path writes (the layers of the
VAE encoder and the codec run image by image there, so an image's bits do
not depend on its batch: `blocks.image_by_image`), and decoded back as a
batch; `decode_batched` samples in micro-batches. The context is the stored
empty prompt, or CLIP's context of caption tokens when a CLIP text tower
is attached (`attach_clip`; a weights file with a `clip/` subtree does it).

Training (`loss_fn`): VAE encode with a posterior sample, under no grad ->
the compression model's forward with noisy likelihoods and the CVQ losses ->
- independent phase: relay-shifted noise, one dual-UNet call, eps -> x0
  loss;
- refine phase (`is_refine`): relay init, the `fixed_step` spaced-DDPM
  sampler over the dual UNet and the VAE decoder, both under grad, then
  pixel MSE + 0.5 LPIPS(alex). The VAE and LPIPS stay frozen; gradients pass
  through them to the sampler's latent.

Numerics: the VAE and the denoiser run in full fp32 (`full_fp32`: no TF32,
which cuDNN convolutions would use by default), so the card computes what the
CPU reference computes; the codec adds its own deterministic settings. A
training step runs its forward and its backward inside the scope. The VAE
and the denoiser may compute in bf16 (`set_compute_dtype`, the JAX
method): bf16 serving also stores their weights in bf16
(`cast_inference_params`), bf16 training keeps the trainable weights fp32
and the trainer stores the frozen ones in bf16. The compression model, the
codec and the sampler's state stay fp32.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Mapping, Optional, Sequence

import math
import os

import torch
from torch import nn

from rdeic_torch.diffusion import ddim, spaced
from rdeic_torch.diffusion.schedule import NoiseSchedule
from rdeic_torch.models import blocks
from rdeic_torch.models.clip import OpenCLIPTextEncoder
from rdeic_torch.models.compression import CompressionModel
from rdeic_torch.models.lpips import LPIPS, warn_random_backbone
from rdeic_torch.models.unet import NoiseEstimator
from rdeic_torch.models.vae import AutoencoderKL, sample_diagonal_gaussian
from rdeic_torch.pipeline.codec import CompressionCodec
from rdeic_torch.utils.backend import full_fp32, resolve_device
from rdeic_torch.utils.bitstream import filesize, read_body, write_body


# sampler name -> (coefficient tables, sampling loop)
SAMPLERS = {"ddpm": (spaced.make_spaced_coefficients, spaced.sample),
            "ddim": (ddim.make_ddim_coefficients, ddim.sample)}


def _cfg_params(cfg: Optional[Mapping[str, Any]]) -> dict:
    if cfg is None:
        return {}
    if "params" in cfg or "target" in cfg:
        return dict(cfg.get("params") or {})
    return dict(cfg)


class RDEIC(nn.Module):
    """Relay-residual diffusion extreme image compression."""

    def __init__(self, control_stage_config: Optional[Mapping] = None,
                 unet_config: Optional[Mapping] = None,
                 first_stage_config: Optional[Mapping] = None,
                 cond_stage_config: Optional[Mapping] = None,
                 preprocess_config: Optional[Mapping] = None,
                 sd_locked: bool = True, is_refine: bool = False,
                 fixed_step: int = 2, scan_remat: bool = False,
                 learning_rate: float = 2e-5, l_bpp_weight: float = 1.0,
                 l_guide_weight: float = 2.0,
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
        ctrl = _cfg_params(control_stage_config)
        unet = _cfg_params(unet_config)
        vae_cfg = _cfg_params(first_stage_config)
        comp = _cfg_params(preprocess_config)
        self.schedule = NoiseSchedule.create(
            timesteps=timesteps, beta_schedule="linear",
            linear_start=linear_start, linear_end=linear_end)
        self.used_timesteps = used_timesteps
        self.scale_factor = scale_factor
        # what the independent loss regresses; sampling reads the output as
        # eps whatever it is, as the JAX package's `sample` does
        self.parameterization = parameterization
        # the CLIP tower, when one is attached (`attach_clip`), stops at the
        # penultimate block unless the cond stage asks for the last
        self.clip_penultimate = (_cfg_params(cond_stage_config).get(
            "layer", "penultimate") == "penultimate")
        self.sd_locked = sd_locked
        self.is_refine = is_refine
        # the refine loss's sampler: its step count, and whether each step is
        # recomputed in the backward (spaced.sample's remat_steps)
        self.fixed_step = fixed_step
        self.scan_remat = scan_remat
        self.learning_rate = learning_rate
        self.l_bpp_weight = l_bpp_weight
        self.l_guide_weight = l_guide_weight
        # the relay shift of the noise target (rdeic_tpu: self.lamba)
        self.lamba = float(self.schedule.table(
            "sqrt_recipm1_alphas_cumprod")[used_timesteps - 1])
        with device:
            self._build(ctrl, unet, vae_cfg, comp)
        self._codec: Optional[CompressionCodec] = None

    def set_compute_dtype(self, dtype: torch.dtype,
                          cast_weights: bool = True) -> None:
        """The denoiser and the VAE compute in `dtype` (the JAX method):
        each layer the JAX package builds with `dtype` casts its weights and
        its input to it, whatever their storage dtype; GroupNorm statistics
        and the softmax stay fp32 inside. With `cast_weights` (serving, the
        `--bf16` flag) the weights are also stored in `dtype`
        (`cast_inference_params`); training passes False and leaves the
        storage to the trainer's `frozen_dtype`."""
        for name in ("vae", "denoiser"):
            blocks.set_compute_dtype(getattr(self, name), dtype)
        if cast_weights:
            self.cast_inference_params(dtype)

    def cast_inference_params(self, dtype: torch.dtype) -> None:
        """Store the weights of `vae`, `denoiser`, `clip` and `lpips` (those
        present) and the `uncond_context` in `dtype`: the rule of the JAX
        package's `cast_inference_params`. `compression` and
        `vq_embed_prob` stay fp32: their outputs parameterise the entropy
        coder, and the stream format pins them."""
        for name in ("vae", "denoiser", "clip", "lpips"):
            if hasattr(self, name):
                getattr(self, name).to(dtype)
        self.uncond_context = self.uncond_context.to(dtype)

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
            use_checkpoint=bool(ctrl.get("use_checkpoint", False)),
            remat_policy=ctrl.get("remat_policy", unet.get("remat_policy")),
        )
        dd = vae_cfg.get("ddconfig", {})
        # latent [B, H / f, W / f, embed_dim] of an [B, H, W, 3] image
        self.latent_factor = 2 ** (len(dd.get("ch_mult", (1, 2, 4, 4))) - 1)
        self.latent_channels = vae_cfg.get("embed_dim", 4)
        self.vae = AutoencoderKL(
            embed_dim=vae_cfg.get("embed_dim", 4), ch=dd.get("ch", 128),
            ch_mult=tuple(dd.get("ch_mult", (1, 2, 4, 4))),
            num_res_blocks=dd.get("num_res_blocks", 2),
            use_checkpoint=bool(vae_cfg.get("use_checkpoint", False)))
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
        if self.is_refine:  # the JAX package makes LPIPS params only here
            warn_random_backbone("RDEIC")
            self.lpips = LPIPS("alex")

    # -- first stage / conditioning ------------------------------------------
    @full_fp32()
    def encode_first_stage(self, img: torch.Tensor):
        """img NHWC in [-1, 1] -> (posterior mean * scale, feature * scale)."""
        mean, _, feature = self.vae.encode_hc(img)
        return mean * self.scale_factor, feature * self.scale_factor

    @full_fp32()
    def decode_first_stage(self, z: torch.Tensor) -> torch.Tensor:
        return self.vae.decode(z / self.scale_factor)

    def attach_clip(self) -> OpenCLIPTextEncoder:
        """Give the model a CLIP text tower (the JAX package makes its
        params only on request, `init_params(include_clip=True)`): width
        `context_dim`, on the device and in the dtype of `uncond_context`.
        A weights file with a `clip/` subtree attaches one
        (`utils.convert.load_npz_weights`)."""
        ctx = self.uncond_context
        with ctx.device:
            self.clip = OpenCLIPTextEncoder(
                width=self.denoiser.context_dim,
                penultimate=self.clip_penultimate).to(ctx.dtype)
        return self.clip

    def get_learned_conditioning(self, batch: int = 1,
                                 tokens: torch.Tensor | None = None
                                 ) -> torch.Tensor:
        """CLIP's context of `tokens` [B, 77] when the model has a CLIP
        tower, else the stored empty-prompt context tiled to the batch."""
        if tokens is not None and hasattr(self, "clip"):
            with torch.no_grad(), full_fp32():
                return self.clip(tokens.to(self.uncond_context.device))
        return self.uncond_context.expand(batch, -1, -1)

    # -- sampling --------------------------------------------------------------
    def relay_init(self, c_latent: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """x_T = q_sample(c_latent, t = used_timesteps - 1, noise)."""
        t = torch.full((c_latent.shape[0],), self.used_timesteps - 1,
                       dtype=torch.long, device=c_latent.device)
        return self.schedule.q_sample(c_latent, t, noise)

    def apply_model_unconditional(self, x: torch.Tensor, t: torch.Tensor,
                                  context: torch.Tensor) -> torch.Tensor:
        """eps of the base UNet alone (the unconditional branch of
        classifier-free guidance)."""
        return self.denoiser.forward_unconditional(x, t, context)

    @full_fp32()
    def sample(self, c_latent, guide_hint, context, steps: int, *,
               sampler: str = "ddpm", guidance_scale: float = 1.0,
               uncond_context: torch.Tensor | None = None,
               relay_noise: torch.Tensor | None = None,
               step_noise: Sequence[torch.Tensor] | None = None,
               generator: torch.Generator | None = None):
        """Relay sampling from the decoded latent -> denoised latent (NHWC),
        by the spaced DDPM ("ddpm") or the DDIM ("ddim", eta 0) sampler.
        With `guidance_scale` != 1 each step also runs the base UNet on
        `uncond_context` (default: `context`) and mixes the two eps. Noise
        the caller does not pass is drawn from `generator`."""
        if sampler not in SAMPLERS:
            raise ValueError(f"unknown sampler {sampler!r}")
        if relay_noise is None:
            relay_noise = torch.randn(c_latent.shape, generator=generator,
                                      device=c_latent.device, dtype=c_latent.dtype)
        x_T = self.relay_init(c_latent, relay_noise)

        def denoise(x, t):
            return self.denoiser(x, t, context, guide_hint)

        uncond_fn = None
        if guidance_scale != 1.0:
            uctx = context if uncond_context is None else uncond_context

            def uncond_fn(x, t):
                return self.apply_model_unconditional(x, t, uctx)

        make, run = SAMPLERS[sampler]
        return run(denoise, x_T, make(self.schedule, self.used_timesteps, steps),
                   noise=step_noise, generator=generator, uncond_fn=uncond_fn,
                   guidance_scale=guidance_scale)

    @torch.no_grad()
    def decode_pipeline(self, c_latent, guide_hint, steps: int, *,
                        sampler: str = "ddpm", guidance_scale: float = 1.0,
                        context: torch.Tensor | None = None,
                        **noise) -> torch.Tensor:
        """(c_latent, guide_hint) -> RGB NHWC in [0, 1]. `context` defaults
        to the stored empty prompt; `noise`: the keyword arguments of
        `sample` (relay_noise, step_noise, generator)."""
        if context is None:
            context = self.get_learned_conditioning(c_latent.shape[0])
        samples = self.sample(c_latent, guide_hint, context, steps,
                              sampler=sampler, guidance_scale=guidance_scale,
                              **noise)
        return torch.clamp((self.decode_first_stage(samples) + 1) / 2, 0.0, 1.0)

    @torch.no_grad()
    def decode_batched(self, c_latent, guide_hint, steps: int, *,
                       sampler: str = "ddpm", guidance_scale: float = 1.0,
                       micro: int | None = None,
                       context: torch.Tensor | None = None,
                       noise: Sequence[dict] | None = None,
                       generator: torch.Generator | None = None
                       ) -> torch.Tensor:
        """`decode_pipeline` over the batch in chunks of `micro` images,
        which bounds the sampler's activations whatever the batch (the JAX
        package's `decode_batched`). A ragged tail is padded with the
        batch's first rows to a whole chunk and sliced off. Without `micro`,
        or with `micro` >= B, it is one `decode_pipeline` call. `noise`:
        one dict of `sample`'s noise arguments (relay_noise, step_noise) per
        chunk, padded rows included; without it each chunk draws from
        `generator`. `context` (default: the stored empty prompt) is padded
        and cut with the rows."""
        b = c_latent.shape[0]
        opts = dict(sampler=sampler, guidance_scale=guidance_scale,
                    generator=generator)
        if micro is None or micro >= b:
            return self.decode_pipeline(c_latent, guide_hint, steps,
                                        context=context, **opts,
                                        **(noise[0] if noise else {}))
        pad = (-b) % micro
        rows = [c_latent, guide_hint] + ([] if context is None else [context])
        if pad:
            rows = [torch.cat([r, r[:pad]]) for r in rows]
        starts = range(0, b + pad, micro)
        if noise is not None and len(noise) != len(starts):
            raise ValueError(f"need noise for {len(starts)} chunks, got "
                             f"{len(noise)}")
        outs = []
        for j, k in enumerate(starts):
            chunk = [r[k:k + micro] for r in rows]
            outs.append(self.decode_pipeline(
                chunk[0], chunk[1], steps,
                context=chunk[2] if context is not None else None, **opts,
                **(noise[j] if noise is not None else {})))
        return torch.cat(outs)[:b]

    # -- training ----------------------------------------------------------------
    def train_noise(self, img: torch.Tensor,
                    generator: torch.Generator | None = None) -> dict:
        """Every draw of one `loss_fn` call for images `img` [B, H, W, 3]:
        `posterior` N(0, 1) of the latent's shape and `uniform`, one
        U(-0.5, 0.5) tensor per slice of y; then for the independent phase
        `t` uniform in [0, used_timesteps) and `eps` N(0, 1) of the latent's
        shape, for the refine phase `relay` and `steps` (`fixed_step`
        tensors) N(0, 1) of c_latent's shape."""
        b, h, w, _ = img.shape
        lh, lw = h // self.latent_factor, w // self.latent_factor
        yh, yw = -(-lh // 2), -(-lw // 2)  # one stride-2 block in g_a
        opts = dict(generator=generator, device=img.device, dtype=img.dtype)
        latent = (b, lh, lw, self.latent_channels)
        if self.is_refine:
            c_latent = (b, 2 * yh, 2 * yw, self.compression.out.Conv_0.out_channels)
            return dict(
                posterior=torch.randn(latent, **opts),
                uniform=[torch.rand((b, yh, yw, c), **opts) - 0.5
                         for c in self.compression.slice_ch],
                relay=torch.randn(c_latent, **opts),
                steps=[torch.randn(c_latent, **opts)
                       for _ in range(self.fixed_step)])
        return dict(
            posterior=torch.randn(latent, **opts),
            t=torch.randint(0, self.used_timesteps, (b,), generator=generator,
                            device=img.device),
            eps=torch.randn(latent, **opts),
            uniform=[torch.rand((b, yh, yw, c), **opts) - 0.5
                     for c in self.compression.slice_ch])

    def get_input(self, img: torch.Tensor, noise: dict | None = None,
                  training: bool = True):
        """img NHWC in [-1, 1] -> (x_start z, cond). The frozen VAE encoder
        runs without grad. Training draws the latent from the posterior
        with `noise` (a `train_noise` dict) and runs the compression model's
        noisy forward; `training=False` takes the posterior mean and the
        compression model's eval forward, and needs no noise."""
        with torch.no_grad():
            if training:
                mean, logvar, h = self.vae.encode_hc(img)
                z = sample_diagonal_gaussian(mean, logvar, noise["posterior"])
                z, h = z * self.scale_factor, h * self.scale_factor
            else:
                z, h = self.encode_first_stage(img)
        out = self.compression(h, noise=noise["uniform"] if training else None,
                               training=training)
        n, lh, lw, _ = z.shape
        num_pixels = n * lh * lw * 64
        bpp = torch.log(out["y_likelihoods"]).sum() / (-math.log(2) * num_pixels)
        q_bpp = torch.log(out["q_likelihoods"]).sum() / (-math.log(2) * num_pixels)
        cond = dict(c_crossattn=self.get_learned_conditioning(n),
                    c_latent=out["c_latent"], guide_hint=out["guide_hint"],
                    bpp=bpp, q_bpp=q_bpp, emb_loss=out["emb_loss"],
                    target=img, z_hyper=out["z"], vq_indices=out["vq_indices"])
        return z, cond

    def p_losses_independent(self, z_start, cond, t, eps):
        """One-step noise loss with the relay shift of the target: the noise
        is eps + (c_latent - z_start) / lamba, the loss is on the predicted
        x0 (or, by `parameterization`, the raw output against x0 or v), plus
        the guide, bpp and CVQ terms."""
        c_latent = cond["c_latent"]
        noise = eps + (c_latent - z_start) / self.lamba
        x_noisy = self.schedule.q_sample(z_start, t, noise)
        model_out = self.denoiser(x_noisy, t, cond["c_crossattn"],
                                  cond["guide_hint"])
        # "eps": the output as eps -> x0, against z_start; "x0": the output
        # against z_start; "v": the output against get_v(z_start, noise, t),
        # `noise` with the relay shift in it, as in the reference
        if self.parameterization == "eps":
            pred = self.schedule.predict_xstart_from_eps(x_noisy, t, model_out)
            target = z_start
        elif self.parameterization == "x0":
            pred, target = model_out, z_start
        elif self.parameterization == "v":
            pred, target = model_out, self.schedule.get_v(z_start, noise, t)
        else:
            raise NotImplementedError(self.parameterization)
        loss_simple = torch.mean((pred - target) ** 2, dim=(1, 2, 3))
        loss_guide = torch.mean((c_latent - z_start) ** 2)
        loss = (self.l_guide_weight * loss_simple.mean()
                + self.l_guide_weight * loss_guide
                + self.l_bpp_weight * cond["bpp"]
                + self.l_bpp_weight * cond["emb_loss"])
        logs = dict(l_simple=loss_simple.mean(), l_guide=loss_guide,
                    l_bpp=cond["bpp"], q_bpp=cond["q_bpp"],
                    l_emb=cond["emb_loss"], loss=loss)
        return loss, logs

    def p_losses_refine(self, z_start, cond, relay, steps):
        """Backprop through the `fixed_step` sampler and the VAE decoder,
        from the relay init with noise `relay` and the step noise `steps`.
        As in the JAX package (and its reference), the latent MSE is only
        logged: the objective is pixel MSE + 0.5 LPIPS, plus the guide, bpp
        and CVQ terms."""
        c_latent = cond["c_latent"]
        coeffs = spaced.make_spaced_coefficients(self.schedule,
                                                 self.used_timesteps,
                                                 self.fixed_step)
        samples = spaced.sample(
            lambda x, t: self.denoiser(x, t, cond["c_crossattn"],
                                       cond["guide_hint"]),
            self.relay_init(c_latent, relay), coeffs, noise=steps,
            remat_steps=self.scan_remat)
        decoded = self.decode_first_stage(samples)
        target = cond["target"]
        loss_simple = torch.mean((samples - z_start) ** 2, dim=(1, 2, 3))
        loss_mse = torch.mean((decoded - target) ** 2, dim=(1, 2, 3))
        loss_lpips = self.lpips(decoded, target).mean()
        loss_guide = torch.mean((c_latent - z_start) ** 2)
        loss = (self.l_guide_weight * loss_mse.mean()
                + self.l_guide_weight * loss_lpips * 0.5
                + self.l_guide_weight * loss_guide
                + self.l_bpp_weight * cond["bpp"]
                + self.l_bpp_weight * cond["emb_loss"])
        logs = dict(l_simple=loss_simple.mean(), l_mse=loss_mse.mean(),
                    l_lpips=loss_lpips, l_guide=loss_guide, l_bpp=cond["bpp"],
                    q_bpp=cond["q_bpp"], l_emb=cond["emb_loss"], loss=loss)
        return loss, logs

    @full_fp32()
    def loss_fn(self, img: torch.Tensor, noise: dict | None = None,
                generator: torch.Generator | None = None):
        """(loss, logs) of one batch of [-1, 1] NHWC images, from `noise` (a
        `train_noise` dict) or draws from `generator`: the refine loss when
        `is_refine`, else the independent one. logs["_z_hyper"] is the hyper
        latent for the trainer's codebook update."""
        if noise is None:
            noise = self.train_noise(img, generator)
        z, cond = self.get_input(img, noise)
        if self.is_refine:
            loss, logs = self.p_losses_refine(z, cond, noise["relay"],
                                              noise["steps"])
        else:
            loss, logs = self.p_losses_independent(z, cond, noise["t"],
                                                   noise["eps"])
        logs["_z_hyper"] = cond["z_hyper"].detach()
        return loss, logs

    # -- real bitstream --------------------------------------------------------
    def codec(self) -> CompressionCodec:
        """The codec, built once: RDEIC_RANS_LANES (default 0) sets its
        interleaved lanes, as the JAX package's `codec` reads it; the other
        RDEIC_RANS_* settings are read by the codec (pipeline/codec.py)."""
        if self._codec is None:
            self._codec = CompressionCodec(
                self.compression,
                lanes=int(os.environ.get("RDEIC_RANS_LANES") or 0))
        return self._codec

    @torch.no_grad()
    def feature(self, img01: torch.Tensor) -> torch.Tensor:
        """img01 [B, H, W, 3] in [0, 1] -> the scaled 512-ch VAE feature
        the codec compresses (the JAX package's `_jitted_feature`). It is
        fp32 under a bf16 VAE too (the encoder returns it so, as flax
        promotes a bf16 input of an fp32 layer)."""
        return self.encode_first_stage(img01 * 2 - 1)[1]

    @torch.no_grad()
    def apply_condition_compress(self, img01: torch.Tensor, stream_path, H: int,
                                 W: int) -> float:
        """img01 [1, H, W, 3] in [0, 1] -> bitstream file; returns the bpp
        of the file over H x W."""
        out = self.codec().compress(self.feature(img01))
        with Path(stream_path).open("wb") as f:
            write_body(f, out["shape"], out["strings"])
        return filesize(stream_path) * 8.0 / (H * W)

    @torch.no_grad()
    def apply_condition_decompress(self, stream_path):
        """Bitstream file -> (c_latent, guide_hint), NHWC."""
        with Path(stream_path).open("rb") as f:
            strings, shape = read_body(f)
        return self.codec().decompress(strings, shape)

    # -- batched bitstreams: one run of the passes for B images ----------------
    @torch.no_grad()
    def apply_condition_compress_batch(self, imgs01: torch.Tensor,
                                       stream_paths) -> list[float]:
        """imgs01 [B, H, W, 3] in [0, 1] (one padded size) -> one stream
        file per image, each the file `apply_condition_compress` writes for
        that image alone (the VAE encoder's layers run image by image, as
        the codec's do: `blocks.image_by_image`); returns each file's bpp
        over H x W."""
        with blocks.image_by_image():
            h = self.feature(imgs01)
        outs = self.codec().compress_batch(h)
        H, W = imgs01.shape[1:3]
        bpps = []
        for out, path in zip(outs, stream_paths, strict=True):
            with Path(path).open("wb") as f:
                write_body(f, out["shape"], out["strings"])
            bpps.append(filesize(path) * 8.0 / (H * W))
        return bpps

    @torch.no_grad()
    def apply_condition_decompress_batch(self, stream_paths):
        """Stream files of one padded size -> (c_latent, guide_hint) of the
        batch, NHWC; row i equals `apply_condition_decompress` of file i."""
        outs = []
        for path in stream_paths:
            with Path(path).open("rb") as f:
                strings, shape = read_body(f)
            outs.append({"strings": strings, "shape": shape})
        return self.codec().decompress_batch(outs)
