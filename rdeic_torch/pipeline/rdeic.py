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
training step runs its forward and its backward inside the scope. Serving
may run the VAE and the denoiser in bf16 (`set_compute_dtype`); the
compression model, the codec and the sampler's state stay fp32.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Mapping, Optional, Sequence

import math

import torch
from torch import nn

from rdeic_torch.diffusion import ddim, spaced
from rdeic_torch.diffusion.schedule import NoiseSchedule
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
        if parameterization != "eps":
            raise NotImplementedError(
                f"parameterization {parameterization!r}: the port's sampler "
                "reads eps (ROADMAP Queue 1, training settings)")
        ctrl = _cfg_params(control_stage_config)
        unet = _cfg_params(unet_config)
        vae_cfg = _cfg_params(first_stage_config)
        comp = _cfg_params(preprocess_config)
        self.schedule = NoiseSchedule.create(
            timesteps=timesteps, beta_schedule="linear",
            linear_start=linear_start, linear_end=linear_end)
        self.used_timesteps = used_timesteps
        self.scale_factor = scale_factor
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

    def set_compute_dtype(self, dtype: torch.dtype) -> None:
        """Serve in `dtype` (bf16): cast the weights of `vae`, `denoiser` and
        `lpips` (when present) and the `uncond_context`, the rule of the JAX
        package's `cast_inference_params`; a torch module computes in its
        weights' dtype, so this also does what its `set_compute_dtype`
        does. `compression` and `vq_embed_prob` stay fp32: their outputs
        parameterise the entropy coder, and the stream format pins them.
        GroupNorm statistics and the softmax stay fp32 inside the modules."""
        for name in ("vae", "denoiser", "lpips"):
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

    def get_input(self, img: torch.Tensor, noise: dict):
        """img NHWC in [-1, 1] -> (x_start z, cond). The frozen VAE encoder
        runs without grad."""
        with torch.no_grad():
            mean, logvar, h = self.vae.encode_hc(img)
            z = sample_diagonal_gaussian(mean, logvar, noise["posterior"])
            z, h = z * self.scale_factor, h * self.scale_factor
        out = self.compression(h, noise=noise["uniform"], training=True)
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
        x0, plus the guide, bpp and CVQ terms."""
        c_latent = cond["c_latent"]
        noise = eps + (c_latent - z_start) / self.lamba
        x_noisy = self.schedule.q_sample(z_start, t, noise)
        model_out = self.denoiser(x_noisy, t, cond["c_crossattn"],
                                  cond["guide_hint"])
        pred = self.schedule.predict_xstart_from_eps(x_noisy, t, model_out)
        loss_simple = torch.mean((pred - z_start) ** 2, dim=(1, 2, 3))
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
        if self._codec is None:
            self._codec = CompressionCodec(self.compression)
        return self._codec

    @torch.no_grad()
    def apply_condition_compress(self, img01: torch.Tensor, stream_path, H: int,
                                 W: int) -> float:
        """img01 [1, H, W, 3] in [0, 1] -> bitstream file; returns the bpp
        of the file over H x W. The feature reaches the compression model
        in fp32 under a bf16 VAE too (the encoder returns it so, as flax
        promotes a bf16 input of an fp32 layer)."""
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
