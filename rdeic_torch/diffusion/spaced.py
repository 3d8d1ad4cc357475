"""Relay spaced-DDPM sampler (counterpart of rdeic_tpu/diffusion/spaced.py).

The JAX package runs the loop as one ``lax.scan``; here it is a Python loop
over the few steps. Per step: predict eps (mixed with an unconditional eps
under classifier-free guidance), then x0, then the posterior mean (shifted
by a classifier-guidance delta when asked), plus fixed-variance noise. The
noise comes from the caller (a list, one tensor per step, as the tests pass
the JAX stream's draws) or from a ``torch.Generator``. The loop is
differentiable: the refine phase backpropagates through it, optionally
recomputing each step in the backward (`remat_steps`).

The sampler's state keeps x's dtype: a bf16 denoiser's eps is taken to it
after the guidance mix, as JAX promotes the fp32 coefficients times a bf16
eps to fp32.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from rdeic_torch.diffusion.schedule import NoiseSchedule, spaced_schedule


class SpacedCoefficients(NamedTuple):
    """Per-step float32 tables, index 0 = first (highest-t) sampling step."""

    timesteps: np.ndarray  # int32, original-process step ids (descending)
    sqrt_recip_acp: np.ndarray
    sqrt_recipm1_acp: np.ndarray
    post_mean_c1: np.ndarray
    post_mean_c2: np.ndarray
    sqrt_model_var: np.ndarray
    nonzero: np.ndarray  # 0.0 on the final (t=0) step

    @property
    def num_steps(self) -> int:
        return int(self.timesteps.shape[0])


def make_spaced_coefficients(base: NoiseSchedule, used_timesteps: int,
                             num_steps: int,
                             var_type: str = "fixed_small") -> SpacedCoefficients:
    sub, timesteps = spaced_schedule(base, used_timesteps, num_steps)
    post_var = sub.table("posterior_variance")
    if var_type == "fixed_small":
        model_var = post_var
    elif var_type == "fixed_large":
        model_var = np.append(post_var[1], sub.betas[1:])
    else:
        raise ValueError(var_type)
    order = np.arange(num_steps)[::-1]
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return SpacedCoefficients(
        timesteps=timesteps[order].astype(np.int32),
        sqrt_recip_acp=f32(sub.table("sqrt_recip_alphas_cumprod")[order]),
        sqrt_recipm1_acp=f32(sub.table("sqrt_recipm1_alphas_cumprod")[order]),
        post_mean_c1=f32(sub.table("posterior_mean_coef1")[order]),
        post_mean_c2=f32(sub.table("posterior_mean_coef2")[order]),
        sqrt_model_var=f32(np.sqrt(model_var[order])),
        nonzero=f32(order != 0),
    )


Denoise = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def guided(denoise_fn: Denoise, uncond_fn: Denoise | None,
           guidance_scale: float) -> Denoise:
    """eps(x, t) under classifier-free guidance: eps_u + s * (eps - eps_u),
    eps_u from `uncond_fn`. Without `uncond_fn`, or at s = 1.0, it is
    `denoise_fn` itself: the unconditional branch never runs."""
    if uncond_fn is None or guidance_scale == 1.0:
        return denoise_fn

    def eps(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        e = denoise_fn(x, t)
        e_u = uncond_fn(x, t)
        return e_u + guidance_scale * (e - e_u)

    return eps


def step_noise(noise: Sequence[torch.Tensor] | None, num_steps: int,
               generator: torch.Generator | None, x: torch.Tensor):
    """Step i's noise: `noise[i]`, or a draw from `generator` of x's shape."""
    if noise is not None and len(noise) != num_steps:
        raise ValueError(f"need {num_steps} noise tensors, got {len(noise)}")
    for i in range(num_steps):
        yield noise[i] if noise is not None else torch.randn(
            x.shape, generator=generator, device=x.device, dtype=x.dtype)


def sample(denoise_fn: Denoise, x_T: torch.Tensor, coeffs: SpacedCoefficients,
           *, noise: Sequence[torch.Tensor] | None = None,
           generator: torch.Generator | None = None,
           uncond_fn: Denoise | None = None, guidance_scale: float = 1.0,
           cond_fn: Denoise | None = None,
           remat_steps: bool = False) -> torch.Tensor:
    """Run the relay spaced sampling loop from x_T (already q_sampled).

    denoise_fn(x, t[B]) -> eps. `noise[i]` is step i's noise (x's shape);
    without it each step draws from `generator`. `uncond_fn` and
    `guidance_scale`: classifier-free guidance (`guided`). cond_fn(x0, t)
    -> delta: latent classifier guidance, which adds 0.5 * delta to the
    posterior mean. `remat_steps` (under grad) keeps only each step's input
    for the backward and runs the step's forward again there (a
    non-reentrant checkpoint, which nests inside the denoiser's own
    per-block checkpoints).
    """
    b = x_T.shape[0]
    c = coeffs
    eps_fn = guided(denoise_fn, uncond_fn, guidance_scale)

    def step(i: int, x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
        t = torch.full((b,), int(c.timesteps[i]), dtype=torch.long,
                       device=x.device)
        eps = eps_fn(x, t).to(x.dtype)
        x0 = float(c.sqrt_recip_acp[i]) * x - float(c.sqrt_recipm1_acp[i]) * eps
        mean = float(c.post_mean_c1[i]) * x0 + float(c.post_mean_c2[i]) * x
        if cond_fn is not None:
            mean = mean + 0.5 * cond_fn(x0, t)
        return mean + float(c.nonzero[i] * c.sqrt_model_var[i]) * n  # f32 product

    x = x_T
    for i, n in enumerate(step_noise(noise, c.num_steps, generator, x_T)):
        if remat_steps and torch.is_grad_enabled():
            x = checkpoint(step, i, x, n, use_reentrant=False)
        else:
            x = step(i, x, n)
    return x
