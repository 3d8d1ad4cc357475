"""Relay spaced-DDPM sampler (counterpart of rdeic_tpu/diffusion/spaced.py).

The JAX package runs the loop as one ``lax.scan``; here it is a Python loop
over the few steps. Per step: predict eps, then x0, then the posterior mean,
plus fixed-variance noise. The noise comes from the caller (a list, one
tensor per step, as the tests pass the JAX stream's draws) or from a
``torch.Generator``. The loop is differentiable: the refine phase
backpropagates through it, optionally recomputing each step in the backward
(`remat_steps`).
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


def sample(denoise_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
           x_T: torch.Tensor, coeffs: SpacedCoefficients, *,
           noise: Sequence[torch.Tensor] | None = None,
           generator: torch.Generator | None = None,
           remat_steps: bool = False) -> torch.Tensor:
    """Run the relay spaced sampling loop from x_T (already q_sampled).

    denoise_fn(x, t[B]) -> eps. `noise[i]` is step i's noise (x's shape);
    without it each step draws from `generator`. `remat_steps` (under grad)
    keeps only each step's input for the backward and runs the step's
    forward again there (a non-reentrant checkpoint, which nests inside the
    denoiser's own per-block checkpoints).
    """
    if noise is not None and len(noise) != coeffs.num_steps:
        raise ValueError(f"need {coeffs.num_steps} noise tensors, got {len(noise)}")
    b = x_T.shape[0]
    c = coeffs

    def step(i: int, x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
        t = torch.full((b,), int(c.timesteps[i]), dtype=torch.long,
                       device=x.device)
        eps = denoise_fn(x, t)
        x0 = float(c.sqrt_recip_acp[i]) * x - float(c.sqrt_recipm1_acp[i]) * eps
        mean = float(c.post_mean_c1[i]) * x0 + float(c.post_mean_c2[i]) * x
        return mean + float(c.nonzero[i] * c.sqrt_model_var[i]) * n  # f32 product

    x = x_T
    for i in range(c.num_steps):
        n = noise[i] if noise is not None else torch.randn(
            x.shape, generator=generator, device=x.device, dtype=x.dtype)
        if remat_steps and torch.is_grad_enabled():
            x = checkpoint(step, i, x, n, use_reentrant=False)
        else:
            x = step(i, x, n)
    return x
