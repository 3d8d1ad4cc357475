"""Relay DDIM sampler and its encode / decode extras (counterpart of
rdeic_tpu/diffusion/ddim.py).

Uniform DDIM striding over the first `used_timesteps` of the full
alphas_cumprod, with the guided-diffusion +1 timestep shift on the model's
timestep and on the alpha gathers, and the eta-parameterized update. The
JAX package runs each loop as one ``lax.scan``; here it is a Python loop
over the steps, with the noise from the caller (a list, one tensor per
step) or from a ``torch.Generator``, as in `spaced.sample`. Every loop takes
`uncond_fn` / `guidance_scale` (classifier-free guidance, `spaced.guided`).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from rdeic_torch.diffusion.schedule import NoiseSchedule
from rdeic_torch.diffusion.spaced import Denoise, guided, step_noise


def _f32(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _ddim_timesteps(used_timesteps: int, num_steps: int) -> np.ndarray:
    """The ascending DDIM timesteps before the +1 shift (at least
    num_steps of them)."""
    return np.arange(0, used_timesteps, used_timesteps // num_steps)


class DDIMCoefficients(NamedTuple):
    """Per-step float32 tables, index 0 = first (highest-t) sampling step."""

    timesteps: np.ndarray  # int32, descending (the +1 shift included)
    sqrt_alphas: np.ndarray  # sqrt(a_t)
    sqrt_one_minus_alphas: np.ndarray
    sqrt_alphas_prev: np.ndarray
    dir_coef: np.ndarray  # sqrt(1 - a_prev - sigma^2)
    sigmas: np.ndarray

    @property
    def num_steps(self) -> int:
        return int(self.timesteps.shape[0])


def make_ddim_coefficients(base: NoiseSchedule, used_timesteps: int,
                           num_steps: int, eta: float = 0.0) -> DDIMCoefficients:
    """The sampling tables. The +1 shift applies to the alpha gathers too
    (ldm's make_ddim_timesteps returns the shifted steps, which its
    make_ddim_sampling_parameters gathers), and the first step's previous
    alpha is acp[0], not 1."""
    ts_shifted = _ddim_timesteps(used_timesteps, num_steps) + 1
    acp = base.table("alphas_cumprod")
    alphas = acp[ts_shifted]
    alphas_prev = np.concatenate([[float(acp[0])], acp[ts_shifted[:-1]]])
    sigmas = eta * np.sqrt(
        (1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev))
    order = np.arange(len(ts_shifted))[::-1]
    return DDIMCoefficients(
        timesteps=ts_shifted[order].astype(np.int32),
        sqrt_alphas=_f32(np.sqrt(alphas[order])),
        sqrt_one_minus_alphas=_f32(np.sqrt(1 - alphas[order])),
        sqrt_alphas_prev=_f32(np.sqrt(alphas_prev[order])),
        dir_coef=_f32(np.sqrt(np.maximum(
            1 - alphas_prev[order] - sigmas[order] ** 2, 0))),
        sigmas=_f32(sigmas[order]),
    )


def sample(denoise_fn: Denoise, x_T: torch.Tensor, coeffs: DDIMCoefficients,
           *, noise: Sequence[torch.Tensor] | None = None,
           generator: torch.Generator | None = None,
           uncond_fn: Denoise | None = None,
           guidance_scale: float = 1.0) -> torch.Tensor:
    """The DDIM loop from x_T: x0 from eps, then x = sqrt(a_prev) x0 +
    dir_coef eps + sigma noise. `noise[i]` is step i's noise (x's shape),
    else it is drawn from `generator`; at eta = 0 every sigma is 0 and the
    noise term is exactly zero, as in the JAX package."""
    b = x_T.shape[0]
    c = coeffs
    eps_fn = guided(denoise_fn, uncond_fn, guidance_scale)
    x = x_T
    for i, n in enumerate(step_noise(noise, c.num_steps, generator, x_T)):
        t = torch.full((b,), int(c.timesteps[i]), dtype=torch.long,
                       device=x.device)
        eps = eps_fn(x, t).to(x.dtype)
        x0 = (x - float(c.sqrt_one_minus_alphas[i]) * eps) / float(c.sqrt_alphas[i])
        dir_xt = float(c.dir_coef[i]) * eps
        x = float(c.sqrt_alphas_prev[i]) * x0 + dir_xt + float(c.sigmas[i]) * n
    return x


# -- the extras: encode / stochastic_encode / decode ---------------------------


class DDIMEncodeCoefficients(NamedTuple):
    """Per-step weights of the deterministic DDIM inversion (ascending)."""

    t_index: np.ndarray  # int32: the loop index (see `encode`)
    xt_w: np.ndarray  # sqrt(a_next / a)
    eps_w: np.ndarray  # sqrt(a_next) * (sqrt(1/a_next - 1) - sqrt(1/a - 1))


def make_ddim_encode_coefficients(base: NoiseSchedule, used_timesteps: int,
                                  num_steps: int) -> DDIMEncodeCoefficients:
    """The inversion tables: alphas_next = the first num_steps DDIM alphas,
    alphas = their previous ones (acp[0] for the first)."""
    ts = _ddim_timesteps(used_timesteps, num_steps)[:num_steps] + 1
    acp = base.table("alphas_cumprod")
    a_next = acp[ts]
    a = np.concatenate([[float(acp[0])], acp[ts[:-1]]])
    return DDIMEncodeCoefficients(
        t_index=np.arange(len(ts), dtype=np.int32),
        xt_w=_f32(np.sqrt(a_next / a)),
        eps_w=_f32(np.sqrt(a_next)
                   * (np.sqrt(1.0 / a_next - 1.0) - np.sqrt(1.0 / a - 1.0))),
    )


def encode(denoise_fn: Denoise, x0: torch.Tensor,
           coeffs: DDIMEncodeCoefficients, *, uncond_fn: Denoise | None = None,
           guidance_scale: float = 1.0) -> torch.Tensor:
    """Deterministic DDIM inversion x0 -> x_{t_enc}.

    The model is called with the LOOP INDEX as its timestep, not the DDIM
    timestep: the LDM behaviour the JAX package keeps for parity, kept
    here too."""
    b = x0.shape[0]
    eps_fn = guided(denoise_fn, uncond_fn, guidance_scale)
    x = x0
    for i in range(coeffs.t_index.shape[0]):
        t = torch.full((b,), int(coeffs.t_index[i]), dtype=torch.long,
                       device=x.device)
        eps = eps_fn(x, t).to(x.dtype)
        x = float(coeffs.xt_w[i]) * x + float(coeffs.eps_w[i]) * eps
    return x


def stochastic_encode(base: NoiseSchedule, used_timesteps: int, num_steps: int,
                      x0: torch.Tensor, t: torch.Tensor, noise: torch.Tensor, *,
                      use_original_steps: bool = False) -> torch.Tensor:
    """q_sample against the DDIM alpha sub-table: `t` [B] indexes DDIM steps
    (raw timesteps with `use_original_steps`)."""
    if use_original_steps:
        sqrt_a = base.table("sqrt_alphas_cumprod")
        sqrt_1ma = base.table("sqrt_one_minus_alphas_cumprod")
    else:
        ts = _ddim_timesteps(used_timesteps, num_steps)[:num_steps] + 1
        a = base.table("alphas_cumprod")[ts]
        sqrt_a, sqrt_1ma = np.sqrt(a), np.sqrt(1.0 - a)
    bc = (-1,) + (1,) * (x0.dim() - 1)

    def gather(table: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(_f32(table), device=x0.device)[t.long()].reshape(bc)

    return gather(sqrt_a) * x0 + gather(sqrt_1ma) * noise


def decode(denoise_fn: Denoise, x_latent: torch.Tensor,
           coeffs: DDIMCoefficients, t_start: int, *,
           noise: Sequence[torch.Tensor] | None = None,
           generator: torch.Generator | None = None,
           uncond_fn: Denoise | None = None,
           guidance_scale: float = 1.0) -> torch.Tensor:
    """The last `t_start` DDIM steps, from x_{t_start} down to x_0: `sample`
    over the tail of the descending table (`noise`, if given, has t_start
    tensors)."""
    if not 0 < t_start <= coeffs.num_steps:
        raise ValueError(f"t_start {t_start} outside (0, {coeffs.num_steps}]")
    sub = DDIMCoefficients(*(a[coeffs.num_steps - t_start:] for a in coeffs))
    return sample(denoise_fn, x_latent, sub, noise=noise, generator=generator,
                  uncond_fn=uncond_fn, guidance_scale=guidance_scale)
