"""Diffusion noise schedules (counterpart of rdeic_tpu/diffusion/schedule.py).

Every table is built in float64 numpy on the host, as the JAX package does,
and used in float32 on the device.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np
import torch


def make_beta_schedule(schedule: str, n_timestep: int,
                       linear_start: float = 1e-4, linear_end: float = 2e-2,
                       cosine_s: float = 8e-3) -> np.ndarray:
    """Beta schedule in float64. "linear" squares a linspace of sqrt-betas."""
    if schedule == "linear":
        return np.linspace(linear_start**0.5, linear_end**0.5, n_timestep,
                           dtype=np.float64) ** 2
    if schedule == "cosine":
        steps = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep
        alphas = np.cos((steps + cosine_s) / (1 + cosine_s) * np.pi / 2) ** 2
        alphas = alphas / alphas[0]
        return np.clip(1 - alphas[1:] / alphas[:-1], 0, 0.999)
    if schedule == "sqrt_linear":
        return np.linspace(linear_start, linear_end, n_timestep,
                           dtype=np.float64)
    if schedule == "sqrt":
        return np.linspace(linear_start, linear_end, n_timestep,
                           dtype=np.float64) ** 0.5
    raise ValueError(f"unknown beta schedule: {schedule!r}")


def space_timesteps(num_timesteps: int, section_counts) -> set:
    """Spaced subset of timesteps (guided-diffusion respacing): an int, a
    list of ints, a comma-separated string, or "ddimN"."""
    if isinstance(section_counts, int):
        section_counts = [section_counts]
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired = int(section_counts[len("ddim"):])
            for stride in range(1, num_timesteps):
                if len(range(0, num_timesteps, stride)) == desired:
                    return set(range(0, num_timesteps, stride))
            raise ValueError(
                f"cannot create exactly {desired} steps with an integer stride")
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps = []
    for i, count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < count:
            raise ValueError(f"cannot divide section of {size} steps into {count}")
        frac_stride = 1 if count <= 1 else (size - 1) / (count - 1)
        cur = 0.0
        for _ in range(count):
            all_steps.append(start_idx + round(cur))
            cur += frac_stride
        start_idx += size
    return set(all_steps)


@dataclasses.dataclass(frozen=True)
class NoiseSchedule:
    """All derived diffusion tables for a beta sequence (float64 numpy)."""

    betas: np.ndarray
    v_posterior: float = 0.0

    @classmethod
    def create(cls, timesteps: int = 1000, beta_schedule: str = "linear",
               linear_start: float = 0.00085, linear_end: float = 0.0120,
               cosine_s: float = 8e-3, v_posterior: float = 0.0):
        betas = make_beta_schedule(beta_schedule, timesteps, linear_start,
                                   linear_end, cosine_s)
        return cls(betas=betas, v_posterior=v_posterior)

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])

    @cached_property
    def _tables(self) -> dict:
        betas = self.betas
        alphas = 1.0 - betas
        acp = np.cumprod(alphas, axis=0)
        acp_prev = np.append(1.0, acp[:-1])
        post_var = (1 - self.v_posterior) * betas * (1.0 - acp_prev) / (
            1.0 - acp) + self.v_posterior * betas
        return dict(
            betas=betas,
            alphas_cumprod=acp,
            alphas_cumprod_prev=acp_prev,
            sqrt_alphas_cumprod=np.sqrt(acp),
            sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - acp),
            log_one_minus_alphas_cumprod=np.log(1.0 - acp),
            sqrt_recip_alphas_cumprod=np.sqrt(1.0 / acp),
            sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / acp - 1),
            posterior_variance=post_var,
            posterior_log_variance_clipped=np.log(np.maximum(post_var, 1e-20)),
            posterior_mean_coef1=betas * np.sqrt(acp_prev) / (1.0 - acp),
            posterior_mean_coef2=(1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp),
        )

    def table(self, name: str) -> np.ndarray:
        """float64 table by name."""
        return self._tables[name]

    def ftable(self, name: str, t: torch.Tensor, ndim: int) -> torch.Tensor:
        """float32 table[t] on t's device, shaped [B, 1, ...] to broadcast
        against an `ndim`-dim tensor."""
        table = torch.as_tensor(self.table(name).astype(np.float32),
                                device=t.device)
        out = table[t.long()]
        return out.reshape(out.shape + (1,) * (ndim - out.dim()))

    def q_sample(self, x_start: torch.Tensor, t: torch.Tensor,
                 noise: torch.Tensor) -> torch.Tensor:
        """Draw x_t ~ q(x_t | x_0) with the given noise."""
        n = x_start.dim()
        return (self.ftable("sqrt_alphas_cumprod", t, n) * x_start
                + self.ftable("sqrt_one_minus_alphas_cumprod", t, n) * noise)


def spaced_schedule(base: NoiseSchedule, used_timesteps: int,
                    num_steps) -> tuple[NoiseSchedule, np.ndarray]:
    """Respaced schedule over the first `used_timesteps` of `base`: betas
    rebuilt so each kept step keeps the base marginal. Returns (schedule,
    kept original timestep ids, ascending)."""
    if used_timesteps > base.num_timesteps:
        raise ValueError("used_timesteps exceeds base schedule length")
    acp = base.table("alphas_cumprod")[:used_timesteps]
    keep = space_timesteps(used_timesteps, num_steps)
    betas = []
    last = 1.0
    for i in range(used_timesteps):
        if i in keep:
            betas.append(1 - acp[i] / last)
            last = acp[i]
    timesteps = np.array(sorted(keep), dtype=np.int32)
    return NoiseSchedule(betas=np.array(betas, dtype=np.float64)), timesteps
