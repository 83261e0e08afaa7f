"""Diffusion noise schedules and derived coefficient tables
(counterpart of ``conditioned_diffusion_models_uad_tpu/diffusion/schedule.py``).

The betas and every derived table are computed in float64 numpy and cast once
to float32, exactly as the JAX package does, so the tables are bitwise equal.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def linear_beta_schedule(timesteps: int) -> np.ndarray:
    """Linear schedule, scaled so the total noise budget is invariant to T."""
    scale = 1000.0 / timesteps
    return np.linspace(scale * 0.0001, scale * 0.02, timesteps, dtype=np.float64)


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    """Cosine schedule (Nichol & Dhariwal, improved DDPM)."""
    steps = timesteps + 1
    x = np.linspace(0, timesteps, steps, dtype=np.float64)
    alphas_cumprod = np.cos(((x / timesteps) + s) / (1 + s) * math.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1.0 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0.0, 0.999)


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """All per-timestep coefficient tables, each a float32 tensor [T]."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    p2_loss_weight: torch.Tensor

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])


def make_schedule(
    timesteps: int = 1000,
    beta_schedule: str = "cosine",
    p2_loss_weight_gamma: float = 0.0,
    p2_loss_weight_k: float = 1.0,
    device="cpu",
) -> DiffusionSchedule:
    if beta_schedule == "linear":
        betas = linear_beta_schedule(timesteps)
    elif beta_schedule == "cosine":
        betas = cosine_beta_schedule(timesteps)
    else:
        raise ValueError(f"unknown beta schedule {beta_schedule}")

    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_cumprod_prev = np.pad(alphas_cumprod[:-1], (1, 0), constant_values=1.0)
    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)

    def f32(a):
        return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(device)

    return DiffusionSchedule(
        betas=f32(betas),
        alphas_cumprod=f32(alphas_cumprod),
        alphas_cumprod_prev=f32(alphas_cumprod_prev),
        sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
        log_one_minus_alphas_cumprod=f32(np.log(1.0 - alphas_cumprod)),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod)),
        sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod - 1.0)),
        posterior_variance=f32(posterior_variance),
        posterior_log_variance_clipped=f32(
            np.log(np.clip(posterior_variance, 1e-20, None))
        ),
        posterior_mean_coef1=f32(
            betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)
        ),
        posterior_mean_coef2=f32(
            (1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod)
        ),
        p2_loss_weight=f32(
            (p2_loss_weight_k + alphas_cumprod / (1 - alphas_cumprod))
            ** -p2_loss_weight_gamma
        ),
    )


def extract(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Gather ``table[t]`` and reshape to broadcast against an
    ``ndim``-dimensional batch tensor ([B] -> [B, 1, ..., 1])."""
    out = table[t]
    return out.reshape(out.shape[0], *((1,) * (ndim - 1)))
