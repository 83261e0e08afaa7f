"""Gaussian diffusion: forward corruption and the training/eval objective
(counterpart of ``conditioned_diffusion_models_uad_tpu/diffusion/gaussian.py``
:76-253).

Tensors are NHWC ``[B, H, W, C]`` like the JAX package; schedule math runs in
float32 whatever the model's compute dtype. The iterative samplers
(``p_sample_loop``, ``ddim_sample``) and the patch-box/brain-mask/inpaint
terms of ``p_losses`` are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch
import torch.nn.functional as F

from .schedule import DiffusionSchedule, extract

# model_fn(x, t, cond) -> model_out ; x: [B,H,W,C] in [-1,1], t: [B] int64
ModelFn = Callable[[torch.Tensor, torch.Tensor, Optional[torch.Tensor]], torch.Tensor]


def normalize_to_neg_one_to_one(img: torch.Tensor) -> torch.Tensor:
    return img * 2.0 - 1.0


def unnormalize_to_zero_to_one(img: torch.Tensor) -> torch.Tensor:
    return (img + 1.0) * 0.5


@dataclasses.dataclass(frozen=True)
class GaussianDiffusionConfig:
    objective: str = "pred_x0"  # 'pred_noise' | 'pred_x0'
    loss_type: str = "l1"  # 'l1' | 'l2'

    def __post_init__(self):
        if self.objective not in ("pred_noise", "pred_x0"):
            raise ValueError(f"unknown objective {self.objective}")
        if self.loss_type not in ("l1", "l2"):
            raise ValueError(f"unknown loss_type {self.loss_type}")


def q_sample(sched: DiffusionSchedule, x_start, t, noise):
    """Forward diffusion: x_t = sqrt(a_bar_t)·x_0 + sqrt(1-a_bar_t)·eps."""
    nd = x_start.ndim
    return (
        extract(sched.sqrt_alphas_cumprod, t, nd) * x_start
        + extract(sched.sqrt_one_minus_alphas_cumprod, t, nd) * noise
    )


def predict_start_from_noise(sched: DiffusionSchedule, x_t, t, noise):
    nd = x_t.ndim
    return (
        extract(sched.sqrt_recip_alphas_cumprod, t, nd) * x_t
        - extract(sched.sqrt_recipm1_alphas_cumprod, t, nd) * noise
    )


def predict_noise_from_start(sched: DiffusionSchedule, x_t, t, x0):
    nd = x_t.ndim
    return (
        extract(sched.sqrt_recip_alphas_cumprod, t, nd) * x_t - x0
    ) / extract(sched.sqrt_recipm1_alphas_cumprod, t, nd)


def model_predictions(
    sched: DiffusionSchedule,
    cfg: GaussianDiffusionConfig,
    model_fn: ModelFn,
    x,
    t,
    cond=None,
    clip_x_start: bool = False,
):
    """Run the model and derive (pred_noise, pred_x_start) under either objective."""
    model_output = model_fn(x, t, cond).float()

    def maybe_clip(v):
        return v.clamp(-1.0, 1.0) if clip_x_start else v

    if cfg.objective == "pred_noise":
        pred_noise = model_output
        x_start = maybe_clip(predict_start_from_noise(sched, x, t, model_output))
    else:
        x_start = maybe_clip(model_output)
        pred_noise = predict_noise_from_start(sched, x, t, x_start)
    return pred_noise, x_start


def p_losses(
    sched: DiffusionSchedule,
    cfg: GaussianDiffusionConfig,
    model_fn: ModelFn,
    x_start: torch.Tensor,  # [B,H,W,C] in [-1,1]
    t: torch.Tensor,  # [B] int
    cond: Optional[torch.Tensor],
    noise: torch.Tensor,
    *,
    reduce: bool = True,
):
    """Objective at the given t and noise. Returns (loss, reconstruction in
    [0,1]); with ``reduce=False`` the loss is the per-sample [B] vector."""
    noise = noise.float()
    x = q_sample(sched, x_start, t, noise)
    model_out = model_fn(x, t, cond).float()
    target = noise if cfg.objective == "pred_noise" else x_start

    err = model_out - target
    per_pixel = (F.l1_loss(model_out, target, reduction="none") if cfg.loss_type == "l1"
                 else err * err)
    per_sample = per_pixel.reshape(per_pixel.shape[0], -1).mean(dim=1)
    per_sample = per_sample * sched.p2_loss_weight[t]
    loss = per_sample.mean() if reduce else per_sample

    if cfg.objective == "pred_noise":
        reco = unnormalize_to_zero_to_one(
            x - extract(sched.sqrt_one_minus_alphas_cumprod, t, x.ndim) * model_out
        )
    else:
        reco = unnormalize_to_zero_to_one(model_out)
    return loss, reco


def diffusion_call(
    sched: DiffusionSchedule,
    cfg: GaussianDiffusionConfig,
    model_fn: ModelFn,
    img01: torch.Tensor,  # [B,H,W,C] in [0,1]
    *,
    t: Optional[Union[int, torch.Tensor]],
    cond: Optional[torch.Tensor],
    noise: torch.Tensor,
    reduce: bool = True,
    generator: Optional[torch.Generator] = None,
):
    """Map the image to [-1,1], then compute ``p_losses`` at t: an int
    broadcast over the batch or a [B] vector (eval, or training with t drawn
    by the caller), or ``None`` for training, where t is drawn uniform in
    [0, timesteps) from ``generator``."""
    b = img01.shape[0]
    if t is None:
        if generator is None:
            raise ValueError("t=None draws t for training and needs a torch.Generator")
        t_vec = torch.randint(0, sched.num_timesteps, (b,), generator=generator,
                              device=generator.device).to(img01.device)
    elif isinstance(t, int):
        t_vec = torch.full((b,), t, dtype=torch.long, device=img01.device)
    else:
        t_vec = t.to(device=img01.device, dtype=torch.long)
    x_start = normalize_to_neg_one_to_one(img01.float())
    return p_losses(sched, cfg, model_fn, x_start, t_vec, cond, noise, reduce=reduce)
