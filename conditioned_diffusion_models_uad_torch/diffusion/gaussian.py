"""Gaussian diffusion: forward corruption, the training/eval objective and
the samplers (counterpart of
``conditioned_diffusion_models_uad_tpu/diffusion/gaussian.py``).

Tensors are NHWC ``[B, H, W, C]`` like the JAX package; schedule math runs in
float32 whatever the model's compute dtype.

The samplers (``p_sample_loop``, ``ddim_sample``, ``interpolate``) take the
JAX package's keys as numpy uint32 words (``utils/prng.py``): [2] for one
volume, or [G, 2] for G volumes stacked on the batch axis, each splitting
its own key chain, so a volume samples the same whichever group it rides in.
The chain is split on the host, step by step as the JAX package's
``lax.scan`` splits it, and each step's noise comes from a ``KeyNoiseFn``
over the step's G keys at once (one noise-kernel launch a step on the hash
path). The loops are Python loops over UNet calls; the last step draws no
noise (its noise is multiplied by 0 in the JAX package).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import prng
from .schedule import DiffusionSchedule, extract

# model_fn(x, t, cond) -> model_out ; x: [B,H,W,C] in [-1,1], t: [B] int64
ModelFn = Callable[[torch.Tensor, torch.Tensor, Optional[torch.Tensor]], torch.Tensor]
# key_noise(keys [N, 2] uint32, shape (B, H, W, C)) -> [N*B, H, W, C] float32:
# block n holds key n's noise over B samples
KeyNoiseFn = Callable[[np.ndarray, tuple], torch.Tensor]


def noise_for(noise_fn: KeyNoiseFn, key, shape: tuple) -> torch.Tensor:
    """Per-volume noise over a grouped slice stack: key [2] draws one field
    over the whole batch axis; key [G, 2] draws volume v's field from its
    own key over its ``shape[0] // G`` slice block, all G in one call."""
    key = np.asarray(key, dtype=np.uint32)
    if key.ndim == 1:
        return noise_fn(key[None], tuple(shape))
    g = key.shape[0]
    return noise_fn(key, (shape[0] // g,) + tuple(shape[1:]))


def normalize_to_neg_one_to_one(img: torch.Tensor) -> torch.Tensor:
    return img * 2.0 - 1.0


def unnormalize_to_zero_to_one(img: torch.Tensor) -> torch.Tensor:
    return (img + 1.0) * 0.5


@dataclasses.dataclass(frozen=True)
class GaussianDiffusionConfig:
    objective: str = "pred_x0"  # 'pred_noise' | 'pred_x0'
    loss_type: str = "l1"  # 'l1' | 'l2'
    inpaint: bool = False
    clip_denoised: bool = True
    ddim_sampling_eta: float = 1.0

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


def q_posterior(sched: DiffusionSchedule, x_start, x_t, t):
    """Mean, variance and clipped log variance of q(x_{t-1} | x_t, x_0)."""
    nd = x_t.ndim
    mean = (extract(sched.posterior_mean_coef1, t, nd) * x_start
            + extract(sched.posterior_mean_coef2, t, nd) * x_t)
    return (mean, extract(sched.posterior_variance, t, nd),
            extract(sched.posterior_log_variance_clipped, t, nd))


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


def box_to_mask(box: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Boxes [B, 4] (x0, y0, x1, y1) -> bool masks [B, H, W, 1], True inside
    (rows y0 <= y < y1, columns x0 <= x < x1)."""
    box = torch.as_tensor(box)
    ys = torch.arange(height, device=box.device)[None, :, None]
    xs = torch.arange(width, device=box.device)[None, None, :]
    x0, y0, x1, y1 = (box[:, i, None, None] for i in range(4))
    m = (ys >= y0) & (ys < y1) & (xs >= x0) & (xs < x1)
    return m[..., None]


def p_losses(
    sched: DiffusionSchedule,
    cfg: GaussianDiffusionConfig,
    model_fn: ModelFn,
    x_start: torch.Tensor,  # [B,H,W,C] in [-1,1]
    t: torch.Tensor,  # [B] int
    cond: Optional[torch.Tensor],
    noise: torch.Tensor,
    *,
    box_mask: Optional[torch.Tensor] = None,  # [B,H,W,1] bool: True inside the patch
    brain_mask: Optional[torch.Tensor] = None,  # [B,H,W,C]
    reduce: bool = True,
):
    """Objective at the given t and noise. Returns (loss, reconstruction in
    [0,1]); with ``reduce=False`` the loss is the per-sample [B] vector.
    With ``box_mask`` only the box is noised (the clean image elsewhere), a
    pred_noise target is the noise inside it, and ``cfg.inpaint`` keeps the
    clean image outside it in the prediction; ``brain_mask`` multiplies a
    pred_x0 prediction."""
    noise = noise.float()
    x = q_sample(sched, x_start, t, noise)
    if box_mask is not None:
        x = torch.where(box_mask, x, x_start)
    model_out = model_fn(x, t, cond).float()
    if cfg.objective == "pred_noise":
        target = torch.where(box_mask, noise, 0.0) if box_mask is not None else noise
    else:
        if brain_mask is not None:
            model_out = model_out * brain_mask
        target = x_start
    if cfg.inpaint and box_mask is not None:
        model_out = torch.where(box_mask, model_out, x_start)

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
    box_mask: Optional[torch.Tensor] = None,
    brain_mask: Optional[torch.Tensor] = None,
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
    return p_losses(sched, cfg, model_fn, x_start, t_vec, cond, noise, box_mask=box_mask,
                    brain_mask=brain_mask, reduce=reduce)


def _posterior_step(sched, cfg, model_fn, img, t: int, cond, noise_fn, key):
    """One ancestral step at t: the model's clipped x0, the posterior mean,
    and its noise from ``key`` ([2] or [G, 2], ``noise_for``) unless
    t == 0."""
    bt = torch.full((img.shape[0],), t, dtype=torch.long, device=img.device)
    _, x0 = model_predictions(sched, cfg, model_fn, img, bt, cond,
                              clip_x_start=cfg.clip_denoised)
    mean, _, log_var = q_posterior(sched, x0, img, bt)
    if t == 0:
        return mean
    return mean + torch.exp(0.5 * log_var) * noise_for(noise_fn, key, img.shape)


def _init_img(sched, noise_fn, key, shape, start_t: int, x_start):
    """x_T from noise, or with ``start_t`` the clean ``x_start`` noised to
    min(start_t, T - 1)."""
    noise = noise_for(noise_fn, key, shape)
    if start_t == 0:
        return noise
    if x_start is None:
        raise ValueError("start_t truncation needs x_start")
    t0 = torch.full((shape[0],), min(start_t, sched.num_timesteps - 1), dtype=torch.long,
                    device=noise.device)
    return q_sample(sched, x_start, t0, noise)


@torch.no_grad()
def p_sample_loop(
    sched: DiffusionSchedule,
    cfg: GaussianDiffusionConfig,
    model_fn: ModelFn,
    shape: tuple,
    *,
    key,
    noise_fn: KeyNoiseFn,
    cond: Optional[torch.Tensor] = None,
    start_t: int = 0,
    x_start: Optional[torch.Tensor] = None,  # [-1,1]; needed when start_t > 0
) -> torch.Tensor:
    """Ancestral sampling x_T -> x_0 (T UNet calls), or from x_{start_t}
    (``x_start`` noised to start_t, then start_t calls: the truncated
    reverse chain). ``key`` [2] or per-volume [G, 2] (see ``noise_for``).
    Returns [0,1] images."""
    steps = sched.num_timesteps if start_t == 0 else start_t
    init_key, key = prng.split_keys(np.asarray(key, np.uint32))
    img = _init_img(sched, noise_fn, init_key, shape, start_t, x_start)
    for t in range(steps - 1, -1, -1):
        key, nk = prng.split_keys(key)
        img = _posterior_step(sched, cfg, model_fn, img, t, cond, noise_fn, nk)
    return unnormalize_to_zero_to_one(img)


@torch.no_grad()
def interpolate(
    sched: DiffusionSchedule,
    cfg: GaussianDiffusionConfig,
    model_fn: ModelFn,
    x1: torch.Tensor,  # [B,H,W,C] in [-1,1]
    x2: torch.Tensor,
    *,
    key,
    noise_fn: KeyNoiseFn,
    t: Optional[int] = None,
    lam: float = 0.5,
    cond: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Latent interpolation (reference GaussianDiffusion.interpolate): noise
    both images to t from one key [2] each, lerp, then run the ancestral
    chain back to x_0. Returns [-1,1] images."""
    if t is None:
        t = sched.num_timesteps - 1
    k1, k2, key = prng.split(np.asarray(key, np.uint32), 3)
    tb = torch.full((x1.shape[0],), t, dtype=torch.long, device=x1.device)
    xt1 = q_sample(sched, x1, tb, noise_for(noise_fn, k1, x1.shape))
    xt2 = q_sample(sched, x2, tb, noise_for(noise_fn, k2, x2.shape))
    img = (1.0 - lam) * xt1 + lam * xt2
    for ti in range(t - 1, -1, -1):
        key, nk = prng.split(key)
        img = _posterior_step(sched, cfg, model_fn, img, ti, cond, noise_fn, nk)
    return img


def ddim_timesteps(total: int, steps: int) -> list:
    """The (t, t_next) pairs of a DDIM run over ``total`` timesteps: the
    reference's ``linspace(0, total, steps + 2)[:-1]`` cast to int,
    reversed and paired."""
    times = np.linspace(0.0, total, steps + 2)[:-1]
    times = list(reversed(times.astype(int).tolist()))
    return list(zip(times[:-1], times[1:]))


@torch.no_grad()
def ddim_sample(
    sched: DiffusionSchedule,
    cfg: GaussianDiffusionConfig,
    model_fn: ModelFn,
    shape: tuple,
    *,
    key,
    noise_fn: KeyNoiseFn,
    sampling_timesteps: int,
    cond: Optional[torch.Tensor] = None,
    start_t: int = 0,
    x_start: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """DDIM(eta = ``cfg.ddim_sampling_eta``) over ``ddim_timesteps``, from
    noise or from ``x_start`` noised to ``start_t``. ``key`` [2] or
    per-volume [G, 2]. Returns [0,1] images."""
    total = sched.num_timesteps if start_t == 0 else start_t
    eta = cfg.ddim_sampling_eta
    init_key, key = prng.split_keys(np.asarray(key, np.uint32))
    img = _init_img(sched, noise_fn, init_key, shape, start_t, x_start)
    bt = torch.empty((shape[0],), dtype=torch.long, device=img.device)
    for t, t_next in ddim_timesteps(total, sampling_timesteps):
        key, nk = prng.split_keys(key)
        alpha = sched.alphas_cumprod_prev[t]
        alpha_next = sched.alphas_cumprod_prev[t_next]
        pred_noise, x0 = model_predictions(sched, cfg, model_fn, img, bt.fill_(t), cond,
                                           clip_x_start=cfg.clip_denoised)
        sigma = eta * torch.sqrt((1 - alpha / alpha_next) * (1 - alpha_next) / (1 - alpha))
        c = torch.sqrt(torch.clamp_min((1 - alpha_next) - sigma ** 2, 0.0))
        img = x0 * torch.sqrt(alpha_next) + c * pred_noise
        if t_next > 0:
            img = img + sigma * noise_for(noise_fn, nk, shape)
    return unnormalize_to_zero_to_one(img)
