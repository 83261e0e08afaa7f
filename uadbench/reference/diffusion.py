"""The cDDPM's objective and single-shot reconstruction in plain form: the
cosine noise schedule (Nichol and Dhariwal), forward noising, the x0
objective under an L1 loss, the intensity augmentation of a training batch,
and Adam. Float32 PyTorch; imports nothing of the system under test.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .noise import fractal_noise


def alpha_bars(timesteps: int = 1000, s: float = 0.008):
    """(sqrt(a_bar_t), sqrt(1 - a_bar_t)) for t = 0..T-1, each float32 [T]:
    betas from the cosine schedule, clipped at 0.999, in float64."""
    x = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64)
    ac = np.cos(((x / timesteps) + s) / (1 + s) * math.pi * 0.5) ** 2
    ac = ac / ac[0]
    betas = np.clip(1.0 - ac[1:] / ac[:-1], 0.0, 0.999)
    a_bar = np.cumprod(1.0 - betas)
    return (torch.from_numpy(np.sqrt(a_bar).astype(np.float32)),
            torch.from_numpy(np.sqrt(1.0 - a_bar).astype(np.float32)))


def denoise(model, img01, t, cond, noise, sched):
    """The x0 prediction of noised slices: ([B] L1 loss per slice, the
    reconstruction [B, H, W, 1] in [0, 1])."""
    sa, s1a = (c.to(img01.device)[t][:, None, None, None] for c in sched)
    x0 = img01 * 2.0 - 1.0
    out = model.unet(sa * x0 + s1a * noise, t, cond)
    return (out - x0).abs().flatten(1).mean(1), (out + 1.0) * 0.5


def model_noise(seeds, hw, model_cfg: dict, device) -> torch.Tensor:
    return fractal_noise(seeds, hw, model_cfg["simplex_octaves"],
                         model_cfg["simplex_persistence"], model_cfg["simplex_frequency"],
                         device=device)


@torch.no_grad()
def reconstruct_volume(model, vol_hwd, seeds, model_cfg: dict, sched, row_chunk: int = 64):
    """A volume's single-shot reconstruction [H, W, D]: its slices encoded
    clean, each ensemble member noised with its own field at its t and
    denoised, and the members averaged. Rows are independent in eval mode,
    so the UNet runs ``row_chunk`` rows at a time."""
    h, w, d = vol_hwd.shape
    slices = vol_hwd.movedim(-1, 0)[..., None].float()
    model.eval()
    cond = torch.cat([model.encoder(slices[i:i + row_chunk]) for i in range(0, d, row_chunk)])
    fields = model_noise(seeds, (h, w), model_cfg, vol_hwd.device)
    total = torch.zeros_like(slices)
    for m, t_m in enumerate(model_cfg["step_ensemble"]):
        t = torch.full((d,), t_m - 1, dtype=torch.long, device=vol_hwd.device)
        noise = fields[m][None, :, :, None].expand(d, h, w, 1)
        total += torch.cat([
            denoise(model, slices[i:i + row_chunk], t[i:i + row_chunk], cond[i:i + row_chunk],
                    noise[i:i + row_chunk], sched)[1] for i in range(0, d, row_chunk)])
    return (total / len(model_cfg["step_ensemble"]))[..., 0].movedim(0, -1)


def _gamma(x, log_gamma):
    return x.clamp_min(0.0) ** torch.exp(log_gamma)[:, None, None, None]


def _bias_field(x, coeffs, order: int = 3):
    b, h, w, _ = x.shape
    u = torch.linspace(-1.0, 1.0, h, device=x.device)[None, :, None]
    v = torch.linspace(-1.0, 1.0, w, device=x.device)[None, None, :]
    field = torch.zeros((b, h, w), device=x.device)
    k = 0
    for i in range(order + 1):
        for j in range(order + 1 - i):
            field = field + coeffs[:, k, None, None] * (u ** i) * (v ** j)
            k += 1
    return x * torch.exp(field)[..., None]


def _blur(x, std, ksize: int = 9):
    r = ksize // 2
    d = torch.arange(-r, r + 1, dtype=torch.float32, device=x.device)
    k = torch.exp(-(d[None] ** 2) / (2 * torch.clamp_min(std, 1e-3)[:, None] ** 2))
    k = torch.where(std[:, None] < 0.05, (d == 0).float()[None], k / k.sum(-1, keepdim=True))
    img = x[..., 0]
    b, h, w = img.shape
    cols = F.pad(img[:, None], (0, 0, r, r), mode="replicate")[:, 0]  # rows padded
    img = sum(cols[:, i:i + h] * k[:, i, None, None] for i in range(ksize))
    rows = F.pad(img[:, None], (r, r, 0, 0), mode="replicate")[:, 0]
    return sum(rows[:, :, i:i + w] * k[:, i, None, None] for i in range(ksize))[..., None]


def _ghosting(x, num, intensity, along_h):
    b, h, w, _ = x.shape
    spect = torch.fft.fft2(x[..., 0])

    def lines(n):
        idx = torch.arange(n, device=x.device)
        sel = ((idx[None] % num.long()[:, None]) == 0) & (torch.minimum(idx, n - idx)[None]
                                                         > n * 0.05)
        return torch.where(sel, (1.0 - intensity)[:, None], 1.0)

    mod = torch.where(along_h[:, None, None], lines(h)[:, :, None].expand(b, h, w),
                      lines(w)[:, None, :].expand(b, h, w))
    return torch.fft.ifft2(spect * mod).real[..., None]


def augment_intensity(x, a: dict):
    """Gamma, a cubic bias field, a 9-tap Gaussian blur with edge padding and
    k-space ghosting, each where its per-sample gate is on."""
    def gated(gate, y):
        return torch.where(gate[:, None, None, None], y, x)

    x = gated(a["gamma_gate"], _gamma(x, a["log_gamma"]))
    x = gated(a["bias_gate"], _bias_field(x, a["bias_coeffs"]))
    x = gated(a["blur_gate"], _blur(x, a["blur_std"]))
    return gated(a["ghost_gate"], _ghosting(x, a["ghost_num"], a["ghost_intensity"],
                                            a["ghost_along_h"]))


class Adam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias
    corrected) over a list of float32 tensors; ``m``, ``v`` and ``n``, when
    given, are the moments and the step count to continue from."""

    def __init__(self, params, lr: float, m=None, v=None, n: int = 0):
        self.params, self.lr, self.n = list(params), lr, n
        self.m = [t.clone() for t in m] if m else [torch.zeros_like(p) for p in self.params]
        self.v = [t.clone() for t in v] if v else [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self):
        self.n += 1
        c1, c2 = 1 - 0.9 ** self.n, 1 - 0.999 ** self.n
        for p, m, v in zip(self.params, self.m, self.v):
            m.mul_(0.9).add_(p.grad, alpha=0.1)
            v.mul_(0.999).addcmul_(p.grad, p.grad, value=0.001)
            p.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + 1e-8))
