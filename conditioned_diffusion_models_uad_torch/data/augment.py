"""Intensity augmentations for slice batches (counterpart of
``conditioned_diffusion_models_uad_tpu/data/augment.py`` :23-97, 202-216).

The ``aug_intensity`` policy the flagship cDDPM trains with: random gamma
(p = .5), a bias field of order 3 (p = .25), a 9-tap separable Gaussian blur
with edge padding (p = .25) and k-space ghosting (p = .5), each gated per
sample and applied to the whole batch [B, H, W, 1] on its device.

Random draws are explicit: ``draw_aug_intensity`` makes the gates and the
per-sample parameters from a ``torch.Generator``, and ``aug_intensity_apply``
applies them, so a test can hand both packages the same draws. The spatial,
noise and motion families of ``full_augment_batch`` are not ported yet.
"""
from __future__ import annotations

import dataclasses

import torch

GATE_P = {"gamma": 0.5, "bias": 0.25, "blur": 0.25, "ghost": 0.5}
BIAS_ORDER = 3
BLUR_MAX_STD = 2.0
BLUR_KSIZE = 9
GHOSTS = (4, 10)


def n_bias_coeffs(order: int = BIAS_ORDER) -> int:
    return sum(1 for i in range(order + 1) for _ in range(order + 1 - i))


@dataclasses.dataclass(frozen=True)
class AugDraws:
    """One batch's draws: per family a gate [B] bool and its parameters."""

    gamma_gate: torch.Tensor
    log_gamma: torch.Tensor  # [B] U(-0.3, 0.3)
    bias_gate: torch.Tensor
    bias_coeffs: torch.Tensor  # [B, 10] U(-0.5, 0.5)
    blur_gate: torch.Tensor
    blur_std: torch.Tensor  # [B] U(0, 2)
    ghost_gate: torch.Tensor
    ghost_num: torch.Tensor  # [B] int in [4, 10]
    ghost_intensity: torch.Tensor  # [B] U(0.5, 1)
    ghost_along_h: torch.Tensor  # [B] bool

    def to(self, device) -> "AugDraws":
        return AugDraws(**{f.name: getattr(self, f.name).to(device)
                           for f in dataclasses.fields(self)})


def draw_aug_intensity(generator: torch.Generator, b: int) -> AugDraws:
    """Gates and parameters for ``b`` samples, on the generator's device."""
    dev = generator.device

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=generator, device=dev)

    def gate(p):
        return torch.rand((b,), generator=generator, device=dev) < p

    return AugDraws(
        gamma_gate=gate(GATE_P["gamma"]), log_gamma=uniform((b,), -0.3, 0.3),
        bias_gate=gate(GATE_P["bias"]),
        bias_coeffs=uniform((b, n_bias_coeffs()), -0.5, 0.5),
        blur_gate=gate(GATE_P["blur"]), blur_std=uniform((b,), 0.0, BLUR_MAX_STD),
        ghost_gate=gate(GATE_P["ghost"]),
        ghost_num=torch.randint(GHOSTS[0], GHOSTS[1] + 1, (b,), generator=generator,
                                device=dev),
        ghost_intensity=uniform((b,), 0.5, 1.0),
        ghost_along_h=torch.rand((b,), generator=generator, device=dev) < 0.5,
    )


def apply_gamma(x: torch.Tensor, log_gamma: torch.Tensor) -> torch.Tensor:
    """x**gamma with gamma = exp(log_gamma) per sample; x clipped at 0."""
    return x.clamp_min(0.0) ** torch.exp(log_gamma)[:, None, None, None]


def apply_bias_field(x: torch.Tensor, coeffs: torch.Tensor,
                     order: int = BIAS_ORDER) -> torch.Tensor:
    """Multiply by exp(P(u, v)), P the per-sample polynomial of ``coeffs``
    over u, v in [-1, 1] (monomials u^i v^j, i + j <= order, i-major)."""
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


def apply_blur(x: torch.Tensor, std: torch.Tensor, ksize: int = BLUR_KSIZE) -> torch.Tensor:
    """Separable Gaussian blur, per-sample std (std < 0.05: identity), edge
    padding; rows first, then columns, taps summed in order."""
    r = ksize // 2
    d = torch.arange(-r, r + 1, dtype=torch.float32, device=x.device)
    s = torch.clamp_min(std, 1e-3)[:, None]
    k1d = torch.exp(-(d[None, :] ** 2) / (2 * s ** 2))
    delta = (d == 0).float()[None, :]
    k1d = torch.where(std[:, None] < 0.05, delta, k1d / k1d.sum(-1, keepdim=True))
    img = x[..., 0]  # [B, H, W]
    h, w = img.shape[1:]

    def taps(padded, dim, n):
        acc = 0
        for i in range(ksize):
            acc = acc + padded.narrow(dim, i, n) * k1d[:, i, None, None]
        return acc

    col = torch.cat([img[:, :1].expand(-1, r, -1), img,
                     img[:, -1:].expand(-1, r, -1)], dim=1)
    img = taps(col, 1, h)
    row = torch.cat([img[:, :, :1].expand(-1, -1, r), img,
                     img[:, :, -1:].expand(-1, -1, r)], dim=2)
    return taps(row, 2, w)[..., None]


def apply_ghosting(x: torch.Tensor, num_ghosts: torch.Tensor, intensity: torch.Tensor,
                   along_h: torch.Tensor) -> torch.Tensor:
    """Attenuate every ``num_ghosts``-th k-space line along H (``along_h``)
    or W by (1 - intensity), sparing lines within 5% of the k-space centre.
    The spectrum is unshifted, so the centre is index 0 and the distance to
    it is circular."""
    b, h, w, _ = x.shape
    dev = x.device
    spect = torch.fft.fft2(x[..., 0])
    ng = num_ghosts.long()[:, None]
    keep = (1.0 - intensity)[:, None]

    def line_mod(n):
        idx = torch.arange(n, device=dev)
        fdist = torch.minimum(idx, n - idx)
        sel = ((idx[None, :] % ng) == 0) & (fdist[None, :] > n * 0.05)
        return torch.where(sel, keep, torch.ones((), device=dev))  # [B, n]

    mod = torch.where(along_h[:, None, None],
                      line_mod(h)[:, :, None].expand(b, h, w),
                      line_mod(w)[:, None, :].expand(b, h, w))
    return torch.fft.ifft2(spect * mod).real[..., None]


def aug_intensity_apply(x: torch.Tensor, draws: AugDraws) -> torch.Tensor:
    """The aug_intensity policy on a slice batch [B, H, W, 1] in [0, 1]:
    gamma, bias field, blur, ghosting, each where its gate is on."""
    def gated(gate, y, x):
        return torch.where(gate[:, None, None, None], y, x)

    x = gated(draws.gamma_gate, apply_gamma(x, draws.log_gamma), x)
    x = gated(draws.bias_gate, apply_bias_field(x, draws.bias_coeffs), x)
    x = gated(draws.blur_gate, apply_blur(x, draws.blur_std), x)
    x = gated(draws.ghost_gate, apply_ghosting(x, draws.ghost_num, draws.ghost_intensity,
                                               draws.ghost_along_h), x)
    return x
