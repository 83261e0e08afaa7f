"""Augmentations for slice batches (counterpart of
``conditioned_diffusion_models_uad_tpu/data/augment.py``).

The ``aug_intensity`` policy the flagship cDDPM trains with: random gamma
(p = .5), a bias field of order 3 (p = .25), a 9-tap separable Gaussian blur
with edge padding (p = .25) and k-space ghosting (p = .5), each gated per
sample and applied to the whole batch [B, H, W, 1] on its device. The full
set (``trainer.aug_full``) puts the spatial families before it — a flip of W
(p = .5), a random affine (p = .25) and an elastic deformation (p = .25),
the image warped bilinearly and the brain mask by its nearest voxel through
the same transform — and Gaussian noise (p = .5) and k-space motion
(p = .1) after it.

Random draws are explicit: ``draw_aug_intensity`` / ``draw_aug_full`` make
the gates and the per-sample parameters from a ``torch.Generator``, and
``aug_intensity_apply`` / ``full_augment_apply`` apply them, so a test can
hand both packages the same draws.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..ops.interp import map_coordinates, resize

GATE_P = {"gamma": 0.5, "bias": 0.25, "blur": 0.25, "ghost": 0.5,
          "flip": 0.5, "affine": 0.25, "elastic": 0.25, "noise": 0.5, "motion": 0.1}
BIAS_ORDER = 3
BLUR_MAX_STD = 2.0
BLUR_KSIZE = 9
GHOSTS = (4, 10)
AFFINE_MAX_DEG, AFFINE_SCALE, AFFINE_MAX_SHIFT = 10.0, 0.1, 5.0
ELASTIC_GRID, ELASTIC_MAX_DISP = 4, 7.5
NOISE_MAX_STD = 0.1
MOTION_TRANSFORMS, MOTION_MAX_SHIFT = 3, 4.0


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
        return _to(self, device)


def _to(draws, device):
    return type(draws)(**{f.name: getattr(draws, f.name).to(device)
                          for f in dataclasses.fields(draws)})


@dataclasses.dataclass(frozen=True)
class FullAugDraws:
    """The draws of the full set: the spatial families', the intensity
    policy's and noise's and motion's, each with its gate [B] bool."""

    flip_gate: torch.Tensor
    affine_gate: torch.Tensor
    affine_deg: torch.Tensor  # [B] U(-10, 10) degrees
    affine_scale: torch.Tensor  # [B] U(-0.1, 0.1), the scale is 1 + it
    affine_shift: torch.Tensor  # [B, 2] U(-5, 5) pixels (y, x)
    elastic_gate: torch.Tensor
    elastic_disp: torch.Tensor  # [B, 2, 4, 4] U(-7.5, 7.5) pixels
    intensity: AugDraws
    noise_gate: torch.Tensor
    noise_std: torch.Tensor  # [B] U(0, 0.1)
    noise: torch.Tensor  # [B, H, W, 1] standard normal
    motion_gate: torch.Tensor
    motion_shifts: torch.Tensor  # [B, 3, 2] U(-4, 4) pixels
    motion_weights: torch.Tensor  # [B, 4] Dirichlet(1, 1, 1, 1)

    def to(self, device) -> "FullAugDraws":
        return _to(self, device)


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


def draw_aug_full(generator: torch.Generator, b: int, h: int, w: int) -> FullAugDraws:
    """The full set's draws for ``b`` samples of ``h`` x ``w``, on the
    generator's device. The Dirichlet weights are normalised Exp(1) draws,
    -log(U)."""
    dev = generator.device

    def rand(shape):
        return torch.rand(shape, generator=generator, device=dev)

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * rand(shape)

    def gate(name):
        return rand((b,)) < GATE_P[name]

    flip_gate = gate("flip")
    affine_gate = gate("affine")
    affine = (uniform((b,), -AFFINE_MAX_DEG, AFFINE_MAX_DEG),
              uniform((b,), -AFFINE_SCALE, AFFINE_SCALE),
              uniform((b, 2), -AFFINE_MAX_SHIFT, AFFINE_MAX_SHIFT))
    elastic_gate = gate("elastic")
    disp = uniform((b, 2, ELASTIC_GRID, ELASTIC_GRID), -ELASTIC_MAX_DISP, ELASTIC_MAX_DISP)
    intensity = draw_aug_intensity(generator, b)
    noise_gate = gate("noise")
    noise_std = uniform((b,), 0.0, NOISE_MAX_STD)
    noise = torch.randn((b, h, w, 1), generator=generator, device=dev)
    motion_gate = gate("motion")
    shifts = uniform((b, MOTION_TRANSFORMS, 2), -MOTION_MAX_SHIFT, MOTION_MAX_SHIFT)
    e = -torch.log(1.0 - rand((b, MOTION_TRANSFORMS + 1)))  # U in (0, 1]
    return FullAugDraws(flip_gate, affine_gate, *affine, elastic_gate, disp, intensity,
                        noise_gate, noise_std, noise, motion_gate, shifts,
                        e / e.sum(dim=1, keepdim=True))


def draw_aug(generator: torch.Generator, b: int, hw, augment):
    """A step's augmentation draws: None for ``augment`` False/None, the
    intensity policy's for True or 'intensity', the full set's for 'full'."""
    if not augment:
        return None
    if augment == "full":
        return draw_aug_full(generator, b, *hw)
    if augment is True or augment == "intensity":
        return draw_aug_intensity(generator, b)
    raise ValueError(f"augment={augment!r}: one of False, True, 'intensity', 'full'")


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


def apply_noise(x: torch.Tensor, std: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """x + std·noise, std [B] per sample."""
    return x + std[:, None, None, None] * noise


def apply_motion(x: torch.Tensor, shifts: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """k-space motion: the spectrum as a weighted mix of the image and
    ``shifts.shape[1]`` shifted copies of it (each shift a phase ramp),
    weights [B, T + 1], shifts [B, T, 2] (y, x) in pixels."""
    b, h, w, _ = x.shape
    dev = x.device
    fy = torch.fft.fftfreq(h, device=dev)[:, None]
    fx = torch.fft.fftfreq(w, device=dev)[None, :]
    spect = torch.fft.fft2(x[..., 0])
    acc = weights[:, 0, None, None] * spect
    for t in range(shifts.shape[1]):
        phase = fy * shifts[:, t, 0, None, None] + fx * shifts[:, t, 1, None, None]
        ramp = torch.exp(torch.complex(torch.zeros_like(phase), -2.0 * math.pi * phase))
        acc = acc + weights[:, t + 1, None, None] * spect * ramp
    return torch.fft.ifft2(acc).real[..., None]


def affine_coords(deg: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                  h: int, w: int) -> torch.Tensor:
    """Source positions [B, 2, H, W] of a rotation by ``deg`` about the
    centre, a scale of 1 + ``scale`` and a shift [B, 2] (y, x)."""
    dev = deg.device
    ang = (deg * math.pi / 180)[:, None, None]
    sc = (1.0 + scale)[:, None, None]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w) - cy
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w) - cx
    cos, sin = torch.cos(ang), torch.sin(ang)
    src_y = (cos * yy - sin * xx) / sc + cy + shift[:, 0, None, None]
    src_x = (sin * yy + cos * xx) / sc + cx + shift[:, 1, None, None]
    return torch.stack([src_y, src_x], dim=1)


def elastic_coords(disp: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Source positions [B, 2, H, W]: the identity plus the coarse
    displacement grid [B, 2, g, g] resized to H x W by ``jax.image``'s cubic
    (Keys a = -0.5, half-pixel centres)."""
    b = disp.shape[0]
    field = resize(disp, (b, 2, h, w), "cubic")
    yy = torch.arange(h, dtype=torch.float32, device=disp.device)[:, None].expand(h, w)
    xx = torch.arange(w, dtype=torch.float32, device=disp.device)[None, :].expand(h, w)
    return torch.stack([yy + field[:, 0], xx + field[:, 1]], dim=1)


def _warp_gated(gate, coords, vol, mask):
    """vol bilinearly and mask by its nearest voxel at ``coords`` where
    ``gate``; mode 'nearest' at the edges."""
    g = gate[:, None, None, None]
    vol = torch.where(g, map_coordinates(vol[..., 0], coords, 1)[..., None], vol)
    if mask is not None:
        mask = torch.where(g, map_coordinates(mask[..., 0], coords, 0)[..., None], mask)
    return vol, mask


def spatial_augment_apply(vol: torch.Tensor, mask: Optional[torch.Tensor],
                          draws: FullAugDraws):
    """Flip of W, then the affine, then the elastic warp, each where its gate
    is on, on the image and (when given) the mask alike. Returns (vol, mask)."""
    _, h, w, _ = vol.shape
    flip = draws.flip_gate[:, None, None, None]
    vol = torch.where(flip, torch.flip(vol, dims=[2]), vol)
    if mask is not None:
        mask = torch.where(flip, torch.flip(mask, dims=[2]), mask)
    coords = affine_coords(draws.affine_deg, draws.affine_scale, draws.affine_shift, h, w)
    vol, mask = _warp_gated(draws.affine_gate, coords, vol, mask)
    coords = elastic_coords(draws.elastic_disp, h, w)
    return _warp_gated(draws.elastic_gate, coords, vol, mask)


def full_augment_apply(vol: torch.Tensor, mask: Optional[torch.Tensor],
                       draws: FullAugDraws):
    """The full set on a slice batch [B, H, W, 1] and its mask: the spatial
    families on both, then the intensity policy, noise and motion on the
    image. Returns (vol, mask)."""
    vol, mask = spatial_augment_apply(vol, mask, draws)
    vol = aug_intensity_apply(vol, draws.intensity)
    g = draws.noise_gate[:, None, None, None]
    vol = torch.where(g, apply_noise(vol, draws.noise_std, draws.noise), vol)
    g = draws.motion_gate[:, None, None, None]
    vol = torch.where(g, apply_motion(vol, draws.motion_shifts, draws.motion_weights), vol)
    return vol, mask
