"""3D simplex noise and the reference's octave API (counterpart of
``conditioned_diffusion_models_uad_tpu/ops/simplex3d.py``).

Gustavson's simplex-3D lattice (skew 1/3, unskew 1/6, the corner ranking as
masked comparisons, four corner contributions) with murmur-hashed gradients
chosen among the 12 cube edges, operation by operation as the JAX package
computes it, in plain PyTorch on the tensors' device: the JAX package
computes it in plain XLA, with no Pallas kernel. The uint32 hash runs in
int64 with each product and xor masked back to 32 bits, as
``ops/simplex_hash.py`` does. ``SimplexNoise.rand_2d_octaves`` is the 2D hash
field, kernel K1 on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device
from .simplex_hash import _MASK, _mul32, fractal_noise_2d, octave_constants

_F3 = 1.0 / 3.0
_G3 = 1.0 / 6.0

_M1 = 0x27D4EB2D
_M2 = 0x9E3779B9
_M3 = 0x85EBCA6B
_M4 = 0x165667B1


def _hash_grad3(i, j, k, seed):
    """One of the 12 edge gradients (±1,±1,0)/(±1,0,±1)/(0,±1,±1) per lattice
    point, picked by h % 12 of a murmur-style hash."""
    h = (_mul32(i.long() & _MASK, _M1) ^ _mul32(j.long() & _MASK, _M2)
         ^ _mul32(k.long() & _MASK, _M4) ^ seed)
    h = h ^ (h >> 15)
    h = _mul32(h, _M3)
    h = h ^ (h >> 13)
    idx = h % 12
    axis = idx >> 2  # 0: (x, y), 1: (x, z), 2: (y, z)
    one = torch.ones((), dtype=torch.float32, device=h.device)
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    s1 = torch.where((idx & 1) != 0, -one, one)
    s2 = torch.where((idx & 2) != 0, -one, one)
    gx = torch.where(axis == 0, s1, torch.where(axis == 1, s1, zero))
    gy = torch.where(axis == 0, s2, torch.where(axis == 2, s1, zero))
    gz = torch.where(axis == 0, zero, s2)
    return gx, gy, gz


def simplex3(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
             seed: torch.Tensor) -> torch.Tensor:
    """Simplex noise at float32 points (x, y, z); ``seed`` the uint32 bits in
    int64. Returns values in about [-1, 1]."""
    s = (x + y + z) * _F3
    i = torch.floor(x + s).int()
    j = torch.floor(y + s).int()
    k = torch.floor(z + s).int()
    t = (i + j + k).float() * _G3
    x0 = x - (i - t)
    y0 = y - (j - t)
    z0 = z - (k - t)

    # the six orderings of (x0, y0, z0) as boolean algebra
    a = x0 >= y0
    b = y0 >= z0
    c = x0 >= z0
    false = torch.zeros_like(a)
    true = ~false
    i1 = torch.where(a, b | c, false).int()
    j1 = torch.where(a, false, b).int()
    k1 = torch.where(a, ~(b | c), ~b).int()
    i2 = torch.where(a, true, b & c).int()
    j2 = torch.where(a, b, true).int()
    k2 = torch.where(a, ~b, ~(b & c)).int()

    x1 = x0 - i1 + _G3
    y1 = y0 - j1 + _G3
    z1 = z0 - k1 + _G3
    x2 = x0 - i2 + 2.0 * _G3
    y2 = y0 - j2 + 2.0 * _G3
    z2 = z0 - k2 + 2.0 * _G3
    x3 = x0 - 1.0 + 3.0 * _G3
    y3 = y0 - 1.0 + 3.0 * _G3
    z3 = z0 - 1.0 + 3.0 * _G3

    def corner(dx, dy, dz, ci, cj, ck):
        att = torch.clamp_min(0.6 - dx * dx - dy * dy - dz * dz, 0.0)
        gx, gy, gz = _hash_grad3(ci, cj, ck, seed)
        att2 = att * att
        return att2 * att2 * (gx * dx + gy * dy + gz * dz)

    n = corner(x0, y0, z0, i, j, k)
    n = n + corner(x1, y1, z1, i + i1, j + j1, k + k1)
    n = n + corner(x2, y2, z2, i + i2, j + j2, k + k2)
    n = n + corner(x3, y3, z3, i + 1, j + 1, k + 1)
    return 32.0 * n


def _inv(f: float) -> float:
    """1/f rounded to float32: XLA compiles the JAX package's ``x / f`` by a
    constant into ``x * (1/f)``, which rounds differently from a division
    when f is not a power of two."""
    return float(np.float32(1.0 / f))


def _seed_bits(seed, device: torch.device) -> torch.Tensor:
    """An int32 seed (a Python int or a tensor) as its uint32 bits, int64."""
    return torch.as_tensor(seed, device=device).long().reshape(()) & _MASK


def _device(seed, device: DeviceLike) -> torch.device:
    if torch.is_tensor(seed) and device is None:
        return seed.device
    return resolve_device(device)


def fractal_noise_3d(seed, shape: Tuple[int, int, int], octaves: int = 6,
                     persistence: float = 0.8, frequency: float = 64.0,
                     device: DeviceLike = None) -> torch.Tensor:
    """Layered 3D noise [D, H, W] f32: noise[z, y, x] = Σ amp·simplex3(x/f,
    y/f, z/f), the frequency halving and the amplitude multiplied by
    ``persistence`` each octave. Runs on the seed tensor's device, else on
    ``device`` (default ``cuda``)."""
    dev = _device(seed, device)
    s = _seed_bits(seed, dev)
    d, h, w = shape
    zz = torch.arange(d, device=dev).float()[:, None, None].expand(shape)
    yy = torch.arange(h, device=dev).float()[None, :, None].expand(shape)
    xx = torch.arange(w, device=dev).float()[None, None, :].expand(shape)
    out = torch.zeros(shape, dtype=torch.float32, device=dev)
    ff, amp = octave_constants(octaves, persistence, frequency).tolist()
    for f, a in zip(ff, amp):
        r = _inv(f)
        out = out + a * simplex3(xx * r, yy * r, zz * r, s)
    return out


def fractal_noise_3d_fixed_t(seed, t, shape: Tuple[int, int], octaves: int = 6,
                             persistence: float = 0.8, frequency: float = 64.0,
                             device: DeviceLike = None) -> torch.Tensor:
    """One [1, H, W] plane of the 3D field at the time coordinate ``t``
    (a distinct but coherent field per diffusion step)."""
    dev = _device(seed, device)
    s = _seed_bits(seed, dev)
    h, w = shape
    tt = torch.as_tensor(t, dtype=torch.float32, device=dev)
    yy = torch.arange(h, device=dev).float()[:, None].expand(h, w)
    xx = torch.arange(w, device=dev).float()[None, :].expand(h, w)
    out = torch.zeros((h, w), dtype=torch.float32, device=dev)
    ff, amp = octave_constants(octaves, persistence, frequency).tolist()
    for f, a in zip(ff, amp):
        r = _inv(f)
        out = out + a * simplex3(xx * r, yy * r, (tt * r).expand(h, w), s)
    return out[None]


# AnoDDPM's random-parameter pool: (octaves, persistence, frequency)
RANDOM_PARAM_POOL = (
    (2, 0.6, 16), (6, 0.6, 32), (7, 0.7, 32), (10, 0.8, 64), (5, 0.8, 16),
    (4, 0.6, 16), (1, 0.6, 64), (7, 0.8, 128), (6, 0.9, 64), (2, 0.85, 128),
    (2, 0.85, 64), (2, 0.85, 32), (2, 0.85, 16), (2, 0.85, 8), (2, 0.85, 4),
    (2, 0.85, 2), (1, 0.85, 128), (1, 0.85, 64), (1, 0.85, 32), (1, 0.85, 16),
    (1, 0.85, 8), (1, 0.85, 4), (1, 0.85, 2),
)


def gen_simplex_noise_random_param(rng: np.random.Generator, shape: Tuple[int, int], t: float,
                                   device: DeviceLike = None) -> torch.Tensor:
    """A [1, H, W] fixed-t field with one (octaves, persistence, frequency)
    triple drawn from the pool and a seed drawn from ``rng``, in the JAX
    package's draw order."""
    octv, pers, freq = RANDOM_PARAM_POOL[int(rng.integers(len(RANDOM_PARAM_POOL)))]
    seed = int(rng.integers(0, 2**31 - 1))
    return fractal_noise_3d_fixed_t(seed, float(t), tuple(shape), octv, pers, float(freq),
                                    device=device)


class SimplexNoise:
    """The reference ``Simplex_CLASS`` surface: ``newSeed()`` and the
    rand_2d/3d octave methods, on ``device`` (default ``cuda``)."""

    def __init__(self, seed: int = 0, device: DeviceLike = None):
        self._seed = int(seed)
        self.device = resolve_device(device)

    def newSeed(self, seed: Optional[int] = None):
        if seed is None:
            seed = int(np.random.default_rng().integers(0, 2**31 - 1))
        self._seed = int(seed)

    def _seed_tensor(self) -> torch.Tensor:
        return torch.tensor([self._seed], dtype=torch.int32, device=self.device)

    def rand_2d_octaves(self, shape, octaves=1, persistence=0.5, frequency=32):
        """The 2D hash field [H, W] (kernel K1 on the card)."""
        return fractal_noise_2d(self._seed_tensor(), tuple(shape), octaves, persistence,
                                float(frequency))[0]

    def rand_3d_octaves(self, shape, octaves=1, persistence=0.5, frequency=32):
        return fractal_noise_3d(self._seed_tensor()[0], tuple(shape), octaves, persistence,
                                float(frequency))

    def rand_3d_fixed_T_octaves(self, shape, T, octaves=1, persistence=0.5, frequency=32):
        return fractal_noise_3d_fixed_t(self._seed_tensor()[0], T, tuple(shape), octaves,
                                        persistence, float(frequency))
