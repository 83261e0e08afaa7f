"""The cDDPM's noise draws in plain form: the per-volume seeds of an eval
stage (JAX's threefry2x32 keys: ``fold_in``, ``split``, ``randint``) and the
fractal OpenSimplex-2D field with hashed gradients that each seed stands for.

Written from the definitions (Salmon et al., "Parallel random numbers: as
easy as 1, 2, 3" for threefry2x32 as JAX uses it; Spencer's OpenSimplex2 for
the lattice walk; a 32-bit multiply-xorshift hash for the gradient choice),
in numpy and float32 PyTorch. Imports nothing of the system under test.
"""
from __future__ import annotations

import numpy as np
import torch

INT32_MAX = 2**31 - 1
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
STRETCH2 = -0.211324865405187  # (1/sqrt(3) - 1) / 2
SQUISH2 = 0.366025403784439  # (sqrt(3) - 1) / 2
NORM2 = 47.0
_M1, _M2, _M3, _MASK = 0x27D4EB2D, 0x9E3779B9, 0x85EBCA6B, 0xFFFFFFFF


def _threefry(key, x1, x2):
    key = np.asarray(key, dtype=np.uint32)
    ks = [key[..., 0], key[..., 1], key[..., 0] ^ key[..., 1] ^ np.uint32(0x1BD11BDA)]
    with np.errstate(over="ignore"):
        x = list(np.broadcast_arrays(np.atleast_1d(np.asarray(x1, np.uint32) + ks[0]),
                                     np.atleast_1d(np.asarray(x2, np.uint32) + ks[1])))
        for i in range(5):
            for r in _ROT[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = ((x[1] << np.uint32(r)) | (x[1] >> np.uint32(32 - r))) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    shape = np.broadcast_shapes(np.shape(x1), np.shape(x2), np.shape(key)[:-1])
    return x[0].reshape(shape), x[1].reshape(shape)


def prng_key(seed: int) -> np.ndarray:
    return np.array([0, int(seed) & 0xFFFFFFFF], dtype=np.uint32)


def fold_in(key, i: int) -> np.ndarray:
    b1, b2 = _threefry(key, np.uint32(0), np.uint32(int(i) & 0xFFFFFFFF))
    return np.array([b1.item(), b2.item()], dtype=np.uint32)


def split(key, n: int) -> np.ndarray:
    b1, b2 = _threefry(key, np.zeros(n, np.uint32), np.arange(n, dtype=np.uint32))
    return np.stack([b1, b2], axis=-1)


def randint_int32(key) -> int:
    """One int32 draw uniform in [0, INT32_MAX), as jax.random.randint: two
    bit streams from the key's two halves, combined modulo the span."""
    k1, k2 = split(key, 2)
    hi = np.bitwise_xor(*_threefry(k1, np.uint32(0), np.uint32(0)))
    lo = np.bitwise_xor(*_threefry(k2, np.uint32(0), np.uint32(0)))
    span = INT32_MAX
    mult = ((2**16 % span) ** 2 & _MASK) % span  # 2^32 mod span, the square wrapping
    wrapped = (((int(hi) % span) * mult & _MASK) + int(lo) % span) & _MASK
    return wrapped % span


def volume_seeds(stage_key, index: int, members: int) -> list:
    """Volume ``index`` of a stage: the seed of each ensemble member."""
    return [randint_int32(k) for k in split(fold_in(stage_key, index), members)]


def _mul32(a, m):
    return ((a * (m & 0xFFFF)) + (((a * (m >> 16)) & 0xFFFF) << 16)) & _MASK


def _grad(xsv, ysv, seed):
    h = _mul32(xsv.long() & _MASK, _M1) ^ _mul32(ysv.long() & _MASK, _M2) ^ seed
    h = h ^ (h >> 15)
    h = _mul32(h, _M3)
    h = h ^ (h >> 13)
    swap = (h & 4) != 0
    s1 = 1.0 - 2.0 * (h & 1).float()
    s2 = 1.0 - ((h & 2) != 0).float() * 2.0
    return s1 * torch.where(swap, 2.0, 5.0), s2 * torch.where(swap, 5.0, 2.0)


def _simplex(x, y, seed):
    def contrib(dx, dy, xv, yv):
        a = torch.clamp_min(2.0 - dx * dx - dy * dy, 0.0)
        gx, gy = _grad(xv, yv, seed)
        return a * a * a * a * (gx * dx + gy * dy)

    st = (x + y) * STRETCH2
    xs, ys = x + st, y + st
    xb, yb = torch.floor(xs).int(), torch.floor(ys).int()
    sq = (xb + yb).float() * SQUISH2
    dx0, dy0 = x - (xb + sq), y - (yb + sq)
    xi, yi = xs - xb, ys - yb
    s = xi + yi
    value = contrib(dx0 - 1 - SQUISH2, dy0 - SQUISH2, xb + 1, yb)
    value = value + contrib(dx0 - SQUISH2, dy0 - 1 - SQUISH2, xb, yb + 1)
    w = torch.where
    lower, xgty = s <= 1.0, xi > yi
    zl = 1.0 - s
    al = (zl > xi) | (zl > yi)
    zu = 2.0 - s
    au = (zu < xi) | (zu < yi)
    ex = w(lower, w(al, w(xgty, xb + 1, xb - 1), xb + 1), w(au, w(xgty, xb + 2, xb), xb))
    ey = w(lower, w(al, w(xgty, yb - 1, yb + 1), yb + 1), w(au, w(xgty, yb, yb + 2), yb))
    edx = w(lower, w(al, w(xgty, dx0 - 1, dx0 + 1), dx0 - 1 - 2 * SQUISH2),
            w(au, w(xgty, dx0 - 2 - 2 * SQUISH2, dx0 - 2 * SQUISH2), dx0))
    edy = w(lower, w(al, w(xgty, dy0 + 1, dy0 - 1), dy0 - 1 - 2 * SQUISH2),
            w(au, w(xgty, dy0 - 2 * SQUISH2, dy0 - 2 - 2 * SQUISH2), dy0))
    value = value + contrib(w(lower, dx0, dx0 - 1 - 2 * SQUISH2),
                            w(lower, dy0, dy0 - 1 - 2 * SQUISH2),
                            w(lower, xb, xb + 1), w(lower, yb, yb + 1))
    value = value + contrib(edx, edy, ex, ey)
    return value / NORM2


def fractal_noise(seeds, hw, octaves: int = 6, persistence: float = 0.8,
                  frequency: float = 64.0, device="cpu") -> torch.Tensor:
    """One [H, W] float32 field a seed: sum over octaves of amplitude
    persistence^o times the simplex value at (column, row) / (frequency / 2^o)."""
    h, w = hw
    seed = (torch.as_tensor(seeds, device=device).long() & _MASK)[:, None, None]
    ii = torch.arange(h, device=device).float()[None, :, None].expand(len(seed), h, w)
    jj = torch.arange(w, device=device).float()[None, None, :].expand(len(seed), h, w)
    out = torch.zeros((len(seed), h, w), device=device)
    f, a = float(frequency), 1.0
    for _ in range(octaves):
        out = out + np.float32(a) * _simplex(jj / np.float32(f), ii / np.float32(f), seed)
        f /= 2.0
        a *= persistence
    return out
