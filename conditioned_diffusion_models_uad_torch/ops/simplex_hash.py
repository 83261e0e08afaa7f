"""Fractal OpenSimplex-2D noise with hashed gradients (counterpart of
``conditioned_diffusion_models_uad_tpu/ops/simplex_pallas.py``).

``fractal_noise_2d_hash`` is the plain PyTorch version: it mirrors
``_hash_grad``, ``_simplex2_hash`` and ``_fractal_body`` operation by
operation. ``fractal_noise_2d`` is the wrapper: it launches kernel K1
(``csrc/simplex_noise.cu``) for a CUDA seed tensor and takes the plain version
only for a CPU one.

CPU PyTorch has no ``>>`` for uint32, so the plain hash runs in int64 with
every product and xor masked back to 32 bits.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build
from .simplex import NORM2, SQUISH2, STRETCH2

_M1 = 0x27D4EB2D
_M2 = 0x9E3779B9
_M3 = 0x85EBCA6B
_MASK = 0xFFFFFFFF


def _mul32(a: torch.Tensor, m: int) -> torch.Tensor:
    """(a * m) mod 2**32 for int64 a in [0, 2**32), without int64 overflow:
    the constant is split into 16-bit halves."""
    lo = a * (m & 0xFFFF)
    hi = ((a * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _hash_grad(xsv, ysv, seed):
    h = _mul32(xsv.long() & _MASK, _M1) ^ _mul32(ysv.long() & _MASK, _M2) ^ seed
    h = h ^ (h >> 15)
    h = _mul32(h, _M3)
    h = h ^ (h >> 13)
    swap = (h & 4) != 0
    one = torch.ones((), dtype=torch.float32, device=h.device)
    s1 = torch.where((h & 1) != 0, -one, one)
    s2 = torch.where((h & 2) != 0, -one, one)
    gx = s1 * torch.where(swap, 2.0 * one, 5.0 * one)
    gy = s2 * torch.where(swap, 5.0 * one, 2.0 * one)
    return gx, gy


def _simplex2_hash(x, y, seed):
    def contribution(dx, dy, xsv, ysv):
        attn = torch.clamp_min(2.0 - dx * dx - dy * dy, 0.0)
        attn2 = attn * attn
        gx, gy = _hash_grad(xsv, ysv, seed)
        return attn2 * attn2 * (gx * dx + gy * dy)

    stretch = (x + y) * STRETCH2
    xs = x + stretch
    ys = y + stretch
    xsb = torch.floor(xs).int()
    ysb = torch.floor(ys).int()
    squish = (xsb + ysb).float() * SQUISH2
    dx0 = x - (xsb + squish)
    dy0 = y - (ysb + squish)
    xins = xs - xsb
    yins = ys - ysb
    in_sum = xins + yins

    value = contribution(dx0 - 1 - SQUISH2, dy0 - SQUISH2, xsb + 1, ysb)
    value += contribution(dx0 - SQUISH2, dy0 - 1 - SQUISH2, xsb, ysb + 1)

    lower = in_sum <= 1.0
    xgty = xins > yins
    where = torch.where

    zins_l = 1.0 - in_sum
    a_l = (zins_l > xins) | (zins_l > yins)
    ext_x_l = where(a_l, where(xgty, xsb + 1, xsb - 1), xsb + 1)
    ext_y_l = where(a_l, where(xgty, ysb - 1, ysb + 1), ysb + 1)
    ext_dx_l = where(a_l, where(xgty, dx0 - 1, dx0 + 1), dx0 - 1 - 2 * SQUISH2)
    ext_dy_l = where(a_l, where(xgty, dy0 + 1, dy0 - 1), dy0 - 1 - 2 * SQUISH2)

    zins_u = 2.0 - in_sum
    a_u = (zins_u < xins) | (zins_u < yins)
    ext_x_u = where(a_u, where(xgty, xsb + 2, xsb), xsb)
    ext_y_u = where(a_u, where(xgty, ysb, ysb + 2), ysb)
    ext_dx_u = where(a_u, where(xgty, dx0 - 2 - 2 * SQUISH2, dx0 - 2 * SQUISH2), dx0)
    ext_dy_u = where(a_u, where(xgty, dy0 - 2 * SQUISH2, dy0 - 2 - 2 * SQUISH2), dy0)

    ext_x = where(lower, ext_x_l, ext_x_u)
    ext_y = where(lower, ext_y_l, ext_y_u)
    ext_dx = where(lower, ext_dx_l, ext_dx_u)
    ext_dy = where(lower, ext_dy_l, ext_dy_u)

    c_x = where(lower, xsb, xsb + 1)
    c_y = where(lower, ysb, ysb + 1)
    c_dx = where(lower, dx0, dx0 - 1 - 2 * SQUISH2)
    c_dy = where(lower, dy0, dy0 - 1 - 2 * SQUISH2)

    value += contribution(c_dx, c_dy, c_x, c_y)
    value += contribution(ext_dx, ext_dy, ext_x, ext_y)
    return value / NORM2


def octave_constants(octaves: int = 6, persistence: float = 0.8,
                     frequency: float = 64.0) -> torch.Tensor:
    """float32 [2, octaves]: row 0 the frequency of each octave, row 1 its
    amplitude, as the JAX loop (``ops/simplex_pallas.py::_fractal_body``)
    makes them in double (``f /= 2.0``, ``amp *= persistence``) and float32
    arithmetic then rounds them."""
    ff, amp = [], []
    f, a = float(frequency), 1.0
    for _ in range(octaves):
        ff.append(f)
        amp.append(a)
        f /= 2.0
        a *= persistence
    return torch.tensor([ff, amp], dtype=torch.float32).reshape(2, octaves)


def fractal_noise_2d_hash(
    seeds: torch.Tensor,  # [N] int32
    shape: Tuple[int, int],
    octaves: int = 6,
    persistence: float = 0.8,
    frequency: float = 64.0,
) -> torch.Tensor:
    """Plain PyTorch version: one [H, W] field per seed -> [N, H, W] f32."""
    h, w = shape
    dev = seeds.device
    seed = (seeds.long() & _MASK)[:, None, None]  # [N, 1, 1] as uint32 bits
    ii = torch.arange(h, dtype=torch.int32, device=dev).float()[None, :, None]
    jj = torch.arange(w, dtype=torch.int32, device=dev).float()[None, None, :]
    ii = ii.expand(seeds.shape[0], h, w)
    jj = jj.expand(seeds.shape[0], h, w)
    out = torch.zeros((seeds.shape[0], h, w), dtype=torch.float32, device=dev)
    ff, amp = octave_constants(octaves, persistence, frequency).tolist()
    for f, a in zip(ff, amp):
        out = out + a * _simplex2_hash(jj / f, ii / f, seed)
    return out


_ARGTYPES = {"simplex_fractal_noise": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_void_p, ctypes.c_void_p]}
MAX_OCTAVES = 32  # csrc/simplex_noise.cu kMaxOctaves


def fractal_noise_2d(
    seeds: torch.Tensor,  # [N] int32
    shape: Tuple[int, int],
    octaves: int = 6,
    persistence: float = 0.8,
    frequency: float = 64.0,
) -> torch.Tensor:
    """One fractal field per seed, [N] int32 -> [N, H, W] f32. Launches K1 for
    a CUDA tensor (one launch for all N fields); the plain version serves a
    CPU tensor only. ``fractal_noise_2d.launches`` counts the launches."""
    if seeds.dim() != 1 or seeds.dtype != torch.int32:
        raise ValueError(f"seeds must be a [N] int32 tensor, got {seeds.dtype} "
                         f"{tuple(seeds.shape)}")
    if seeds.device.type == "cpu":
        return fractal_noise_2d_hash(seeds, shape, octaves, persistence, frequency)
    if seeds.device.type != "cuda":
        raise ValueError(f"unsupported device {seeds.device}")
    h, w = shape
    if not 0 <= octaves <= MAX_OCTAVES or h > 65535 or seeds.shape[0] > 65535:
        raise ValueError(f"K1 takes 0..{MAX_OCTAVES} octaves and at most 65535 rows "
                         f"and fields, got {octaves}, {h}, {seeds.shape[0]}")
    seeds = seeds.contiguous()
    out = torch.empty((seeds.shape[0], h, w), dtype=torch.float32,
                      device=seeds.device)
    consts = octave_constants(octaves, persistence, frequency)
    fn = _build.bind("simplex_noise", _ARGTYPES)["simplex_fractal_noise"]
    stream = torch.cuda.current_stream(seeds.device).cuda_stream
    _build.check(fn(seeds.data_ptr(), out.data_ptr(), seeds.shape[0], h, w,
                    octaves, consts.data_ptr(), stream),
                 "simplex_fractal_noise launch")
    fractal_noise_2d.launches += 1
    return out


fractal_noise_2d.launches = 0
