"""Noise sources of the diffusion process (counterpart of
``conditioned_diffusion_models_uad_tpu/ops/simplex.py``).

Two simplex paths, picked by ``make_noise_fn(impl=...)`` and never by what
the hardware offers:

* ``'hash'`` (the default): hashed gradients, one field per int32 seed
  (``ops/simplex_hash.py``; kernel K1 on CUDA, its plain twin on the CPU).
  It is the JAX package's Pallas path.
* ``'table'``: the permutation-table OpenSimplex of the reference
  (``opensimplex2``), one field per JAX-package key through
  ``perm_from_key`` (``jax.random.permutation(key, 256)``, bit-equal through
  ``utils/prng.py``). It is the path the JAX package takes off a TPU, so the
  port's CPU tests hold against that package's committed numbers with it.
  Plain PyTorch on either device: no kernel.

White Gaussian noise (None/'gaussian') is drawn from a torch generator per
seed; it has no JAX-exact form.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..utils import prng

STRETCH2 = -0.211324865405187  # (1/sqrt(2+1)-1)/2
SQUISH2 = 0.366025403784439  # (sqrt(2+1)-1)/2
NORM2 = 47.0

# noise_fn(draws [N] int32 seeds ('hash') or [N, 2] keys ('table'),
# shape (B, H, W, C)) -> [N*B, H, W, C] float32: block n holds draw n's noise
# over B samples
NoiseFn = Callable[[torch.Tensor, Tuple[int, int, int, int]], torch.Tensor]

# gradient table for 2D: the vertices of an octagon, indexed by
# (hash & 0x0E) >> 1
_GRAD2 = np.array([[5, 2], [2, 5], [-5, 2], [-2, 5],
                   [5, -2], [2, -5], [-5, -2], [-2, -5]], dtype=np.float32)

_LCG_MULT = 6364136223846793005
_LCG_ADD = 1442695040888963407
_I64 = 1 << 64


def _lcg(seed: int) -> int:
    return ((seed * _LCG_MULT + _LCG_ADD) % _I64 + _I64) % _I64


def perm_from_seed_lcg(seed: int = 3) -> np.ndarray:
    """The reference's permutation table (generate_noise.py:214-232): three
    LCG warm-up steps, then a Fisher-Yates draw on the signed 64-bit LCG
    state. int32 [256]."""
    perm = np.zeros(256, dtype=np.int32)
    source = np.arange(256)
    s = seed % _I64
    for _ in range(3):
        s = _lcg(s)
    for i in range(255, -1, -1):
        s = _lcg(s)
        signed = s - _I64 if s >= (1 << 63) else s
        r = int((signed + 31) % (i + 1))
        perm[i] = source[r]
        source[r] = source[i]
    return perm


def perm_from_key(key) -> np.ndarray:
    """A uniform permutation of 0..255 from a JAX-package key [2]:
    ``jax.random.permutation(key, 256)`` bit for bit. int32 [256]."""
    return prng.permutation(key, 256)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 a*b + c with one rounding: the product of two float32 values
    is exact in float64, and the sum rounds once more to float32."""
    return (a.double() * b.double() + c.double()).float()


def _fms(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 c - a*b with one rounding."""
    return (c.double() - a.double() * b.double()).float()


def _c32(*terms: float) -> float:
    """The float32 constant ``terms[0] + terms[1] + ...``, each term and
    each partial sum rounded to float32 (XLA folds ``x - 1 - SQUISH2`` into
    ``x + c`` so)."""
    acc = np.float32(terms[0])
    for t in terms[1:]:
        acc = np.float32(acc + np.float32(t))
    return float(acc)


_INV_NORM2 = float(np.float32(1.0 / NORM2))


def _simplex_sum(x: torch.Tensor, y: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """The four vertex contributions of OpenSimplex-2D at (x, y), summed and
    not yet normalised.

    The roundings are those of the JAX package's jitted program on XLA:CPU,
    which the golden numbers come from (eager JAX rounds otherwise, by up
    to 5e-7): the offset constants folded into one float32 each; LLVM's FMA
    contraction of a multiply that feeds one add or subtract: the falloff
    ``2 - dx*dx - dy*dy`` as two fused subtracts, the gradient dot product
    as ``fma(gx, dx, gy*dy)`` and the sum of the contributions as
    ``fma(a1, d1, a2*d2)`` and then two more FMAs. The squish term has two
    uses, so it is not contracted."""
    x, y = x.float(), y.float()
    perm = perm.long()
    grad2 = torch.from_numpy(_GRAD2).to(x.device)
    two = torch.full_like(x, 2.0)

    def contribution(dx, dy, xsv, ysv):
        attn = torch.clamp_min(_fms(_fms(two, dx, dx), dy, dy), 0.0)
        attn2 = attn * attn
        idx = perm[(perm[xsv & 0xFF] + ysv) & 0xFF] & 0x0E
        g = grad2[idx >> 1]
        return attn2 * attn2, _fma(g[..., 0], dx, g[..., 1] * dy)

    stretch = (x + y) * STRETCH2
    xs = x + stretch
    ys = y + stretch
    xsb = torch.floor(xs).long()
    ysb = torch.floor(ys).long()
    squish = (xsb + ysb).float() * SQUISH2
    xb = xsb + squish
    yb = ysb + squish
    xins = xs - xsb
    yins = ys - ysb
    in_sum = xins + yins
    dx0 = x - xb
    dy0 = y - yb
    s1, s2 = _c32(-1, -SQUISH2), _c32(-1, -2 * SQUISH2)

    c10 = contribution(dx0 + s1, dy0 - SQUISH2, xsb + 1, ysb)
    c01 = contribution(dx0 - SQUISH2, dy0 + s1, xsb, ysb + 1)

    lower = in_sum <= 1.0  # the (0,0) simplex, else the (1,1) one
    xgty = xins > yins
    where = torch.where

    zins_l = 1.0 - in_sum
    a_l = (zins_l > xins) | (zins_l > yins)
    ext_x_l = where(a_l, where(xgty, xsb + 1, xsb - 1), xsb + 1)
    ext_y_l = where(a_l, where(xgty, ysb - 1, ysb + 1), ysb + 1)
    ext_dx_l = where(a_l, where(xgty, dx0 - 1, dx0 + 1), dx0 + s2)
    ext_dy_l = where(a_l, where(xgty, dy0 + 1, dy0 - 1), dy0 + s2)

    zins_u = 2.0 - in_sum
    a_u = (zins_u < xins) | (zins_u < yins)
    ext_x_u = where(a_u, where(xgty, xsb + 2, xsb), xsb)
    ext_y_u = where(a_u, where(xgty, ysb, ysb + 2), ysb)
    s3, s4 = _c32(-2, -2 * SQUISH2), _c32(-2 * SQUISH2)
    ext_dx_u = where(a_u, where(xgty, dx0 + s3, dx0 + s4), dx0)
    ext_dy_u = where(a_u, where(xgty, dy0 + s4, dy0 + s3), dy0)

    ext_x = where(lower, ext_x_l, ext_x_u)
    ext_y = where(lower, ext_y_l, ext_y_u)
    ext_dx = where(lower, ext_dx_l, ext_dx_u)
    ext_dy = where(lower, ext_dy_l, ext_dy_u)

    c_x = where(lower, xsb, xsb + 1)
    c_y = where(lower, ysb, ysb + 1)
    c_dx = where(lower, dx0, dx0 + s2)
    c_dy = where(lower, dy0, dy0 + s2)

    cc = contribution(c_dx, c_dy, c_x, c_y)
    ce = contribution(ext_dx, ext_dy, ext_x, ext_y)
    value = _fma(c10[0], c10[1], c01[0] * c01[1])
    value = _fma(cc[0], cc[1], value)
    return _fma(ce[0], ce[1], value)


def opensimplex2(x: torch.Tensor, y: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Permutation-table OpenSimplex-2D at points (x, y), all four candidate
    vertices evaluated for every point and selected with masks (the JAX
    package's branchless form of the reference's noise2). ``perm`` int [256]
    on the points' device. Noise in about [-1, 1], float32; the division by
    NORM2 is a multiply by its float32 reciprocal, as in the jitted JAX
    function."""
    return _simplex_sum(x, y, perm) * _INV_NORM2


def fractal_noise_2d(shape: Tuple[int, int], perm: torch.Tensor, octaves: int = 6,
                     persistence: float = 0.8, frequency: float = 64.0) -> torch.Tensor:
    """Layered table noise over an (H, W) pixel lattice on ``perm``'s
    device: out[i, j] = sum_o persistence**o * noise2(j / f_o, i / f_o) with
    f_o = frequency / 2**o (reference rand_2d_octaves). float32 [H, W].

    Rounded as the jitted JAX function: octave o's weight is the float32
    product of persistence**o and 1/NORM2, and the octaves accumulate as
    ``fma(v0, w0, v1 * w1)``, then ``fma(v_o, w_o, out)``."""
    h, w = shape
    dev = perm.device
    ii = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    jj = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    out = torch.zeros((h, w), dtype=torch.float32, device=dev)
    amplitude = 1.0
    f = float(frequency)
    for o in range(octaves):
        v = _simplex_sum(jj / f, ii / f, perm)
        weight = float(np.float32(np.float32(amplitude) * np.float32(_INV_NORM2)))
        if o == 0:
            out = v * _INV_NORM2
        elif o == 1:  # the first octave's multiply feeds this add alone
            out = _fma(v0, torch.tensor(_INV_NORM2, device=dev), v * weight)
        else:
            out = _fma(v, torch.tensor(weight, device=dev), out)
        v0 = v
        f /= 2.0
        amplitude *= persistence
    return out


def gen_simplex_noise(key, shape: tuple, octaves: int = 6, persistence: float = 0.8,
                      frequency: float = 64.0, device="cpu") -> torch.Tensor:
    """One table field from ``key`` [2] over the trailing (H, W) axes of
    ``shape``, broadcast across the leading ones. float32."""
    perm = torch.from_numpy(perm_from_key(prng.key_words(key))).to(device)
    field = fractal_noise_2d(tuple(shape[-2:]), perm, octaves, persistence, frequency)
    return field.expand(tuple(shape))


def gen_simplex_noise_nhwc(key, shape: tuple, octaves: int = 6, persistence: float = 0.8,
                           frequency: float = 64.0, device="cpu") -> torch.Tensor:
    """NHWC form: one table field from ``key`` [2] broadcast over batch and
    channel of ``shape`` (B, H, W, C). float32."""
    b, h, w, c = shape
    field = gen_simplex_noise(key, (h, w), octaves, persistence, frequency, device)
    return field[None, :, :, None].expand(b, h, w, c)


def make_noise_fn(
    noisetype: Optional[str],
    octaves: int = 6,
    persistence: float = 0.8,
    frequency: float = 64.0,
    impl: str = "hash",
) -> NoiseFn:
    """'simplex': one fractal field per draw, broadcast over its B samples
    and the channel. ``impl='hash'`` takes int32 seeds [N] (all N fields
    from ONE kernel launch on CUDA); ``impl='table'`` takes JAX-package keys
    [N, 2] (int64 holding the uint32 words) on the device the noise goes to.
    None/'gaussian' (hash only): white noise from a generator seeded by each
    seed."""
    if impl not in ("hash", "table"):
        raise ValueError(f"unknown noise impl {impl!r} (hash | table)")
    if noisetype == "simplex":
        if impl == "table":
            def table_fn(keys, shape):
                return torch.cat([
                    gen_simplex_noise_nhwc(k, shape, octaves, persistence, frequency,
                                           keys.device)
                    for k in prng.key_words(keys).reshape(-1, 2)])

            return table_fn

        from .simplex_hash import fractal_noise_2d as hash_noise_2d

        def simplex_fn(seeds, shape):
            b, h, w, c = shape
            fields = hash_noise_2d(seeds, (h, w), octaves, persistence, frequency)
            n = fields.shape[0]
            out = fields[:, None, :, :, None].expand(n, b, h, w, c)
            return out.reshape(n * b, h, w, c)

        return simplex_fn
    if noisetype not in (None, "gaussian"):
        raise ValueError(f"unknown noisetype {noisetype}")
    if impl == "table":
        raise ValueError("impl='table' is a simplex path; Gaussian noise takes seeds")

    def gaussian_fn(seeds, shape):
        out = []
        for s in seeds.tolist():
            g = torch.Generator(device=seeds.device).manual_seed(int(s))
            out.append(torch.randn(shape, generator=g, device=seeds.device))
        return torch.cat(out)

    return gaussian_fn
