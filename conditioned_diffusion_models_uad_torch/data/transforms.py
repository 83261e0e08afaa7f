"""Volume preprocessing transforms in torch (counterpart of
``conditioned_diffusion_models_uad_tpu/data/transforms.py``). Every function
takes a CPU or a CUDA tensor and computes where the tensor lives.

Reference pipeline (src/datamodules/create_dataset.py:196-258, torchio and
SimpleITK on dataloader workers):

* ``crop_or_pad``         tio.CropOrPad(imageDim, pad 0)
* ``percentile_rescale``  tio.RescaleIntensity((0, 1), percentiles (1, 99),
                          masking_method='mask')
* ``bspline_downsample``  tio.Resample(rescaleFactor, 'bspline'): cubic
                          B-spline interpolation after Unser's recursive
                          prefilter
* ``curvature_flow``      sitk.CurvatureFlow(timeStep=.125, iterations=3) on
                          images (not masks or segs) at read time

Rounding. The JAX package's XLA:CPU programs contract a multiply and an add
into one fused multiply-add at some sites. This module rounds once where
they do (``_fma``: the float32 product is exact in float64): the percentile
interpolation, the prefilter's causal initial sum and recursion
``xi + z * carry``, and the B-spline taps. That makes the percentiles and
the prefilter bit-equal to the JAX package on the CPU. The curvature-flow
stencil is left to float32 arithmetic; its agreement with the JAX package is
stated in tests/test_torch_transforms.py.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 a*b + c with one rounding (exact product, double sum)."""
    return (a.double() * (b.double() if torch.is_tensor(b) else b)
            + (c.double() if torch.is_tensor(c) else c)).float()


# --------------------------------------------------------------------------- #
# crop or pad
# --------------------------------------------------------------------------- #
def crop_or_pad(vol: torch.Tensor, target: Sequence[int], pad_value: float = 0.0):
    """Centre crop/pad to ``target`` (tio.CropOrPad: the odd voxel of a
    split goes to the LEADING side, torchio's ``ini, fin = ceil(half),
    floor(half)``)."""
    out = vol
    for ax, tgt in enumerate(target):
        size = out.shape[ax]
        if size > tgt:
            lo = -(-(size - tgt) // 2)
            out = out.narrow(ax, lo, tgt)
        elif size < tgt:
            lo = -(-(tgt - size) // 2)
            pads = [0, 0] * (out.dim() - ax)
            pads[-2:] = [lo, tgt - size - lo]
            out = F.pad(out, pads, mode="constant", value=pad_value)
    return out


def crop_or_pad_dynamic(vol: torch.Tensor, ext: Sequence[int], target: Sequence[int],
                        pad_value: float = 0.0):
    """``crop_or_pad`` of a volume whose true extent ``ext`` (per axis) may be
    smaller than its bucket-padded array; everything at or past ``ext`` must
    already equal ``pad_value``. The JAX package traces ``ext`` into one
    program per bucket; eager torch cuts the true extent and crops that."""
    ext = [int(e) for e in ext]
    return crop_or_pad(vol[tuple(slice(0, e) for e in ext)], target, pad_value)


def zero_beyond_extent(vol: torch.Tensor, ext: Sequence[int]) -> torch.Tensor:
    """Zero every position at or past the true extent along each axis (by
    multiplying with 0/1, as the JAX package does)."""
    for ax, e in enumerate(ext):
        keep = (torch.arange(vol.shape[ax], device=vol.device) < int(e)).to(vol.dtype)
        shape = [1] * vol.dim()
        shape[ax] = -1
        vol = vol * keep.reshape(shape)
    return vol


# --------------------------------------------------------------------------- #
# masked percentile rescale
# --------------------------------------------------------------------------- #
def _nanpercentiles(vals: torch.Tensor, ps: Sequence[float]) -> list:
    """``jnp.nanpercentile(vals, p)`` for each p (method 'linear'): one sort
    with NaNs last, the non-NaN count in float32, JAX's float32 index
    arithmetic and its interpolation as one fused multiply-add. An all-NaN
    input gives NaN. No host sync."""
    x = torch.sort(vals.reshape(-1)).values  # NaN sorts last
    count = (~torch.isnan(x)).sum().to(torch.float32)
    hi_idx = x.numel() - 1
    out = []
    for p in ps:
        q = torch.tensor(np.float32(np.float32(p) / np.float32(100.0)), device=x.device)
        qn = q * (count - 1.0)
        low, high = torch.floor(qn), torch.ceil(qn)
        hw = qn - low
        lw = 1.0 - hw
        lo_i = torch.maximum(torch.zeros_like(low), torch.minimum(low, count - 1.0))
        hi_i = torch.maximum(torch.zeros_like(high), torch.minimum(high, count - 1.0))
        lo_v = x[lo_i.long().clamp(0, hi_idx)]
        hi_v = x[hi_i.long().clamp(0, hi_idx)]
        out.append(_fma(hi_v, hw, lo_v * lw))
    return out


def percentile_rescale(vol: torch.Tensor, mask: torch.Tensor, out_min: float = 0.0,
                       out_max: float = 1.0, p_low: float = 1.0,
                       p_high: float = 99.0) -> torch.Tensor:
    """Rescale intensities to [out_min, out_max] between the percentiles of
    the voxels under mask > 0 (tio.RescaleIntensity, masked). An empty mask
    falls back to cutoffs [0, 1], so an all-zero scan gives zeros, not NaN."""
    vol = vol.float()
    vals = torch.where(mask > 0, vol, torch.full_like(vol, float("nan")))
    lo, hi = _nanpercentiles(vals, (p_low, p_high))
    lo = torch.where(torch.isnan(lo), torch.zeros_like(lo), lo)
    hi = torch.where(torch.isnan(hi), torch.ones_like(hi), hi)
    rng = torch.where(hi - lo > 1e-8, hi - lo, torch.ones_like(hi))
    out = (torch.minimum(torch.maximum(vol, lo), hi) - lo) / rng
    lo32, hi32 = np.float32(out_min), np.float32(out_max)
    return _fma(out, float(hi32 - lo32), float(lo32))


# --------------------------------------------------------------------------- #
# curvature flow (the read-time smoother)
# --------------------------------------------------------------------------- #
def _edge_shift(vol: torch.Tensor, d: Sequence[int], ext: Sequence[int]) -> torch.Tensor:
    """Neighbour ``vol[i + d]`` with the edge replicated at the true extent:
    per axis, gather at clip(arange + d, 0, ext - 1)."""
    out = vol
    for ax, dd in enumerate(d):
        if dd == 0:
            continue
        idx = (torch.arange(vol.shape[ax], device=vol.device) + dd).clamp(0, int(ext[ax]) - 1)
        out = out.index_select(ax, idx)
    return out


def _curvature_step(I: torch.Tensor, sh, timestep: float) -> torch.Tensor:
    c = I
    xp, xm = sh(1, 0, 0), sh(-1, 0, 0)
    yp, ym = sh(0, 1, 0), sh(0, -1, 0)
    zp, zm = sh(0, 0, 1), sh(0, 0, -1)
    ix = (xp - xm) * 0.5
    iy = (yp - ym) * 0.5
    iz = (zp - zm) * 0.5
    ixx = xp - 2 * c + xm
    iyy = yp - 2 * c + ym
    izz = zp - 2 * c + zm
    ixy = (sh(1, 1, 0) - sh(1, -1, 0) - sh(-1, 1, 0) + sh(-1, -1, 0)) * 0.25
    ixz = (sh(1, 0, 1) - sh(1, 0, -1) - sh(-1, 0, 1) + sh(-1, 0, -1)) * 0.25
    iyz = (sh(0, 1, 1) - sh(0, 1, -1) - sh(0, -1, 1) + sh(0, -1, -1)) * 0.25
    ix2, iy2, iz2 = ix * ix, iy * iy, iz * iz
    g2 = ix2 + iy2 + iz2
    num = (
        ixx * (iy2 + iz2)
        + iyy * (ix2 + iz2)
        + izz * (ix2 + iy2)
        - 2 * (ix * iy * ixy + ix * iz * ixz + iy * iz * iyz)
    )
    upd = torch.where(g2 > 1e-12, num / (g2 + 1e-12), torch.zeros_like(num))
    return I + timestep * upd


def curvature_flow(vol: torch.Tensor, timestep: float = 0.125, iterations: int = 3,
                   ext: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Mean-curvature-flow denoising I_t = kappa * |grad I| on a 3D volume,
    central differences with the edge replicated (the sitk.CurvatureFlow
    capability; ITK's stencil details differ slightly, as in the JAX
    package). ``ext``: the true extent of a bucket-padded volume; the
    stencil then replicates the edge at the true boundary and the result is
    zeroed beyond it."""
    v = vol.float()
    if ext is None:
        for _ in range(iterations):
            p = F.pad(v[None, None], (1, 1, 1, 1, 1, 1), mode="replicate")[0, 0]
            n = v.shape

            def sh(dx, dy, dz, p=p, n=n):
                return p[1 + dx:1 + dx + n[0], 1 + dy:1 + dy + n[1], 1 + dz:1 + dz + n[2]]

            v = _curvature_step(v, sh, timestep)
        return v
    for _ in range(iterations):
        v = _curvature_step(v, lambda dx, dy, dz, v=v: _edge_shift(v, (dx, dy, dz), ext),
                            timestep)
    return zero_beyond_extent(v, ext)


# --------------------------------------------------------------------------- #
# cubic B-spline resampling (tio.Resample 'bspline')
# --------------------------------------------------------------------------- #
_POLE = math.sqrt(3.0) - 2.0  # cubic B-spline prefilter pole
_GAIN = (1.0 - _POLE) * (1.0 - 1.0 / _POLE)  # = 6.0
_HORIZON = 14  # |pole|**14 < 1e-8
_Z32 = float(np.float32(_POLE))
_GAIN32 = float(np.float32(_GAIN))
_LAST32 = float(np.float32(_POLE / (_POLE * _POLE - 1.0)))
# the float32 pole's powers as the JAX package makes them (float32 pow)
_POWERS = np.float32(_POLE) ** np.arange(_HORIZON, dtype=np.float32)


def _prefilter_axis0(x: torch.Tensor) -> torch.Tensor:
    """Unser's causal/anti-causal recursion along axis 0: samples -> cubic
    B-spline coefficients, mirror boundary, causal initial value from a
    truncated horizon."""
    n = x.shape[0]
    z = _Z32
    x = x * _GAIN32
    horizon = min(n, _HORIZON)
    # the causal initial value sum_k z**k x[k], accumulated in order with
    # one rounding a term, as XLA:CPU computes the JAX package's tensordot
    c0 = x[0] * float(_POWERS[0])
    for k in range(1, horizon):
        c0 = _fma(x[k], float(_POWERS[k]), c0)
    cp = [c0]
    for i in range(1, n):
        cp.append(_fma(cp[-1], z, x[i]))  # x[i] + z * carry
    # n == 1: cp[n - 2] is cp[0], as JAX's negative index reads it
    last = _LAST32 * (cp[n - 1] + z * cp[n - 2])
    cm = [last]
    for i in range(n - 2, -1, -1):
        cm.append(z * (cm[-1] - cp[i]))
    return torch.stack(cm[::-1])


def bspline_prefilter(vol: torch.Tensor) -> torch.Tensor:
    """Prefilter a 3D volume along all axes."""
    c = vol.float()
    for ax in range(c.dim()):
        c = _prefilter_axis0(c.movedim(ax, 0)).movedim(0, ax)
    return c


def _bspline_weights(f: torch.Tensor):
    """Cubic B-spline weights of the taps at offsets (-1, 0, 1, 2) for the
    fractional position f in [0, 1)."""
    f2 = f * f
    f3 = f2 * f
    g = 1 - f
    return g * g * g / 6.0, (3 * f3 - 6 * f2 + 4) / 6.0, \
        (-3 * f3 + 3 * f2 + 3 * f + 1) / 6.0, f3 / 6.0


def _mirror_idx(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Reflect out-of-range indices (mirror boundary without edge repeat)."""
    idx = idx.abs()
    return torch.where(idx >= n, 2 * (n - 1) - idx, idx)


def _interp_axis0(coeffs: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    n = coeffs.shape[0]
    base = torch.floor(positions)
    ws = _bspline_weights(positions - base)
    base = base.long()
    shape = (-1,) + (1,) * (coeffs.dim() - 1)
    taps = [(ws[k].reshape(shape), coeffs.index_select(0, _mirror_idx(base + (k - 1), n)))
            for k in range(4)]
    # XLA:CPU's contraction of the JAX package's tap sum: the second product
    # rounded, the first and then the third and fourth fused in
    out = _fma(*taps[0], taps[1][0] * taps[1][1])
    for w, tap in taps[2:]:
        out = _fma(w, tap, out)
    return out


def bspline_resample_to(vol: torch.Tensor, out_shape: Sequence[int],
                        factors: Optional[Sequence[float]] = None) -> torch.Tensor:
    """Cubic-B-spline resample a 3D volume to ``out_shape``, sampling input
    index i_out * factor per axis (ITK/torchio resample-with-spacing; the
    factor defaults to the in/out size ratio per axis)."""
    c = bspline_prefilter(vol)
    for ax in range(3):
        n_out = int(out_shape[ax])
        factor = factors[ax] if factors is not None else vol.shape[ax] / out_shape[ax]
        pos = torch.arange(n_out, dtype=torch.float32, device=vol.device) * float(
            np.float32(factor))
        c = _interp_axis0(c.movedim(ax, 0), pos).movedim(0, ax)
    return c


def bspline_downsample(vol: torch.Tensor, factor: float) -> torch.Tensor:
    """tio.Resample(factor, 'bspline') for isotropic volumes: target spacing
    factor x the source's, new size ceil(size / factor)."""
    out_shape = tuple(int(math.ceil(s / factor)) for s in vol.shape)
    return bspline_resample_to(vol, out_shape, factors=(factor,) * 3)


def nearest_downsample(vol: torch.Tensor, factor: float) -> torch.Tensor:
    """Label-map resampling (masks and segs take the nearest neighbour;
    ``torch.round`` rounds half to even, as ``jnp.round`` does)."""
    out = vol
    for ax, s in enumerate(vol.shape):
        n = int(math.ceil(s / factor))
        pos = torch.arange(n, dtype=torch.float32, device=vol.device) * float(np.float32(factor))
        idx = torch.round(pos).long().clamp(0, s - 1)
        out = out.index_select(ax, idx)
    return out
