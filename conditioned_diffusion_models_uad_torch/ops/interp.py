"""Resampling with the JAX package's semantics, in plain PyTorch on the
tensors' device: ``jax.scipy.ndimage.map_coordinates`` (orders 0 and 1, mode
'nearest') and ``jax.image.resize`` ('nearest', 'linear', 'cubic').

Both are plain XLA in the JAX package (no Pallas kernel), so they are plain
PyTorch here. They are written out rather than taken from
``F.grid_sample``/``F.interpolate`` because those differ in the cases the
package relies on: order-0 sampling rounds half away from zero (torch rounds
half to even), and ``jax.image.resize`` uses half-pixel centres, Keys' cubic
with a = -0.5, kernel weights renormalised at the edges and, when it shrinks
an axis, a kernel widened by the inverse scale (antialiasing).
"""
from __future__ import annotations

import functools
import itertools
import math
import operator
from typing import Sequence

import torch


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """Round to the nearest integer, ties away from zero (``lax.round``).
    The fraction is taken exactly, so 0.5 - 2**-25 rounds to 0."""
    a = x.abs()
    f = torch.floor(a)
    return torch.copysign(f + (a - f >= 0.5).to(x.dtype), x)


def map_coordinates(img: torch.Tensor, coords: torch.Tensor, order: int) -> torch.Tensor:
    """``map_coordinates(img[n], coords[n], order, mode='nearest')`` for each
    n: img [N, *S] sampled at coords [N, len(S), *O] (absolute positions,
    clamped to the edges) -> [N, *O] in img's dtype. Order 1 sums the
    corners in JAX's order, each weight the left-to-right product of the
    per-axis weights; order 0 takes the nearest voxel, ties away from zero.
    Differentiable in ``coords`` for order 1."""
    n = img.shape[0]
    sizes = img.shape[1:]
    nd = len(sizes)
    if coords.shape[:2] != (n, nd):
        raise ValueError(f"coords must be [{n}, {nd}, ...], got {tuple(coords.shape)}")
    out_shape = coords.shape[2:]
    flat = img.reshape(n, -1)
    strides = [math.prod(sizes[d + 1:]) for d in range(nd)]

    def gather(idx):
        return torch.gather(flat, 1, idx.reshape(n, -1)).reshape(n, *out_shape)

    if order == 0:
        idx = [round_half_away(coords[:, d]).long().clamp(0, sizes[d] - 1) * strides[d]
               for d in range(nd)]
        return gather(functools.reduce(operator.add, idx))
    if order != 1:
        raise NotImplementedError("map_coordinates supports order 0 and 1")
    # per axis: (offset of the corner's index along it, its weight), lower
    # then upper; a corner's flat index and weight are built up axis by axis,
    # so corners sharing their first axes share those partial sums/products
    nodes = []
    for d in range(nd):
        c = coords[:, d]
        lower = torch.floor(c)
        upper_w = c - lower
        lo = lower.long()
        nodes.append(((lo.clamp(0, sizes[d] - 1) * strides[d], 1 - upper_w),
                      ((lo + 1).clamp(0, sizes[d] - 1) * strides[d], upper_w)))
    partial = [(None, None)]
    for d in range(nd):
        partial = [(off if idx is None else idx + off, w if wt is None else wt * w)
                   for idx, wt in partial for off, w in nodes[d]]
    out = None
    for idx, wt in partial:
        term = wt * gather(idx)
        out = term if out is None else out + term
    return out.to(img.dtype)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(1 - torch.abs(x), 0.0)


KERNELS = {"linear": _triangle, "cubic": _keys_cubic}


def resize_weights(in_size: int, out_size: int, method: str) -> torch.Tensor:
    """``jax.image``'s weight matrix [in, out] (float32, on the CPU) of one
    axis: half-pixel sample positions, the kernel widened by in/out when
    shrinking (antialiasing, on by default there), columns renormalised to
    sum to 1, and zero columns for samples outside the input."""
    kernel = KERNELS[method]
    inv_scale = torch.tensor(1.0 / (out_size / in_size), dtype=torch.float32)
    kernel_scale = torch.clamp_min(inv_scale, 1.0)
    sample_f = (torch.arange(out_size, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    grid = torch.arange(in_size, dtype=torch.float32)
    x = torch.abs(sample_f[None, :] - grid[:, None]) / kernel_scale
    weights = kernel(x)
    total = weights.sum(dim=0, keepdim=True)
    eps = float(torch.finfo(torch.float32).eps)
    weights = torch.where(torch.abs(total) > 1000.0 * eps,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def nearest_indices(in_size: int, out_size: int, device=None) -> torch.Tensor:
    """``jax.image.resize(..., 'nearest')``'s source index of each output:
    floor((i + 0.5) * in / out) in float32."""
    i = torch.arange(out_size, dtype=torch.float32, device=device)
    return torch.floor((i + 0.5) * in_size / out_size).long()


def _resize_axis(x: torch.Tensor, d: int, w: torch.Tensor) -> torch.Tensor:
    """Axis ``d`` of ``x`` through the weights w [in, out]: each output the
    sum, in ascending input order, of its few nonzero taps. Elementwise
    products and sums, so the CPU and the card round alike."""
    nz = w != 0
    k = max(int(nz.sum(0).max()), 1)
    idx = torch.argsort((~nz).to(torch.int8), dim=0, stable=True)[:k]  # [k, out]
    taps = torch.gather(w, 0, idx).to(x.device)
    idx = idx.to(x.device)
    xm = x.movedim(d, -1)
    out = taps[0] * xm[..., idx[0]]
    for j in range(1, k):
        out = out + taps[j] * xm[..., idx[j]]
    return out.movedim(-1, d)


def resize(x: torch.Tensor, shape: Sequence[int], method: str) -> torch.Tensor:
    """``jax.image.resize(x, shape, method)`` for 'nearest', 'linear' and
    'cubic'; axes whose size does not change are left alone, as there. The linear and cubic paths compute in float32,
    an axis at a time, with the taps summed in order rather than in XLA's
    contraction: they agree with JAX to float32 rounding, and bit for bit
    between the CPU and the card."""
    shape = tuple(int(s) for s in shape)
    if len(shape) != x.ndim:
        raise ValueError(f"shape {shape} does not match x's {x.ndim} axes")
    if method == "nearest":
        for d, (m, n) in enumerate(zip(x.shape, shape)):
            if m != n:
                x = torch.index_select(x, d, nearest_indices(m, n, x.device))
        return x
    if method not in KERNELS:
        raise ValueError(f"unknown resize method {method!r}")
    x = x.float()
    for d, (m, n) in enumerate(zip(x.shape, shape)):
        if m != n:
            x = _resize_axis(x, d, resize_weights(m, n, method))
    return x
