"""Exact euclidean surface Hausdorff distance on tensors (counterpart of
``conditioned_diffusion_models_uad_tpu/eval/hausdorff.py``; the reference
uses monai's symmetric surface Hausdorff, src/utils/utils_eval.py:132-135).

The squared euclidean distance transform is separable into three 1-D
min-plus transforms, dt2[i] = min_j (f[j] + (i - j)^2), one along each axis;
each is computed by brute force as a [rows, n, n] minimum, in chunks of at
most 2^25 elements (128 MB). Squared distances are integers below 2^24, so
float32 is exact: the pair equals the JAX package's and scipy's.
"""
from __future__ import annotations

import math

import torch

from ..utils.device import DeviceLike, to_tensor

_CHUNK_ELEMENTS = 1 << 25


def _minplus_pass(f: torch.Tensor) -> torch.Tensor:
    """One 1-D squared-EDT min-plus transform along the LAST axis of f."""
    n = f.shape[-1]
    i = torch.arange(n, dtype=torch.float32, device=f.device)
    d2 = (i[:, None] - i[None, :]) ** 2  # [n_out, n_src]
    flat = f.reshape(-1, n)
    out = torch.empty_like(flat)
    step = max(1, _CHUNK_ELEMENTS // (n * n))
    for s in range(0, flat.shape[0], step):
        out[s:s + step] = (flat[s:s + step, None, :] + d2[None]).amin(dim=-1)
    return out.view(f.shape)


def _edt2(mask: torch.Tensor) -> torch.Tensor:
    """Exact squared euclidean distance from every voxel to the nearest TRUE
    voxel of ``mask`` (scipy: distance_transform_edt(~mask)**2), with a
    finite sentinel above any reachable squared distance."""
    h, w, d = mask.shape
    big = float(h * h + w * w + d * d + 1)
    f = torch.where(mask, 0.0, big).float()
    for axis in range(3):
        f = _minplus_pass(f.movedim(axis, -1).contiguous()).movedim(-1, axis)
    return f


def _surface(mask: torch.Tensor) -> torch.Tensor:
    """The mask minus its 6-connectivity erosion (outside counts as False)."""
    m = mask.bool()
    h, w, d = m.shape
    pad = torch.zeros((h + 2, w + 2, d + 2), dtype=torch.bool, device=m.device)
    pad[1:-1, 1:-1, 1:-1] = m
    er = m
    for axis in range(3):
        lo = [slice(1, -1)] * 3
        hi = [slice(1, -1)] * 3
        lo[axis] = slice(0, -2)
        hi[axis] = slice(2, None)
        er = er & pad[tuple(lo)] & pad[tuple(hi)]
    return m & ~er


def hausdorff_sq_pair(pred: torch.Tensor, target: torch.Tensor):
    """(max squared distance pred-surface -> target-surface, the reverse) as
    0-d float32 tensors; -1 signals an empty mask (the host maps it to NaN,
    the monai convention the reference filters, utils_eval.py:255)."""
    p = pred.bool()
    t = target.bool()
    ps = _surface(p)
    ts = _surface(t)
    zero = torch.zeros((), device=p.device)
    d_pt = torch.where(ps, _edt2(ts), zero).max()
    d_tp = torch.where(ts, _edt2(ps), zero).max()
    empty = ~p.any() | ~t.any()
    return torch.where(empty, -1.0, d_pt), torch.where(empty, -1.0, d_tp)


def hausdorff_distance_device(pred, target, device: DeviceLike = None) -> float:
    """``metrics.hausdorff_distance`` computed with ``hausdorff_sq_pair``:
    host arrays go to ``device`` (``cuda`` unless the caller passes
    another); tensors stay where they are. NaN when either mask is empty."""
    d_pt, d_tp = hausdorff_sq_pair(to_tensor(pred, torch.bool, device),
                                   to_tensor(target, torch.bool, device))
    a, b = float(d_pt), float(d_tp)
    if a < 0 or b < 0:
        return float("nan")
    return math.sqrt(max(a, b))
