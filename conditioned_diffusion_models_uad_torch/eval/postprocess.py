"""Anomaly-map post-processing on tensors (counterpart of
``conditioned_diffusion_models_uad_tpu/eval/postprocess.py``).

The reference's residual chain (src/utils/utils_eval.py): residual map
|orig - reco| or (orig - reco)^2 (:28-33), brain-mask erosion per depth slice
with a cross, iterations = W // 25 (:449-460), a 3D median filter of kernel 5
with scipy's 'reflect' border (:462-464), masked per-slice and per-volume mean
scores (:156-194) and healthy/unhealthy L1/L2 reconstruction errors (:36-49).

Volumes are [H, W, D] (depth last). Every function runs on the device of its
inputs. Exact where the arithmetic is exact: the residual, the erosion and
the median (a selection) equal the JAX package's bit for bit; the masked
means are float32 sums whose order differs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def residual_volume(orig: torch.Tensor, reco: torch.Tensor, mode: str = "l1") -> torch.Tensor:
    """|orig - reco| (l1) or the squared residual (ref utils_eval.py:28-33)."""
    d = orig.float() - reco.float()
    return d.abs() if mode == "l1" else d * d


def reco_errors(orig: torch.Tensor, reco: torch.Tensor, seg: torch.Tensor) -> dict:
    """Whole/healthy/unhealthy L1 and L2 reconstruction errors (ref :36-49),
    as 0-d float32 tensors. ``seg > 0`` marks anomalous voxels. An empty
    selection gives NaN, as the reference's mean over zero elements does, so
    the nanmean aggregation leaves that volume out."""
    orig = orig.float()
    reco = reco.float()
    an = (seg > 0).float()
    he = 1.0 - an
    l1 = (reco - orig).abs()
    l2 = (reco - orig) ** 2
    nan = torch.tensor(float("nan"), device=orig.device)

    def masked_mean(x, m):
        n = m.sum()
        return torch.where(n > 0, (x * m).sum() / n.clamp_min(1.0), nan)

    return {
        "l1recoErrorAll": l1.mean(),
        "l2recoErrorAll": l2.mean(),
        "l1recoErrorUnhealthy": masked_mean(l1, an),
        "l1recoErrorHealthy": masked_mean(l1, he),
        "l2recoErrorUnhealthy": masked_mean(l2, an),
        "l2recoErrorHealthy": masked_mean(l2, he),
    }


def _erode_cross_2d(mask: torch.Tensor, iterations: int) -> torch.Tensor:
    """Binary erosion of [H, W, D] per depth slice by the 3x3 cross,
    ``iterations`` times (scipy generate_binary_structure(2, 1)); outside the
    volume counts as False (scipy border_value=0)."""
    m = mask > 0
    h, w, d = m.shape
    for _ in range(iterations):
        p = torch.zeros((h + 2, w + 2, d), dtype=torch.bool, device=m.device)
        p[1:-1, 1:-1] = m
        m = p[1:-1, 1:-1] & p[:-2, 1:-1] & p[2:, 1:-1] & p[1:-1, :-2] & p[1:-1, 2:]
    return m


def apply_brainmask_volume(diff: torch.Tensor, mask: torch.Tensor, iterations: int) -> torch.Tensor:
    """Erode the brain mask per slice and zero the residual outside it (ref
    utils_eval.py:447-460; the caller passes iterations = W // 25)."""
    return diff * _erode_cross_2d(mask, iterations).to(diff.dtype)


def _symmetric_index(n: int, lo: int, hi: int, device) -> torch.Tensor:
    """Source indices of an axis of ``n`` padded by ``lo``/``hi`` in numpy's
    'symmetric' mode (scipy's 'reflect': the edge sample repeated), which
    ``F.pad`` lacks (its 'reflect' skips the edge sample)."""
    i = torch.arange(-lo, n + hi, device=device) % (2 * n)
    return torch.where(i >= n, 2 * n - 1 - i, i)


def median_filter_3d(vol: torch.Tensor, kernel: int = 5) -> torch.Tensor:
    """3D median filter with scipy's 'reflect' border (scipy.ndimage.
    median_filter; ref apply_3d_median_filter, utils_eval.py:462-464): the
    k^3 shifted views of the padded volume, and the middle of each window
    selected exactly."""
    k = kernel
    lo = k // 2
    hi = k - 1 - lo
    h, w, d = vol.shape
    dev = vol.device
    p = vol[_symmetric_index(h, lo, hi, dev)]
    p = p[:, _symmetric_index(w, lo, hi, dev)]
    p = p[:, :, _symmetric_index(d, lo, hi, dev)]
    windows = p.unfold(0, k, 1).unfold(1, k, 1).unfold(2, k, 1).reshape(h, w, d, k ** 3)
    # k^3 is odd: torch's median is the middle element of the sorted window
    return windows.median(dim=-1).values


def postprocess_residual(
    orig: torch.Tensor,  # [H, W, D]
    reco: torch.Tensor,  # [H, W, D]
    mask: torch.Tensor,  # [H, W, D] brain mask
    *,
    residualmode: str = "l1",
    erode_iterations: int = 3,
    median_kernel: int = 5,
) -> torch.Tensor:
    """Residual -> brain-mask erosion -> 3D median (ref _test_step,
    utils_eval.py:28-69)."""
    diff = residual_volume(orig, reco, residualmode)
    if erode_iterations > 0:
        diff = apply_brainmask_volume(diff, mask, erode_iterations)
    if median_kernel > 1:
        diff = median_filter_3d(diff, median_kernel)
    return diff


def slice_anomaly_scores(diff: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-depth-slice masked mean residual [D] (ref utils_eval.py:160-167;
    0.0 where the slice has no brain)."""
    m = (mask > 0).float()
    num = (diff * m).sum(dim=(0, 1))
    den = m.sum(dim=(0, 1))
    return torch.where(den > 0, num / den.clamp_min(1.0), torch.zeros_like(num))


def volume_anomaly_score(diff: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean residual over the whole volume (ref utils_eval.py:157)."""
    m = (mask > 0).float()
    return (diff * m).sum() / m.sum().clamp_min(1.0)


def resize_trilinear(vol: torch.Tensor, size) -> torch.Tensor:
    """Trilinear resize to ``size`` with align_corners=True (ref
    utils_eval.py:24-27): output index i samples input i*(in-1)/(out-1).
    The JAX package computes the same positions with linspace and
    map_coordinates, which round differently (tolerance 1e-5, not bits)."""
    return F.interpolate(vol.float()[None, None], size=tuple(int(s) for s in size),
                         mode="trilinear", align_corners=True)[0, 0]
