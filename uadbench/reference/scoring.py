"""One volume's anomaly scoring in plain form (the reference's
``_test_step``, src/utils/utils_eval.py of Conditioned-Diffusion-Models-UAD):
the L1 residual, the brain mask eroded per slice, a 5x5x5 median with a
mirrored border, reconstruction errors, slice and volume scores, AUROC, the
average precision, the greedy Dice-threshold search (per volume, and pooled
over a val stage for its threshold), the thresholded map with components
under ``cc_min_size`` voxels (26-connectivity) removed, its confusion
counts, and the squared surface-Hausdorff pair.

Float32 PyTorch for the volume filters, numpy and scipy for the rest;
imports nothing of the system under test. ``rounding`` rounds the inputs and
the residual (the identity in the reference; bfloat16 in the control).
"""
from __future__ import annotations

import math

import numpy as np
import scipy.ndimage as ndi
import torch
import torch.nn.functional as F

SCALAR_KEYS = (
    "l1recoErrorAll", "l2recoErrorAll", "l1recoErrorUnhealthy",
    "l1recoErrorHealthy", "l2recoErrorUnhealthy", "l2recoErrorHealthy",
    "vol_score", "auroc", "auprc", "best_dice", "th_record", "th_apply",
    "lesion_size", "haus_pt", "haus_tp", "aux_loss", "tp", "fp", "tn", "fn",
)


def _erode_slices(mask: torch.Tensor, iterations: int) -> torch.Tensor:
    cross = torch.tensor([[0, 1, 0], [1, 1, 1], [0, 1, 0]], dtype=torch.float32,
                         device=mask.device)[None, None]
    m = (mask > 0).float().movedim(-1, 0)[:, None]  # [D, 1, H, W]
    for _ in range(iterations):
        m = (F.conv2d(m, cross, padding=1) > 4.5).float()
    return m[:, 0].movedim(0, -1) > 0


def _median5(vol: torch.Tensor, k: int = 5) -> torch.Tensor:
    r = k // 2
    idx = []
    for n in vol.shape:
        i = torch.arange(-r, n + r, device=vol.device)
        idx.append(torch.where(i < 0, -i - 1, torch.where(i >= n, 2 * n - 1 - i, i)))
    p = vol[idx[0]][:, idx[1]][:, :, idx[2]]
    h, w, d = vol.shape
    out = torch.empty_like(vol)
    step = max(1, (1 << 24) // (h * w * k ** 3))
    for z in range(0, d, step):
        win = p[:, :, z:z + step + 2 * r].unfold(0, k, 1).unfold(1, k, 1).unfold(2, k, 1)
        out[:, :, z:z + step] = win.reshape(*win.shape[:3], -1).median(dim=-1).values
    return out


def _masked_mean(x, m):
    n = m.sum()
    return float("nan") if n == 0 else float((x * m).sum() / n)


def auroc_ap(x: np.ndarray, y: np.ndarray):
    """AUROC as the Mann-Whitney U with tied values counted half, and the
    average precision over the distinct scores from the highest down:
    sum of (recall step) x precision."""
    x = x.astype(np.float64)
    order = np.argsort(x, kind="stable")
    xs, ys = x[order], y[order].astype(np.float64)
    n_pos, n = ys.sum(), len(ys)
    n_neg = n - n_pos
    starts = np.r_[True, xs[1:] != xs[:-1]]
    gid = np.cumsum(starts) - 1
    pos_g = np.bincount(gid, weights=ys)
    neg_g = np.bincount(gid, weights=1 - ys)
    neg_below = np.r_[0.0, np.cumsum(neg_g)[:-1]]
    auroc = float((pos_g * (neg_below + 0.5 * neg_g)).sum() / (n_pos * n_neg))
    tp = np.cumsum(pos_g[::-1])
    fp = np.cumsum(neg_g[::-1])
    recall = tp / max(n_pos, 1.0)
    ap = float((np.diff(np.r_[0.0, recall]) * tp / (tp + fp)).sum())
    return auroc, ap


def greedy_threshold(x: np.ndarray, y: np.ndarray, steps: int = 10):
    """Zimmerer's greedy search: Dice of ``x > q`` at the 25% and 75% points
    of [lo, hi) (from [0, max x)), keep the better half, ten times; the best
    (dice, threshold) seen, ties to the later. float32 throughout, the 75%
    point one rounding of (hi - lo) * 0.75 + lo."""
    f32 = np.float32
    xs = np.sort(x.astype(f32))
    cpos = np.r_[0, np.cumsum(y[np.argsort(x.astype(f32), kind="stable")].astype(np.int64))]
    n = len(xs)
    n_pos = cpos[-1]

    def dice(th):
        rank = np.searchsorted(xs, th, side="right")
        denom = f32(n - rank) + f32(n_pos)
        return f32(2.0) * f32(n_pos - cpos[rank]) / denom if denom > 0 else f32(0.0)

    lo, hi = f32(0.0), f32(xs[-1])
    if hi == lo:
        hi = f32(1.0)
    best, point = f32(0.0), f32(0.0)
    for _ in range(steps):
        center = f32(lo + f32(hi - lo) * f32(0.5))
        q_lo = f32(lo + f32(hi - lo) * f32(0.25))
        q_hi = f32(np.float64(f32(hi - lo)) * 0.75 + np.float64(lo))
        d_lo, d_hi = dice(q_lo), dice(q_hi)
        if d_lo >= d_hi:
            cand, cpoint, hi = d_lo, q_lo, center
        else:
            cand, cpoint, lo = d_hi, q_hi, center
        if cand >= best:
            best, point = cand, cpoint
    return float(best), float(point)


def _surface(m: np.ndarray) -> np.ndarray:
    return m & ~ndi.binary_erosion(m, ndi.generate_binary_structure(3, 1), border_value=0)


def hausdorff_sq(pred: np.ndarray, target: np.ndarray):
    if not pred.any() or not target.any():
        return -1.0, -1.0
    ps, ts = _surface(pred), _surface(target)
    d_t = ndi.distance_transform_edt(~ts) ** 2
    d_p = ndi.distance_transform_edt(~ps) ** 2
    return float(np.round(d_t[ps].max())), float(np.round(d_p[ts].max()))


def residual(orig, reco, mask, *, erode_iterations: int, median_kernel: int = 5,
             rounding=None) -> torch.Tensor:
    """The post-processed residual [H, W, D]: |orig - reco| inside the brain
    mask eroded per slice, then the median filter."""
    r = rounding or (lambda t: t)
    diff = r((r(orig.float()) - r(reco.float())).abs())
    if erode_iterations > 0:
        diff = diff * _erode_slices(mask, erode_iterations).float()
    if median_kernel > 1:
        diff = _median5(diff, median_kernel)
    return diff


def pooled_threshold(origs, recos, masks, segs, *, erode_iterations: int,
                     median_kernel: int = 5, rounding=None) -> float:
    """The val stage's threshold (the reference's ``_test_end``): the greedy
    Dice search over the residuals of every volume of the stage, pooled."""
    xs, ys = [], []
    for orig, reco, mask, seg in zip(origs, recos, masks, segs):
        d = residual(orig, reco, mask, erode_iterations=erode_iterations,
                     median_kernel=median_kernel, rounding=rounding)
        xs.append(d.cpu().numpy().reshape(-1))
        ys.append((seg > 0).cpu().numpy().reshape(-1))
    return greedy_threshold(np.concatenate(xs), np.concatenate(ys))[1]


def score_volume(orig, reco, mask, seg, th_record: float, *, erode_iterations: int,
                 median_kernel: int = 5, cc_min_size: int = 8, rounding=None) -> dict:
    """The scoring outputs of one [H, W, D] volume: {'scalars': {key: float},
    'per_slice': [D, 5] (slice score, seg size, tp, fp, fn at the recorded
    threshold), 'diff': the post-processed residual}. ``th_record`` NaN
    takes the greedy search's threshold."""
    r = rounding or (lambda t: t)
    orig, reco = r(orig.float()), r(reco.float())
    seg_b = seg > 0
    diff = residual(orig, reco, mask, erode_iterations=erode_iterations,
                    median_kernel=median_kernel, rounding=rounding)
    l1, l2 = (reco - orig).abs(), (reco - orig) ** 2
    an = seg_b.float()
    m = (mask > 0).float()
    s = {"l1recoErrorAll": float(l1.mean()), "l2recoErrorAll": float(l2.mean()),
         "l1recoErrorUnhealthy": _masked_mean(l1, an),
         "l1recoErrorHealthy": _masked_mean(l1, 1 - an),
         "l2recoErrorUnhealthy": _masked_mean(l2, an),
         "l2recoErrorHealthy": _masked_mean(l2, 1 - an),
         "vol_score": float((diff * m).sum() / m.sum().clamp_min(1.0))}
    den = m.sum(dim=(0, 1))
    slice_score = torch.where(den > 0, (diff * m).sum(dim=(0, 1)) / den.clamp_min(1.0), 0.0)

    x = diff.cpu().numpy().reshape(-1)
    y = seg_b.cpu().numpy().reshape(-1)
    s["auroc"], s["auprc"] = auroc_ap(x, y)
    s["best_dice"], best_th = greedy_threshold(x, y)
    th = best_th if math.isnan(th_record) else th_record
    s["th_record"] = s["th_apply"] = th
    s["lesion_size"] = float(y.sum())
    d_np = diff.cpu().numpy()
    seg_np = seg_b.cpu().numpy()
    pred = d_np > np.float32(th)
    per_slice = np.stack([slice_score.cpu().numpy(), seg_np.sum(axis=(0, 1)),
                          (pred & seg_np).sum(axis=(0, 1)), (pred & ~seg_np).sum(axis=(0, 1)),
                          (~pred & seg_np).sum(axis=(0, 1))], axis=-1).astype(np.float64)
    labels, _ = ndi.label(pred, structure=np.ones((3, 3, 3)))
    sizes = np.bincount(labels.ravel())
    final = pred & (sizes[labels] >= cc_min_size) & (labels > 0)
    s["tp"] = float((final & seg_np).sum())
    s["fp"] = float((final & ~seg_np).sum())
    s["fn"] = float((~final & seg_np).sum())
    s["tn"] = float(final.size) - s["tp"] - s["fp"] - s["fn"]
    s["haus_pt"], s["haus_tp"] = hausdorff_sq(final, seg_np)
    return {"scalars": s, "per_slice": per_slice, "diff": diff}
