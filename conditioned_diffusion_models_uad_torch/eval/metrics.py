"""Anomaly-segmentation metrics (counterpart of
``conditioned_diffusion_models_uad_tpu/eval/metrics.py``; reference
src/utils/utils_eval.py).

Host functions (numpy and scipy): ``dice``, ``tpr``, ``fpr`` (the
reference's fp/(fp+tp) kept), ``compute_roc``/``compute_prc`` (ref
:548-557), ``find_best_val`` (Zimmerer greedy quartile search, :508-539),
``confusion_counts``, ``precision_recall_specificity_accuracy`` (:108-129),
``filter_3d_connected_components`` (:489-503), ``hausdorff_distance``
(:132-135) and ``quantiles_from_hist``. The reference computes the ROC/PR
curves with scikit-learn; this module computes them in numpy with
scikit-learn 1.9's semantics and operations (tie-grouped thresholds, AUROC as
the trapezoid of the ROC curve with its collinear points dropped, AP as
sum (R_n - R_{n-1}) P_n clipped at 0, and its values where there is no
positive, no negative, or one score), so it needs no scikit-learn.

Device functions (torch, on the device of their tensors, or ``cuda`` for
host arrays unless given ``device``): AUROC + AP + the greedy Dice-threshold
search from one unstable sort (``seg_metrics_device``), the pooled greedy fit
(``find_best_val_device``), FPR quantiles, the histogram pool, and the
direct forms ``compute_roc_prc_device``/``_greedy_search_device_impl`` kept
as cross-checks. Every output of the sorted forms is built from value-group
aggregates, so the order an unstable sort leaves within ties cannot move it.
The greedy search keeps its quartile arithmetic in 0-d float32 tensors and
its positive prefix in integers, so its trajectory (and BestDice /
BestThreshold) equals the JAX package's bit for bit.
"""
from __future__ import annotations

import numpy as np
import scipy.ndimage as ndi
import torch
from scipy.integrate import trapezoid

from ..utils.device import DeviceLike, resolve_device, to_tensor


# --------------------------------------------------------------------------- #
# host metrics
# --------------------------------------------------------------------------- #
def dice(p: np.ndarray, g: np.ndarray) -> float:
    """Dice = 2|P∩G| / (|P|+|G|) (ref utils_eval.py:540-545)."""
    p = np.asarray(p).astype(np.float64).ravel()
    g = np.asarray(g).astype(np.float64).ravel()
    denom = p.sum() + g.sum()
    if denom == 0:
        return np.nan
    return float(2.0 * (p * g).sum() / denom)


def tpr(p: np.ndarray, g: np.ndarray) -> float:
    """Sensitivity of a binary map (ref utils_eval.py:565-568)."""
    p = np.asarray(p).astype(bool).ravel()
    g = np.asarray(g).astype(bool).ravel()
    tp = float(np.sum(p & g))
    fn = float(np.sum((~p) & g))
    return tp / (tp + fn) if (tp + fn) > 0 else np.nan


def fpr(p: np.ndarray, g: np.ndarray) -> float:
    """False-positive fraction among predicted positives (ref :571-574: the
    reference computes fp/(fp+tp), kept)."""
    p = np.asarray(p).astype(bool).ravel()
    g = np.asarray(g).astype(bool).ravel()
    tp = float(np.sum(p & g))
    fp = float(np.sum(p & (~g)))
    return fp / (fp + tp) if (fp + tp) > 0 else np.nan


def _clf_curve(labels, scores):
    """Cumulative (fps, tps, thresholds) at each distinct score, scores
    descending (float64), as scikit-learn's confusion_matrix_at_thresholds
    counts them."""
    y = (np.asarray(labels).astype(int).ravel() == 1).astype(np.int32)
    s = np.asarray(scores, dtype=np.float64).ravel()
    if y.shape != s.shape:
        raise ValueError(f"labels {y.shape} and scores {s.shape} differ in length")
    if not np.isfinite(s).all():
        raise ValueError("scores contain NaN or infinity")
    order = np.argsort(-s, kind="stable")
    s = s[order]
    y = y[order].astype(np.float64)
    idx = np.concatenate([np.nonzero(np.diff(s))[0], [y.size - 1]])
    tps = np.cumsum(y * 1.0, dtype=np.float64)[idx]
    fps = 1 + idx.astype(np.float64) - tps
    return fps, tps, s[idx]


def _auc(x: np.ndarray, y: np.ndarray) -> float:
    """Area under (x, y) by the trapezoidal rule, x monotonic."""
    direction = 1
    dx = np.diff(x)
    if np.any(dx < 0):
        if np.all(dx <= 0):
            direction = -1
        else:
            raise ValueError(f"x is neither increasing nor decreasing: {x}")
    return float(direction * trapezoid(y, x))


def compute_roc(predictions: np.ndarray, labels: np.ndarray):
    """(AUROC, fpr, tpr, thresholds) (ref utils_eval.py:548-551). Without
    negatives fpr is all NaN, without positives tpr is, and AUROC is NaN."""
    fps, tps, thresholds = _clf_curve(labels, predictions)
    if fps.shape[0] > 2:  # drop collinear points (they do not move the area)
        keep = np.where(np.concatenate([
            [True], np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), [True]]))[0]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps = np.concatenate([[0.0], tps])
    fps = np.concatenate([[0.0], fps])
    thresholds = np.concatenate([[np.inf], thresholds])
    _fpr = np.full(fps.shape, np.nan) if fps[-1] <= 0 else fps / fps[-1]
    _tpr = np.full(tps.shape, np.nan) if tps[-1] <= 0 else tps / tps[-1]
    return _auc(_fpr, _tpr), _fpr, _tpr, thresholds


def compute_prc(predictions: np.ndarray, labels: np.ndarray):
    """(AUPRC, precisions, recalls, thresholds) (ref utils_eval.py:554-557).
    AUPRC is the average precision; without positives recall is 1 at every
    threshold."""
    fps, tps, thresholds = _clf_curve(labels, predictions)
    ps = tps + fps
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(ps != 0, np.divide(tps, ps), 0.0)
    recall = np.full(tps.shape, 1.0) if tps[-1] == 0 else tps / tps[-1]
    precision = np.concatenate([precision[::-1], [1.0]])
    recall = np.concatenate([recall[::-1], [0.0]])
    ap = float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))
    return ap, precision, recall, thresholds[::-1]


def find_best_val(
    x: np.ndarray,
    y: np.ndarray,
    val_range=(0.0, 1.0),
    max_steps: int = 10,
    step: int = 0,
    max_val: float = 0.0,
    max_point: float = 0.0,
):
    """Greedy quartile search for the Dice-maximising threshold (Zimmerer,
    ref utils_eval.py:508-539): Dice at the 25%/75% points of the range, then
    the better half, keeping the best (dice, threshold) seen. Returns
    (best_dice, best_threshold)."""
    x = np.asarray(x).ravel()
    y = np.asarray(y).astype(bool).ravel()
    lo, hi = float(val_range[0]), float(val_range[1])
    if lo == hi:
        hi = 1.0
    for _ in range(step, max_steps):
        center = lo + (hi - lo) * 0.5
        q_bottom = lo + (hi - lo) * 0.25
        q_top = lo + (hi - lo) * 0.75
        val_bottom = dice(x > q_bottom, y)
        val_top = dice(x > q_top, y)
        if np.isnan(val_bottom):
            val_bottom = 0.0
        if np.isnan(val_top):
            val_top = 0.0
        if val_bottom >= val_top:
            if val_bottom >= max_val:
                max_val, max_point = val_bottom, q_bottom
            hi = center
        else:
            if val_top >= max_val:
                max_val, max_point = val_top, q_top
            lo = center
    return max_val, max_point


def confusion_counts(pred: np.ndarray, target: np.ndarray):
    """(TP, FP, TN, FN) with target as truth (the reference passes
    confusion_matrix(pred, target), ref :108; the standard counts are what
    its TPR/precision formulas assume)."""
    pred = np.asarray(pred).astype(bool).ravel()
    target = np.asarray(target).astype(bool).ravel()
    tp = int(np.sum(pred & target))
    fp = int(np.sum(pred & ~target))
    tn = int(np.sum(~pred & ~target))
    fn = int(np.sum(~pred & target))
    return tp, fp, tn, fn


def precision_recall_specificity_accuracy(pred: np.ndarray, target: np.ndarray):
    """Per-volume precision and recall of the positive class (0 where
    undefined), specificity and accuracy (ref utils_eval.py:125-129)."""
    tp, fp, tn, fn = confusion_counts(pred, target)
    precision = tp / (tp + fp) if tp + fp > 0 else 0.0
    recall = tp / (tp + fn) if tp + fn > 0 else 0.0
    specificity = tn / (tn + fp + 1e-7)
    accuracy = (tp + tn) / (tp + fp + tn + fn)
    return float(precision), float(recall), float(specificity), float(accuracy)


def filter_3d_connected_components(volume: np.ndarray, min_size: int = 8) -> np.ndarray:
    """Zero out connected components of fewer than ``min_size`` voxels (ref
    utils_eval.py:489-503: skimage.label(connectivity=3), full
    26-connectivity; components of <= 7 voxels dropped)."""
    volume = np.asarray(volume).astype(bool)
    sz = None
    if volume.ndim > 3:
        sz = volume.shape
        volume = volume.reshape(sz[0] * sz[1], sz[2], sz[3])
    structure = np.ones((3,) * volume.ndim, dtype=bool)
    labeled, n = ndi.label(volume, structure=structure)
    if n:
        counts = np.bincount(labeled.ravel())
        small = counts < min_size
        small[0] = False
        volume = volume & ~small[labeled]
    if sz is not None:
        volume = volume.reshape(sz)
    return volume


def _surface(mask: np.ndarray) -> np.ndarray:
    """Surface voxels: the mask minus its erosion (monai's surface)."""
    if not mask.any():
        return mask
    eroded = ndi.binary_erosion(mask, structure=ndi.generate_binary_structure(mask.ndim, 1))
    return mask & ~eroded


def hausdorff_distance(pred: np.ndarray, target: np.ndarray) -> float:
    """Symmetric euclidean surface Hausdorff distance (monai
    compute_hausdorff_distance(directed=False, percentile=None), ref
    utils_eval.py:132-135); NaN when either mask is empty. Computed inside
    the union's bounding box plus one voxel, where both surfaces lie."""
    pred = np.asarray(pred).astype(bool)
    target = np.asarray(target).astype(bool)
    if not pred.any() or not target.any():
        return float("nan")
    union = pred | target
    idx = np.where(union)
    sl = tuple(
        slice(max(0, int(i.min()) - 1), min(s, int(i.max()) + 2))
        for i, s in zip(idx, union.shape)
    )
    pred = pred[sl]
    target = target[sl]
    ps = _surface(pred)
    ts = _surface(target)
    dt_t = ndi.distance_transform_edt(~ts)
    dt_p = ndi.distance_transform_edt(~ps)
    d_pt = dt_t[ps].max() if ps.any() else 0.0
    d_tp = dt_p[ts].max() if ts.any() else 0.0
    return float(max(d_pt, d_tp))


def quantiles_from_hist(hist, qs):
    """Value quantiles from a pooled histogram (healthy-set FPR thresholds,
    ref utils_eval.py:289-297): the upper edge of the bin where the CDF
    reaches each q."""
    h = np.asarray(hist, np.float64)
    cdf = np.cumsum(h)
    total = cdf[-1]
    edges = (np.searchsorted(cdf, np.asarray(qs) * total, side="left")
             .astype(np.float64) + 1.0) / h.size
    return [float(e) for e in edges]


# --------------------------------------------------------------------------- #
# device metrics
# --------------------------------------------------------------------------- #
def _scalar(v, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def _cat0(x: torch.Tensor, value, first: bool = True) -> torch.Tensor:
    """x with one ``value`` prepended (or appended)."""
    v = torch.full((1,), value, dtype=x.dtype, device=x.device)
    return torch.cat([v, x] if first else [x, v])


def _auc_ap_device_impl(x: torch.Tensor, y: torch.Tensor):
    """AUROC (Mann-Whitney U with midranks) and tie-grouped AP from a stable
    sort and two binary searches; the direct form the sorted one is checked
    against."""
    x = x.float()
    y = y.float()
    n = x.numel()
    n_pos = y.sum()
    n_neg = n - n_pos
    sorted_x = torch.sort(x).values
    left = torch.searchsorted(sorted_x, x).float()
    right = torch.searchsorted(sorted_x, x, right=True).float()
    midrank = 0.5 * (left + right + 1.0)
    auroc = ((midrank * y).sum() - n_pos * (n_pos + 1.0) / 2.0) / (n_pos * n_neg)

    order = torch.argsort(-x, stable=True)
    xs = x[order]
    ys = y[order]
    tp = torch.cumsum(ys, 0)
    fp = torch.cumsum(1.0 - ys, 0)
    precision = tp / (tp + fp).clamp_min(1.0)
    recall = tp / n_pos.clamp_min(1.0)
    boundary = _cat0(xs[1:] != xs[:-1], True, first=False)
    r_b = torch.where(boundary, recall, 0.0)
    prev = _cat0(torch.cummax(r_b, 0).values[:-1], 0.0)
    ap = torch.where(boundary, (recall - prev) * precision, 0.0).sum()
    return auroc, ap


def _fma32(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """float32 a*b + c as the JAX package's XLA:CPU programs compute it (LLVM
    contracts the multiply and the add into one FMA). The product of two
    float32 values is exact in float64; the sum rounds to float64, then to
    float32, which is the FMA's single rounding unless the float64 sum falls
    exactly on a float32 halfway point."""
    return (a.double() * b + c.double()).float()


def _greedy_step(lo, hi, max_val, max_point, dice_at):
    # the 0.5 and 0.25 points are exact products either way; the 0.75 point
    # is one rounding of (hi - lo) * 0.75 + lo, as in the JAX package
    center = lo + (hi - lo) * 0.5
    q_bottom = lo + (hi - lo) * 0.25
    q_top = _fma32(hi - lo, 0.75, lo)
    val_bottom = dice_at(q_bottom)
    val_top = dice_at(q_top)
    take_bottom = val_bottom >= val_top
    cand_val = torch.where(take_bottom, val_bottom, val_top)
    cand_point = torch.where(take_bottom, q_bottom, q_top)
    better = cand_val >= max_val
    return (torch.where(take_bottom, lo, center), torch.where(take_bottom, center, hi),
            torch.where(better, cand_val, max_val), torch.where(better, cand_point, max_point))


def _greedy_search_device_impl(x, y, lo0, hi0, max_steps: int = 10):
    """The Zimmerer greedy quartile search (ref utils_eval.py:508-539) with
    two full-array Dice probes a step; the direct form the sorted search is
    checked against. Returns 0-d (best_dice, best_threshold)."""
    x = x.float()
    y = y.float()
    y_sum = y.sum()

    def dice_at(th):
        p = (x > th).float()
        inter = (p * y).sum()
        denom = p.sum() + y_sum
        return torch.where(denom > 0, 2.0 * inter / denom, 0.0)

    lo = lo0.float()
    hi = torch.where(hi0 == lo0, 1.0, hi0.float())
    best, point = _scalar(0.0, x.device), _scalar(0.0, x.device)
    for _ in range(max_steps):
        lo, hi, best, point = _greedy_step(lo, hi, best, point, dice_at)
    return best, point


def _greedy_from_sorted(xs, cpos0, lo0, hi0, max_steps: int = 10):
    """The greedy quartile search given ascending values ``xs`` and the
    integer inclusive positive-count prefix ``cpos0`` (length n + 1,
    cpos0[0] == 0): Dice at a threshold is one binary search and one prefix
    lookup. Shared by the pooled fit and the per-volume scoring core.
    Returns 0-d float32 (best_dice, best_threshold)."""
    n = xs.numel()
    n_pos = cpos0[n].float()

    def dice_at(th):
        rank = torch.searchsorted(xs, th.reshape(1), right=True)[0]
        inter = n_pos - cpos0[rank].float()
        denom = (n - rank).float() + n_pos
        return torch.where(denom > 0, 2.0 * inter / denom, 0.0)

    lo = lo0.float()
    hi = torch.where(hi0 == lo0, 1.0, hi0.float())
    best, point = _scalar(0.0, xs.device), _scalar(0.0, xs.device)
    for _ in range(max_steps):
        lo, hi, best, point = _greedy_step(lo, hi, best, point, dice_at)
    return best, point


def _sorted_greedy_search_impl(x, y, lo0, hi0, max_steps: int = 10):
    """The greedy search on one unstable pair sort and an int64
    positive-count prefix (exact past 2^24 pooled voxels)."""
    xs, order = torch.sort(x.float())
    cpos0 = _cat0(torch.cumsum(y.reshape(-1)[order].long(), 0), 0)
    return _greedy_from_sorted(xs, cpos0, lo0, hi0, max_steps)


def _quantiles_sorted_impl(x: torch.Tensor, qs) -> torch.Tensor:
    """numpy-'linear' quantiles of ``x`` from one unstable sort, float32."""
    xs = torch.sort(x.float().reshape(-1)).values
    n = xs.numel()
    out = []
    for q in qs:
        pos = q * (n - 1)
        lo = int(np.floor(pos))
        hi = min(lo + 1, n - 1)
        frac = _scalar(pos - lo, xs.device)
        # xs[lo] * (1 - frac) + xs[hi] * frac, the first product fused with
        # the sum as XLA:CPU fuses it in the JAX package
        out.append(_fma32(xs[lo], (1.0 - frac).double(), xs[hi] * frac))
    return torch.stack(out)


def quantiles_device(x, qs=(0.99, 0.95, 0.90), device: DeviceLike = None):
    """Pooled healthy-set FPR-quantile thresholds (ref utils_eval.py:289-297)
    from one unstable sort; a list of floats."""
    vals = _quantiles_sorted_impl(to_tensor(x, torch.float32, device), tuple(qs))
    return vals.cpu().tolist()


def _seg_metrics_sorted_impl(x: torch.Tensor, y: torch.Tensor, hi0: torch.Tensor):
    """AUROC + AP + the greedy Dice-threshold search from ONE unstable pair
    sort, every quantity from value-group aggregates:

    * AUROC: Mann-Whitney U, per positive the negatives strictly below its
      value plus half the tied ones, from group-start/-end negative counts
      carried through each group by running max/min scans.
    * AP: scikit-learn's tie-grouped form on the descending order, read at
      each group's last element there.
    * Greedy search: ``_greedy_from_sorted`` on the integer positive prefix.

    Returns 0-d float32 (auroc, ap, best_dice, best_threshold)."""
    x = x.float().reshape(-1)
    y = y.float().reshape(-1)
    n = x.numel()
    xs, order = torch.sort(x)
    ys = y[order]
    idx = torch.arange(n, dtype=torch.float32, device=x.device)  # exact below 2^24
    n_pos = ys.sum()
    n_neg = n - n_pos
    cpos = torch.cumsum(ys, 0)
    cneg = idx + 1.0 - cpos

    neq = xs[1:] != xs[:-1]
    first = _cat0(neq, True)
    last = _cat0(neq, True, first=False)

    # ---- AUROC ------------------------------------------------------------- #
    # negatives strictly below each value: the exclusive count at its group
    # start, carried forward; negatives up to the group end, carried backward
    neg_below = torch.cummax(torch.where(first, _cat0(cneg[:-1], 0.0), 0.0), 0).values
    neg_upto = torch.cummin(torch.where(last, cneg, float("inf")).flip(0), 0).values.flip(0)
    u_stat = (ys * (neg_below + 0.5 * (neg_upto - neg_below))).sum()
    auroc = u_stat / (n_pos * n_neg)

    # ---- average precision, ties grouped ----------------------------------- #
    yd = ys.flip(0)
    tp = torch.cumsum(yd, 0)
    fp = idx + 1.0 - tp
    precision = tp / (tp + fp).clamp_min(1.0)
    recall = tp / n_pos.clamp_min(1.0)
    # the descending order's group ends are the ascending order's starts
    boundary = first.flip(0)
    r_b = torch.where(boundary, recall, 0.0)
    prev = _cat0(torch.cummax(r_b, 0).values[:-1], 0.0)
    ap = torch.where(boundary, (recall - prev) * precision, 0.0).sum()

    # ---- greedy quartile search -------------------------------------------- #
    cpos0 = _cat0(torch.cumsum(ys.long(), 0), 0)
    best_dice, best_th = _greedy_from_sorted(xs, cpos0, _scalar(0.0, x.device), hi0)
    return auroc, ap, best_dice, best_th


def seg_metrics_device(predictions, labels, device: DeviceLike = None):
    """Exact AUROC + AP + the 10-step greedy Dice-threshold search of one
    volume (ref utils_eval.py:80-90, 508-539) as floats (auroc, auprc,
    best_dice, best_threshold)."""
    x = to_tensor(predictions, torch.float32, device).reshape(-1)
    y = to_tensor(labels, torch.float32, x.device if device is None else device).reshape(-1)
    return tuple(float(v) for v in _seg_metrics_sorted_impl(x, y, x.max()))


def compute_roc_prc_device(predictions, labels, device: DeviceLike = None):
    """Exact AUROC + average precision by the direct form (stable sort,
    midranks, grouped thresholds), as floats."""
    x = to_tensor(predictions, torch.float32, device).reshape(-1)
    y = to_tensor(labels, torch.float32, x.device if device is None else device).reshape(-1)
    auroc, ap = _auc_ap_device_impl(x, y)
    return float(auroc), float(ap)


def find_best_val_device(x, y, val_range=(0.0, 1.0), max_steps: int = 10,
                         device: DeviceLike = None):
    """``find_best_val`` for large pooled arrays (the val-stage fit over every
    voxel of every validation volume, ref utils_eval.py:262-288): one
    unstable pair sort, then ``max_steps`` scalar steps with float32
    quartiles. Returns floats (best_dice, best_threshold)."""
    xd = to_tensor(x, torch.float32, device).reshape(-1)
    yd = to_tensor(y, torch.float32, xd.device if device is None else device).reshape(-1)
    lo, hi = (_scalar(float(v), xd.device) for v in val_range)
    best, th = _sorted_greedy_search_impl(xd, yd, lo, hi, max_steps)
    return float(best), float(th)


# --------------------------------------------------------------------------- #
# histogram-pooled threshold fit: bounded memory for any number of volumes
# --------------------------------------------------------------------------- #
HIST_BINS = 1 << 20  # 1e-6 threshold resolution over the [0, 1] residual range


def hist_pool_init(bins: int = HIST_BINS, device: DeviceLike = None):
    """Empty (lesion, healthy) value histograms, float32 [bins] each."""
    dev = resolve_device(device)
    return (torch.zeros(bins, dtype=torch.float32, device=dev),
            torch.zeros(bins, dtype=torch.float32, device=dev))


def hist_pool_update(hist_pos, hist_neg, diff, seg):
    """Add one volume's residuals to the pooled (lesion, healthy) value
    histograms on their device. Residuals lie in [0, 1] (|a-b| or (a-b)^2 of
    [0, 1] volumes); larger values clip into the top bin. The float32 counts
    are exact below 2^24 voxels a bin."""
    b = hist_pos.shape[0]
    d = to_tensor(diff, torch.float32, hist_pos.device).reshape(-1)
    pos = to_tensor(seg, torch.float32, hist_pos.device).reshape(-1)
    idx = (d * b).to(torch.int32).clamp(0, b - 1).long()
    return hist_pos.index_add(0, idx, pos), hist_neg.index_add(0, idx, 1.0 - pos)


def find_best_val_hist(hist_pos, hist_neg):
    """Best pooled dice and its threshold from the value histograms: dice at
    every bin edge (suffix-sum TP/FP) and the first argmax, on the 1e-6 grid
    (ref utils_eval.py:262-288 searches 10 greedy steps instead)."""
    tp = torch.cumsum(hist_pos.flip(0), 0).flip(0)
    fp = torch.cumsum(hist_neg.flip(0), 0).flip(0)
    total_pos = tp[0]
    dice_b = 2.0 * tp / (tp + fp + total_pos + 1e-7)
    b = torch.argmax(dice_b)
    return float(dice_b[b]), float(b.float() / hist_pos.shape[0])
