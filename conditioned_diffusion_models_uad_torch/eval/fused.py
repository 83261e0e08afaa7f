"""The per-volume scoring core and its packed output (counterpart of
``conditioned_diffusion_models_uad_tpu/eval/fused.py``): every
device-computable quantity of the reference's ``_test_step`` chain
(src/utils/utils_eval.py:18-194) for one volume, returned as the residual
``diff`` [H, W, D] (kept on the device for the val-stage pooling) and ONE
uint8 buffer that the host fetches once:

* the per-volume scalars ``SCALAR_KEYS``           N_SCALARS x 4 bytes, f32
* per-slice reductions [D, 5] ``PER_SLICE_KEYS``   D x 5 x 4 bytes, f32
* the slice-mean conditioning latent [L]           L x 4 bytes, f32
* the thresholded map, 1 bit a voxel               ceil(HWD / 8) bytes
* optionally the binarised seg, 1 bit a voxel

The layout is the JAX package's byte for byte (float32 little-endian, bits
in numpy's big-endian ``packbits`` order with the tail padded), so one
``parse_packed`` reads either buffer.

Thresholds (ref utils_eval.py:84-93): ``th_record`` replaces the greedy
search's threshold in the test stage (the val fit), ``th_apply`` a fixed
cfg.threshold; NaN means "use the search's". Squared Hausdorff distances are
exact integers in float32; -1 marks an empty mask.
"""
from __future__ import annotations

import numpy as np
import torch

from . import cc, hausdorff
from .metrics import _seg_metrics_sorted_impl
from .postprocess import (
    apply_brainmask_volume,
    median_filter_3d,
    reco_errors,
    residual_volume,
    resize_trilinear,
    slice_anomaly_scores,
    volume_anomaly_score,
)

# order of the packed per-volume scalar block. 'haus_pt'/'haus_tp' are the
# SQUARED directed surface-Hausdorff distances (-1 = empty mask, NaN = not
# computed here); 'aux_loss' is the model-forward eval loss (NaN = none);
# tp/fp/tn/fn are the confusion counts of the component-filtered map (NaN
# unless the filter ran here)
SCALAR_KEYS = (
    "l1recoErrorAll", "l2recoErrorAll", "l1recoErrorUnhealthy",
    "l1recoErrorHealthy", "l2recoErrorUnhealthy", "l2recoErrorHealthy",
    "vol_score", "auroc", "auprc", "best_dice", "th_record", "th_apply",
    "lesion_size", "haus_pt", "haus_tp", "aux_loss",
    "tp", "fp", "tn", "fn",
)
N_SCALARS = len(SCALAR_KEYS)
PER_SLICE_KEYS = ("slice_score", "seg_size", "tp", "fp", "fn")

_STATIC_EVAL_ARGS = (
    "residualmode", "erode_iterations", "median_kernel", "eval_seg",
    "cc_min_size", "pack_seg", "with_hausdorff", "pack_maps",
)

_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def _f32_bytes(x: torch.Tensor) -> torch.Tensor:
    """A float32 tensor's bytes, flat uint8 (little-endian on host and card)."""
    if x.numel() == 0:
        return torch.empty(0, dtype=torch.uint8, device=x.device)
    return x.float().contiguous().reshape(-1).view(torch.uint8)


def _packbits(b: torch.Tensor) -> torch.Tensor:
    """bool -> uint8 [ceil(N / 8)], first element in the high bit (numpy's
    big-endian ``packbits``), the last byte padded with zeros."""
    flat = b.reshape(-1).to(torch.uint8)
    pad = (-flat.numel()) % 8
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    w = torch.tensor(_BIT_WEIGHTS, dtype=torch.int32, device=b.device)
    return (flat.view(-1, 8).int() * w).sum(dim=1).to(torch.uint8)


def _volume_eval_core(
    orig: torch.Tensor,  # [H, W, D]
    reco: torch.Tensor,  # [H, W, D], or the model grid (resized here)
    mask: torch.Tensor,  # [H, W, D]
    seg: torch.Tensor,  # [H, W, D]
    th_record: torch.Tensor,  # 0-d; NaN -> greedy-search best threshold
    th_apply: torch.Tensor,  # 0-d; NaN -> th_record
    aux_loss: torch.Tensor,  # 0-d model-forward eval loss (NaN = none)
    aux_latent: torch.Tensor,  # [L] slice-mean conditioning latent (L may be 0)
    *,
    residualmode: str = "l1",
    erode_iterations: int = 3,
    median_kernel: int = 5,
    eval_seg: bool = True,
    cc_min_size: int = 0,  # > 0: the component filter runs here (cc.py)
    pack_seg: bool = False,  # append the bit-packed binarised seg
    with_hausdorff: bool = False,  # the Hausdorff pair here (needs cc_min_size > 0)
    pack_maps: bool = True,  # False: neither map in the buffer (every map
    # consumer ran here: component filter, Hausdorff, confusion counts)
):
    """One volume's scoring: (diff [H, W, D] f32, packed [B] uint8), both on
    the inputs' device."""
    dev = orig.device
    orig = orig.float()
    reco = reco.float()
    if reco.shape != orig.shape:
        # full-resolution evaluation: the model-grid reconstruction resized
        # onto the orig grid (ref utils_eval.py:24-27)
        reco = resize_trilinear(reco, orig.shape)

    diff = residual_volume(orig, reco, residualmode)
    if erode_iterations > 0:
        diff = apply_brainmask_volume(diff, mask, erode_iterations)
    if median_kernel > 1:
        diff = median_filter_3d(diff, median_kernel)

    errs = reco_errors(orig, reco, seg)
    slice_scores = slice_anomaly_scores(diff, mask)
    vol_score = volume_anomaly_score(diff, mask)

    d = diff.shape[-1]
    seg_b = seg > 0
    zero = torch.zeros((), device=dev)
    nan = torch.full((), float("nan"), device=dev)
    if eval_seg:
        x = diff.reshape(-1)
        auroc, ap, best_dice, best_th = _seg_metrics_sorted_impl(x, seg_b.reshape(-1), x.max())
        th_rec = torch.where(torch.isnan(th_record), best_th, th_record.float())
        th_app = torch.where(torch.isnan(th_apply), th_rec, th_apply.float())
        thresholded = diff > th_app
        # per-slice reductions at the recorded threshold (ref :137-144)
        pred_all = diff > th_rec
        tp_s = (pred_all & seg_b).sum(dim=(0, 1)).float()
        fp_s = (pred_all & ~seg_b).sum(dim=(0, 1)).float()
        fn_s = (~pred_all & seg_b).sum(dim=(0, 1)).float()
        lesion = seg_b.sum().float()
    else:
        auroc = ap = best_dice = lesion = th_rec = th_app = zero
        thresholded = torch.zeros(diff.shape, dtype=torch.bool, device=dev)
        tp_s = fp_s = fn_s = torch.zeros(d, device=dev)
    seg_sz = seg_b.sum(dim=(0, 1)).float()

    if cc_min_size > 0 and eval_seg:
        thresholded = cc.filter_3d_connected_components_device(thresholded, cc_min_size)
        # confusion counts of the final map: every other per-volume ratio
        # derives from these on the host (ref utils_eval.py:108-135)
        tp = (thresholded & seg_b).sum().float()
        fp = (thresholded & ~seg_b).sum().float()
        fn = (~thresholded & seg_b).sum().float()
        tn = torch.tensor(float(seg_b.numel()), device=dev) - tp - fp - fn
    else:
        tp = fp = tn = fn = nan
    if with_hausdorff and eval_seg:
        if cc_min_size <= 0:
            raise ValueError("with_hausdorff needs the component filter here "
                             "(cc_min_size > 0): Hausdorff reads the final map")
        haus_pt, haus_tp = hausdorff.hausdorff_sq_pair(thresholded, seg_b)
    else:
        haus_pt = haus_tp = nan

    scalars = torch.stack([
        errs["l1recoErrorAll"], errs["l2recoErrorAll"],
        errs["l1recoErrorUnhealthy"], errs["l1recoErrorHealthy"],
        errs["l2recoErrorUnhealthy"], errs["l2recoErrorHealthy"],
        vol_score, auroc, ap, best_dice, th_rec, th_app, lesion,
        haus_pt, haus_tp, aux_loss.float().reshape(()),
        tp, fp, tn, fn,
    ])
    per_slice = torch.stack([slice_scores, seg_sz, tp_s, fp_s, fn_s], dim=-1)
    segments = [_f32_bytes(scalars), _f32_bytes(per_slice), _f32_bytes(aux_latent)]
    if pack_maps:
        segments.append(_packbits(thresholded))
        if pack_seg:
            segments.append(_packbits(seg_b))
    return diff, torch.cat(segments)


# the JAX package jits the core under this name; here it is the core itself
volume_eval_program = _volume_eval_core


def group_eval_core(orig, reco, mask, seg, th_record, th_apply, aux_loss,
                    aux_latent, **static):
    """``_volume_eval_core`` over a leading group axis, one volume at a time:
    volumes [G, ...], scalars [G], latents [G, L] -> (diff [G, H, W, D],
    packed [G, B])."""
    outs = [
        _volume_eval_core(orig[g], reco[g], mask[g], seg[g], th_record[g],
                          th_apply[g], aux_loss[g], aux_latent[g], **static)
        for g in range(orig.shape[0])
    ]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


def packed_layout(shape, latent_len: int, pack_seg: bool, pack_maps: bool = True):
    """Byte offsets of the packed buffer's segments for ``parse_packed``."""
    n = int(np.prod(shape))
    d = shape[-1]
    nbits = (n + 7) // 8 if pack_maps else 0
    o_scalars = 0
    o_slice = o_scalars + N_SCALARS * 4
    o_latent = o_slice + d * 5 * 4
    o_thresh = o_latent + latent_len * 4
    o_seg = o_thresh + nbits
    total = o_seg + (nbits if (pack_seg and pack_maps) else 0)
    return o_scalars, o_slice, o_latent, o_thresh, o_seg, total


def parse_packed(buf, shape, latent_len: int, pack_seg: bool,
                 pack_maps: bool = True) -> dict:
    """Split one fetched uint8 buffer (numpy, or a tensor, fetched here with
    ``.cpu()``) into host views: {'scalars': {key: float}, 'per_slice':
    [D, 5] f32, 'latent': [L] f32, 'thresholded': bool [H, W, D] | None,
    'seg': bool [H, W, D] | None}."""
    if torch.is_tensor(buf):
        buf = buf.cpu().numpy()
    buf = np.asarray(buf)
    o_sc, o_sl, o_la, o_th, o_se, total = packed_layout(shape, latent_len, pack_seg, pack_maps)
    if buf.size != total:
        raise ValueError(f"packed buffer has {buf.size} bytes, layout wants {total}")
    n = int(np.prod(shape))
    d = shape[-1]
    scalars = np.frombuffer(buf[o_sc:o_sl].tobytes(), "<f4")
    per_slice = np.frombuffer(buf[o_sl:o_la].tobytes(), "<f4").reshape(d, 5)
    latent = np.frombuffer(buf[o_la:o_th].tobytes(), "<f4")
    thresholded = (
        np.unpackbits(buf[o_th:o_se], count=n).reshape(shape).astype(bool)
        if pack_maps else None
    )
    seg = (
        np.unpackbits(buf[o_se:], count=n).reshape(shape).astype(bool)
        if (pack_seg and pack_maps) else None
    )
    return {
        "scalars": dict(zip(SCALAR_KEYS, scalars.tolist())),
        "per_slice": per_slice,
        "latent": latent,
        "thresholded": thresholded,
        "seg": seg,
    }


def unpack_thresholded(packed, shape) -> np.ndarray:
    """Host inverse of ``_packbits``: [ceil(N / 8)] uint8 -> bool ``shape``."""
    if torch.is_tensor(packed):
        packed = packed.cpu().numpy()
    n = int(np.prod(shape))
    return np.unpackbits(np.asarray(packed), count=n).reshape(shape).astype(bool)
