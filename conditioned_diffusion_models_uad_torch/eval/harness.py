"""Anomaly-detection evaluation harness: per-volume scoring and aggregation
(counterpart of ``conditioned_diffusion_models_uad_tpu/eval/harness.py``;
reference src/utils/utils_eval.py).

* ``get_eval_dictionary``   the result schema                     (ref :324-445)
* ``EvalSession.test_step`` one volume: residual -> brain-mask erosion ->
  3D median -> AUROC/AUPRC -> greedy threshold (val) or the val threshold
  (test) -> connected-component filter -> Dice, confusion counts, Hausdorff
  -> per-slice metrics -> slice and volume anomaly scores     (ref :18-194)
* ``EvalSession.test_end``  nan-mean/std aggregation; the val-stage pooled
  threshold fit (lesion sets) or FPR-quantile thresholds (healthy sets)
                                                               (ref :196-297)
* ``log_images``            4-panel grids every 10th slice      (ref :586-628)

Volumes above ``FUSED_MIN_VOXELS`` score through ``fused.volume_eval_program``
with one packed fetch; smaller ones through the host path. A session runs on
``cuda`` unless given ``device``. Where the JAX harness tells a device array
from a host one, this one asks ``torch.is_tensor``: a tensor takes the
device branch whatever device it is on.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device, to_tensor
from . import metrics as M
from . import postprocess as P
from .fused import parse_packed, volume_eval_program

HEALTHY_SETS = ("IXI",)

# volumes above this voxel count score through the fused program (one packed
# fetch); smaller ones take the host path. Tests lower it to force the fused
# path on small volumes.
FUSED_MIN_VOXELS = 100_000


def get_eval_dictionary() -> dict:
    """The reference's eval-result schema (utils_eval.py:324-445), dead
    reference paths (KLD/gradELBO/age) included so the pickled dict keeps its
    shape."""
    keys_lists = [
        "IDs", "x", "reconstructions", "diffs", "diffs_volume", "Segmentation",
        "reconstructionTimes", "latentSpace", "Age", "AgeGroup",
        "l1reconstructionErrors", "l1recoErrorAll", "l1recoErrorUnhealthy",
        "l1recoErrorHealthy", "l2recoErrorAll", "l2recoErrorUnhealthy",
        "l2recoErrorHealthy", "l2reconstructionErrors",
        "HausPerVol", "TPPerVol", "FPPerVol", "FNPerVol", "TNPerVol",
        "TPRPerVol", "FPRPerVol", "TPTotal", "FPTotal", "FNTotal", "TNTotal",
        "TPRTotal", "FPRTotal", "PrecisionPerVol", "RecallPerVol",
        "PrecisionPerSlice", "RecallPerSlice", "lesionSizePerSlice",
        "lesionSizePerVol", "Dice", "DiceScorePerSlice", "DiceScorePerVol",
        "BestDicePerVol", "BestThresholdPerVol", "AUCPerVol", "AUPRCPerVol",
        "SpecificityPerVol", "AccuracyPerVol",
        "TPgradELBO", "FPgradELBO", "FNgradELBO", "TNgradELBO",
        "TPRgradELBO", "FPRgradELBO", "DicegradELBO", "DiceScorePerVolgradELBO",
        "BestDicePerVolgradELBO", "BestThresholdPerVolgradELBO",
        "AUCPerVolgradELBO", "AUPRCPerVolgradELBO", "KLD_to_learned_prior",
        "AUCAnomalyCombPerSlice", "AUPRCAnomalyCombPerSlice",
        "AnomalyScoreCombPerSlice", "AUCAnomalyKLDPerSlice",
        "AUPRCAnomalyKLDPerSlice", "AnomalyScoreKLDPerSlice",
        "AUCAnomalyRecoPerSlice", "AUPRCAnomalyRecoPerSlice",
        "AnomalyScoreRecoPerSlice", "AnomalyScoreRecoBinPerSlice",
        "AnomalyScoreAgePerSlice", "AUCAnomalyAgePerSlice",
        "AUPRCAnomalyAgePerSlice", "labelPerSlice", "labelPerVol",
        "AnomalyScoreCombPerVol", "AnomalyScoreCombiPerVol",
        "AnomalyScoreCombMeanPerVol", "AnomalyScoreRegPerVol",
        "AnomalyScoreRegMeanPerVol", "AnomalyScoreRecoPerVol",
        "AnomalyScoreCombPriorPerVol", "AnomalyScoreCombiPriorPerVol",
        "AnomalyScoreAgePerVol", "AnomalyScoreRecoMeanPerVol",
        "DiceScoreKLPerVol", "DiceScoreKLCombPerVol", "BestDiceKLCombPerVol",
        "BestDiceKLPerVol", "AUCKLCombPerVol", "AUPRCKLCombPerVol",
        "AUCKLPerVol", "AUPRCKLPerVol", "TPKLCombPerVol", "FPKLCombPerVol",
        "TNKLCombPerVol", "FNKLCombPerVol", "TPRKLCombPerVol", "FPRKLCombPerVol",
        "TPKLPerVol", "FPKLPerVol", "TNKLPerVol", "FNKLPerVol", "TPRKLPerVol",
        "FPRKLPerVol",
    ]
    d = {k: [] for k in keys_lists}
    d.update({
        "l1reconstructionErrorMean": 0.0,
        "l1reconstructionErrorStd": 0.0,
        "l2reconstructionErrorMean": 0.0,
        "l2reconstructionErrorStd": 0.0,
    })
    return d


@dataclasses.dataclass
class EvalConfig:
    """Knobs of the eval chain (reference cfg.* reads in utils_eval.py); the
    JAX package's fields and defaults."""

    resized_evaluation: bool = True
    new_size: Sequence[int] = (160, 190, 160)
    residualmode: str = "l1"
    erode_brainmask: bool = True
    median_filtering: bool = True
    kernelsize_median: int = 5
    eval_seg: bool = True
    threshold: str = "auto"  # 'auto' or a float
    cc_min_size: int = 8  # drop components <= 7 voxels (ref :500)
    # 'host' = scipy label on the fetched map; 'device' = label propagation
    # inside the fused core (eval/cc.py, same partition); fused path only
    cc_backend: str = "host"
    # 'host' = bbox-cropped scipy distance transforms; 'device' = the exact
    # separable squared EDT (eval/hausdorff.py). Identical values
    hausdorff_backend: str = "host"
    # device memory for the val-stage pooled residuals (fused path): up to
    # this many MB the exact pool and one greedy fit; beyond it O(1)-memory
    # value histograms (metrics.find_best_val_hist). 0 = histograms from the
    # first volume
    pool_device_budget_mb: int = 2048
    save_output_images: bool = False
    save_to_disc: bool = True
    use_postprocessed_score: bool = True
    out_dir: str = "."
    # the orchestrator's knobs, kept for the config's shape: scorer threads
    # beside the reconstruction, loader threads and prefetch, volumes per
    # reconstruction call, loader-thread pre-upload, and the reconstruct +
    # score dispatch (VolumeReconstructor.batch_call_scored)
    scorer_threads: int = 2
    loader_threads: int = 2
    loader_prefetch: int = 2
    volumes_per_call: int = 1
    preupload: bool = True
    fused_dispatch: bool = True

    def __post_init__(self):
        for knob in ("cc_backend", "hausdorff_backend"):
            v = getattr(self, knob)
            if v not in ("host", "device"):
                raise ValueError(f"{knob} must be 'host' or 'device', got {v!r}")


def _numel(a) -> int:
    return a.numel() if torch.is_tensor(a) else int(np.size(a))


def _host(a) -> np.ndarray:
    """A tensor fetched to the host (explicit ``.cpu()``), or the array."""
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


class EvalSession:
    """One val or test pass over a dataset: ``test_step`` per volume, then
    ``test_end``. Mirrors the reference mixin's state (eval_dict, pooled
    residuals, the val threshold handed to the test stage)."""

    def __init__(
        self,
        cfg: EvalConfig,
        dataset_name: str,
        stage: str,  # 'val' | 'test'
        threshold: Optional[dict] = None,  # val-fit threshold for the test stage
        logger=None,  # optional: saved image grids go to logger.log_image
        device: DeviceLike = None,
    ):
        self.cfg = cfg
        self.dataset = dataset_name
        self.stage = stage
        self.logger = logger
        self.device = resolve_device(device)
        self.eval_dict = get_eval_dictionary()
        self.threshold = dict(threshold) if threshold else {}
        self.threshholds_healthy: dict = {}
        self._diffs_list: list = []
        self._seg_list: list = []
        self.is_healthy = dataset_name in HEALTHY_SETS
        # commits land atomically and in batch_idx order (dense, 0-based)
        # through a reorder buffer: a volume scored out of order parks its
        # commit and frees its thread, so a lone scorer worker handed a later
        # group first cannot deadlock
        self._commit_cv = threading.Condition()
        self._commit_turn = 0
        self._ready: dict = {}  # batch_idx -> parked commit closure
        self._aborted: set = set()
        self._pool_bytes = 0
        self._hist = None  # (hist_pos, hist_neg) once the pool budget is hit

    # ------------------------------------------------------------------ #
    def _hausdorff(self, pred: np.ndarray, target: np.ndarray) -> float:
        if self.cfg.hausdorff_backend == "device":
            from .hausdorff import hausdorff_distance_device

            return hausdorff_distance_device(pred, target, device=self.device)
        return M.hausdorff_distance(pred, target)

    def _record_volume_scores(self, rec, aux, vol_score, label_vol) -> None:
        """Model-forward scalars and sample-wise anomaly scores, shared by the
        host and fused paths (ref DDPM_2D.py:214-223,267-280 and
        utils_eval.py:185-194)."""
        cfg = self.cfg
        if aux is not None:
            lat = aux.get("latent")
            if lat is not None:
                rec.append(("latentSpace", "append", _host(lat)))
            loss_v = aux.get("loss")
            if loss_v is not None:
                loss_v = float(_host(loss_v))
                score_fn = aux.get("score_fn") or (
                    lambda l: {k: l for k in ("reco", "reg", "comb", "combi",
                                              "comb_prior", "combi_prior")}
                )
                scores = score_fn(loss_v)
                rec.append(("AnomalyScoreRegPerVol", "append", scores["reg"]))
                if not cfg.use_postprocessed_score:
                    # volumes scored by the model loss (ref DDPM_2D.py:276-280)
                    rec.extend([
                        ("AnomalyScoreRecoPerVol", "append", scores["reco"]),
                        ("AnomalyScoreCombPerVol", "append", scores["comb"]),
                        ("AnomalyScoreCombiPerVol", "append", scores["combi"]),
                        ("AnomalyScoreCombPriorPerVol", "append", scores["comb_prior"]),
                        ("AnomalyScoreCombiPriorPerVol", "append", scores["combi_prior"]),
                    ])
        if cfg.use_postprocessed_score:
            for k in ("AnomalyScoreRecoPerVol", "AnomalyScoreCombPerVol",
                      "AnomalyScoreCombiPerVol", "AnomalyScoreCombPriorPerVol",
                      "AnomalyScoreCombiPriorPerVol"):
                rec.append((k, "append", vol_score))
        rec.append(("labelPerVol", "append", int(label_vol)))

    # ------------------------------------------------------------------ #
    def _commit_in_order(self, batch_idx: int, apply_fn) -> None:
        """Park this volume's commit, then run every consecutive ready commit
        in batch_idx order (under the lock, one thread drains at a time)."""
        with self._commit_cv:
            self._ready[batch_idx] = apply_fn
            self._drain_locked()

    def _drain_locked(self) -> None:
        while True:
            if self._commit_turn in self._aborted:
                self._aborted.discard(self._commit_turn)
                self._commit_turn += 1
                continue
            fn = self._ready.pop(self._commit_turn, None)
            if fn is None:
                return
            # the turn is spent before the closure runs, so one that raises
            # cannot wedge the buffer
            self._commit_turn += 1
            fn()

    def _abort_turn(self, batch_idx: int) -> None:
        """Release a failed step's commit slot so later commits can land."""
        with self._commit_cv:
            if batch_idx >= self._commit_turn:
                self._aborted.add(batch_idx)
                self._ready.pop(batch_idx, None)
                self._drain_locked()

    def test_step(
        self,
        final_volume,
        data_orig,
        data_seg,
        data_mask,
        *,
        batch_idx: int = 0,
        ID: str = "",
        label_vol: int = 0,
        aux: Optional[dict] = None,
        seg_dev=None,
    ) -> None:
        """Score one volume. ``batch_idx`` (keyword-only) orders the commits
        of concurrent scorer threads. ``seg_dev`` optionally hands the device
        twin of ``data_seg``: device consumers use it, host binarisation keeps
        ``data_seg``."""
        try:
            return self._test_step_impl(
                final_volume, data_orig, data_seg, data_mask,
                batch_idx=batch_idx, ID=ID, label_vol=label_vol, aux=aux,
                seg_dev=seg_dev,
            )
        except BaseException:
            self._abort_turn(int(batch_idx))
            raise

    def _test_step_impl(
        self,
        final_volume,  # [H, W, D] reconstruction in [0, 1]
        data_orig,  # [H, W, D]
        data_seg,  # [H, W, D] or None
        data_mask,  # [H, W, D]
        *,
        batch_idx: int = 0,
        ID: str = "",
        label_vol: int = 0,
        aux: Optional[dict] = None,
        seg_dev=None,
    ) -> None:
        """``aux`` carries the model-forward eval values the reference's task
        records before scoring (DDPM_2D.py:214-280): 'loss' (the eval
        diffusion loss), 'latent' (slice-mean conditioning features or None)
        and 'score_fn' (``task.anomaly_scores``: loss -> the
        AnomalyScore*PerVol family used when use_postprocessed_score is off)."""
        cfg = self.cfg
        dev = self.device
        final_volume = to_tensor(final_volume, torch.float32, dev)
        if not cfg.resized_evaluation and tuple(final_volume.shape) != tuple(data_orig.shape):
            # full-resolution evaluation: the model-grid reconstruction
            # resized onto the orig grid (ref utils_eval.py:24-27)
            final_volume = P.resize_trilinear(final_volume, tuple(data_orig.shape))
        orig = to_tensor(data_orig, torch.float32, dev)
        mask = to_tensor(data_mask, torch.float32, dev)
        seg_src = seg_dev if seg_dev is not None else data_seg
        seg = (to_tensor(seg_src, torch.float32, dev) if seg_src is not None
               else torch.zeros_like(mask))

        if orig.numel() > FUSED_MIN_VOXELS:
            return self._test_step_fused(
                final_volume, orig, mask, seg,
                seg_available=data_seg is not None,
                batch_idx=batch_idx, ID=ID, label_vol=label_vol, aux=aux,
                data_seg=data_seg,
            )

        rec: list = []  # every eval_dict change, committed at once

        errs = P.reco_errors(orig, final_volume, seg)  # ref :36-49
        for k, v in errs.items():
            rec.append((k, "append", float(v)))

        erode_iters = int(orig.shape[1]) // 25 if cfg.erode_brainmask else 0
        diff_dev = P.postprocess_residual(  # ref :28-69
            orig, final_volume, mask,
            residualmode=cfg.residualmode,
            erode_iterations=erode_iters,
            median_kernel=cfg.kernelsize_median if cfg.median_filtering else 1,
        )
        slice_scores = _host(P.slice_anomaly_scores(diff_dev, mask))
        vol_score = float(P.volume_anomaly_score(diff_dev, mask))
        diff = _host(diff_dev)
        # binarise from the caller's host arrays
        seg_np = _host(data_seg) > 0 if data_seg is not None else np.zeros(diff.shape, bool)
        mask_np = _host(data_mask) > 0

        if cfg.save_output_images:
            self._log_images(diff, _host(orig), seg_np, mask_np, _host(final_volume), ID)

        # --- segmentation metrics (lesion sets only, ref :77-144) ---------- #
        if cfg.eval_seg and not self.is_healthy:
            flat_diff = diff.ravel()
            flat_seg = seg_np.ravel()
            if flat_diff.size > 100_000:
                # whole-volume arrays: AUROC + AP + the greedy search from one
                # device sort, on tensors already on the device
                AUC, AUPRC, bestDice, bestThresh = M.seg_metrics_device(diff_dev, seg > 0)
            else:
                AUC, _, _, _ = M.compute_roc(flat_diff, flat_seg)
                AUPRC, _, _, _ = M.compute_prc(flat_diff, flat_seg)
                bestDice, bestThresh = M.find_best_val(
                    flat_diff, flat_seg, val_range=(0, float(diff.max())), max_steps=10,
                )
            if "test" in self.stage:
                bestThresh = self.threshold["total"]
            th = bestThresh if cfg.threshold == "auto" else float(cfg.threshold)
            thresholded = M.filter_3d_connected_components(diff > th, min_size=cfg.cc_min_size)

            diceScore = M.dice(thresholded, flat_seg)
            TP, FP, TN, FN = M.confusion_counts(thresholded, flat_seg)
            prec, recall, spec, acc = M.precision_recall_specificity_accuracy(
                thresholded, flat_seg)
            rec.extend([
                ("lesionSizePerVol", "append", int(flat_seg.sum())),
                ("DiceScorePerVol", "append", diceScore),
                ("BestDicePerVol", "append", bestDice),
                ("BestThresholdPerVol", "append", bestThresh),
                ("AUCPerVol", "append", AUC),
                ("AUPRCPerVol", "append", AUPRC),
                ("TPPerVol", "append", TP),
                ("FPPerVol", "append", FP),
                ("TNPerVol", "append", TN),
                ("FNPerVol", "append", FN),
                ("TPRPerVol", "append", M.tpr(thresholded, flat_seg)),
                ("FPRPerVol", "append", M.fpr(thresholded, flat_seg)),
                ("IDs", "append", ID),
                ("AccuracyPerVol", "append", acc),
                ("PrecisionPerVol", "append", prec),
                ("RecallPerVol", "append", recall),
                ("SpecificityPerVol", "append", spec),
                ("HausPerVol", "append", M.hausdorff_distance(thresholded, seg_np)),
            ])

            # per-slice metrics on lesion slices (ref :137-144), depth last
            pred_all = diff > bestThresh
            seg_sz = seg_np.sum(axis=(0, 1))
            lesion = seg_sz > 0
            tp_s = (pred_all & seg_np).sum(axis=(0, 1)).astype(np.float64)
            fp_s = (pred_all & ~seg_np).sum(axis=(0, 1)).astype(np.float64)
            fn_s = ((~pred_all) & seg_np).sum(axis=(0, 1)).astype(np.float64)
            rec.extend(self._slice_rows(seg_sz, lesion, tp_s, fp_s, fn_s))

        # slice-wise anomaly scores and labels (ref :154-183)
        if diff.ndim != 2:
            slice_labels = [int(seg_np[..., s].any()) for s in range(seg_np.shape[-1])]
            if not self.is_healthy:
                rec.extend(self._slice_score_rows(slice_scores, slice_labels))

        self._record_volume_scores(rec, aux, vol_score, label_vol)

        def _apply():
            for k, mode, v in rec:
                getattr(self.eval_dict[k], mode)(v)
            if "val" in self.stage:  # pooled for the global threshold fit
                self._diffs_list.append(diff.ravel())
                self._seg_list.append(seg_np.ravel().astype(np.int8))

        self._commit_in_order(batch_idx, _apply)

    @staticmethod
    def _slice_rows(seg_sz, lesion, tp_s, fp_s, fn_s) -> list:
        """Per-slice Dice/precision/recall/lesion size on lesion slices."""
        pred_sz = tp_s + fp_s
        with np.errstate(divide="ignore", invalid="ignore"):
            dice_s = np.where(pred_sz + seg_sz > 0, 2 * tp_s / (pred_sz + seg_sz), np.nan)
            prec_s = np.where(pred_sz > 0, tp_s / pred_sz, 0.0)
            rec_s = np.where(tp_s + fn_s > 0, tp_s / (tp_s + fn_s), 0.0)
        return [
            ("DiceScorePerSlice", "extend", dice_s[lesion].tolist()),
            ("PrecisionPerSlice", "extend", prec_s[lesion].tolist()),
            ("RecallPerSlice", "extend", rec_s[lesion].tolist()),
            ("lesionSizePerSlice", "extend", seg_sz[lesion].astype(int).tolist()),
        ]

    @staticmethod
    def _slice_score_rows(slice_scores, slice_labels) -> list:
        AUC_s, _, _, _ = M.compute_roc(slice_scores, np.array(slice_labels))
        AUPRC_s, _, _, _ = M.compute_prc(slice_scores, np.array(slice_labels))
        return [
            ("AUCAnomalyRecoPerSlice", "append", AUC_s),
            ("AUPRCAnomalyRecoPerSlice", "append", AUPRC_s),
            ("labelPerSlice", "extend", list(slice_labels)),
            ("AnomalyScoreRecoPerSlice", "extend", np.asarray(slice_scores).tolist()),
        ]

    # ------------------------------------------------------------------ #
    def _log_images(self, diff, orig, seg_np, mask_np, reco, ID) -> None:
        """Save the 4-panel grids and push them to the logger (the reference
        logs every grid to wandb, utils_eval.py:627)."""
        paths = log_images(self.cfg, diff, orig, seg_np, mask_np, reco, ID, self.dataset)
        if self.logger is not None and hasattr(self.logger, "log_image"):
            for p in paths:
                self.logger.log_image(f"{self.dataset}/{self.stage}/grid", p)

    # ------------------------------------------------------------------ #
    def _fused_flags(self, orig_shape, seg_is_host: bool) -> dict:
        """The thresholds and static flags of the fused core for this
        session's stage, shared by the in-step call and the reconstruct +
        score path (``VolumeReconstructor.batch_call_scored``)."""
        cfg = self.cfg
        eval_seg = cfg.eval_seg and not self.is_healthy
        th_record = float("nan")
        th_apply = float("nan")
        if eval_seg:
            if "test" in self.stage:
                th_record = float(self.threshold["total"])
            if cfg.threshold != "auto":
                th_apply = float(cfg.threshold)
        # cc_min_size <= 0 means no filter at all: the core then computes
        # neither the filtered map nor the counts, so the host path serves it
        cc_on_device = cfg.cc_backend == "device" and cfg.cc_min_size > 0
        hd_in_program = eval_seg and cc_on_device and cfg.hausdorff_backend == "device"
        # the maps go to the host only when a map consumer runs there
        maps_needed = eval_seg and (not cc_on_device or not hd_in_program)
        # a seg that lives on the device rides the same fetch, bit-packed
        pack_seg = maps_needed and not seg_is_host
        return {
            "th_record": th_record,
            "th_apply": th_apply,
            "statics": dict(
                residualmode=cfg.residualmode,
                erode_iterations=int(orig_shape[1]) // 25 if cfg.erode_brainmask else 0,
                median_kernel=cfg.kernelsize_median if cfg.median_filtering else 1,
                eval_seg=eval_seg,
                cc_min_size=cfg.cc_min_size if cc_on_device else 0,
                pack_seg=pack_seg,
                with_hausdorff=hd_in_program,
                pack_maps=maps_needed,
            ),
        }

    def _test_step_fused(self, final_volume, orig, mask, seg, *, seg_available: bool,
                         batch_idx: int, ID: str, label_vol: int, aux: Optional[dict],
                         data_seg=None) -> None:
        """Large-volume scoring through ``volume_eval_program``: one packed
        fetch, the residual kept on the device for the val-stage pooling.
        Records the same rows as the host path."""
        flags = self._fused_flags(
            tuple(orig.shape), seg_is_host=not seg_available or not torch.is_tensor(data_seg),
        )
        dev = self.device
        have_loss = aux is not None and aux.get("loss") is not None
        have_latent = aux is not None and aux.get("latent") is not None
        aux_loss = (to_tensor(aux["loss"], torch.float32, dev) if have_loss
                    else torch.tensor(float("nan"), device=dev))
        aux_latent = (to_tensor(aux["latent"], torch.float32, dev).reshape(-1) if have_latent
                      else torch.zeros(0, device=dev))
        diff_dev, packed_dev = volume_eval_program(
            orig, final_volume, mask, seg,
            torch.tensor(flags["th_record"], device=dev),
            torch.tensor(flags["th_apply"], device=dev),
            aux_loss, aux_latent, **flags["statics"],
        )
        parsed = parse_packed(  # the one fetch of this volume
            packed_dev, tuple(orig.shape), int(aux_latent.shape[0]),
            flags["statics"]["pack_seg"], flags["statics"]["pack_maps"],
        )
        return self._record_fused(
            parsed, diff_dev, flags, orig=orig, mask=mask, seg=seg,
            final_volume=final_volume, seg_available=seg_available,
            batch_idx=batch_idx, ID=ID, label_vol=label_vol, aux=aux, data_seg=data_seg,
        )

    def test_step_precomputed(
        self,
        parsed: dict,  # parse_packed output for this volume
        diff_dev,  # the residual [H, W, D] (val-stage pooling input)
        flags: dict,  # this session's _fused_flags(...)
        *,
        seg_available: bool,
        batch_idx: int,
        ID: str,
        label_vol: int,
        score_fn=None,
        data_seg=None,
        seg_dev=None,  # the seg volume (tensor or host) for val-stage pooling
    ) -> None:
        """Commit one volume scored by ``VolumeReconstructor.
        batch_call_scored``; records what ``test_step``'s fused path does."""
        try:
            aux = {"score_fn": score_fn} if score_fn is not None else {}
            aux["loss"] = parsed["scalars"]["aux_loss"]
            aux["latent"] = parsed["latent"] if parsed["latent"].size else None
            seg = (to_tensor(seg_dev, torch.float32, diff_dev.device) if seg_dev is not None
                   else torch.zeros(diff_dev.shape, device=diff_dev.device))
            return self._record_fused(
                parsed, diff_dev, flags, orig=None, mask=None, seg=seg,
                final_volume=None, seg_available=seg_available, batch_idx=batch_idx,
                ID=ID, label_vol=label_vol, aux=aux, data_seg=data_seg,
            )
        except BaseException:
            self._abort_turn(int(batch_idx))
            raise

    def _record_fused(self, parsed: dict, diff_dev, flags: dict, *, orig, mask, seg,
                      final_volume, seg_available: bool, batch_idx: int, ID: str,
                      label_vol: int, aux: Optional[dict], data_seg) -> None:
        cfg = self.cfg
        statics = flags["statics"]
        eval_seg = statics["eval_seg"]
        maps_needed = statics["pack_maps"]
        pack_seg = statics["pack_seg"]
        cc_on_device = statics["cc_min_size"] > 0
        hd_in_program = statics["with_hausdorff"]
        have_loss = aux is not None and aux.get("loss") is not None
        have_latent = (aux is not None and aux.get("latent") is not None
                       and _numel(aux["latent"]) > 0)
        vol_size = int(np.prod(diff_dev.shape))
        s = parsed["scalars"]
        per_slice = parsed["per_slice"]
        slice_scores = per_slice[:, 0]
        seg_sz = per_slice[:, 1]
        vol_score = s["vol_score"]
        # the packed fetch carried the aux values: record the host floats
        if aux is not None:
            aux = dict(aux)
            if have_loss:
                aux["loss"] = s["aux_loss"]
            if have_latent:
                aux["latent"] = parsed["latent"]

        rec: list = [
            (k, "append", s[k])
            for k in ("l1recoErrorAll", "l2recoErrorAll", "l1recoErrorUnhealthy",
                      "l1recoErrorHealthy", "l2recoErrorUnhealthy", "l2recoErrorHealthy")
        ]

        if cfg.save_output_images and orig is not None:
            self._log_images(_host(diff_dev), _host(orig), _host(seg) > 0, _host(mask) > 0,
                             _host(final_volume), ID)

        if eval_seg:
            # component filter + metrics on the filtered map (ref :100-135):
            # with cc_backend='device' the filter ran in the core and the
            # counts came in the scalar block; else scipy labels the map here
            if maps_needed:
                thresholded = parsed["thresholded"]
                if not cc_on_device:
                    thresholded = M.filter_3d_connected_components(
                        thresholded, min_size=cfg.cc_min_size)
                if pack_seg:
                    seg_np = parsed["seg"]  # a device seg rode the fetch
                elif not seg_available:
                    seg_np = np.zeros(thresholded.shape, bool)
                else:
                    seg_np = _host(data_seg) > 0
            if cc_on_device:
                TP, FP, TN, FN = int(s["tp"]), int(s["fp"]), int(s["tn"]), int(s["fn"])
            else:
                TP, FP, TN, FN = M.confusion_counts(thresholded, seg_np)
            if hd_in_program:
                a, b = s["haus_pt"], s["haus_tp"]
                haus = float("nan") if (a < 0 or b < 0) else float(np.sqrt(max(a, b)))
            else:
                haus = self._hausdorff(thresholded, seg_np)
            prec = TP / (TP + FP) if (TP + FP) > 0 else 0.0
            recall = TP / (TP + FN) if (TP + FN) > 0 else 0.0
            spec = TN / (TN + FP + 1e-7)
            acc = (TP + TN) / vol_size
            dice_v = 2 * TP / (2 * TP + FP + FN) if (2 * TP + FP + FN) > 0 else float("nan")
            tpr_v = TP / (TP + FN) if (TP + FN) > 0 else float("nan")
            # the reference's FPR = FP / (FP + TP) (utils_eval.py:571)
            fpr_v = FP / (FP + TP) if (FP + TP) > 0 else float("nan")
            rec.extend([
                ("lesionSizePerVol", "append", int(s["lesion_size"])),
                ("DiceScorePerVol", "append", dice_v),
                ("BestDicePerVol", "append", s["best_dice"]),
                ("BestThresholdPerVol", "append", s["th_record"]),
                ("AUCPerVol", "append", s["auroc"]),
                ("AUPRCPerVol", "append", s["auprc"]),
                ("TPPerVol", "append", TP),
                ("FPPerVol", "append", FP),
                ("TNPerVol", "append", TN),
                ("FNPerVol", "append", FN),
                ("TPRPerVol", "append", tpr_v),
                ("FPRPerVol", "append", fpr_v),
                ("IDs", "append", ID),
                ("AccuracyPerVol", "append", acc),
                ("PrecisionPerVol", "append", prec),
                ("RecallPerVol", "append", recall),
                ("SpecificityPerVol", "append", spec),
                ("HausPerVol", "append", haus),
            ])
            rec.extend(self._slice_rows(seg_sz, seg_sz > 0, per_slice[:, 2],
                                        per_slice[:, 3], per_slice[:, 4]))

        slice_labels = (seg_sz > 0).astype(int).tolist()
        if not self.is_healthy:
            rec.extend(self._slice_score_rows(slice_scores, slice_labels))

        self._record_volume_scores(rec, aux, vol_score, label_vol)

        def _apply():
            for k, mode, v in rec:
                getattr(self.eval_dict[k], mode)(v)
            if "val" in self.stage:
                # pooled on the device; past the memory budget, folded into
                # bounded value histograms instead
                nbytes = diff_dev.numel() * 4
                budget = int(self.cfg.pool_device_budget_mb) * (1 << 20)
                if self._hist is None and self._pool_bytes + nbytes > budget:
                    self._hist = M.hist_pool_init(device=diff_dev.device)
                    for a, sg in zip(self._diffs_list, self._seg_list):
                        self._hist = M.hist_pool_update(*self._hist, a, sg)
                    self._diffs_list, self._seg_list = [], []
                    self._pool_bytes = 0
                if self._hist is not None:
                    self._hist = M.hist_pool_update(*self._hist, diff_dev.reshape(-1),
                                                    (seg > 0).reshape(-1))
                else:
                    self._diffs_list.append(diff_dev.reshape(-1))
                    self._seg_list.append((seg > 0).reshape(-1))
                    self._pool_bytes += nbytes

        self._commit_in_order(batch_idx, _apply)

    # ------------------------------------------------------------------ #
    def test_end(self) -> dict:
        """Aggregate (nan)mean/std over volumes; fit the val threshold (ref
        _test_end, utils_eval.py:196-297). Returns the eval dict."""
        d = self.eval_dict

        def agg(key, out, nan=True):
            vals = np.asarray(d[key], dtype=np.float64)
            if vals.size == 0:
                d[out + "Mean"], d[out + "Std"] = float("nan"), float("nan")
                return
            mean = np.nanmean(vals) if nan else np.mean(vals)
            std = np.nanstd(vals) if nan else np.std(vals)
            d[out + "Mean"], d[out + "Std"] = float(mean), float(std)

        for key in ("l1recoErrorAll", "l2recoErrorAll", "l1recoErrorHealthy",
                    "l1recoErrorUnhealthy", "l2recoErrorHealthy", "l2recoErrorUnhealthy",
                    "AUPRCPerVol", "AUCPerVol"):
            agg(key, key)
        agg("DiceScorePerVol", "DicePerVol")
        for key in ("BestDicePerVol", "BestThresholdPerVol", "PrecisionPerVol",
                    "RecallPerVol", "PrecisionPerSlice", "RecallPerSlice",
                    "AccuracyPerVol", "SpecificityPerVol"):
            agg(key, key, nan=False)
        for key in ("TPPerVol", "FPPerVol", "TNPerVol", "FNPerVol", "TPRPerVol", "FPRPerVol"):
            agg(key, key)
        haus = np.asarray(d["HausPerVol"], dtype=np.float64)
        haus = haus[np.isfinite(haus)]
        d["HausPerVolMean"] = float(np.nanmean(haus)) if haus.size else float("nan")
        d["HausPerVolStd"] = float(np.nanstd(haus)) if haus.size else float("nan")

        if "val" in self.stage:
            pool_on_device = any(torch.is_tensor(a) for a in self._diffs_list)
            if not self.is_healthy and self._hist is not None:
                _, self.threshold["total"] = M.find_best_val_hist(*self._hist)
            elif not self.is_healthy and self._diffs_list:
                if pool_on_device or sum(_numel(a) for a in self._diffs_list) > 4_000_000:
                    # the pooled fit on the device, where the residuals are
                    diffs = torch.cat([to_tensor(a, torch.float32, self.device).reshape(-1)
                                       for a in self._diffs_list])
                    segs = torch.cat([to_tensor(a, torch.float32, self.device).reshape(-1)
                                      for a in self._seg_list])
                    _, bestThresh = M.find_best_val_device(
                        diffs, segs, val_range=(0, float(diffs.max())), max_steps=10)
                else:
                    diffs = np.concatenate(self._diffs_list)
                    segs = np.concatenate(self._seg_list).astype(bool)
                    _, bestThresh = M.find_best_val(
                        diffs, segs, val_range=(0, float(diffs.max())), max_steps=10)
                self.threshold["total"] = bestThresh
            elif self._hist is not None:
                # healthy sets past the budget: seg is all zero there, so the
                # value distribution is hist_pos + hist_neg
                qs = M.quantiles_from_hist(_host(self._hist[0] + self._hist[1]),
                                           [0.99, 0.95, 0.90])
                self._set_healthy(qs)
            elif self._diffs_list:
                if pool_on_device:
                    diffs = torch.cat([to_tensor(a, torch.float32, self.device).reshape(-1)
                                       for a in self._diffs_list])
                    qs = M.quantiles_device(diffs, (0.99, 0.95, 0.90))
                else:
                    qs = np.quantile(np.concatenate(self._diffs_list), [0.99, 0.95, 0.90])
                self._set_healthy([float(q) for q in qs])
        return d

    def _set_healthy(self, qs) -> None:
        """Healthy-set FPR-quantile thresholds (ref utils_eval.py:289-297)."""
        self.threshholds_healthy = {
            "thresh_1p": qs[0], "thresh_5p": qs[1], "thresh_10p": qs[2],
        }
        d = self.eval_dict
        d["t_1p"], d["t_5p"], d["t_10p"] = qs[0], qs[1], qs[2]


def log_images(cfg: EvalConfig, diff_volume: np.ndarray, data_orig: np.ndarray,
               data_seg: np.ndarray, data_mask: np.ndarray, final_volume: np.ndarray,
               ID: str, dataset_name: str) -> list:
    """4-panel grid (orig / reco / residual in inferno / seg) every 10th
    slice (ref log_images, utils_eval.py:586-628). Returns the saved paths.
    matplotlib is imported here, and needed only when grids are saved."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.colors as colors
    import matplotlib.pyplot as plt

    grid_dir = os.path.join(cfg.out_dir, "grid")
    os.makedirs(grid_dir, exist_ok=True)
    paths = []
    vmax = float(diff_volume.max()) + 0.01
    for j in range(0, diff_volume.shape[-1], 10):
        fig, ax = plt.subplots(1, 4, figsize=(16, 4))
        fig.subplots_adjust(wspace=0.0)
        ax[0].imshow(np.rot90(data_orig[..., j], 3), "gray")
        ax[1].imshow(np.rot90(final_volume[..., j], 3), "gray")
        ax[2].imshow(np.rot90(diff_volume[..., j], 3), "inferno",
                     norm=colors.Normalize(vmin=0, vmax=vmax))
        ax[3].imshow(np.rot90(data_seg[..., j], 3), "gray")
        for axes in ax:
            axes.set_xticks([])
            axes.set_yticks([])
            for side in ("top", "right", "bottom", "left"):
                axes.spines[side].set_visible(False)
        plt.tight_layout()
        if cfg.save_to_disc:
            p = os.path.join(grid_dir, f"{ID}_{j}_Grid.png")
            plt.savefig(p, bbox_inches="tight")
            paths.append(p)
        plt.close(fig)
    return paths
