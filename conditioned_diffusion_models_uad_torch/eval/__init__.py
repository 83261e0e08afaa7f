"""Evaluation: post-processing, metrics and the per-volume anomaly-scoring
harness (counterpart of ``conditioned_diffusion_models_uad_tpu/eval``;
reference src/utils/utils_eval.py)."""
from .harness import EvalConfig, EvalSession, get_eval_dictionary, log_images
from .metrics import (
    compute_prc,
    compute_roc,
    confusion_counts,
    dice,
    filter_3d_connected_components,
    find_best_val,
    fpr,
    hausdorff_distance,
    tpr,
)
from .postprocess import (
    apply_brainmask_volume,
    median_filter_3d,
    postprocess_residual,
    reco_errors,
    residual_volume,
    resize_trilinear,
    slice_anomaly_scores,
    volume_anomaly_score,
)

__all__ = [
    "EvalConfig", "EvalSession", "get_eval_dictionary", "log_images",
    "compute_prc", "compute_roc", "confusion_counts", "dice",
    "filter_3d_connected_components", "find_best_val", "fpr",
    "hausdorff_distance", "tpr", "apply_brainmask_volume", "median_filter_3d",
    "postprocess_residual", "reco_errors", "residual_volume",
    "resize_trilinear", "slice_anomaly_scores", "volume_anomaly_score",
]
