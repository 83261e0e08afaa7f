from .gaussian import (  # noqa: F401
    GaussianDiffusionConfig,
    diffusion_call,
    model_predictions,
    normalize_to_neg_one_to_one,
    p_losses,
    predict_noise_from_start,
    predict_start_from_noise,
    q_sample,
    unnormalize_to_zero_to_one,
)
from .schedule import DiffusionSchedule, extract, make_schedule  # noqa: F401
