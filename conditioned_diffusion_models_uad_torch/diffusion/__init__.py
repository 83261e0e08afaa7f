from .gaussian import (  # noqa: F401
    GaussianDiffusionConfig,
    box_to_mask,
    ddim_sample,
    ddim_timesteps,
    diffusion_call,
    interpolate,
    model_predictions,
    noise_for,
    normalize_to_neg_one_to_one,
    p_losses,
    p_sample_loop,
    predict_noise_from_start,
    predict_start_from_noise,
    q_posterior,
    q_sample,
    unnormalize_to_zero_to_one,
)
from .schedule import DiffusionSchedule, extract, make_schedule  # noqa: F401
