"""Metric loggers (counterpart of ``conditioned_diffusion_models_uad_tpu/log``)."""
from .loggers import CSVLogger, MultiLogger, WandbLogger, log_hyperparameters, summarize

__all__ = ["CSVLogger", "MultiLogger", "WandbLogger", "log_hyperparameters", "summarize"]
