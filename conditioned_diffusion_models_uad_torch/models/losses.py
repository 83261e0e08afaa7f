"""Reconstruction losses (counterpart of
``conditioned_diffusion_models_uad_tpu/models/losses.py``; reference
src/models/losses.py:3-23 ``L1_AE``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def l1_error(reco: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """|reco - target| elementwise, through this module's ``F`` (which
    ``utils/decisions.py`` can record and replay)."""
    return F.l1_loss(reco, target, reduction="none")


def l1_ae_loss(reco: torch.Tensor, target: torch.Tensor, strategy: str = "sum",
               per_sample: bool = False) -> dict:
    """L1 reconstruction error as {'combined_loss', 'reg', 'recon_error'}
    (reg 0: no regulariser). 'sum' sums each sample's errors and averages
    over the batch; 'mean' averages each sample's. ``per_sample=True``
    returns the [B] vectors whose batch mean is the scalar, so a padded
    slice stack can be cropped to its true depth before the mean."""
    err = (reco - target).abs().reshape(reco.shape[0], -1)
    recon = err.sum(dim=1) if strategy == "sum" else err.mean(dim=1)
    if not per_sample:
        recon = recon.mean()
    return {"combined_loss": recon, "reg": torch.zeros_like(recon), "recon_error": recon}
