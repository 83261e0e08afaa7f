"""The cDDPM train step (counterpart of
``conditioned_diffusion_models_uad_tpu/train/loop.py`` :97-184).

One step gathers the batch's slices from volumes already on the device,
applies the intensity augmentation, evaluates ``DDPMTask.loss`` with the
encoder in training mode, back-propagates and takes an Adam step. Random
draws come in as a ``TrainDraws`` (``DDPMTask.draw_train``), so a step is a
function of the state, the indices and the draws. The fit loop (validation
cadence, checkpoints, logging) and ``full_augment_batch`` are not ported yet.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..data.augment import aug_intensity_apply
from ..models.tasks import TrainDraws

# (vols [V, H, W, D], masks [V, H, W, D] or None), both on the task's device
Data = Tuple[torch.Tensor, Optional[torch.Tensor]]


def make_optimizer(task) -> torch.optim.Adam:
    """Adam(lr) over every parameter: b1 0.9, b2 0.999, eps 1e-8 outside the
    square root, bias-corrected, the update of ``optax.adam(lr)``."""
    return torch.optim.Adam(task.parameters(), lr=task.cfg.lr, betas=(0.9, 0.999), eps=1e-8)


def gathered_batch(data: Data, vol_idx, slice_idx, aug=None) -> dict:
    """Slices ``vols[vol_idx, :, :, slice_idx]`` as a batch {'vol', 'mask'}
    of [B, H, W, 1], with the intensity augmentation applied to 'vol' when
    ``aug`` (an ``AugDraws``) is given."""
    vols, masks = data
    vi = torch.as_tensor(vol_idx, device=vols.device).long()
    si = torch.as_tensor(slice_idx, device=vols.device).long()
    v = vols[vi, :, :, si][..., None].float()
    if aug is not None:
        v = aug_intensity_apply(v, aug.to(v.device))
    batch = {"vol": v}
    if masks is not None:
        batch["mask"] = masks[vi, :, :, si][..., None]
    return batch


def train_step(task, opt: torch.optim.Optimizer, data: Data, vol_idx, slice_idx,
               draws: TrainDraws) -> torch.Tensor:
    """One training step; updates the task's parameters and the encoder's
    running statistics in place and returns the loss (a detached scalar on
    the device; reading it synchronises)."""
    batch = gathered_batch(data, vol_idx, slice_idx, draws.aug)
    opt.zero_grad(set_to_none=True)
    loss, _ = task.loss(batch, draws, train=True)
    loss.backward()
    opt.step()
    return loss.detach()


@torch.no_grad()
def val_step(task, data: Data, vol_idx, slice_idx, draws: TrainDraws) -> torch.Tensor:
    """The validation loss: no augmentation, running BatchNorm statistics."""
    batch = gathered_batch(data, vol_idx, slice_idx)
    loss, _ = task.loss(batch, draws, train=False)
    return loss


def train_epoch(task, opt: torch.optim.Optimizer, data: Data,
                vol_idx_all: Sequence, slice_idx_all: Sequence,
                generator: torch.Generator) -> torch.Tensor:
    """``train_step`` over the rows of [S, B] index arrays, with each step's
    draws (aug_intensity on) taken from ``generator``. Returns the [S] losses."""
    losses = []
    for vi, si in zip(vol_idx_all, slice_idx_all):
        draws = task.draw_train(generator, len(vi))
        losses.append(train_step(task, opt, data, vi, si, draws))
    return torch.stack(losses)
