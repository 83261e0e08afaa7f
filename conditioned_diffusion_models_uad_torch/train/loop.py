"""The training loop of the cDDPM and SparK tasks (counterpart of
``conditioned_diffusion_models_uad_tpu/train/loop.py``; reference
src/train.py:31-250 and the Lightning Trainer semantics it relies on).

One step gathers the batch's slices from volumes already on the device,
applies the intensity augmentation (or, with ``aug_full``, the full set to
the slices and their masks), evaluates the task's ``loss`` with its
BatchNorm in training mode, back-propagates and takes an Adam (AdamW for
SparK) step. Random draws come in as the task's draws (``TrainDraws`` from
``DDPMTask.draw_train``, with the patch boxes of the pDDPM; ``SparkDraws``
from ``SparkTask.draw_train``), so a step is a function of the state, the
indices and the draws.

``Trainer.fit`` runs the epochs: the index stream of epoch e comes from
``np.random.default_rng([seed + fold, e])`` (the JAX package's), validation
every ``check_val_every_n_epoch`` epochs with best/last checkpoints,
``fast_dev_run``, ``overfit_batches``, ``limit_val_batches``, resume from
'last' and ``train/loss`` / ``val/loss_comb`` / ``train/steps_per_sec``
rows. Every random draw of the fit goes through ``task.draw_train``: epoch
e's from a generator on the task's device seeded from (seed, fold, e),
validation's from one seeded from (seed, fold) afresh at each validation.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.augment import FullAugDraws, aug_intensity_apply, full_augment_apply
from ..models.tasks import TrainDraws
from .checkpoint import FoldCheckpointer

# (vols [V, H, W, D], masks [V, H, W, D] or None), both on the task's device
Data = Tuple[torch.Tensor, Optional[torch.Tensor]]


def make_optimizer(task) -> torch.optim.Optimizer:
    """Adam(lr) over every parameter: b1 0.9, b2 0.999, eps 1e-8 outside the
    square root, bias-corrected, the update of ``optax.adam(lr)``. A task
    whose config has ``weight_decay`` (SparK) takes AdamW(lr, (b1, b2), wd)
    over every parameter, as ``optax.adamw``: both decay the parameter
    before the step, so they agree to rounding."""
    cfg = task.cfg
    if hasattr(cfg, "weight_decay"):
        return torch.optim.AdamW(task.parameters(), lr=cfg.lr, betas=(cfg.b1, cfg.b2),
                                 weight_decay=cfg.weight_decay, eps=1e-8)
    return torch.optim.Adam(task.parameters(), lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)


def gathered_batch(data: Data, vol_idx, slice_idx, aug=None) -> dict:
    """Slices ``vols[vol_idx, :, :, slice_idx]`` as a batch {'vol', 'mask'}
    of [B, H, W, 1]. ``aug``: an ``AugDraws`` applies the intensity policy to
    'vol'; a ``FullAugDraws`` applies the full set to 'vol' and 'mask'
    together (the spatial families warp both)."""
    vols, masks = data
    vi = torch.as_tensor(vol_idx, device=vols.device).long()
    si = torch.as_tensor(slice_idx, device=vols.device).long()
    v = vols[vi, :, :, si][..., None].float()
    m = None if masks is None else masks[vi, :, :, si][..., None]
    if isinstance(aug, FullAugDraws):
        v, m = full_augment_apply(v, m, aug.to(v.device))
    elif aug is not None:
        v = aug_intensity_apply(v, aug.to(v.device))
    batch = {"vol": v}
    if m is not None:
        batch["mask"] = m
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
                generator: torch.Generator, augment=True) -> torch.Tensor:
    """``train_step`` over the rows of [S, B] index arrays, with each step's
    draws taken from ``generator`` (``augment``: True for aug_intensity,
    'full' for the full set, False for none). Returns the [S] losses."""
    losses = []
    for vi, si in zip(vol_idx_all, slice_idx_all):
        draws = task.draw_train(generator, len(vi), augment=augment)
        losses.append(train_step(task, opt, data, vi, si, draws))
    return torch.stack(losses)


@dataclasses.dataclass
class TrainerConfig:
    """The JAX package's trainer knobs, fields and defaults.
    ``epochs_per_dispatch`` and ``epoch_scan`` choose how the JAX package
    dispatches epochs to its device; they never change its results, and
    eager torch dispatches step by step whatever they say."""

    max_epochs: int = 1200
    check_val_every_n_epoch: int = 10
    epochs_per_dispatch: Optional[int] = None
    seed: int = 42
    ckpt_dir: str = "./checkpoints"
    resume: bool = False
    log_every_n_steps: int = 50
    fast_dev_run: bool = False  # 1 epoch, 1 batch, no checkpoint
    overfit_batches: int = 0  # > 0: the same first N batches every epoch
    aug_intensity: bool = True
    aug_full: bool = False  # also the spatial/noise/motion families
    epoch_scan: bool = True
    limit_val_batches: Optional[int] = None
    save_last: bool = True  # callbacks.checkpoint.save_last


def _seed(*parts: int) -> int:
    """A 63-bit generator seed from integers."""
    return int(np.random.SeedSequence([int(p) for p in parts]).generate_state(2, np.uint64)[0]
               >> np.uint64(1))


class Trainer:
    """Fit, validate and checkpoint one task on one fold. The task's weights
    at ``fit`` time are the starting point."""

    def __init__(self, task, cfg: TrainerConfig, logger=None):
        self.task = task
        self.cfg = cfg
        self.logger = logger
        self.opt = make_optimizer(task)
        self._step = 0  # optimizer steps taken, resumed ones included
        # wall seconds of the last fit: per epoch (training steps only),
        # validations, checkpoint writes, and its step count
        self.timings = {"epoch_s": [], "val_s": [], "ckpt_s": [], "steps": 0}

    def _log(self, metrics: dict, step: int) -> None:
        if self.logger is not None:
            self.logger.log_metrics(metrics, step=step)

    def _epoch_index_arrays(self, source, rng, limit=None):
        vis, sis = [], []
        for vi, si in source.epoch_indices(rng):
            vis.append(vi)
            sis.append(si)
            if limit is not None and len(vis) >= limit:
                break
        if not vis:
            return None, None
        # wrap-pad a remainder batch to the common size, as the JAX package
        # stacks an epoch into one [S, B] array
        bs = max(len(v) for v in vis)
        for i, (vi, si) in enumerate(zip(vis, sis)):
            if len(vi) != bs:
                idx = np.resize(np.arange(len(vi)), bs)
                vis[i], sis[i] = vi[idx], si[idx]
        return np.stack(vis), np.stack(sis)

    def validate(self, source, fold: int = 0) -> float:
        """Mean val loss over the val set's batches (fixed slices, fixed
        draws); NaN when there is no batch."""
        gen = torch.Generator(device=self.task.device).manual_seed(
            _seed(self.cfg.seed, fold, 1))
        data = (source.vols, source.masks)
        limit = self.cfg.limit_val_batches
        losses = []
        for i, (vi, si) in enumerate(source.epoch_indices(np.random.default_rng(0))):
            if limit is not None and i >= limit:
                break
            draws = self.task.draw_train(gen, len(vi), augment=False)
            losses.append(val_step(self.task, data, vi, si, draws))
        if not losses:
            return float("nan")
        vals = torch.stack(losses).double().cpu().numpy()  # one fetch
        return float(np.mean(vals))

    def state(self) -> dict:
        """The train state: task weights, optimizer state, optimizer steps."""
        return {"model": self.task.state_dict(), "optimizer": self.opt.state_dict(),
                "step": self._step}

    def fit(self, train_source, val_source=None, fold: int = 0) -> dict:
        """The fit loop (trainer.fit + ModelCheckpoint + resume,
        src/train.py:129-156); returns the final train state."""
        cfg, task = self.cfg, self.task
        ckpt = FoldCheckpointer(cfg.ckpt_dir, fold)
        start_epoch = 0
        if cfg.resume and ckpt.exists("last"):
            state, meta = ckpt.restore("last", map_location=task.device)
            task.load_state_dict(state["model"])
            self.opt.load_state_dict(state["optimizer"])
            self._step = int(state["step"])
            start_epoch = int(meta.get("step", 0))

        max_epochs = 1 if cfg.fast_dev_run else cfg.max_epochs
        data = (train_source.vols, train_source.masks)
        gen = torch.Generator(device=task.device)
        every = max(1, int(cfg.log_every_n_steps))
        val_n = max(1, int(cfg.check_val_every_n_epoch))
        self.timings = {"epoch_s": [], "val_s": [], "ckpt_s": [], "steps": 0}
        overfit_arrays = None
        if cfg.overfit_batches and not cfg.fast_dev_run:
            # Lightning overfit semantics: the SAME batches every epoch
            overfit_arrays = self._epoch_index_arrays(
                train_source, np.random.default_rng(cfg.seed), cfg.overfit_batches)
        steps, t_fit = 0, time.perf_counter()
        for epoch in range(start_epoch, max_epochs):
            if overfit_arrays is not None:
                vi_all, si_all = overfit_arrays
            else:
                # the shuffle stream is a function of (seed, fold, epoch), so
                # a resumed run continues the order an unbroken one draws
                vi_all, si_all = self._epoch_index_arrays(
                    train_source, np.random.default_rng([cfg.seed + fold, epoch]),
                    1 if cfg.fast_dev_run else None)
            if vi_all is None:
                raise ValueError("empty training source")
            gen.manual_seed(_seed(cfg.seed, fold, 0, epoch))
            t0 = time.perf_counter()
            # aug_full takes precedence over aug_intensity, as in the JAX package
            augment = "full" if cfg.aug_full else cfg.aug_intensity
            losses = train_epoch(task, self.opt, data, vi_all, si_all, gen, augment=augment)
            self._step += len(vi_all)
            loss_host = losses.double().cpu().numpy()  # one fetch an epoch
            self.timings["epoch_s"].append(time.perf_counter() - t0)
            for b, value in enumerate(loss_host):
                if (steps + b + 1) % every == 0 or b == len(loss_host) - 1:
                    self._log({"train/loss": float(value), "epoch": epoch}, steps + b + 1)
            steps += len(loss_host)
            done = epoch + 1
            if (val_source is None or cfg.fast_dev_run
                    or not (done % val_n == 0 or done == max_epochs)):
                continue
            t0 = time.perf_counter()
            val_loss = self.validate(val_source, fold)
            self.timings["val_s"].append(time.perf_counter() - t0)
            self._log({"val/loss_comb": val_loss, "epoch": epoch}, steps)
            t0 = time.perf_counter()
            state = self.state()
            saved = ckpt.maybe_save_best(state, done, val_loss)
            if cfg.save_last:
                ckpt.save_last(state, done, val_loss)
            if saved or cfg.save_last:
                self.timings["ckpt_s"].append(time.perf_counter() - t0)
        if not cfg.fast_dev_run and val_source is None and cfg.save_last:
            t0 = time.perf_counter()
            ckpt.save_last(self.state(), max_epochs)
            self.timings["ckpt_s"].append(time.perf_counter() - t0)
        self.timings["steps"] = steps
        self._log({"train/steps_per_sec": steps / max(time.perf_counter() - t_fit, 1e-9)},
                  steps)
        return self.state()
