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
Checkpoints are written on a background thread from a snapshot
(``AsyncCheckpointWriter``). Within a process group (``parallel/mesh.py``)
the step is data-parallel and equals the one-process step over the whole
batch (``train_step``).
"""
from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.augment import FullAugDraws, aug_intensity_apply, full_augment_apply
from ..models.tasks import TrainDraws
from ..parallel.mesh import (
    all_reduce_grads,
    barrier,
    broadcast_module,
    global_mean,
    shard,
    shard_draws,
    sharded,
    world,
)
from ..utils.profiling import span
from .checkpoint import FoldCheckpointer, to_cpu, variables_only

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
    with span("train.gather"):
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


def _rank_rows(vol_idx, slice_idx, draws):
    """This rank's rows of a global batch's indices and draws (all of them
    without a process group)."""
    rank, size = world()
    if size == 1:
        return vol_idx, slice_idx, draws
    return (shard(vol_idx, rank, size), shard(slice_idx, rank, size),
            shard_draws(draws, rank, size, len(vol_idx)))


def train_step(task, opt: torch.optim.Optimizer, data: Data, vol_idx, slice_idx,
               draws: TrainDraws) -> torch.Tensor:
    """One training step; updates the task's parameters and the encoder's
    running statistics in place and returns the loss (a detached scalar on
    the device; reading it synchronises).

    Within a process group (``parallel/mesh.py``) the indices and draws are
    the global batch's, the same on every rank: each rank takes its rows
    (``shard``, ``shard_draws``), the BatchNorm statistics are the global
    batch's, the gradients are all-reduced and averaged before the optimizer
    step, and the returned loss is the global mean, so the step is the
    one-process step over the whole batch. Its phases are spans
    (``utils/profiling.py``)."""
    with span("train.step"):
        rank, size = world()
        vol_idx, slice_idx, draws = _rank_rows(vol_idx, slice_idx, draws)
        batch = gathered_batch(data, vol_idx, slice_idx, draws.aug)
        opt.zero_grad(set_to_none=True)
        with span("train.forward"), sharded(task, rank, size):
            loss, _ = task.loss(batch, draws, train=True)
        with span("train.backward"):
            loss.backward()
        with span("train.all_reduce"):
            all_reduce_grads(task)
            loss = global_mean(loss.detach())
        with span("train.optimizer"):
            opt.step()
        return loss


@torch.no_grad()
def val_step(task, data: Data, vol_idx, slice_idx, draws: TrainDraws) -> torch.Tensor:
    """The validation loss: no augmentation, running BatchNorm statistics
    (within a process group the global batch's mean, as ``train_step``)."""
    rank, size = world()
    vol_idx, slice_idx, draws = _rank_rows(vol_idx, slice_idx, draws)
    batch = gathered_batch(data, vol_idx, slice_idx)
    with sharded(task, rank, size):
        loss, _ = task.loss(batch, draws, train=False)
    return global_mean(loss)


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


class AsyncCheckpointWriter:
    """One checkpoint cycle in flight (counterpart of the JAX package's
    ``_AsyncCheckpointWriter``): ``submit(fn)`` waits for the previous
    cycle, then runs ``fn`` on a one-thread pool, so the fit loop goes on
    while a snapshot is copied to the host and written. An exception of a
    cycle surfaces at the next ``submit`` or ``join``."""

    def __init__(self):
        self._fut = None
        self._pool = None

    def submit(self, fn) -> None:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt-writer")
        self.join()  # cycles share meta.json and the best/last paths
        self._fut = self._pool.submit(fn)

    def join(self) -> None:
        if self._fut is not None:
            fut, self._fut = self._fut, None
            fut.result()

    def close(self) -> None:
        """``join``, then stop the thread."""
        try:
            self.join()
        finally:
            if self._pool is not None:
                self._pool.shutdown()
                self._pool = None


def snapshot(obj):
    """A copy of a train state on its device (``detach().clone()`` of every
    tensor), which later in-place updates of the live state cannot change."""
    if torch.is_tensor(obj):
        return obj.detach().clone()
    if isinstance(obj, dict):
        return type(obj)((k, snapshot(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(snapshot(v) for v in obj)
    return obj


def host_copy(snap, device, ready: Optional[torch.cuda.Event] = None):
    """``snap`` on the host, for the checkpoint writer's thread. With
    ``ready`` (an event recorded behind the snapshot on ``device``), the copy
    runs on a side stream into pinned buffers, which the caching host
    allocator hands out again the next cycle: it does not queue on the fit's
    stream, and the next cycle faults no fresh pages. The thread then waits
    for it."""
    if ready is None:
        return to_cpu(snap)
    stream = torch.cuda.Stream(device=device)
    stream.wait_event(ready)
    with torch.cuda.stream(stream):
        host = to_cpu(snap, non_blocking=True)
    stream.synchronize()
    return host


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
        # validations, checkpoint stalls (the snapshot and the wait for the
        # previous write), the writer's host copy and files a cycle, the
        # wait for the last write, and its step count
        self.timings = {"epoch_s": [], "val_s": [], "ckpt_s": [], "ckpt_write_s": [],
                        "steps": 0}

    def _log(self, metrics: dict, step: int) -> None:
        if self.logger is not None and world()[0] == 0:
            self.logger.log_metrics(metrics, step=step)

    @staticmethod
    def _pad_batch_idx(vi: np.ndarray, si: np.ndarray):
        """Wrap-pad an index batch up to a multiple of the world size, so it
        splits evenly over the ranks (the JAX package's ``_pad_batch_idx``;
        the duplicated samples reweight a monitoring loss slightly)."""
        size = world()[1]
        n = len(vi)
        target = -(-n // size) * size
        if target == n:
            return vi, si
        idx = np.resize(np.arange(n), target)[n:]
        return np.concatenate([vi, vi[idx]]), np.concatenate([si, si[idx]])

    def _epoch_index_arrays(self, source, rng, limit=None):
        vis, sis = [], []
        for vi, si in source.epoch_indices(rng):
            vi, si = self._pad_batch_idx(vi, si)
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
            vi, si = self._pad_batch_idx(vi, si)
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
        src/train.py:129-156); returns the final train state.

        A checkpoint cycle snapshots the state on the device (``snapshot``:
        the full state, or its 'best' subset when ``save_last`` is off) and
        hands the copy to the host (``host_copy``) and the write to
        ``AsyncCheckpointWriter``. The loop waits for the snapshot and for
        the previous cycle, so the write is hidden only when the epochs
        between two validations outlast it; meanwhile the card holds the
        snapshot, a second copy of the state.
        Within a process group every rank runs the loop on the same index
        and draw streams (``train_step`` takes its rows), resumes from
        'last', and rank 0 alone logs and writes checkpoints; the others
        wait for its last write at a barrier before ``fit`` returns."""
        cfg, task = self.cfg, self.task
        rank, size = world()
        ckpt = FoldCheckpointer(cfg.ckpt_dir, fold)
        start_epoch = 0
        if cfg.resume and ckpt.exists("last"):
            state, meta = ckpt.restore("last", map_location=task.device)
            task.load_state_dict(state["model"])
            self.opt.load_state_dict(state["optimizer"])
            self._step = int(state["step"])
            start_epoch = int(meta.get("step", 0))
        broadcast_module(task)  # every rank starts from rank 0's replica

        max_epochs = 1 if cfg.fast_dev_run else cfg.max_epochs
        data = (train_source.vols, train_source.masks)
        gen = torch.Generator(device=task.device)
        every = max(1, int(cfg.log_every_n_steps))
        val_n = max(1, int(cfg.check_val_every_n_epoch))
        self.timings = {"epoch_s": [], "val_s": [], "ckpt_s": [], "ckpt_write_s": [],
                        "steps": 0}
        writer = AsyncCheckpointWriter()
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
            if rank != 0:
                continue
            is_best = ckpt.is_best(val_loss)
            if not (is_best or cfg.save_last):
                continue
            t0 = time.perf_counter()
            state = self.state()
            snap = snapshot(state if cfg.save_last else variables_only(state))
            ready = None
            if torch.device(task.device).type == "cuda":
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(task.device))

            def write(snap=snap, ready=ready, done=done, val_loss=val_loss, is_best=is_best):
                t0 = time.perf_counter()
                host = host_copy(snap, task.device, ready)  # one a cycle, for best and last
                t1 = time.perf_counter()
                if is_best:
                    ckpt.maybe_save_best(host, done, val_loss)
                if cfg.save_last:
                    ckpt.save_last(host, done, val_loss)
                self.timings["ckpt_write_s"].append([t1 - t0, time.perf_counter() - t1])

            writer.submit(write)
            self.timings["ckpt_s"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        writer.close()
        self.timings["ckpt_join_s"] = time.perf_counter() - t0
        if rank == 0 and not cfg.fast_dev_run and val_source is None and cfg.save_last:
            t0 = time.perf_counter()
            ckpt.save_last(self.state(), max_epochs)
            self.timings["ckpt_s"].append(time.perf_counter() - t0)
        barrier()  # rank 0's checkpoints are on disk for every rank
        self.timings["steps"] = steps
        self._log({"train/steps_per_sec": steps / max(time.perf_counter() - t_fit, 1e-9)},
                  steps)
        return self.state()
