"""Run orchestration: fold loop, fit, test after training, result pickling
(counterpart of ``conditioned_diffusion_models_uad_tpu/orchestrate.py``;
reference src/train.py:31-250).

* seed + fold loop over ``start_fold..num_folds``; the task by name
  (``task=DDPM_2D`` the cDDPM, ``task=Spark_2D`` SparK pretraining)
* ``pretrained_encoder``: the cDDPM's encoder backbone from a SparK run
  (a run directory of this port, or a reference torch SparK ``.ckpt``)
* fit with best/last checkpoints and resume; ``only_eval`` restores a
  checkpoint (a run directory, a best/last directory, or a reference
  Lightning ``.ckpt`` file) and skips the fit
* test after training: per-modality gated test sets, a val pass that fits
  the Dice threshold, then the test pass that applies it; a healthy set
  hands its 1% FPR quantile on instead
* ``<run>/<fold>_preds_dict.pkl`` and scalar summaries logged

Each eval volume draws its noise from the keys the JAX package gives it:
volume i of a stage takes ``key_i = fold_in(PRNGKey(seed + 1000 + fold),
i)`` (``volume_draws``, through ``utils/prng.py``). The cDDPM's single-shot
reconstruction on the hash noise path takes the seeds of its ensemble
members, ``randint(split(key_i, E)[m], (), 0, 2**31 - 1)``
(``volume_seeds``); its iterative and patched reconstructions, table noise
and SparK (its eval mask) take ``key_i`` itself and split it further as the
JAX package does. Grouping never moves a volume's metrics. ``run_stage`` is
the per-stage group loop.
"""
from __future__ import annotations

import itertools
import json
import logging
import math
import os
import pickle
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Optional

import numpy as np
import torch

from .config import RunConfig
from .data.datamodules import EVAL_MODULES, IXI, SETS_BY_MODE
from .eval.fused import parse_packed
from .eval.harness import FUSED_MIN_VOXELS, EvalSession
from .eval.reconstruct import VolumeReconstructor
from .log import CSVLogger, MultiLogger, WandbLogger, log_hyperparameters, summarize
from .models.tasks import TASKS, DDPMTask, SparkTask, import_spark_encoder
from .native.binding import reads as nifti_reads
from .native.mempool import enable_host_alloc_cache, pool_stats
from .parallel.mesh import broadcast_object, check_world, rank_device, spawn, world
from .train.checkpoint import find_run_checkpoint, load_state
from .train.loop import Trainer
from .utils import prng
from .utils.prefetch import PrefetchLoader
from .utils.profiling import span

log = logging.getLogger(__name__)


def build_task(cfg: RunConfig, fold: int = 0):
    """The run's task (``TASKS[cfg.task]``) on ``cfg.device``; its initial
    weights come from the CPU generator seeded with seed + fold."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed + fold)
        return TASKS[cfg.task](cfg.model, device=cfg.device)


def eval_key(seed: int, fold: int) -> np.ndarray:
    """The eval stage key of the JAX package: PRNGKey(seed + 1000 + fold)."""
    return prng.PRNGKey(seed + 1000 + fold)


def volume_seeds(key, idxs: Iterable[int], ensemble: int) -> torch.Tensor:
    """Simplex seeds [G, E] int32: row v holds volume idxs[v]'s E seeds,
    ``randint(split(fold_in(key, i), E)[m], (), 0, 2**31 - 1)``."""
    rows = [[int(prng.randint(k)) for k in prng.split(prng.fold_in(key, int(i)), ensemble)]
            for i in idxs]
    return torch.tensor(rows, dtype=torch.int32)


def volume_draws(task, key, idxs: Iterable[int]) -> torch.Tensor:
    """What the task's reconstruction takes for volumes ``idxs`` of a stage,
    one row a volume: the keys ``fold_in(key, i)`` [G, 2] (int64 holding the
    uint32 words) for SparK and for a cDDPM whose reconstruction takes keys
    (``DDPMTask.draws_keys``: iterative, patched or table noise), else the
    cDDPM's ``volume_seeds``."""
    if isinstance(task, SparkTask) or task.draws_keys:
        return torch.from_numpy(prng.fold_in(key, np.asarray(list(idxs))).astype(np.int64))
    return volume_seeds(key, idxs, task.cfg.ensemble_size)


def _load_torch_state_dict(path: str) -> dict:
    """A reference torch/Lightning ``.ckpt`` file -> {key: tensor}. Read
    with ``weights_only=True``; a file that embeds pickled objects needs
    UAD_UNSAFE_TORCH_LOAD=1, because loading it runs code."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        if os.environ.get("UAD_UNSAFE_TORCH_LOAD", "") in ("", "0"):
            raise RuntimeError(
                f"{path!r} is not loadable with torch.load(weights_only=True) "
                "(it embeds pickled non-tensor objects, which execute code at "
                "load time). If you trust this file, set "
                "UAD_UNSAFE_TORCH_LOAD=1 to allow the unsafe loader."
            )
        obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: v for k, v in obj.items() if torch.is_tensor(v)}


def reference_to_port(sd: dict) -> dict:
    """A reference cDDPM Lightning state_dict -> the port's names: the UNet
    under ``diffusion.model.*`` becomes ``unet.*``, the encoder (``encoder.*``
    or the SparK wrapper's ``encoder.encoder.*``) ``encoder.*``; schedule
    buffers are dropped (the port rebuilds them from the config)."""
    enc = "encoder.encoder." if any(k.startswith("encoder.encoder.") for k in sd) else "encoder."
    out = {}
    for k, v in sd.items():
        if k.startswith("diffusion.model."):
            out["unet." + k[len("diffusion.model."):]] = v
        elif k.startswith(enc):
            out["encoder." + k[len(enc):]] = v
    if not any(k.startswith("unet.") for k in out):
        raise ValueError("no 'diffusion.model.*' UNet keys in checkpoint")
    return out


def _run_state(src: str, which: str, fold: int, device) -> dict:
    """The task state_dict of a run directory's (or a best/last directory's)
    checkpoint."""
    path = src
    if os.path.basename(path) not in ("best", "last"):
        path = find_run_checkpoint(path, which, fold)
    return load_state(path, map_location=device)["model"]


def load_weights(task, cfg: RunConfig, fold: int) -> None:
    """``only_eval``: the weights of ``load_checkpoint`` (or this run's own
    checkpoints) into ``task``."""
    src = cfg.load_checkpoint or os.path.join(cfg.run_dir, "checkpoints")
    if os.path.isfile(src):  # a reference Lightning checkpoint file
        if not isinstance(task, DDPMTask):
            raise ValueError("a torch .ckpt file loads into the cDDPM task family only "
                             "(Lightning DDPM_2D checkpoints)")
        task.load_state_dict(reference_to_port(_load_torch_state_dict(src)))
        return
    task.load_state_dict(_run_state(src, cfg.checkpoint, fold, task.device))


def reference_spark_encoder(sd: dict) -> dict:
    """A reference torch SparK pretrain state_dict -> the ``model.encoder.*``
    keys ``import_spark_encoder`` reads: ``sparse_encoder.sp_cnn.*`` without
    its ``fc.*`` head (reference DDPM_2D.py:84-96)."""
    prefix = "sparse_encoder.sp_cnn."
    out = {"model.encoder." + k[len(prefix):]: v for k, v in sd.items()
           if k.startswith(prefix) and not k[len(prefix):].startswith("fc.")}
    if not out:
        raise ValueError(f"no '{prefix}*' keys in the SparK checkpoint")
    return out


def load_pretrained_encoder(task: DDPMTask, cfg: RunConfig, fold: int) -> None:
    """``pretrained_encoder``: the cDDPM's encoder backbone (weights and
    running statistics) from a SparK run directory of this port (its
    ``checkpoint`` best/last) or a reference torch SparK ``.ckpt`` file; the
    ``fc`` head keeps its fresh weights."""
    src = cfg.pretrained_encoder
    if os.path.isfile(src):
        spark = reference_spark_encoder(_load_torch_state_dict(src))
    else:
        spark = _run_state(src, cfg.checkpoint, fold, "cpu")
    task.load_state_dict(import_spark_encoder(task.state_dict(), spark))


def _dev(sub: dict, k: str):
    return sub.get("_dev", {}).get(k, sub.get(k))


def run_stage(session: EvalSession, recon: VolumeReconstructor, subjects: Iterable[dict],
              key, *, volumes_per_call: int = 1, scorer_threads: int = 2,
              fused_dispatch: bool = True, score_fn=None, warn=None) -> dict:
    """One eval stage: the subjects (in dataset order) grouped by shape into
    reconstruction calls of ``volumes_per_call`` volumes, each volume with
    its own draws (``volume_draws(task, key, [i])``); a full-size group of one
    shape reconstructs and scores in one call (``batch_call_scored``) and is
    committed on a scorer thread from its one packed fetch, other groups
    score volume by volume (``session.test_step``). A short tail group is
    padded with its last volume. Returns the stage's wall seconds:
    'load' (waiting for the loader), 'recon' (dispatching reconstructions),
    'wait' (waiting for scorer threads), 'total', and 'volumes'; the first
    three are its spans ``eval.load``, ``eval.dispatch`` and ``eval.wait``
    (``utils/profiling.py``).

    Within a process group every rank runs the stage on the same subjects
    in the same order: each group's reconstruction (and scoring) is split
    across the ranks by ``recon``, and rank 0 alone records the rows."""
    task = recon.task
    scoring = recon.rank == 0  # within a process group rank 0 alone scores
    group_n = max(1, int(volumes_per_call))
    n_workers = max(1, int(scorer_threads))
    warn = warn or (lambda reason, msg, *a: None)
    ph = {"load": 0.0, "recon": 0.0, "wait": 0.0, "volumes": 0}
    t_start = time.perf_counter()
    with ThreadPoolExecutor(max_workers=n_workers) as scorer:
        pending: list = []

        def backpressure():
            with span("eval.wait", into=ph, key="wait"):
                while len(pending) >= n_workers:
                    pending.pop(0).result()

        def seeds_of(group):
            idxs = [i for i, _ in group]
            return volume_draws(task, key, idxs + [idxs[-1]] * (group_n - len(idxs)))

        def score_group(group, diff_g, packed_g, flags, llen):
            statics = flags["statics"]
            first = group[0][0]
            done = 0
            try:
                with span("eval.fetch", group=first):
                    buf = packed_g.cpu().numpy()  # the group's one fetch
                with span("eval.commit", group=first):
                    for j, (i, sub) in enumerate(group):
                        seg_orig = sub.get("seg_orig")
                        seg_avail = bool(sub.get("seg_available", True))
                        parsed = parse_packed(buf[j], tuple(sub["vol_orig"].shape), llen,
                                              statics["pack_seg"], statics["pack_maps"])
                        session.test_step_precomputed(
                            parsed, diff_g[j], flags, seg_available=seg_avail, batch_idx=i,
                            ID=sub.get("ID", str(i)), label_vol=sub.get("label", 0),
                            score_fn=score_fn,
                            data_seg=seg_orig if seg_avail and isinstance(seg_orig, np.ndarray)
                            else None,
                            seg_dev=_dev(sub, "seg_orig"))
                        done = j + 1
            except BaseException:
                for i, _ in group[done:]:
                    session._abort_turn(int(i))
                raise

        def fusable(group):
            if not fused_dispatch:
                return False
            shapes_o = {tuple(s["vol_orig"].shape) for _, s in group}
            shapes_v = {tuple(s["vol"].shape) for _, s in group}
            if len(shapes_o) != 1 or len(shapes_v) != 1:
                warn("mixed_shapes", "a dispatch group mixes volume shapes (orig %s / "
                     "model %s)", sorted(shapes_o), sorted(shapes_v))
                return False
            if int(np.prod(next(iter(shapes_o)))) <= FUSED_MIN_VOXELS:
                warn("small_volumes", "volumes of shape %s are below the fused-path size "
                     "gate (%d voxels)", next(iter(shapes_o)), FUSED_MIN_VOXELS)
                return False
            return True

        def dispatch(group):
            with span("eval.dispatch", into=ph, key="recon", group=group[0][0]):
                fused = fusable(group)
                if fused:
                    subs = [s for _, s in group]
                    flags = session._fused_flags(
                        tuple(subs[0]["vol_orig"].shape),
                        seg_is_host=isinstance(subs[0].get("seg_orig"), np.ndarray))
                    devs = [dict(s, **s.get("_dev", {})) for s in subs]
                    padded = devs + [devs[-1]] * (group_n - len(devs))
                    diff_g, packed_g = recon.batch_call_scored(padded, flags, seeds_of(group))
                else:
                    vols = [_dev(s, "vol") for _, s in group]
                    res = recon.batch_call(vols + [vols[-1]] * (group_n - len(vols)),
                                           seeds_of(group))[:len(group)]
            if fused:
                if not scoring:
                    return
                backpressure()
                pending.append(scorer.submit(score_group, group, diff_g, packed_g, flags,
                                             recon.latent_len()))
                return
            if not scoring:
                return
            for (i, sub), (reco, raux) in zip(group, res):
                backpressure()
                fused_vol = int(np.prod(sub["vol_orig"].shape)) > FUSED_MIN_VOXELS
                seg_avail = bool(sub.get("seg_available", True))
                pending.append(scorer.submit(
                    session.test_step, reco,
                    _dev(sub, "vol_orig") if fused_vol else sub["vol_orig"],
                    sub.get("seg_orig") if seg_avail else None,
                    _dev(sub, "mask_orig") if fused_vol else sub["mask_orig"],
                    batch_idx=i, ID=sub.get("ID", str(i)), label_vol=sub.get("label", 0),
                    aux={"loss": raux["loss"], "latent": raux["latent"], "score_fn": score_fn},
                    seg_dev=_dev(sub, "seg_orig") if fused_vol and seg_avail else None))

        # groups of identical (orig, model) shapes, not raw dataset order:
        # each volume's rows land in dataset order through the session's
        # commit reorder buffer
        buckets: dict = {}
        feed = iter(subjects)
        for i in itertools.count():
            with span("eval.load", into=ph, key="load"):
                sub = next(feed, None)
            if sub is None:
                break
            ph["volumes"] += 1
            sig = (tuple(sub["vol_orig"].shape), tuple(sub["vol"].shape))
            bucket = buckets.setdefault(sig, [])
            bucket.append((i, sub))
            if len(bucket) >= group_n:
                dispatch(bucket)
                buckets[sig] = []
        for bucket in buckets.values():
            if bucket:
                dispatch(bucket)
        with span("eval.wait", into=ph, key="wait"):
            for f in pending:
                f.result()
    ph["total"] = time.perf_counter() - t_start
    return ph


def evaluate(cfg: RunConfig, task, fold: int, logger,
             timings: Optional[dict] = None) -> dict:
    """Val-threshold-fit -> test protocol over the configured test sets.
    Writes ``<run>/<fold>_preds_dict.pkl`` and returns the preds dict; each
    stage's ``run_stage`` seconds (and its 'test_end') go into ``timings``
    under '<set>/<stage>'. Within a process group every rank calls it; rank
    0 records, writes and returns the preds, the others return None."""
    dev = cfg.device
    recon = VolumeReconstructor(task, num_eval_slices=getattr(cfg.model, "num_eval_slices", None),
                                patched=getattr(cfg.model, "patched", False), device=dev)
    key = eval_key(cfg.seed, fold)
    preds = {"val": {}, "test": {}}
    allowed = SETS_BY_MODE.get(cfg.data.mode, list(EVAL_MODULES))
    warned: set = set()

    def warn(reason: str, msg: str, *args) -> None:
        if reason not in warned and world()[0] == 0:
            warned.add(reason)
            log.warning("eval.fused_dispatch is on but " + msg
                        + " — falling back to the separate-dispatch eval path.", *args)

    rank, size = recon.rank, recon.size
    group_n = max(1, int(cfg.eval.volumes_per_call))
    # within a process group a fused group is volume-parallel: it must split
    # evenly over the ranks (the JAX package's mesh gate)
    fused_ok = (cfg.eval.fused_dispatch and not cfg.eval.save_output_images
                and group_n % size == 0)
    if cfg.eval.fused_dispatch and group_n % size:
        warn("mesh", "eval.volumes_per_call=%d does not divide by the %d ranks (set it to "
             "a multiple, e.g. %d)", group_n, size, 2 * size)
    if cfg.eval.fused_dispatch and cfg.eval.save_output_images:
        warn("save_images", "eval.save_output_images needs the full volumes on host")
    # the loader threads put a host-preprocessed subject's arrays on the
    # device while the previous group computes
    preupload = (cfg.eval.preupload and cfg.data.preprocess_backend != "device"
                 and not cfg.eval.save_output_images)
    timings = {} if timings is None else timings
    for setname in [s for s in cfg.data.testsets if s in allowed]:
        module = (IXI(cfg.data, fold=fold, device=dev) if setname == "IXI"
                  else EVAL_MODULES[setname](cfg.data, fold, device=dev))
        threshold = None
        for stage in ("val", "test"):
            ds = module.val_eval() if stage == "val" else module.test_eval()
            session = EvalSession(cfg.eval, setname, stage,
                                  threshold=threshold if stage == "test" else None,
                                  logger=logger, device=dev)

            def load(i, ds=ds):
                sub = ds[i]
                if preupload:
                    sub = dict(sub)
                    sub["_dev"] = {k: torch.as_tensor(sub[k]).to(dev, non_blocking=True)
                                   for k in ("vol", "vol_orig", "mask_orig", "seg_orig")
                                   if isinstance(sub.get(k), np.ndarray)}
                return sub

            loader = PrefetchLoader(range(len(ds)), load,
                                    num_threads=max(1, int(cfg.eval.loader_threads)),
                                    prefetch=max(1, int(cfg.eval.loader_prefetch)))
            ph = run_stage(session, recon, loader, key,
                           volumes_per_call=cfg.eval.volumes_per_call,
                           scorer_threads=cfg.eval.scorer_threads, fused_dispatch=fused_ok,
                           score_fn=task.anomaly_scores, warn=warn)
            timings[f"{setname}/{stage}"] = ph
            if rank == 0:
                t0 = time.perf_counter()
                result = session.test_end()
                ph["test_end"] = time.perf_counter() - t0
                if stage == "val":
                    threshold = dict(session.threshold) or None
                    if threshold is None and session.threshholds_healthy:
                        threshold = {"total": session.threshholds_healthy["thresh_1p"]}
                preds[stage][setname] = result
                logger.log_metrics(summarize(result, f"{stage}/{setname}/fold-{fold}"))
            if stage == "val":  # the test stage's scoring needs it on every rank
                threshold = broadcast_object(threshold)
    if rank != 0:
        return None
    os.makedirs(cfg.run_dir, exist_ok=True)
    with open(os.path.join(cfg.run_dir, f"{fold}_preds_dict.pkl"), "wb") as f:
        pickle.dump(preds, f)
    return preds


def n_ranks(cfg: RunConfig) -> int:
    """Ranks of a run: gcd(batch size, ``n_devices`` or the card count), as
    the JAX package sizes its mesh (the CPU counts as one device unless
    ``n_devices`` says more). On ``cuda``, ``n_devices`` above the card
    count raises."""
    cuda = torch.device(cfg.device).type == "cuda"
    count = torch.cuda.device_count() if cuda else 1
    if cfg.n_devices and cuda:
        check_world(int(cfg.n_devices), cfg.device)
    return math.gcd(int(cfg.data.batch_size), int(cfg.n_devices or count))


def train(cfg: RunConfig) -> dict:
    """The full run: per fold a fit (unless only_eval) and the evaluation.
    Returns {fold: preds}. Each fold's wall seconds (the fit's per epoch,
    validation and checkpoint stalls, and each eval stage's) are written to
    ``<run>/<fold>_timings.json``. With ``n_ranks(cfg)`` > 1 the run is
    data-parallel: that many ranks are spawned (``parallel/mesh.py``: nccl
    with ``cuda:<rank>`` each, or gloo on the CPU), each runs ``run_folds``
    and rank 0's result is returned."""
    n = n_ranks(cfg)
    if n == 1 or world()[1] > 1:
        return run_folds(cfg)
    cuda = torch.device(cfg.device).type == "cuda"
    log.info("data-parallel run over %d ranks", n)
    return spawn(_rank_run, n, "nccl" if cuda else "gloo",
                 [rank_device(cfg.device, r) for r in range(n)], cfg,
                 pool_stats() is not None)[0]


def _rank_run(rank: int, cfg: RunConfig, host_pool: bool) -> Optional[dict]:
    """One rank of a data-parallel run (a top-level function, so the spawn
    start method can import it): its card, the parent's host pool, the
    folds."""
    if host_pool:
        enable_host_alloc_cache()
    cfg.device = str(rank_device(cfg.device, rank))
    return run_folds(cfg)


def run_folds(cfg: RunConfig) -> dict:
    """The fold loop of ``train`` in this process (one rank of a group, or
    the whole run); rank 0 logs, writes and returns the results."""
    rank = world()[0]
    os.makedirs(cfg.run_dir, exist_ok=True)
    cfg.eval.out_dir = cfg.run_dir  # image grids land under <run>/grid
    results = {}
    for fold in range(cfg.start_fold, cfg.num_folds):
        active = []
        if cfg.logger.use_csv and rank == 0:
            active.append(CSVLogger(cfg.run_dir, name=f"csv_fold{fold}"))
        if cfg.logger.use_wandb and rank == 0:
            active.append(WandbLogger(cfg.run_dir,
                                      project=cfg.logger.project or f"uad_{cfg.datamodule_name}",
                                      group=cfg.logger.group or cfg.name))
        logger = MultiLogger(*active)  # no logger on the other ranks
        task = build_task(cfg, fold)
        log_hyperparameters(logger, cfg, task)

        trainer_cfg = cfg.trainer
        trainer_cfg.ckpt_dir = os.path.join(cfg.run_dir, "checkpoints")
        trainer_cfg.seed = cfg.seed
        trainer_cfg.resume = trainer_cfg.resume or cfg.resume_train
        timings = {}
        if cfg.pretrained_encoder and isinstance(task, DDPMTask):
            load_pretrained_encoder(task, cfg, fold)
        if cfg.only_eval:
            load_weights(task, cfg, fold)
        else:
            trainer = Trainer(task, trainer_cfg, logger=logger)
            t0 = time.perf_counter()
            dm = IXI(cfg.data, fold=fold, device=cfg.device)
            sources = dm.train_slices(), dm.val_slices()
            timings["ingest_s"] = time.perf_counter() - t0
            trainer.fit(*sources, fold=fold)
            timings["fit"] = trainer.timings
        timings["eval"] = {}
        t0 = time.perf_counter()
        results[fold] = evaluate(cfg, task, fold, logger, timings["eval"])
        timings["eval_s"] = time.perf_counter() - t0
        timings["nifti_reads"] = dict(nifti_reads)
        timings["host_pool"] = pool_stats()
        if rank == 0:
            with open(os.path.join(cfg.run_dir, f"{fold}_timings.json"), "w") as f:
                json.dump(timings, f, indent=1)
        logger.finish()
    return results
