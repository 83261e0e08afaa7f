"""Metric loggers: CSV always, wandb when it is installed (counterpart of
``conditioned_diffusion_models_uad_tpu/log/loggers.py``; reference
configs/logger/wandb.yaml + csv.yaml, src/utils/utils.py:112-178).

* ``CSVLogger``: metrics.csv rows (key, value, step, time) per run and fold,
  and hparams.yaml
* ``WandbLogger``: wandb runs grouped per experiment with resumable ids; a
  no-op without wandb (the orchestrator depends on the interface only)
* ``summarize``: prefix + drop list-valued entries of an eval dict
* ``log_hyperparameters``: config + parameter-count snapshot
"""
from __future__ import annotations

import csv
import dataclasses
import json
import os
import time
from typing import Any, Dict, Optional


class CSVLogger:
    """Append-only metrics.csv (key, value, step, time) + hparams.yaml."""

    def __init__(self, run_dir: str, name: str = "csv"):
        self.dir = os.path.join(run_dir, name)
        os.makedirs(self.dir, exist_ok=True)
        self.path = os.path.join(self.dir, "metrics.csv")
        new = not os.path.exists(self.path)
        self._f = open(self.path, "a", newline="")
        self._w = csv.writer(self._f)
        if new:
            self._w.writerow(["key", "value", "step", "time"])

    def log_metrics(self, metrics: Dict[str, Any], step: int = 0) -> None:
        now = time.time()
        for k, v in metrics.items():
            try:
                v = float(v)
            except (TypeError, ValueError):
                v = str(v)
            self._w.writerow([k, v, step, f"{now:.3f}"])
        self._f.flush()

    def log_hyperparams(self, hparams: Dict[str, Any]) -> None:
        import yaml

        with open(os.path.join(self.dir, "hparams.yaml"), "w") as f:
            yaml.safe_dump(hparams, f, sort_keys=False)

    def finish(self) -> None:
        self._f.close()


class WandbLogger:
    """wandb logger with per-experiment grouping and a resumable run id kept
    in ``<run_dir>/wandb_id.json``. wandb is imported when the logger is
    made; without it every call is a no-op. ``module`` injects an
    implementation (tests, offline shims)."""

    def __init__(self, run_dir: str, project: str = "uad", group: Optional[str] = None,
                 run_id: Optional[str] = None, module=None):
        if module is None:
            try:
                import wandb as module
            except ImportError:
                module = None
        self.dir = run_dir
        self._wandb = module
        self._id_path = os.path.join(run_dir, "wandb_id.json")
        if run_id is None and os.path.exists(self._id_path):
            with open(self._id_path) as f:
                run_id = json.load(f).get("id")
        self.run = None
        if self._wandb is not None:
            self.run = self._wandb.init(project=project, group=group, id=run_id,
                                        resume="allow", dir=run_dir)
            os.makedirs(run_dir, exist_ok=True)
            with open(self._id_path, "w") as f:
                json.dump({"id": self.run.id}, f)

    def log_metrics(self, metrics: Dict[str, Any], step: int = 0) -> None:
        if self.run is not None:
            self.run.log(metrics, step=step)

    def log_hyperparams(self, hparams: Dict[str, Any]) -> None:
        if self.run is not None:
            self.run.config.update(hparams, allow_val_change=True)

    def log_image(self, key: str, path: str) -> None:
        if self.run is not None:
            self.run.log({key: [self._wandb.Image(path)]})

    def finish(self) -> None:
        if self.run is not None:
            self.run.finish()


class MultiLogger:
    def __init__(self, *loggers):
        self.loggers = [l for l in loggers if l is not None]

    def log_metrics(self, metrics, step=0):
        for l in self.loggers:
            l.log_metrics(metrics, step=step)

    def log_hyperparams(self, hparams):
        for l in self.loggers:
            l.log_hyperparams(hparams)

    def log_image(self, key, path):
        for l in self.loggers:
            if hasattr(l, "log_image"):
                l.log_image(key, path)

    def finish(self):
        for l in self.loggers:
            l.finish()


def summarize(eval_dict: dict, prefix: str) -> dict:
    """Prefix keys and drop list-valued entries so only scalars are logged
    (reference utils.summarize, src/utils/utils.py:172-178)."""
    return {f"{prefix}/{k}": v for k, v in eval_dict.items()
            if not isinstance(v, (list, tuple, dict))}


def log_hyperparameters(logger, cfg, module=None) -> None:
    """Snapshot the config (+ the parameter count of the torch ``module``)
    to every logger (reference utils.log_hyperparameters, utils.py:112-152)."""
    def to_dict(o):
        if dataclasses.is_dataclass(o) and not isinstance(o, type):
            return {k: to_dict(v) for k, v in dataclasses.asdict(o).items()}
        if isinstance(o, dict):
            return {k: to_dict(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            return [to_dict(v) for v in o]
        return o

    h = to_dict(cfg)
    if module is not None:
        h["model/params_total"] = int(sum(p.numel() for p in module.parameters()))
    logger.log_hyperparams(h)
