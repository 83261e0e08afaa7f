"""best/last checkpoints per fold (counterpart of
``conditioned_diffusion_models_uad_tpu/train/checkpoint.py``, in torch's
format; reference configs/callbacks/checkpoint.yaml:1-9: monitor the val
loss, save_top_k 1, save_last; per-fold suffixes src/train.py:102-118;
best/last resolution utils.get_checkpoint, src/utils/utils.py:188-231).

Layout on disk:

    <ckpt_dir>/fold-<k>/best/state.pt   the lowest-val-loss VARIABLES: the
                                        task's state_dict and the step, no
                                        optimizer state
    <ckpt_dir>/fold-<k>/last/state.pt   the most recent FULL state (resume
                                        needs the Adam moments)
    <ckpt_dir>/fold-<k>/meta.json       {'best': {'step', 'val_loss'}, 'last': ...}

A state is a dict {'model': state_dict, 'optimizer': optimizer state_dict,
'step': int} of CPU tensors and plain values, written with ``torch.save``
and read with ``weights_only=True``.
"""
from __future__ import annotations

import json
import math
import os
from typing import Any, Optional, Tuple

import torch

# 'best' checkpoint payload: what an eval reload reads
BEST_KEYS = ("model", "step")
STATE_FILE = "state.pt"


def variables_only(state: dict) -> dict:
    """The 'best'-checkpoint subset of a train state."""
    return {k: state[k] for k in BEST_KEYS if k in state}


def to_cpu(obj: Any) -> Any:
    """A state with every tensor copied to the CPU."""
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return type(obj)((k, to_cpu(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_cpu(v) for v in obj)
    return obj


def load_state(path: str, map_location="cpu") -> dict:
    """A checkpoint directory (or its state file) -> the state dict."""
    if os.path.isdir(path):
        path = os.path.join(path, STATE_FILE)
    return torch.load(path, map_location=map_location, weights_only=True)


class FoldCheckpointer:
    """best/last checkpoint pair for one fold."""

    def __init__(self, ckpt_dir: str, fold: int = 0):
        self.dir = os.path.abspath(os.path.join(ckpt_dir, f"fold-{fold}"))
        os.makedirs(self.dir, exist_ok=True)
        self._meta_path = os.path.join(self.dir, "meta.json")
        self.meta = {}
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                self.meta = json.load(f)

    def _save(self, name: str, state: dict, step: int, val_loss: Optional[float]):
        path = os.path.join(self.dir, name)
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, STATE_FILE + ".tmp")
        torch.save(to_cpu(state), tmp)
        os.replace(tmp, os.path.join(path, STATE_FILE))
        self.meta[name] = {"step": int(step), "val_loss": val_loss}
        with open(self._meta_path, "w") as f:
            json.dump(self.meta, f)

    def save_last(self, state: dict, step: int, val_loss: Optional[float] = None):
        self._save("last", state, step, val_loss)

    def maybe_save_best(self, state: dict, step: int, val_loss: float) -> bool:
        """Keep only the best-by-val-loss VARIABLES (save_top_k=1; the
        optimizer state stays in 'last'). A non-finite val loss never becomes
        'best': a NaN written once would win no later comparison and pin the
        diverged state as the restored checkpoint."""
        if not self.is_best(val_loss):
            return False
        self._save("best", variables_only(state), step, float(val_loss))
        return True

    def is_best(self, val_loss: Optional[float]) -> bool:
        """Would this val loss become the new 'best'?"""
        if val_loss is None or not math.isfinite(val_loss):
            return False
        prev = self.meta.get("best", {}).get("val_loss", None)
        return prev is None or not math.isfinite(prev) or val_loss < prev

    def restore(self, which: str = "best", map_location="cpu") -> Tuple[dict, dict]:
        """Restore 'best' (falling back to 'last', as the reference's
        get_checkpoint falls through) or 'last': (state, meta entry)."""
        name = which
        if name == "best" and "best" not in self.meta:
            name = "last"
        path = os.path.join(self.dir, name)
        if not os.path.exists(os.path.join(path, STATE_FILE)):
            raise FileNotFoundError(f"no '{which}' checkpoint under {self.dir}")
        return load_state(path, map_location), self.meta.get(name, {})

    def exists(self, which: str = "last") -> bool:
        return os.path.exists(os.path.join(self.dir, which, STATE_FILE))


def find_run_checkpoint(run_dir: str, which: str = "best", fold: int = 0) -> str:
    """Resolve a checkpoint directory inside a previous run directory
    (reference utils.get_checkpoint path walking, utils.py:188-231)."""
    for cand in (os.path.join(run_dir, "checkpoints", f"fold-{fold}", which),
                 os.path.join(run_dir, f"fold-{fold}", which)):
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(f"no {which} checkpoint for fold {fold} in {run_dir}")
