"""Tracing and step timing (counterpart of
``conditioned_diffusion_models_uad_tpu/utils/profiling.py``):

* ``trace(logdir)``: a ``torch.profiler`` context (CPU, and CUDA when the
  card is there) that writes a Chrome trace to ``logdir/trace.json``
  (chrome://tracing, Perfetto);
* ``StepTimer``: wall time per step, each lap ending on a CUDA event
  synchronise (``utils/timing.py``'s event timers time kernels; this times
  whole steps from the host);
* ``flops_summary``: the analytic UNet FLOPs
  (``models/unet.py::unet_flops_per_forward``) and the TFLOP/s a measured
  step time implies.
"""
from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str, with_memory: bool = True):
    """``with trace(dir) as prof: step()`` records the ops (and CUDA kernels
    on the card) and writes ``dir/trace.json`` on exit."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts, profile_memory=with_memory) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    """``lap(result)`` once a step: the work queued on the CUDA devices of
    the result's tensors so far is waited for (an event recorded on the
    current stream and synchronised), so each lap is the step's device time
    plus its dispatch; CPU tensors and ``lap()`` take the host clock as it
    is."""

    def __init__(self):
        self.times: list = []

    @staticmethod
    def _devices(result) -> set:
        if torch.is_tensor(result):
            return {result.device} if result.device.type == "cuda" else set()
        if isinstance(result, dict):
            result = list(result.values())
        if isinstance(result, (list, tuple)):
            return set().union(*(StepTimer._devices(r) for r in result)) if result else set()
        return set()

    def lap(self, result=None):
        if result is not None:
            for dev in self._devices(result):
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(dev))
                ev.synchronize()
        now = time.perf_counter()
        if hasattr(self, "_last"):
            self.times.append(now - self._last)
        self._last = now

    def summary(self) -> dict:
        """Statistics over the laps, the first (warm-up) lap left out when
        there are others."""
        ts = np.asarray(self.times[1:] or self.times or [float("nan")])
        return {
            "steps": len(self.times),
            "mean_s": float(ts.mean()),
            "median_s": float(np.median(ts)),
            "p90_s": float(np.percentile(ts, 90)) if ts.size else float("nan"),
            "steps_per_sec": float(1.0 / np.median(ts)) if ts.size else 0.0,
        }


def flops_summary(unet_cfg, image_hw, batch: int, step_time_s: float,
                  n_forwards: int = 1) -> dict:
    """Model TFLOP/s for a measured step time (a forward-only count; pass
    n_forwards=3 to count a forward and backward)."""
    from ..models.unet import unet_flops_per_forward

    per_fwd = unet_flops_per_forward(unet_cfg, tuple(image_hw))
    total = per_fwd * batch * n_forwards
    return {
        "unet_gflops_per_forward": per_fwd / 1e9,
        "achieved_tflops": total / step_time_s / 1e12,
    }
