"""Tracing (counterpart of ``conditioned_diffusion_models_uad_tpu/
utils/profiling.py``'s ``trace``):

* ``trace(logdir)``: a ``torch.profiler`` context over every thread (CPU
  ops, and CUDA activity when the card is there) that writes a Chrome trace
  to ``logdir/trace.json`` (chrome://tracing, Perfetto);
* ``span(name)``: the port's own ranges, where the work happens. While a
  torch profiler records, a span is a ``record_function`` range, which
  Kineto stamps on the clock of the CUDA activity, so a gap in the device
  trace falls inside the spans the host was in. ``into`` also adds its
  wall seconds to a dict. Otherwise a span is one flag check.

The spans:

| Span | Where | What it bounds |
|---|---|---|
| ``train.step`` | ``train/loop.py::train_step`` | one step, whole |
| ``train.gather`` | ``train/loop.py::gathered_batch`` | the batch's gather and augmentation |
| ``train.forward`` | ``train_step``: ``task.loss`` | forward and loss |
| ``train.backward`` | ``train_step``: ``loss.backward()`` | the backward; the main thread waits while the autograd engine's thread launches |
| ``train.all_reduce`` | ``train_step``: ``all_reduce_grads``, ``global_mean`` | the gradients' and the loss's exchange (nothing on one card) |
| ``train.optimizer`` | ``train_step``: ``opt.step()`` | the update |
| ``task.encode``, ``task.noise``, ``task.unet`` | ``models/tasks.py::DDPMTask.loss``, ``reconstruct_with_aux`` | the conditioning encoder; the noise fields; ``diffusion_call`` (or the sampler's chain) |
| ``unet.full_res`` | ``models/unet.py::UNetModel.forward`` | each block that ends at the input's resolution (the input convolution, the first level's input blocks, the output blocks that end there) and the output head |
| ``eval.load`` | ``orchestrate.py::run_stage`` | waiting on the subjects' iterator (its 'load' phase) |
| ``eval.dispatch`` | ``run_stage``'s ``dispatch`` | a group's reconstruct-and-score launch (its 'recon' phase) |
| ``eval.recon``, ``eval.score`` | ``eval/reconstruct.py::VolumeReconstructor._scored`` | the group's reconstruction; its scoring core (``group_eval_core``) |
| ``eval.wait`` | ``run_stage``: back-pressure, the final drain | waiting for scorer threads (its 'wait' phase) |
| ``eval.fetch``, ``eval.commit`` | ``run_stage``'s ``score_group``, on a scorer thread | the group's packed fetch; its rows' commit |

``eval.dispatch``, ``eval.fetch`` and ``eval.commit`` take ``group=`` the
group's first subject index. ``zero_grad`` opens the step outside these
spans, under torch's own ``Optimizer.zero_grad#...`` range: it has to come
before the backward, and callers read the gradients after the step.
Counters beside the spans, counted whether or not a profiler records:
``models/unet.py``'s ``GroupNorm32.fold_calls`` (the fold's calls on the
card by route) and ``ResBlock.residual_calls`` (the ResBlock output sums on
the card by route), and the K2, K3 and residual wrappers' ``.launches``
(``ops/``).
"""
from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.autograd import profiler as _autograd_profiler

_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def trace(logdir: str, with_memory: bool = True):
    """``with trace(dir) as prof: step()`` records the ops of every thread
    (and CUDA kernels on the card) and writes ``dir/trace.json`` on exit."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts, profile_memory=with_memory,
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def _span(name, into, key, group, profiling):
    with torch.profiler.record_function(name) if profiling else _OFF:
        if profiling and group is not None:
            # a profiler over every thread (``trace``) records no range
            # arguments, so the id rides in a name
            with torch.profiler.record_function(f"group={group}"):
                pass
        t0 = time.perf_counter()
        yield
        if into is not None:
            into[key] = into.get(key, 0.0) + time.perf_counter() - t0


def span(name: str, *, into: dict = None, key: str = None, group: int = None):
    """A context over the work it bounds. While a torch profiler records
    (any thread's), a ``record_function(name)`` range, holding with
    ``group`` a zero-length range ``group=<group>`` at its start. With
    ``into``, its wall seconds are added to ``into[key or name]``. With
    neither, a shared null context."""
    profiling = _autograd_profiler._is_profiler_enabled
    if into is None and not profiling:
        return _OFF
    return _span(name, into, key or name, group, profiling)
