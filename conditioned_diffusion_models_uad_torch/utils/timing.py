"""Timers for kernels on the card, shared by ``chip_smoke.py`` and
``utils/kernel_variants.py``. Each takes a function that launches work on
the current CUDA device and returns milliseconds."""
from __future__ import annotations

import time

import torch


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_events(prof):
    """The profile's device kernels: CUDA events with device time, without
    user annotations (``Optimizer.step#Adam.step`` spans the kernels it
    launches and would count them twice)."""
    return [ev for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and ev.self_device_time_total > 0
            and not getattr(ev, "is_user_annotation", False)]


def profiled_kernel_ms(fn, marks, reps: int = 200, per_call: int = 1) -> float:
    """Mean device milliseconds per call of ``fn`` in the CUDA kernels whose
    names hold one of ``marks``, from torch.profiler over ``reps`` calls
    (each call launching ``per_call`` such kernels; the mean is over the
    launches the profiler recorded, which may drop some): the kernels' own
    time, without the host's launch cost. Raises if it recorded none, or
    more than ``per_call`` a call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [ev for ev in kernel_events(prof) if any(m in ev.key for m in marks)]
    count = sum(ev.count for ev in evs)
    if not 0 < count <= reps * per_call:
        raise RuntimeError(f"profiler recorded {count} launches of {marks} in {reps} calls")
    return sum(ev.self_device_time_total for ev in evs) / 1e3 / count * per_call


def graph_ms(fn, launches: int = 100, replays: int = 20) -> float:
    """Device milliseconds per call of ``fn`` replayed from one CUDA graph
    of ``launches`` calls: the kernel plus the graph's gap between kernels."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * launches)


def host_ms(fn, reps: int = 50) -> float:
    """Host wall milliseconds per call over ``reps`` calls ending in a
    synchronise: for a tiny kernel, the host's launch rate."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps
