"""The program's own spans (``utils/profiling.py::span`` of the port) in the
traced slice (``harness/trace.py``'s ``Trace``):

* the device's idle ms inside a main-thread span: the span's time less its
  overlap with the union of the device's kernel, copy and set intervals;
* the launches inside a span: the distinct correlation ids of device
  events whose runtime call lies inside it, so that a CUDA-graph replay,
  whose kernels share the launch's id, counts once.

A program without the span gives None, not 0.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

AUTOGRAD_OP = "autograd::engine::evaluate_function"


def _merged(intervals) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def main_spans(trace, name: str) -> List[Tuple[float, float]]:
    """The main thread's ranges called ``name`` within the slice, merged."""
    return _merged((max(ts, trace.t0), min(ts + d, trace.t1))
                   for ts, d, n in trace.host.get(trace.main_tid, []) if n == name)


def idle_ms(trace, name: str) -> Optional[float]:
    """Device idle ms inside the main thread's ``name`` spans."""
    spans = main_spans(trace, name)
    if not spans:
        return None
    busy = trace.busy_intervals()
    starts = [a for a, _ in busy]
    idle = 0.0
    for a, b in spans:
        covered = 0.0
        for k in range(max(bisect.bisect_right(starts, a) - 1, 0), len(busy)):
            ba, bb = busy[k]
            if ba >= b:
                break
            covered += max(0.0, min(b, bb) - max(a, ba))
        idle += (b - a) - covered
    return idle / 1e3


def launches(trace, name: str, autograd: bool = False) -> Optional[int]:
    """Distinct correlation ids of device events launched inside the main
    thread's ``name`` spans, and with ``autograd`` inside the autograd
    engine's ops on any thread (the backward's own thread)."""
    spans = main_spans(trace, name)
    if not spans:
        return None
    cover: Dict[object, List[Tuple[float, float]]] = {trace.main_tid: spans}
    if autograd:
        for tid, ops in trace.host.items():
            ranges = [(ts, ts + d) for ts, d, n in ops if n.startswith(AUTOGRAD_OP)]
            if ranges:
                cover[tid] = _merged(ranges + cover.get(tid, []))
    starts = {tid: [a for a, _ in iv] for tid, iv in cover.items()}
    found = set()
    for _, _, _, corr in trace.device:
        tid, ts = trace.launches.get(corr, (None, None))
        if corr is None or tid not in cover:
            continue
        k = bisect.bisect_right(starts[tid], ts) - 1
        if k >= 0 and ts <= cover[tid][k][1]:
            found.add(corr)
    return len(found)
