"""The traced slice: torch.profiler over a bounded run of the cell's work,
exported as a Chrome trace and read back here.

* busy seconds: the union of the device's kernel, copy and set intervals, so
  work on two streams at once counts once;
* a span's device time: the kernels whose launch (the runtime call that
  carries the kernel's correlation id) lies inside a host op of that name on
  the launching thread;
* the breakdown: the device operations with the most time, and the idle gaps
  by the innermost host op the main thread was in at each gap's middle.
"""
from __future__ import annotations

import bisect
import json
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Tuple

ROOT_SPAN = "uadbench.traced"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


@dataclass
class Trace:
    t0: float  # us
    t1: float
    main_tid: object
    device: List[Tuple[float, float, str, object]]  # (ts, dur, name, correlation)
    launches: Dict[object, Tuple[object, float]]  # correlation -> (tid, ts)
    host: Dict[object, List[Tuple[float, float, str]]] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        spans = sorted((max(ts, self.t0), min(ts + d, self.t1)) for ts, d, _, _ in self.device)
        merged: List[List[float]] = []
        for a, b in spans:
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def device_ms_under(self, match: Callable[[str], bool]) -> float:
        """Device ms of the kernels launched inside a host op whose name
        ``match`` accepts."""
        cover: Dict[object, List[List[float]]] = {}
        for tid, ops in self.host.items():
            iv = sorted((ts, ts + d) for ts, d, name in ops if match(name))
            merged: List[List[float]] = []
            for a, b in iv:
                if merged and a <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], b)
                else:
                    merged.append([a, b])
            cover[tid] = merged
        starts = {tid: [a for a, _ in iv] for tid, iv in cover.items()}
        total = 0.0
        for _, dur, _, corr in self.device:
            tid, ts = self.launches.get(corr, (None, None))
            if tid not in cover:
                continue
            k = bisect.bisect_right(starts[tid], ts) - 1
            if k >= 0 and ts <= cover[tid][k][1]:
                total += dur
        return total / 1e3

    def top_device_ops(self, n: int = 10) -> List[list]:
        by_name: Dict[str, float] = defaultdict(float)
        for _, dur, name, _ in self.device:
            by_name[name[:160]] += dur / 1e6
        return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """Idle seconds summed by the innermost main-thread host op at each
        gap's middle ('python' where no op was open)."""
        ops = sorted((ts, ts + d, name) for ts, d, name in self.host.get(self.main_tid, [])
                     if name != ROOT_SPAN)
        starts = [a for a, _, _ in ops]
        by_label: Dict[str, float] = defaultdict(float)
        edge = self.t0
        for a, b in self.busy_intervals() + [(self.t1, self.t1)]:
            if a > edge:
                mid = 0.5 * (edge + a)
                label = "python"
                for k in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
                    if ops[k][1] >= mid:
                        label = ops[k][2]  # the latest-starting open op
                        break
                by_label[label[:160]] += (a - edge) / 1e6
            edge = max(edge, b)
        return [[k, v] for k, v in sorted(by_label.items(), key=lambda kv: -kv[1])[:n]]


def read_chrome_trace(path: Path) -> Trace:
    events = json.loads(Path(path).read_text())["traceEvents"]
    device, launches = [], {}
    host: Dict[object, List[Tuple[float, float, str]]] = defaultdict(list)
    root = None
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        args = ev.get("args", {})
        if cat in DEVICE_CATS:
            device.append((float(ev["ts"]), float(ev.get("dur", 0.0)), ev.get("name", ""),
                           args.get("correlation")))
        elif cat in ("cuda_runtime", "cuda_driver"):
            launches[args.get("correlation")] = (ev.get("tid"), float(ev["ts"]))
        elif cat in HOST_CATS:
            host[ev.get("tid")].append((float(ev["ts"]), float(ev.get("dur", 0.0)),
                                        ev.get("name", "")))
            if ev.get("name") == ROOT_SPAN:
                root = ev
    if root is None:
        raise RuntimeError(f"no {ROOT_SPAN} span in the trace")
    t0 = float(root["ts"])
    return Trace(t0, t0 + float(root["dur"]), root.get("tid"), device, launches, dict(host))


def profile(fn, out_path: Path, cuda: bool = True) -> Trace:
    """Run ``fn`` under torch.profiler (host ops, and CUDA activity with
    ``cuda``) inside the root span, synchronising before it closes, and read
    the trace."""
    import torch
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with torch_profile(activities=activities) as prof:
        with record_function(ROOT_SPAN):
            fn()
            if cuda:
                torch.cuda.synchronize()
    out_path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out_path))
    return read_chrome_trace(out_path)
