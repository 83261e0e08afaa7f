"""The measured window: it opens after set-up and closes at the first
completed unit of work (a step, or a committed group) at or after the run's
seconds. A rate is all the work completed over the time to that completion,
so a stall inside the window lowers it."""
from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np


class Window:
    def __init__(self, seconds: float, clock=time.perf_counter):
        self.seconds = float(seconds)
        self.clock = clock
        self.t_open: Optional[float] = None
        self.marks: List[Tuple[float, int]] = []  # (completion time, units)

    def open(self) -> None:
        self.t_open = self.clock()

    def due(self) -> bool:
        """Whether the next unit would start at or after the window's length."""
        return self.clock() - self.t_open >= self.seconds

    def mark(self, units: int, t: Optional[float] = None) -> None:
        """Record ``units`` completed at ``t`` (now by default)."""
        self.marks.append((self.clock() if t is None else t, int(units)))

    @property
    def units(self) -> int:
        return sum(u for _, u in self.marks)

    @property
    def elapsed(self) -> float:
        return self.marks[-1][0] - self.t_open

    def rate(self) -> float:
        return self.units / self.elapsed

    def intervals(self) -> np.ndarray:
        """Seconds from each completion (the first: from the opening) to the
        next."""
        t = np.array([self.t_open] + [m for m, _ in self.marks])
        return np.diff(t)

    def percentile_ms(self, q: float) -> float:
        return float(np.percentile(self.intervals(), q) * 1e3)

    def summary(self) -> dict:
        """The intervals at a glance, for the run's log: their count, median,
        90th percentile and largest (ms), how many exceed twice the median,
        and the medians of the window's two halves."""
        iv = self.intervals() * 1e3
        half = len(iv) // 2
        return {"n": len(iv), "p50_ms": float(np.median(iv)),
                "p90_ms": float(np.percentile(iv, 90)), "max_ms": float(iv.max()),
                "over_2x_p50": int((iv > 2 * np.median(iv)).sum()),
                "halves_p50_ms": [float(np.median(iv[:half])) if half else None,
                                  float(np.median(iv[half:]))]}
