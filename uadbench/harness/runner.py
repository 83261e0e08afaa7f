"""One run of one cell: set-up, the measured window, the traced slice with
``traced``, the check against the reference, and the result line."""
from __future__ import annotations

import gc
import json
import math
import sys
import time
from types import SimpleNamespace

import torch

from . import trace as trace_mod
from .cell import BENCH_DIR, load_reader
from .window import Window

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "conditioned_diffusion_models_uad_tpu")
OUT_DIR = BENCH_DIR / ".out"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is a JAX package's, compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def device_record(device: torch.device, chips: int, peak: int) -> dict:
    cuda = device.type == "cuda"
    return {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
            "count": chips, "memory_peak_bytes": int(peak)}


def run_cell(cell, seed: int, seconds: float, traced: bool, device="cuda", chips: int = 1,
             t_start: float = None, judge=None):
    """(the result line's fields, the checks: {name: {'value', 'limit'}},
    every number the check worked out).
    ``t_start``: when the process started; set-up counts from it.
    ``judge``: what works the numbers out from what the run kept (the
    driver's ``check_numbers`` by default)."""
    t_start = time.perf_counter() if t_start is None else t_start
    stamps = {"start": t_start}
    device = torch.device(device)
    cuda = device.type == "cuda"
    drv = cell.driver(seed, device)
    drv.setup()
    if traced:
        drv.install_spans()
    if cuda:
        torch.cuda.synchronize(device)
    window = Window(seconds)
    setup_s = time.perf_counter() - t_start
    stamps["window"] = time.perf_counter()
    drv.run_window(window)
    stamps["closed"] = time.perf_counter()
    ctx = SimpleNamespace(driver=drv, window=window, phases=dict(getattr(drv, "phases", {})))
    if traced:
        done = {}
        OUT_DIR.mkdir(exist_ok=True)
        ctx.trace = trace_mod.profile(lambda: done.update(n=drv.traced_slice()),
                                      OUT_DIR / f"trace-{cell.name}.json", cuda)
        ctx.traced_units = done["n"]
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules of the JAX package or JAX loaded in this process: {found}")

    record = device_record(device, chips, peak)
    if traced:
        metrics = {}
        for m in cell.metrics("per_layer"):
            value = load_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        record.update(busy_s=ctx.trace.busy_s, window_s=ctx.trace.window_s)
        breakdown = {"device_ops": ctx.trace.top_device_ops(),
                     "idle_gaps": ctx.trace.idle_gaps()}
    else:
        e2e = dict(drv.end_to_end(window), setup_s=setup_s)
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.metrics("end_to_end")}
    stamps["read"] = time.perf_counter()
    attempted = drv.attempted(window)
    produced = drv.free()
    del drv, ctx
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    judge = judge or cell.driver(seed, device).check_numbers
    numbers = judge(produced)
    checks = {k: {"value": numbers[k], "limit": lim} for k, lim in cell.limits.items()}

    def ok(k, v):
        return math.isfinite(v) and v <= cell.limits[k]

    out = {"correct": all(ok(k, c["value"]) for k, c in checks.items()),
           "attempted": attempted,
           "failed": sum(1 for u in numbers["per_unit"]
                         if not all(ok(k, u[k]) for k in cell.limits if k in u)),
           "metrics": metrics, "device": record}
    if traced:
        out["breakdown"] = breakdown
    stamps["checked"] = time.perf_counter()
    names = list(stamps)
    phases = {f"{a}->{b}": round(stamps[b] - stamps[a], 3) for a, b in zip(names, names[1:])}
    print(f"phases_s {json.dumps(phases)} intervals {json.dumps(window.summary())} numbers "
          f"{json.dumps({k: v for k, v in numbers.items() if k != 'per_unit'})}",
          file=sys.stderr)
    return out, checks, numbers
