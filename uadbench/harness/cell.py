"""A cell, found by name: ``workloads/<cell>.json`` names its configuration
(``configs/<config>.json``) and its traffic mix (``traffic/<traffic>.json``,
whose ``driver`` is a module of ``drivers/``), and holds the traffic's
parameters and the limits of its check. ``BENCHMARK.json`` at the checkout's
root says which metrics the cell reports; a per-layer metric's reader is
``layer_metrics/<metric>.py``."""
from __future__ import annotations

import hashlib
import importlib
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


class Cell:
    def __init__(self, name: str, benchmark: dict = None, workload: dict = None,
                 config: dict = None, traffic: dict = None):
        """The files named by ``name``; the tests hand tiny ones in directly."""
        self.name = name
        self.workload = workload or _json(BENCH_DIR / "workloads" / f"{name}.json")
        self.config = config or _json(BENCH_DIR / "configs" / f"{self.workload['config']}.json")
        self.traffic = traffic or _json(BENCH_DIR / "traffic" / f"{self.workload['traffic']}.json")
        self.params = {**self.traffic["defaults"], **self.workload.get("params", {})}
        self.limits = self.workload["limits"]
        self.benchmark = benchmark

    # the run's seed splits into independent streams, one a use
    def derive(self, seed: int, use: str, bits: int = 62) -> int:
        h = hashlib.sha256(f"{int(seed)}:{use}".encode()).digest()
        return int.from_bytes(h[:8], "little") >> (64 - bits)

    def weight_seed(self, seed: int) -> int:
        return self.derive(seed, "weights")

    def input_seed(self, seed: int) -> int:
        return self.derive(seed, "inputs")

    def check_seed(self, seed: int) -> int:
        return self.derive(seed, "draws")

    def stage_key_seed(self, seed: int) -> int:
        """The eval stage key's seed, in int32 range less the key's offset."""
        return self.derive(seed, "stage", bits=30)

    def task_config(self):
        from conditioned_diffusion_models_uad_torch.models.tasks import DDPMTaskConfig

        m = dict(self.config["model"])
        m["image_hw"] = tuple(self.config["shape"][:2])
        for k in ("channel_mult", "attention_resolutions", "step_ensemble"):
            m[k] = tuple(m[k])
        m.pop("num_head_channels", None)  # the system's UNet fixes 64
        return DDPMTaskConfig(**m)

    def driver(self, seed: int, device="cuda"):
        mod = importlib.import_module(f"uadbench.drivers.{self.traffic['driver']}")
        return getattr(mod, self.traffic["class"])(self, seed, device)

    def metrics(self, section: str) -> list:
        """The BENCHMARK.json metrics of ``section`` this cell reports: each
        that lists it under 'workloads'; one without the key goes with every
        cell (a per-layer one, with every cell that reports the metric it
        moves)."""
        def reports(m):
            if "workloads" in m:
                return self.name in m["workloads"]
            return section == "end_to_end" or m["moves"] in {
                e["name"] for e in self.metrics("end_to_end")}

        return [m for m in self.benchmark[section] if reports(m)]


def load_reader(metric: str):
    """``layer_metrics/<metric>.py``'s ``read(ctx)``."""
    path = BENCH_DIR / "layer_metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"uadbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def benchmark_json() -> dict:
    return _json(ROOT / "BENCHMARK.json")
