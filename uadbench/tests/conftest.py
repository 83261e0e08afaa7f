"""CPU tests of the benchmark: ``python -m pytest uadbench/tests -q`` from
the checkout's root (a few minutes on one process)."""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture(scope="session")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


TINY_MODEL = {"unet_dim": 32, "channel_mult": [1, 2], "num_res_blocks": 1,
              "attention_resolutions": [2], "cond_dim": 16, "encoder_backbone": "resnet18",
              "dtype": "float32"}


def tiny_cell(bench, kind: str, params=None, limits_from=None):
    """A float32 cell at a size the CPU holds, with the real cell's limits."""
    from uadbench.harness.cell import BENCH_DIR, Cell

    real = "cddpm96.eval" if kind == "eval" else "cddpm96.train"
    base = json.loads((BENCH_DIR / "configs" / "cddpm_spark_96.json").read_text())
    config = dict(base, model=dict(base["model"], **TINY_MODEL),
                  shape=[48, 48, 48] if kind == "eval" else [32, 32, 8])
    workload = json.loads((BENCH_DIR / "workloads" / f"{real}.json").read_text())
    traffic = json.loads((BENCH_DIR / "traffic" / f"{workload['traffic']}.json").read_text())
    small = ({"subjects": 4, "traced_volumes": 2, "check_groups": 1} if kind == "eval"
             else {"batch": 4, "train_volumes": 3, "traced_steps": 2,
                "check_window_steps": 2})
    workload = dict(workload, params=dict(small, **(params or {})))
    return Cell(real, bench, workload, config, traffic)
