"""Every configuration, cell, traffic mix and per-layer metric of
BENCHMARK.json is a file of its own, found by name, and keeps to the
contract's shapes and characters."""
import json
import re

import pytest

from uadbench.harness.cell import BENCH_DIR, ROOT, Cell, load_reader

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|proj|head|expan|experts")


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["uadbench"] and bench["command"][1] == "uadbench/run.py"
    assert 1 <= bench["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_text(bench):
    names = [x["name"] for sec in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[sec]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for x in bench["configs"] + bench["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"] and "\t" not in x["why"]


@pytest.mark.parametrize("section", ["configs", "workloads", "per_layer"])
def test_files_found_by_name(bench, section):
    for x in bench[section]:
        if section == "configs":
            path = ROOT / x["file"]
            cfg = json.loads(path.read_text())
            assert cfg["name"] == x["name"] and cfg["reduced"] == x["reduced"]
            assert not any(WIDTH.search(k) for k in x["reduced"])
            assert "assumed" in cfg and cfg["precision"] == "bfloat16"
        elif section == "workloads":
            cell = Cell(x["name"], bench)
            assert cell.workload["config"] == x["config"]
            assert cell.workload["traffic"] == x["traffic"] and x["chips"] == 1
            assert (BENCH_DIR / "drivers" / f"{cell.traffic['driver']}.py").is_file()
            assert cell.limits and all(v > 0 for v in cell.limits.values())
        else:
            assert callable(load_reader(x["name"]))


def test_metric_wiring(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    layers = {}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", cells))
        layers.setdefault(m["layer"], set()).add(m["name"])
    for name in cells:
        cell = Cell(name, bench)
        reported = {m["name"] for m in cell.metrics("end_to_end")}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.metrics("per_layer")
    for m in bench["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_run_seconds_fit_the_check(bench):
    """A full check with 24 cells: 2 + 14 x 24 runs of run_seconds + 60 s,
    2 x 90 s a cell to compile and 1200 s spare, within 43200 s."""
    n = 24
    total = (2 + 14 * n) * (bench["run_seconds"] + 60) + n * 2 * 90 + 1200
    assert total <= 43200
