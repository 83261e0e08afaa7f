"""Readings that set a cell's check limits, many seeds in one process:

    python3 uadbench/readings.py --workload <cell> --seeds 1,2,3 \\
        --what program[,control][,half_batch][,control_threshold] [--seconds 3]

Each seed makes one run of the cell (its window at ``--seconds``), whose
compared numbers are the ``program`` line: the lower readings. Beside it,
judged by the same float32 reference:
* ``control`` (the upper readings): the plain reference put in the system's
  place one precision below the configuration's (the networks' products in
  fp8 e4m3, gradients in e5m2, the scoring in bfloat16). In a train cell it
  takes the set-up steps from the seed and the window's checked steps from
  the state the run kept there; in an eval cell it reconstructs and scores
  the volumes a run samples, and fits their threshold.
* ``control_threshold`` (eval cells): the val threshold fitted in bfloat16
  over the run's own kept val stage.
* ``half_batch`` (train cells): the reference in the system's place with
  each step's loss over half its batch, at both places.

Prints one JSON line a seed and reading, and appends them to
``chiprun_out/readings.jsonl``. Not part of a benchmark run."""
import argparse
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def stand_in_eval(cell, seed: int, device, quant, rounding) -> dict:
    """The reference in the system's place over the volumes a run checks
    (the first val groups of the pool, the search's own threshold), those
    volumes taken as the val stage whose threshold it fits."""
    import torch

    from uadbench.drivers.eval_protocol import make_subjects
    from uadbench.harness.checks import no_tf32, reference_model, val_threshold
    from uadbench.reference.diffusion import alpha_bars, reconstruct_volume
    from uadbench.reference.noise import prng_key, volume_seeds
    from uadbench.reference.scoring import score_volume

    no_tf32()
    p, m = cell.params, cell.config["model"]
    shape = tuple(cell.config["shape"])
    n = p["check_groups"] * p["volumes_per_call"]
    pool = make_subjects(n, shape, cell.input_seed(seed), p["lesion_share"], p["lesions"],
                         device)
    model = reference_model(cell, seed, device, quant)
    sched = alpha_bars(m["timesteps"])
    key = prng_key(cell.stage_key_seed(seed) + 1000)
    statics = {"erode_iterations": shape[1] // 25, "median_kernel": 5, "cc_min_size": 8}
    out = []
    with torch.no_grad():
        for i, sub in enumerate(pool):
            dev = sub["_dev"]
            reco = reconstruct_volume(model, dev["vol"], volume_seeds(key, i, len(
                m["step_ensemble"])), m, sched)
            scores = score_volume(dev["vol"], reco, dev["mask_orig"], dev["seg_orig"],
                                  float("nan"), rounding=rounding, **statics)
            out.append({"vol": dev["vol"], "mask": dev["mask_orig"], "seg": dev["seg_orig"],
                        "stage_index": i, "th_record": float("nan"), "statics": statics,
                        "reco": reco, "diff": scores["diff"], "scores": scores})
    val = {k: [s[k] for s in out] for k in ("vol", "mask", "seg", "reco")}
    val["statics"] = statics
    val["threshold"] = val_threshold(val, rounding)
    return {"samples": out, "val": val}


def stand_in_train(cell, seed: int, drv, device, what: str, start: dict) -> dict:
    """The reference in the system's place (``what``: 'control' or a fault)
    at the set-up steps and at the window's checked steps from ``start``."""
    from uadbench.harness import checks
    from uadbench.reference import precision

    kw = {"quant": precision.fp8} if what == "control" else {"fault": what}
    setup = checks.reference_train(cell, seed, drv, device, **kw)
    win = checks.reference_train(cell, seed, drv, device, start=start, **kw)
    return dict(setup, window=dict(win, start=start))


def readings(cell, seed: int, kinds: list, seconds: float, device) -> list:
    """One line for each of ``kinds`` at ``seed``."""
    from uadbench.harness import checks
    from uadbench.harness.runner import run_cell
    from uadbench.reference import precision

    train = "train" in cell.traffic["driver"]
    lines = {}

    def judge(produced):
        drv = cell.driver(seed, device)
        numbers = drv.check_numbers(produced)
        for what in kinds:
            t0 = time.perf_counter()
            if train and what in ("control", "half_batch"):
                stand = stand_in_train(cell, seed, drv, device, what,
                                       produced["window"]["start"])
                lines[what] = checks.judge_train(stand, drv, device)
            elif not train and what == "control_threshold":
                val = produced["val"]
                lines[what] = {"threshold_gap": checks.threshold_gap(
                    checks.val_threshold(val, precision.bf16), val)}
            else:
                continue
            lines[what]["seconds"] = time.perf_counter() - t0
        return numbers

    t0 = time.perf_counter()
    result, _, numbers = run_cell(cell, seed, seconds, False, device, judge=judge)
    lines["program"] = dict(numbers, metrics={k: v["value"] for k, v in result["metrics"].items()},
                            seconds=time.perf_counter() - t0)
    if not train and "control" in kinds:
        t0 = time.perf_counter()
        stand = stand_in_eval(cell, seed, device, precision.fp8, precision.bf16)
        lines["control"] = dict(checks.judge_eval(stand, cell, seed, device),
                                seconds=time.perf_counter() - t0)
    out = []
    for what in kinds:
        line = {k: v for k, v in lines[what].items() if k != "per_unit"}
        out.append({"workload": cell.name, "seed": seed, "what": what, **line})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--what", default="program,control")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path[0] = str(ROOT)
    import torch

    from uadbench.harness.cell import Cell, benchmark_json

    cell = Cell(args.workload, benchmark_json())
    log = ROOT / "chiprun_out" / "readings.jsonl"
    log.parent.mkdir(exist_ok=True)
    for seed in [int(s) for s in args.seeds.split(",")]:
        for line in readings(cell, seed, args.what.split(","), args.seconds,
                             torch.device("cuda")):
            text = json.dumps(line, default=lambda v: None if isinstance(v, float)
                              and not math.isfinite(v) else v)
            print(text, flush=True)
            with open(log, "a") as f:
                f.write(text + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
