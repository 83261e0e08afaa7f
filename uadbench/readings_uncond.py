"""``readings.py`` for cells of the ``eval_uncond`` traffic (an unconditional
UNet such as ADM-256), many seeds in one process:

    python3 uadbench/readings_uncond.py --workload adm256.eval --seeds 1,2,3 \\
        --what program[,control][,control_threshold] [--seconds 3]

``program`` and ``control_threshold`` are ``readings.py``'s (the run's own
numbers; the val threshold fitted in bfloat16 over the run's kept val
stage). ``control`` puts ``reference/adm.py`` in the system's place one
precision below the configuration's (its products and norms in fp8 e4m3,
its scoring in bfloat16) over the volumes a run checks, judged by the same
float32 reference. Prints one JSON line a seed and reading, and appends them
to ``chiprun_out/readings.jsonl``. Not part of a benchmark run."""
import argparse
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--what", default="program,control")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path[0] = str(ROOT)
    import torch

    from uadbench.drivers.eval_uncond import judge, stand_in
    from uadbench.harness.cell import Cell, benchmark_json
    from uadbench.readings import readings
    from uadbench.reference import precision

    cell = Cell(args.workload, benchmark_json())
    device = torch.device("cuda")
    kinds = args.what.split(",")
    log = ROOT / "chiprun_out" / "readings.jsonl"
    log.parent.mkdir(exist_ok=True)
    for seed in [int(s) for s in args.seeds.split(",")]:
        rest = [k for k in kinds if k != "control"]
        lines = readings(cell, seed, rest, args.seconds, device) if rest else []
        torch.cuda.empty_cache()
        if "control" in kinds:
            t0 = time.perf_counter()
            numbers = judge(stand_in(cell, seed, device, precision.fp8, precision.bf16),
                            cell, seed, device)
            lines.append({"workload": cell.name, "seed": seed, "what": "control",
                          **{k: v for k, v in numbers.items() if k != "per_unit"},
                          "seconds": time.perf_counter() - t0})
        for line in lines:
            text = json.dumps(line, default=lambda v: None if isinstance(v, float)
                              and not math.isfinite(v) else v)
            print(text, flush=True)
            with open(log, "a") as f:
                f.write(text + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
