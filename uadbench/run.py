"""The benchmark of the PyTorch/CUDA port, one cell a run:

    python3 uadbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Builds (or reuses) the port's kernels, makes
the weights and inputs on the card from the seed, warms up the cell's shapes,
measures for ``--seconds`` and prints one JSON line last on standard output:
the end-to-end metrics with ``--trace 0``, the per-layer metrics and the
breakdown of a traced slice with ``--trace 1``. The check against the plain
reference runs after the window; its numbers and limits close the line
('checks') and standard error; before them 'build_s', the part of
``setup_s`` spent building the port's kernels (0 but on a checkout's first
run). Exits non-zero, printing no result, without a CUDA card (or fewer
than the cell asks for), or when JAX or the JAX package is loaded in this
process."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "uadbench" / ".cache"


def pin_caches() -> None:
    """Every kernel and build cache at a fixed path inside the checkout (the
    port builds its CUDA libraries in its own ``_build/``)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    pin_caches()
    sys.path[0] = str(ROOT)  # the checkout's root, not this folder

    import torch

    from uadbench.harness.cell import Cell, benchmark_json
    from uadbench.harness.runner import forbidden_modules, run_cell

    bench = benchmark_json()
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    chips = int(entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    from conditioned_diffusion_models_uad_torch.ops import _build

    build_s = _build.build_all()  # part of set-up; only a checkout's first run builds
    result, checks, _ = run_cell(Cell(args.workload, bench), args.seed, args.seconds,
                                 bool(args.trace), "cuda", chips, T_START)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {found}", file=sys.stderr)
        return 3
    result["build_s"] = build_s
    result["checks"] = checks
    print(f"build_s {build_s!r} (within setup_s)", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
