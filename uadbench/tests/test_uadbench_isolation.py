"""Nothing the benchmark runs loads JAX or the JAX package (each module's
top-level name compared whole: the port's name begins with the JAX
package's), and the plain reference imports nothing of the port."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "conditioned_diffusion_models_uad_tpu"}
PORT = "conditioned_diffusion_models_uad_torch"


def modules():
    return sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts
                  and ".cache" not in p.parts)


def imported_names(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", modules(), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_in_sources(path):
    assert not imported_names(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert PORT not in imported_names(path)
    assert not imported_names(path) & FORBIDDEN


def test_loaded_modules_of_a_run(tmp_path):
    """Import every module a run loads, drivers and the port's modules they
    reach included, then drive a tiny eval and train cell on the CPU, and
    list the top-level names in sys.modules."""
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r}); sys.path.insert(0, {str(BENCH / 'tests')!r})
import json, importlib, pathlib
import torch
torch.set_num_threads(2)
for p in sorted(pathlib.Path({str(BENCH)!r}).rglob('*.py')):
    rel = p.relative_to({str(ROOT)!r}).with_suffix('')
    if 'tests' in rel.parts or '.cache' in rel.parts or 'layer_metrics' in rel.parts:
        continue
    importlib.import_module('.'.join(rel.parts))
from uadbench.harness.cell import load_reader
from uadbench.harness.runner import run_cell
from conftest import tiny_cell
bench = json.load(open({str(ROOT / 'BENCHMARK.json')!r}))
for m in bench['per_layer']:
    load_reader(m['name'])
for kind in ('eval', 'train'):
    run_cell(tiny_cell(bench, kind), 7, 0.5, True, 'cpu')
names = {{n.split('.')[0] for n in sys.modules}}
print(sorted(names & set({sorted(FORBIDDEN)!r})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
