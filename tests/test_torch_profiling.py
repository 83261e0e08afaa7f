"""The port's ``utils/shapes.py::calc_interres`` against the JAX package's
on the CPU (exact: integer shapes), and ``utils/profiling.py::trace``
writing a Chrome trace (its spans: tests/test_torch_spans.py)."""
import json
import os

import pytest
import torch

from conditioned_diffusion_models_uad_torch.utils import profiling
from conditioned_diffusion_models_uad_torch.utils.shapes import calc_interres
from conditioned_diffusion_models_uad_tpu.utils.shapes import calc_interres as jcalc_interres


@pytest.mark.parametrize("dims,fac,n,k,p,s", [
    ((192, 192, 100), 2.0, 3, 2, 0, 2), ((160, 192, 160), 1.0, 5, 3, 1, 2),
    ((96, 96), 2.5, 2, 4, 1, 2), ((7,), 1.0, 4, 3, 1, 1)])
def test_calc_interres_matches_jax(dims, fac, n, k, p, s):
    assert calc_interres(dims, fac, n, k, p, s) == jcalc_interres(dims, fac, n, k, p, s)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "t"), with_memory=False) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = tmp_path / "t" / "trace.json"
    assert path.is_file() and prof is not None
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert os.path.getsize(path) > 0
