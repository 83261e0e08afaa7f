"""The port's ``utils/shapes.py::calc_interres`` and ``utils/profiling.py``
(trace, StepTimer, flops_summary) against the JAX package's on the CPU.
Exact (integer shapes, the same FLOP arithmetic)."""
import json
import os

import pytest
import torch

from conditioned_diffusion_models_uad_torch.models.unet import UNetConfig
from conditioned_diffusion_models_uad_torch.utils import profiling
from conditioned_diffusion_models_uad_torch.utils.shapes import calc_interres
from conditioned_diffusion_models_uad_tpu.models.unet import UNetConfig as JUNetConfig
from conditioned_diffusion_models_uad_tpu.utils import profiling as jprofiling
from conditioned_diffusion_models_uad_tpu.utils.shapes import calc_interres as jcalc_interres


@pytest.mark.parametrize("dims,fac,n,k,p,s", [
    ((192, 192, 100), 2.0, 3, 2, 0, 2), ((160, 192, 160), 1.0, 5, 3, 1, 2),
    ((96, 96), 2.5, 2, 4, 1, 2), ((7,), 1.0, 4, 3, 1, 1)])
def test_calc_interres_matches_jax(dims, fac, n, k, p, s):
    assert calc_interres(dims, fac, n, k, p, s) == jcalc_interres(dims, fac, n, k, p, s)


@pytest.mark.parametrize("kw", [{}, dict(model_channels=64, channel_mult=(1, 2),
                                         num_res_blocks=1)])
def test_flops_summary_matches_jax(kw):
    got = profiling.flops_summary(UNetConfig(**kw), (96, 96), 32, 0.25, n_forwards=3)
    want = jprofiling.flops_summary(JUNetConfig(**kw), (96, 96), 32, 0.25, n_forwards=3)
    assert got == want and got["achieved_tflops"] > 0


def test_step_timer_laps_and_summary():
    t = profiling.StepTimer()
    for i in range(5):
        t.lap(torch.ones(3) * i)  # CPU results: nothing to wait for
    s = t.summary()
    assert s["steps"] == 4 and s["median_s"] >= 0 and s["steps_per_sec"] > 0
    assert set(s) == set(jprofiling.StepTimer().summary())
    t2 = profiling.StepTimer()
    t2.lap()
    t2.lap({"a": [torch.zeros(1)], "b": (torch.ones(2),)})
    assert t2.summary()["steps"] == 1
    assert profiling.StepTimer._devices({"a": [torch.zeros(1)]}) == set()


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "t"), with_memory=False) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = tmp_path / "t" / "trace.json"
    assert path.is_file() and prof is not None
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert os.path.getsize(path) > 0
