"""The traced slice's arithmetic on a hand-made Chrome trace: busy time is
the union of device intervals (two streams at once count once), a span's
device time is that of the kernels launched inside it, and idle gaps are
labelled by the main thread's innermost host op."""
import json

import pytest

from uadbench.harness.trace import ROOT_SPAN, read_chrome_trace


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


@pytest.fixture()
def trace(tmp_path):
    events = [
        ev("user_annotation", ROOT_SPAN, 0, 1000),
        ev("user_annotation", "uadbench.recon", 10, 300),
        ev("cpu_op", "aten::conv2d", 20, 50),
        ev("cuda_runtime", "cudaLaunchKernel", 30, 5, corr=1),
        ev("cuda_runtime", "cudaLaunchKernel", 40, 5, corr=2),
        ev("cpu_op", "aten::sort", 400, 300),
        ev("cuda_runtime", "cudaLaunchKernel", 410, 5, corr=3),
        ev("cpu_op", "autograd::engine::evaluate_function: X", 50, 100, tid=2),
        ev("cuda_runtime", "cudaLaunchKernel", 60, 5, tid=2, corr=4),
        ev("kernel", "conv_a", 100, 200, tid=7, corr=1),  # stream 7
        ev("kernel", "conv_b", 150, 200, tid=8, corr=2),  # overlaps on stream 8
        ev("kernel", "sort_k", 800, 100, tid=7, corr=3),
        ev("gpu_memcpy", "Memcpy DtoH", 360, 20, tid=7, corr=9),
        ev("kernel", "bwd_k", 950, 10, tid=7, corr=4),
        ev("gpu_user_annotation", "uadbench.recon", 100, 250, tid=7),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return read_chrome_trace(path)


def test_busy_is_the_union(trace):
    # [100, 350] + [360, 380] + [800, 900] + [950, 960] = 250 + 20 + 100 + 10
    assert trace.busy_s == pytest.approx(380e-6)
    assert trace.window_s == pytest.approx(1000e-6)


def test_span_device_time(trace):
    assert trace.device_ms_under(lambda n: n == "uadbench.recon") == pytest.approx(0.4)
    assert trace.device_ms_under(lambda n: n == "aten::sort") == pytest.approx(0.1)
    assert trace.device_ms_under(
        lambda n: n.startswith("autograd::engine")) == pytest.approx(0.01)
    assert trace.device_ms_under(lambda n: n == "nothing") == 0.0


def test_breakdown(trace):
    ops = dict(trace.top_device_ops())
    assert ops["conv_a"] == pytest.approx(200e-6) and len(ops) == 5
    gaps = dict(trace.idle_gaps())
    # [0, 100): at 50 the innermost open op is the conv inside the recon span
    assert gaps["aten::conv2d"] == pytest.approx(100e-6)
    assert gaps["aten::sort"] == pytest.approx(420e-6)  # [380, 800)
    # [350, 360), [900, 950) and [960, 1000): no op open on the main thread
    assert gaps["python"] == pytest.approx(100e-6)
