"""The program's spans in a hand-made Chrome trace (``harness/program_spans.py``
and its readers): idle time inside spans, launches as distinct correlation
ids (two kernels of one graph launch count once), the autograd thread's
launches counted for a train step, another thread's not for an eval
dispatch, and None for a program without the spans."""
import json
from types import SimpleNamespace

import pytest

from uadbench.harness import program_spans
from uadbench.harness.cell import load_reader
from uadbench.harness.trace import ROOT_SPAN, read_chrome_trace


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def launch(ts, corr, tid=1):
    return ev("cuda_runtime", "cudaLaunchKernel", ts, 5, tid=tid, corr=corr)


@pytest.fixture()
def trace(tmp_path):
    events = [
        ev("user_annotation", ROOT_SPAN, 0, 1000),
        # step 1 [0, 400): forward [10, 110), backward [120, 320)
        ev("user_annotation", "train.step", 0, 400),
        ev("user_annotation", "train.forward", 10, 100),
        launch(20, 1),
        launch(30, 2),
        ev("user_annotation", "train.backward", 120, 200),
        # the backward's own thread launches inside the engine's ops
        ev("cpu_op", "autograd::engine::evaluate_function: MulBackward0", 130, 100, tid=2),
        launch(140, 3, tid=2),
        launch(240, 9, tid=2),  # outside any engine op: not counted
        launch(350, 4),  # the optimizer, inside the step
        # step 2 [500, 640): a graph replay whose two kernels share id 5
        ev("user_annotation", "train.step", 500, 140),
        ev("user_annotation", "train.backward", 520, 100),
        launch(530, 5),
        # an eval dispatch [650, 750) beside a scorer thread's copy
        ev("user_annotation", "eval.dispatch", 650, 100),
        launch(660, 6),
        launch(670, 7, tid=3),
        ev("kernel", "k1", 50, 40, tid=7, corr=1),  # [50, 90) in the forward
        ev("kernel", "k2", 60, 20, tid=8, corr=2),  # on another stream, inside k1
        ev("kernel", "k3", 200, 50, tid=7, corr=3),  # [200, 250) in the backward
        ev("kernel", "k9", 260, 10, tid=7, corr=9),
        ev("kernel", "adam", 360, 20, tid=7, corr=4),
        ev("kernel", "g_a", 540, 30, tid=7, corr=5),  # [540, 570)
        ev("kernel", "g_b", 570, 20, tid=7, corr=5),  # [570, 590): one launch
        ev("kernel", "e1", 700, 30, tid=7, corr=6),  # [700, 730)
        ev("gpu_memcpy", "Memcpy DtoH", 730, 10, tid=7, corr=7),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return read_chrome_trace(path)


def test_idle_inside_spans(trace):
    # forward [10, 110) less [50, 90): 60 us
    assert program_spans.idle_ms(trace, "train.forward") == pytest.approx(0.060)
    # backward [120, 320) less [200, 250) and [260, 270); [520, 620) less [540, 590)
    assert program_spans.idle_ms(trace, "train.backward") == pytest.approx(0.140 + 0.050)
    # dispatch [650, 750) less [700, 740)
    assert program_spans.idle_ms(trace, "eval.dispatch") == pytest.approx(0.060)


def test_launches_count_correlation_ids(trace):
    # 1, 2, 4 on the main thread, 3 from the engine's op, 5 once for two kernels
    assert program_spans.launches(trace, "train.step", autograd=True) == 5
    assert program_spans.launches(trace, "train.step") == 4  # the engine's thread left out
    # the scorer thread's copy (7) inside the dispatch's time is not the dispatch's
    assert program_spans.launches(trace, "eval.dispatch") == 1


def test_readers(trace, bench):
    train = SimpleNamespace(trace=trace, traced_units=2 * 32,
                            driver=SimpleNamespace(p={"batch": 32}))
    assert load_reader("train.launches_per_step")(train) == pytest.approx(2.5)
    assert load_reader("train.backward_idle_ms_per_step")(train) == pytest.approx(0.095)
    assert load_reader("train.forward_idle_ms_per_step")(train) == pytest.approx(0.030)
    ev_ctx = SimpleNamespace(trace=trace, traced_units=2)
    assert load_reader("eval.launches_per_volume")(ev_ctx) == pytest.approx(0.5)
    assert load_reader("eval.dispatch_idle_ms_per_volume")(ev_ctx) == pytest.approx(0.030)
    names = {m["name"] for m in bench["per_layer"] if m["source"] == "program_span"}
    assert {"train.launches_per_step", "eval.launches_per_volume"} <= names


def test_no_spans_read_none(tmp_path):
    """A program without the spans: every reader gives None."""
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        ev("user_annotation", ROOT_SPAN, 0, 100), launch(10, 1),
        ev("kernel", "k", 20, 10, tid=7, corr=1)]}))
    t = read_chrome_trace(path)
    ctx = SimpleNamespace(trace=t, traced_units=32, driver=SimpleNamespace(p={"batch": 32}))
    for name in ("train.launches_per_step", "train.backward_idle_ms_per_step",
                 "train.forward_idle_ms_per_step", "eval.launches_per_volume",
                 "eval.dispatch_idle_ms_per_volume"):
        assert load_reader(name)(ctx) is None, name
