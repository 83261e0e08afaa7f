"""The ``eval_uncond`` traffic (an unconditional UNet, ADM-256's cell) at a
size the CPU holds: its operation count against torch's FLOP counter, a
traced run that comes out correct against ``reference/adm.py``, the control
one precision below that fails the cell's limits, and the three readers
(the attention blocks' device time, the program's full-resolution span, the
share of attention calls that launched K2) against a hand-made trace, which
give None where there is nothing to read."""
import json
from types import SimpleNamespace

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from uadbench.drivers.eval_uncond import (
    attention_sites,
    judge,
    recon_numbers,
    stand_in,
    unet_forward,
)
from uadbench.harness.cell import BENCH_DIR, Cell, load_reader
from uadbench.harness.runner import run_cell
from uadbench.harness.trace import ROOT_SPAN, read_chrome_trace
from uadbench.reference import precision
from uadbench.reference.adm import ADM

SEED = 2**31 + 4321
READERS = ("eval.attn_device_ms_per_volume", "eval.full_res_device_ms_per_volume",
           "eval.attn_k2_share")


def tiny_adm_cell(bench):
    """``adm256.eval`` at 32 channels, float32, 64x64x32 volumes, with the
    real cell's limits."""
    base = json.loads((BENCH_DIR / "configs" / "adm_256.json").read_text())
    config = dict(base, model=dict(base["model"], unet_dim=32, dtype="float32"),
                  shape=[64, 64, 32])
    workload = json.loads((BENCH_DIR / "workloads" / "adm256.eval.json").read_text())
    workload = dict(workload, params=dict(workload["params"], subjects=4, traced_volumes=2))
    traffic = json.loads((BENCH_DIR / "traffic" / f"{workload['traffic']}.json").read_text())
    return Cell("adm256.eval", bench, workload, config, traffic)


@pytest.mark.parametrize("hw", [(64, 64), (96, 96)])
def test_count_matches_the_flop_counter(hw):
    model = {"unet_dim": 32, "num_res_blocks": 2, "channel_mult": [1, 1, 2, 2, 4, 4],
             "attention_resolutions": [8, 16, 32], "num_head_channels": 16}
    net = ADM(model).eval()
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        net.unet(torch.zeros((2, *hw, 1)), torch.zeros(2, dtype=torch.long))
    assert unet_forward(model, hw) * 2 == pytest.approx(fc.get_total_flops(), rel=1e-12)
    assert len(attention_sites(model, hw)) == 16


def test_run_correct_and_control_fails(bench):
    torch.set_num_threads(2)
    cell = tiny_adm_cell(bench)
    out, checks, _ = run_cell(cell, SEED, 0.5, True, "cpu")
    assert out["correct"] is True and out["failed"] == 0, checks
    # off the card every attention call takes the plain route
    assert out["metrics"]["eval.attn_k2_share"]["value"] == 0.0
    numbers = judge(stand_in(cell, SEED, torch.device("cpu"), precision.fp8, precision.bf16),
                    cell, SEED, torch.device("cpu"))
    assert any(numbers[k] > lim for k, lim in cell.limits.items()), numbers


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def trace_of(tmp_path, spans: bool):
    events = [ev("user_annotation", ROOT_SPAN, 0, 1000),
              ev("cuda_runtime", "cudaLaunchKernel", 20, 5, corr=1),
              ev("cuda_runtime", "cudaLaunchKernel", 120, 5, corr=2),
              ev("cuda_runtime", "cudaLaunchKernel", 320, 5, corr=3),
              ev("kernel", "conv", 30, 60, tid=7, corr=1),  # in unet.full_res
              ev("kernel", "k2", 130, 40, tid=7, corr=2),  # in uadbench.attn
              ev("kernel", "other", 330, 10, tid=7, corr=3)]
    if spans:
        events += [ev("user_annotation", "unet.full_res", 10, 50),
                   ev("user_annotation", "uadbench.attn", 100, 100)]
    path = tmp_path / f"t{int(spans)}.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return read_chrome_trace(path)


def test_readers_on_a_trace(tmp_path):
    counted = {"calls": 8, "k2": 8}
    ctx = SimpleNamespace(trace=trace_of(tmp_path, True), traced_units=2,
                          driver=SimpleNamespace(traced_attention=counted))
    assert load_reader("eval.full_res_device_ms_per_volume")(ctx) == pytest.approx(0.030)
    assert load_reader("eval.attn_device_ms_per_volume")(ctx) == pytest.approx(0.020)
    assert load_reader("eval.attn_k2_share")(ctx) == pytest.approx(100.0)
    ctx.driver.traced_attention = {"calls": 16, "k2": 8}
    assert load_reader("eval.attn_k2_share")(ctx) == pytest.approx(50.0)


def test_readers_give_none_without_spans_or_counter(tmp_path):
    """A trace without the spans, or a driver that counted no attention
    call, reports none of the three."""
    ctx = SimpleNamespace(trace=trace_of(tmp_path, False), traced_units=2,
                          driver=SimpleNamespace(traced_attention={"calls": 0, "k2": 0}))
    for name in READERS:
        assert load_reader(name)(ctx) is None, name
    ctx.driver = SimpleNamespace()
    assert load_reader("eval.attn_k2_share")(ctx) is None


def test_recon_input_gap_is_the_datas_scale():
    """``recon_input_gap`` divides the reconstruction's gap by the volume's
    RMS, which the weights do not set: the same gap reads the same over a
    reference reconstruction ten times smaller, where ``recon_gap`` grows
    tenfold."""
    g = torch.Generator().manual_seed(3)
    vol, ref = torch.rand((2, 8, 8, 4), generator=g)
    big, small = (recon_numbers(ref * k + 0.01, ref * k, vol) for k in (1.0, 0.1))
    want = 0.01 / float(vol.pow(2).mean().sqrt())
    assert big["recon_input_gap"] == pytest.approx(want, rel=1e-4)
    assert small["recon_input_gap"] == pytest.approx(want, rel=1e-4)
    assert small["recon_gap"] == pytest.approx(10 * big["recon_gap"], rel=1e-4)
