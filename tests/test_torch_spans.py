"""The port's spans (``utils/profiling.py::span``) on the CPU. With no
profiler a span enters no ``record_function`` and still adds its seconds to
``into``; under a profiler a CPU ``train_step`` and a CPU ``run_stage``
trace their spans nested as the span table of ``utils/profiling.py`` says,
the eval group's id on the main thread's dispatch and on the scorer
thread's fetch and commit, and ``run_stage`` keeps its phases."""
import json
import threading
import time

import numpy as np
import pytest
import torch

from conditioned_diffusion_models_uad_torch.utils import profiling

torch.set_num_threads(2)

HOST_CATS = ("cpu_op", "user_annotation")


def host_ranges(path) -> list:
    """(tid, ts, end, name) of the trace's host ranges."""
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["tid"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
            for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS]


def named(ranges, name) -> list:
    return [r for r in ranges if r[3] == name]


def inside(ranges, outer, name) -> list:
    """The ranges called ``name`` on ``outer``'s thread within it."""
    tid, a, b, _ = outer
    return [r for r in named(ranges, name) if r[0] == tid and a <= r[1] and r[2] <= b]


def group_of(ranges, outer) -> int:
    """The id of the one ``group=<id>`` range within ``outer``."""
    tid, a, b, _ = outer
    marks = [r[3] for r in ranges if r[0] == tid and a <= r[1] <= b and r[3].startswith("group=")]
    assert len(marks) == 1, (outer, marks)
    return int(marks[0][len("group="):])


@pytest.mark.parametrize("key", [None, "wait"])
def test_span_off_enters_no_record_function(monkeypatch, key):
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda *a, **k: entered.append(a))
    ph = {"wait": 1.0}
    with profiling.span("eval.wait", into=ph, key=key, group=3):
        time.sleep(0.002)
    with profiling.span("train.step"):
        pass
    assert entered == []
    assert profiling.span("train.step") is profiling.span("eval.fetch", group=1)
    if key is None:
        assert ph["wait"] == 1.0 and ph["eval.wait"] >= 0.002
    else:
        assert set(ph) == {"wait"} and ph["wait"] >= 1.002


@pytest.mark.parametrize("how", ["torch_profiler", "trace"])
def test_span_is_a_range_under_a_profiler(tmp_path, how):
    """A plain ``torch.profiler.profile`` (the main thread's ranges) and
    ``profiling.trace`` (every thread's) both record the span, its group
    marker inside it, and ``into`` still counts."""
    ph = {}

    def work():
        with profiling.span("eval.dispatch", into=ph, key="recon", group=4):
            torch.ones(8).sum()

    if how == "trace":
        with profiling.trace(str(tmp_path), with_memory=False):
            work()
        path = tmp_path / "trace.json"
    else:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU]) as prof:
            work()
        path = tmp_path / "t.json"
        prof.export_chrome_trace(str(path))
    ranges = host_ranges(path)
    (dispatch,) = named(ranges, "eval.dispatch")
    assert group_of(ranges, dispatch) == 4 and inside(ranges, dispatch, "aten::sum")
    assert ph["recon"] > 0


def _tiny_task():
    from conditioned_diffusion_models_uad_torch.models.tasks import DDPMTask, DDPMTaskConfig
    from conditioned_diffusion_models_uad_torch.utils.random_init import randomize_

    cfg = DDPMTaskConfig(image_hw=(32, 32), cond_dim=16, encoder_backbone="resnet18",
                         timesteps=20, unet_dim=32, num_res_blocks=1, channel_mult=(1, 2),
                         attention_resolutions=(), test_timesteps=10, step_ensemble=(5, 10),
                         dtype="float32")
    return randomize_(DDPMTask(cfg, device="cpu"), 21)


def test_train_step_spans_nest(tmp_path):
    from conditioned_diffusion_models_uad_torch.train import loop

    task = _tiny_task()
    opt = loop.make_optimizer(task)
    g = torch.Generator().manual_seed(0)
    vols = torch.rand((2, 32, 32, 4), generator=g)
    steps = 2
    with profiling.trace(str(tmp_path), with_memory=False):
        for _ in range(steps):
            vi, si = torch.tensor([0, 1, 1, 0]), torch.tensor([0, 1, 2, 3])
            loop.train_step(task, opt, (vols, None), vi, si, task.draw_train(g, 4))
    ranges = host_ranges(tmp_path / "trace.json")
    outer = named(ranges, "train.step")
    assert len(outer) == steps
    for step in outer:
        for name in ("train.gather", "train.forward", "train.backward", "train.all_reduce",
                     "train.optimizer"):
            assert len(inside(ranges, step, name)) == 1, name
        (forward,) = inside(ranges, step, "train.forward")
        for name in ("task.encode", "task.noise", "task.unet"):
            assert len(inside(ranges, forward, name)) == 1, name


def test_run_stage_phases_and_spans(tmp_path, monkeypatch):
    """Two fused groups of two volumes: the phases keep their keys, and the
    trace holds each group's dispatch (reconstruction and scoring inside it)
    on the main thread and its fetch and commit on a scorer thread, both
    carrying the group's first subject index."""
    from conditioned_diffusion_models_uad_torch import orchestrate
    from conditioned_diffusion_models_uad_torch.eval.harness import EvalConfig, EvalSession
    from conditioned_diffusion_models_uad_torch.eval.reconstruct import VolumeReconstructor

    monkeypatch.setattr(orchestrate, "FUSED_MIN_VOXELS", 1000)
    rng = np.random.default_rng(11)
    shape = (32, 32, 6)
    subs = []
    for i in range(4):
        vol = rng.uniform(0, 1, shape).astype(np.float32)
        seg = np.zeros(shape, np.float32)
        seg[8:20, 10:22, 1:5] = 1.0
        mask = np.zeros(shape, np.float32)
        mask[2:30, 2:30] = 1.0
        subs.append({"vol": vol, "vol_orig": vol, "mask_orig": mask, "seg_orig": seg,
                     "ID": f"s{i}", "label": 1})
    recon = VolumeReconstructor(_tiny_task(), device="cpu")
    key = np.asarray([0, 1007], np.uint32)

    def stage():
        session = EvalSession(EvalConfig(cc_backend="device", hausdorff_backend="device"),
                              "Brats21", "val", device="cpu")
        ph = orchestrate.run_stage(session, recon, iter(subs), key, volumes_per_call=2)
        assert session.test_end()["IDs"] == ["s0", "s1", "s2", "s3"]
        return ph

    ph = stage()
    assert set(ph) == {"load", "recon", "wait", "total", "volumes"} and ph["volumes"] == 4
    assert ph["recon"] > 0 and 0 <= ph["load"] + ph["recon"] + ph["wait"] <= ph["total"]
    with profiling.trace(str(tmp_path), with_memory=False):
        stage()
    ranges = host_ranges(tmp_path / "trace.json")
    main = threading.get_native_id()
    dispatches = named(ranges, "eval.dispatch")
    assert {r[0] for r in dispatches} == {main}
    assert sorted(group_of(ranges, r) for r in dispatches) == [0, 2]
    for r in dispatches:
        assert len(inside(ranges, r, "eval.recon")) == len(inside(ranges, r, "eval.score")) == 1
        assert len(inside(ranges, r, "task.unet")) == 2  # a call a volume
    for name in ("eval.fetch", "eval.commit"):
        found = named(ranges, name)
        assert found and all(r[0] != main for r in found), name
        assert sorted(group_of(ranges, r) for r in found) == [0, 2], name
    assert len(named(ranges, "eval.load")) >= 4 and named(ranges, "eval.wait")
