"""A run with the timed path broken underneath comes out not correct, once
for each fault a cell can have, against the real cell's limits (the run
itself is a tiny float32 cell on the CPU, the look for a card skipped). One
cell has one chip, so no exchange between chips can be left out."""
import contextlib
import dataclasses

import pytest
import torch

from conditioned_diffusion_models_uad_torch.eval import metrics
from conditioned_diffusion_models_uad_torch.models.tasks import DDPMTask
from uadbench.harness.runner import run_cell

from conftest import tiny_cell


@contextlib.contextmanager
def patched(owner, name, make):
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def altered_reco(orig):
    def f(self, *a, **k):
        reco, aux = orig(self, *a, **k)
        return reco * 1.1, aux
    return f


def half_rows_reco(orig):
    def f(self, slices, *a, **k):
        reco, aux = orig(self, slices, *a, **k)
        h = reco.shape[0] // 2
        return torch.cat([reco[:h], reco[:h].mean(0, keepdim=True).expand_as(reco[h:])]), aux
    return f


def altered_threshold(orig):
    def f(*a, **k):
        dice, th = orig(*a, **k)
        return dice, th * 1.05
    return f


def half_pool_threshold(orig):
    def f(x, y, *a, **k):
        return orig(x[:x.numel() // 2], y[:y.numel() // 2], *a, **k)
    return f


EVAL_FAULTS = {"answer_altered": (DDPMTask, "reconstruct_with_aux", altered_reco),
               "half_batch": (DDPMTask, "reconstruct_with_aux", half_rows_reco),
               "threshold_altered": (metrics, "find_best_val_device", altered_threshold),
               "val_pool_halved": (metrics, "find_best_val_device", half_pool_threshold)}


@pytest.mark.parametrize("fault", sorted(EVAL_FAULTS))
def test_eval_fault_is_caught(bench, fault):
    torch.set_num_threads(2)
    owner, name, make = EVAL_FAULTS[fault]
    with patched(owner, name, make):
        out, checks, _ = run_cell(tiny_cell(bench, "eval"), 31, 0.5, False, "cpu")
    assert out["correct"] is False and out["failed"] > 0, checks


def unchanged_step(orig):
    def f(self, *a, **k):
        return None
    return f


def half_batch_loss(orig):
    def f(self, batch, draws, **k):
        h = batch["vol"].shape[0] // 2
        return orig(self, {"vol": batch["vol"][:h]}, dataclasses.replace(draws, t=draws.t[:h]),
                    **k)
    return f


def altered_loss(orig):
    def f(self, *a, **k):
        loss, aux = orig(self, *a, **k)
        return loss * 1.05, aux
    return f


def unchanged_after_setup(orig):
    calls = [0]

    def f(self, *a, **k):
        calls[0] += 1
        return orig(self, *a, **k) if calls[0] <= 3 else None
    return f


TRAIN_FAULTS = {"state_unchanged": (torch.optim.Adam, "step", unchanged_step),
                "state_unchanged_in_window": (torch.optim.Adam, "step", unchanged_after_setup),
                "half_batch": (DDPMTask, "loss", half_batch_loss),
                "answer_altered": (DDPMTask, "loss", altered_loss)}


@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
def test_train_fault_is_caught(bench, fault):
    torch.set_num_threads(2)
    owner, name, make = TRAIN_FAULTS[fault]
    with patched(owner, name, make):
        out, checks, _ = run_cell(tiny_cell(bench, "train"), 32, 0.5, False, "cpu")
    assert out["correct"] is False, checks


@pytest.mark.parametrize("kind", ["eval", "train"])
def test_sound_run_is_correct(bench, kind):
    torch.set_num_threads(2)
    out, checks, _ = run_cell(tiny_cell(bench, kind), 33, 0.5, False, "cpu")
    assert out["correct"] is True and out["failed"] == 0, checks
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device"]
    assert set(checks) == set(tiny_cell(bench, kind).limits)
    assert set(out["metrics"]) == {m["name"] for m in tiny_cell(bench, kind).metrics(
        "end_to_end")}
