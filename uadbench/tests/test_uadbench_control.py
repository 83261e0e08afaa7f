"""The control, the reference put in the system's place one precision below
the configuration's (fp8 products, bfloat16 scoring), fails the real cell's
limits at a size a test run holds; so does the half-batch fault planted in
the reference; in a train cell both at the set-up steps and at the window's
checked steps. The readings that set the limits were taken on the card at
the cells' own sizes (``readings.py``)."""
import pytest
import torch

from uadbench.harness import checks
from uadbench.readings import readings, stand_in_eval
from uadbench.reference import precision

from conftest import tiny_cell


def fails(numbers, cell):
    return any(numbers[k] > lim for k, lim in cell.limits.items())


def test_eval_control_fails(bench):
    torch.set_num_threads(2)
    cell = tiny_cell(bench, "eval")
    samples = stand_in_eval(cell, 41, torch.device("cpu"), precision.fp8, precision.bf16)
    numbers = checks.judge_eval(samples, cell, 41, torch.device("cpu"))
    assert fails(numbers, cell), numbers


def test_train_control_fails(bench):
    """At the set-up steps and at the window's checked steps alike."""
    torch.set_num_threads(2)
    cell = tiny_cell(bench, "train")
    lines = {line["what"]: line for line in readings(
        cell, 42, ["program", "control", "half_batch"], 0.5, torch.device("cpu"))}
    assert not fails(lines["program"], cell), lines["program"]
    for what in ("control", "half_batch"):
        assert fails(lines[what], cell), lines[what]
        assert any(lines[what][k] > lim for k, lim in cell.limits.items()
                   if k.startswith("window_")), lines[what]


def test_eval_threshold_control_fails(bench):
    torch.set_num_threads(2)
    cell = tiny_cell(bench, "eval")
    lines = {line["what"]: line for line in readings(
        cell, 43, ["program", "control_threshold"], 0.5, torch.device("cpu"))}
    lim = cell.limits["threshold_gap"]
    assert lines["program"]["threshold_gap"] <= lim < lines["control_threshold"][
        "threshold_gap"], lines
