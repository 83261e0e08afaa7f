"""Seeded random weights for parity and smoke runs.

A fresh model zero-initialises its output convolutions and starts batch
statistics at mean 0, var 1, so an untouched model reconstructs a constant
image. ``randomize_`` overwrites every parameter and buffer of a module from
a numpy seed, the same values on any device, so a comparison exercises every
weight.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


@torch.no_grad()
def randomize_(module: nn.Module, seed: int) -> nn.Module:
    """Fill every floating parameter and buffer of ``module`` in place:
    weights of rank >= 2 ~ N(0, 1/fan_in), norm scales ~ U(0.6, 1.4),
    biases ~ N(0, 0.1), running means ~ N(0, 0.1), running vars ~ U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    for name, t in module.state_dict(keep_vars=True).items():
        if not t.is_floating_point():
            continue
        shape = tuple(t.shape)
        if name.endswith("running_var"):
            v = rng.uniform(0.5, 1.5, shape)
        elif name.endswith("running_mean") or name.endswith("bias"):
            v = rng.normal(0.0, 0.1, shape)
        elif t.dim() >= 2:
            fan_in = int(np.prod(shape[1:]))
            v = rng.normal(0.0, 1.0 / np.sqrt(fan_in), shape)
        else:
            v = rng.uniform(0.6, 1.4, shape)
        t.copy_(torch.from_numpy(v.astype(np.float32)))
    return module
