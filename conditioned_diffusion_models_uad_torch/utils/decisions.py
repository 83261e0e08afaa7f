"""Record and replay the piecewise choices of a training step, for parity
runs.

A train step's gradient is piecewise smooth: each ReLU of the ResNet encoder
chooses by the sign of its input, the stem's max-pool by the largest value of
each window, and the L1 loss by the sign of each pixel's error. Two float32
runs that sum their convolutions in other orders (the card and the CPU, or
this package and the JAX one) differ by ~1e-6 relative, so the few of these
millions of choices whose input lies that close to its threshold can go the
other way. One flip re-routes one element's gradient: in the encoder, through
the batch statistics of a training-mode BatchNorm, it moves whole gradient
tensors by up to a few percent (``python -m`` this module), and a flipped
L1 sign moves every gradient a little. ``recorded_choices`` records one run's
choices and makes another run take them, so the two are compared on the same
piece of the function, and it counts the choices the replaying run would
have made otherwise.
"""
from __future__ import annotations

import contextlib
from typing import List

import torch
import torch.nn.functional as F

from ..diffusion import gaussian
from ..models import resnet


class _Choices:
    """Stands in for ``torch.nn.functional`` inside ``models/resnet.py`` and
    ``diffusion/gaussian.py``."""

    def __init__(self, choices: List[torch.Tensor], replay: bool):
        self.choices, self.replay, self.next = choices, replay, 0
        self.count = {"made": 0, "flipped": 0}

    def __getattr__(self, name):
        return getattr(F, name)

    def _take(self, like: torch.Tensor) -> torch.Tensor:
        if self.next >= len(self.choices):
            raise RuntimeError(f"only {len(self.choices)} choices were recorded")
        c = self.choices[self.next].to(like.device)
        self.next += 1
        if c.shape != like.shape:
            raise RuntimeError(f"choice {self.next - 1}: shape {tuple(c.shape)}, "
                               f"expected {tuple(like.shape)}")
        return c

    def relu(self, x):
        if not self.replay:
            self.choices.append((x > 0).cpu())
            return F.relu(x)
        keep = self._take(x)
        self.count["made"] += keep.numel()
        self.count["flipped"] += int(((x > 0) != keep).sum())
        return x * keep.to(x.dtype)

    def max_pool2d(self, x, *args, **kwargs):
        y, idx = F.max_pool2d(x, *args, return_indices=True, **kwargs)
        if not self.replay:
            self.choices.append(idx.cpu())
            return y
        idx = self._take(idx)
        taken = x.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)
        self.count["made"] += idx.numel()
        self.count["flipped"] += int((taken != y).sum())  # a tie is no flip
        # in y's memory layout, so the convolutions after it sum as they would
        return torch.empty_like(y).copy_(taken)

    def l1_loss(self, x, target, reduction="mean"):
        if reduction != "none":
            raise NotImplementedError("only reduction='none' is recorded")
        err = x - target
        if not self.replay:
            self.choices.append(err.sign().to(torch.int8).cpu())
            return err.abs()
        sign = self._take(err)
        self.count["made"] += sign.numel()
        self.count["flipped"] += int((err.sign().to(torch.int8) != sign).sum())
        return err * sign.to(err.dtype)


@contextlib.contextmanager
def recorded_choices(choices: List[torch.Tensor], *, replay: bool, loss: bool = True):
    """Within the block, every ResNet forward of this package (and, with
    ``loss``, every L1 objective of ``diffusion/gaussian.py``) appends each
    ReLU's mask (input > 0), each max-pool's argmax indices and each L1
    error's sign to ``choices`` in call order (``replay=False``), or takes
    them from ``choices`` in that order instead of choosing (``replay=True``):
    a replayed ReLU is ``x * mask``, a replayed max-pool gathers the recorded
    indices, a replayed L1 is ``err * sign``. Yields a dict, filled on
    replay, of the choices ``made`` and of those ``flipped``, where the
    replaying run's own choice would differ (for a max-pool, a different
    value; a tie is no flip). Choices are kept on the CPU."""
    proxy = _Choices(choices, replay)
    modules = [resnet, gaussian] if loss else [resnet]
    saved = [m.F for m in modules]
    for m in modules:
        m.F = proxy
    try:
        yield proxy.count
    finally:
        for m, f in zip(modules, saved):
            m.F = f
    if replay and proxy.next != len(choices):
        raise RuntimeError(f"{len(choices) - proxy.next} recorded choices were not replayed")

def _probe(batch: int, trial: int, variant: str = "resnet18", hw: int = 96) -> dict:
    """One CPU trial: a randomly initialised training-mode encoder's
    gradients (of a fixed projection of its output) on slices and on the
    slices moved by 1e-6, choosing for itself and replaying the first run's
    choices; and the smallest BatchNorm batch variance of the first run."""
    import numpy as np

    from .random_init import randomize_

    rng = np.random.default_rng(10 + trial)
    x = torch.from_numpy(rng.uniform(0, 1, (batch, hw, hw, 1)).astype(np.float32))
    dx = torch.from_numpy(1e-6 * rng.normal(size=x.shape).astype(np.float32))
    proj = torch.from_numpy(rng.normal(size=(batch, 128)).astype(np.float32))
    min_var = []

    def grads(inp, choices, replay):
        enc = randomize_(resnet.ResNetEncoder(resnet.ResNetConfig(variant=variant)), 3)
        enc.train()
        hooks = [m.register_forward_hook(
            lambda m, a, y: min_var.append(
                a[0].detach().float().var((0, 2, 3), unbiased=False).min().item()))
            for m in enc.modules() if isinstance(m, resnet.MaskedBatchNorm)]
        with recorded_choices(choices, replay=replay) as count:
            (enc(inp) * proj).sum().backward()
        for h in hooks:
            h.remove()
        return {n: p.grad.double() for n, p in enc.named_parameters()}, count

    def spread(a, b):
        return max((((a[n] - b[n]).norm() / b[n].norm()).item(), n) for n in b)

    choices = []
    g0, _ = grads(x, choices, False)
    bn_min_var = min(min_var)
    g_own, _ = grads(x + dx, [], False)
    g_rep, count = grads(x + dx, choices, True)
    own, rep = spread(g_own, g0), spread(g_rep, g0)
    return {"batch": batch, "trial": trial, "choices": count["made"],
            "flipped": count["flipped"], "grad_spread_own": own[0], "worst_leaf_own": own[1],
            "grad_spread_replayed": rep[0], "worst_leaf_replayed": rep[1],
            "bn_min_batch_var": bn_min_var}


if __name__ == "__main__":
    # python -m conditioned_diffusion_models_uad_torch.utils.decisions (CPU,
    # about a minute): how a 1e-6 change of the input moves a resnet18
    # encoder's gradients at 96x96, with its own choices and replayed ones
    import json

    torch.set_num_threads(4)
    for b in (2, 4):
        for trial in range(3):
            print(json.dumps(_probe(b, trial)), flush=True)
