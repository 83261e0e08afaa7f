"""Seeded random weights, made on the device in two large draws.

Every floating tensor of a state dict is filled: weights of rank >= 2 from
N(0, 1/fan_in), biases and running means from N(0, 0.01), running variances
from U(0.5, 1.5) and the other vectors (norm scales) from U(0.6, 1.4). A
fresh model zeroes its output convolutions; random values everywhere make a
check exercise every weight. The same seed gives the same values on any
call, so a reference can be handed the weights again after the program's
state is freed."""
from __future__ import annotations

import math

import torch


def _kind(name: str, t: torch.Tensor) -> str:
    if name.endswith("running_var"):
        return "var"
    if name.endswith("running_mean") or name.endswith("bias"):
        return "small"
    return "fan" if t.dim() >= 2 else "scale"


def make_weights(template: dict, seed: int, device) -> dict:
    """{name: float32 tensor on ``device``} for every floating entry of
    ``template`` (a state dict; only names and shapes are read, in name
    order, so two modules with the same names get the same values)."""
    specs = [(n, tuple(t.shape), _kind(n, t)) for n, t in sorted(template.items())
             if t.is_floating_point()]
    n_normal = sum(math.prod(s) for _, s, k in specs if k in ("fan", "small"))
    n_uniform = sum(math.prod(s) for _, s, k in specs if k in ("var", "scale"))
    g = torch.Generator(device=device).manual_seed(seed)
    normal = torch.randn(n_normal, generator=g, device=device)
    uniform = torch.rand(n_uniform, generator=g, device=device)
    out, i, j = {}, 0, 0
    for name, shape, kind in specs:
        n = math.prod(shape)
        if kind in ("fan", "small"):
            v = normal[i:i + n].view(shape)
            i += n
            scale = 1.0 / math.sqrt(math.prod(shape[1:])) if kind == "fan" else 0.1
            out[name] = v * scale
        else:
            v = uniform[j:j + n].view(shape)
            j += n
            out[name] = v + 0.5 if kind == "var" else 0.6 + 0.8 * v
    return out
