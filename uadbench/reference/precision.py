"""Lower precisions for the control: the reference put in the system's
place and computed one step below the precision the configuration states.

``fp8`` rounds a tensor to float8 e4m3 under one scale per tensor (its
largest magnitude to 448), as an fp8 product takes its operands, and in the
backward pass rounds the incoming gradient to float8 e5m2 the same way, as
fp8 training holds gradients; ``bf16`` rounds to bfloat16."""
from __future__ import annotations

import torch


def _round(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    scale = x.abs().amax().clamp_min(1e-30) / top
    return (x / scale).to(dtype).float() * scale


class _FP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad, torch.float8_e5m2, 57344.0)


def fp8(x: torch.Tensor) -> torch.Tensor:
    return _FP8.apply(x) if x.requires_grad else _round(x, torch.float8_e4m3fn, 448.0)


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()
