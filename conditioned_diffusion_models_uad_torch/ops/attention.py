"""Exact softmax self-attention for the UNet middle block (counterpart of
``conditioned_diffusion_models_uad_tpu/ops/attention_pallas.py``).

``attention_reference`` is the plain PyTorch version of the JAX
``attention_reference``: q and k scaled by D^-1/4 in the input dtype, float32
logits and softmax, weights cast to v's dtype, P·V accumulated in float32.
``fused_attention`` launches kernel K2 (``csrc/attention.cu``) for a CUDA
tensor; its backward recomputes through the plain version, as the JAX custom
VJP does.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64)


def qk_scale(d: int, dtype: torch.dtype) -> float:
    """D^-1/4 rounded to the input dtype: JAX rounds the python scalar to the
    (weakly typed) input dtype before multiplying."""
    return torch.tensor(1.0 / math.sqrt(math.sqrt(d)), dtype=dtype).item()


def attention_reference(qkv: torch.Tensor) -> torch.Tensor:
    """qkv [B, S, 3, H, D] -> [B, S, H, D]."""
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    scale = torch.tensor(qk_scale(qkv.shape[-1], qkv.dtype), dtype=qkv.dtype,
                         device=qkv.device)
    qs = (q * scale).float()
    ks = (k * scale).float()
    logits = torch.einsum("bthc,bshc->bhts", qs, ks)
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhts,bshc->bthc", weights.float(), v.float())
    return out.to(v.dtype)


def _attention_fwd_cuda(qkv: torch.Tensor) -> torch.Tensor:
    b, s, three, h, d = qkv.shape
    if three != 3:
        raise ValueError(f"expected qkv [B, S, 3, H, D], got {tuple(qkv.shape)}")
    if qkv.dtype not in _DTYPE_CODES:
        raise ValueError(f"fused_attention takes float32 or bfloat16, got {qkv.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"fused_attention head dim must be one of {_HEAD_DIMS}, got {d}")
    if not qkv.is_contiguous():
        raise ValueError("fused_attention needs a contiguous qkv tensor")
    out = torch.empty((b, s, h, d), dtype=qkv.dtype, device=qkv.device)
    lib = _build.load("attention")
    fn = lib.attention_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    _build.check(fn(qkv.data_ptr(), out.data_ptr(), b, s, h, d,
                    _DTYPE_CODES[qkv.dtype], qk_scale(d, qkv.dtype), stream),
                 "attention_fwd launch")
    fused_attention.launches += 1
    return out


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv):
        ctx.save_for_backward(qkv)
        if qkv.device.type == "cpu":
            return attention_reference(qkv)
        if qkv.device.type != "cuda":
            raise ValueError(f"unsupported device {qkv.device}")
        return _attention_fwd_cuda(qkv)

    @staticmethod
    def backward(ctx, grad_out):
        (qkv,) = ctx.saved_tensors
        with torch.enable_grad():
            x = qkv.detach().requires_grad_(True)
            out = attention_reference(x)
        (grad,) = torch.autograd.grad(out, x, grad_out)
        return grad


def fused_attention(qkv: torch.Tensor) -> torch.Tensor:
    """qkv [B, S, 3, H, D] (float32 or bfloat16) -> [B, S, H, D]. The forward
    launches K2 for a CUDA tensor and uses the plain version for a CPU one;
    the backward recomputes through the plain version.
    ``fused_attention.launches`` counts the kernel launches."""
    return _FusedAttention.apply(qkv)


fused_attention.launches = 0
