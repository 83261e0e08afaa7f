"""Exact softmax self-attention for the UNet middle block (counterpart of
``conditioned_diffusion_models_uad_tpu/ops/attention_pallas.py``).

``attention_reference`` is the plain PyTorch version of the JAX
``attention_reference``: q and k scaled by D^-1/4 in the input dtype, float32
logits and softmax, weights cast to v's dtype, P·V accumulated in float32.
``fused_attention`` launches kernel K2 for a CUDA tensor, in one of three
variants chosen by ``kernel_for``:

========  ============================  ====================================
dtype     S                             variant (source)
========  ============================  ====================================
bfloat16  S <= 576 (``MMA_MAX_SEQ``)    ``attention_fwd_mma``: one pass on
                                        the tensor cores, a head's K and V
                                        held on chip (``csrc/attention_mma.cu``)
bfloat16  S > 576                       ``attention_fwd_mma_long``: two passes
                                        on the tensor cores over streamed
                                        K/V tiles (``csrc/attention_mma_long.cu``)
float32   any                           ``attention_fwd_scalar``: one pass on
                                        the CUDA cores (``csrc/attention.cu``)
========  ============================  ====================================

The scalar kernel's bf16 mode (two passes on the CUDA cores) stays callable
directly; no dispatch takes it. The backward recomputes through the plain
version, as the JAX custom VJP does.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64)
# the largest S the tensor-core kernel's on-chip layout holds (4 warps x 9
# steps of 16 keys; csrc/attention_mma.cu kMaxSeq)
MMA_MAX_SEQ = 576


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


def kernel_for(dtype: torch.dtype, s: int, d: int) -> str:
    """The K2 variant that takes qkv of this dtype, sequence length and head
    dim on the card: "mma" (bf16, S <= MMA_MAX_SEQ), "mma_long" (bf16 beyond
    that S) or "scalar" (float32). Anything else raises."""
    if d not in _HEAD_DIMS:
        raise ValueError(f"fused_attention head dim must be one of {_HEAD_DIMS}, got {d}")
    if s < 1:
        raise ValueError(f"fused_attention needs S >= 1, got {s}")
    if dtype == torch.bfloat16:
        return "mma" if s <= MMA_MAX_SEQ else "mma_long"
    if dtype == torch.float32:
        return "scalar"
    raise ValueError(f"fused_attention takes float32 or bfloat16, got {dtype}")


def _check_qkv(qkv: torch.Tensor, kernel: str) -> None:
    """Raise unless ``kernel`` takes this qkv: shape, dtype, S and D, a
    contiguous layout and 16-byte aligned rows (every kernel copies 16-byte
    vectors; a view with a storage offset could break it). "mma" takes bf16
    up to MMA_MAX_SEQ, "mma_long" bf16 of any S, "scalar" both dtypes."""
    if qkv.dim() != 5 or qkv.shape[2] != 3:
        raise ValueError(f"expected qkv [B, S, 3, H, D], got {tuple(qkv.shape)}")
    _, s, _, _, d = qkv.shape
    picked = kernel_for(qkv.dtype, s, d)  # raises on what no kernel takes
    if kernel == "mma" and picked != "mma":
        raise ValueError(f"the mma kernel does not take {qkv.dtype} at S={s}")
    if kernel == "mma_long" and qkv.dtype != torch.bfloat16:
        raise ValueError(f"the mma_long kernel does not take {qkv.dtype}")
    if not qkv.is_contiguous():
        raise ValueError("fused_attention needs a contiguous qkv tensor")
    if qkv.data_ptr() % 16:
        raise ValueError(f"the {kernel} kernel needs 16-byte aligned qkv rows "
                         f"(data_ptr % 16 = {qkv.data_ptr() % 16})")


def _lib_fn(lib_name: str, fn_name: str, argtypes):
    return _build.bind(lib_name, {fn_name: argtypes})[fn_name]


def attention_fwd_mma(qkv: torch.Tensor) -> torch.Tensor:
    """K2 on the tensor cores for bf16 qkv [B, S, 3, H, D], S <= MMA_MAX_SEQ,
    D in {32, 64}. A CPU tensor takes the plain version. Counts its launches
    in ``attention_fwd_mma.launches`` and ``fused_attention.launches``."""
    if qkv.device.type == "cpu":
        return attention_reference(qkv)
    _check_qkv(qkv, "mma")
    b, s, _, h, d = qkv.shape
    out = torch.empty((b, s, h, d), dtype=qkv.dtype, device=qkv.device)
    fn = _lib_fn("attention_mma", "attention_mma_fwd",
                 [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                  ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    _build.check(fn(qkv.data_ptr(), out.data_ptr(), b, s, h, d,
                    qk_scale(d, qkv.dtype), stream), "attention_mma_fwd launch")
    attention_fwd_mma.launches += 1
    fused_attention.launches += 1
    return out


def attention_fwd_mma_long(qkv: torch.Tensor) -> torch.Tensor:
    """K2 on the tensor cores for bf16 qkv [B, S, 3, H, D] of any S, D in
    {32, 64}: two passes over streamed 64-key tiles in one launch (the row
    max and sum, then the normalised weights times V). ``kernel_for`` sends
    it every bf16 qkv with S > MMA_MAX_SEQ. A CPU tensor takes the plain
    version. Counts its launches in ``attention_fwd_mma_long.launches`` and
    ``fused_attention.launches``."""
    if qkv.device.type == "cpu":
        return attention_reference(qkv)
    _check_qkv(qkv, "mma_long")
    b, s, _, h, d = qkv.shape
    out = torch.empty((b, s, h, d), dtype=qkv.dtype, device=qkv.device)
    fn = _lib_fn("attention_mma_long", "attention_mma_long_fwd",
                 [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                  ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    _build.check(fn(qkv.data_ptr(), out.data_ptr(), b, s, h, d,
                    qk_scale(d, qkv.dtype), stream), "attention_mma_long_fwd launch")
    attention_fwd_mma_long.launches += 1
    fused_attention.launches += 1
    return out


def attention_fwd_scalar(qkv: torch.Tensor) -> torch.Tensor:
    """K2 on the CUDA cores for float32 or bf16 qkv [B, S, 3, H, D] of any S,
    D in {32, 64}: float32 in one pass with an online softmax, bf16 in two
    (its weights round to bf16 normalised, as the plain version's do; no
    dispatch takes this mode, which stays for comparison). A CPU tensor
    takes the plain version. Counts its launches in
    ``attention_fwd_scalar.launches`` and ``fused_attention.launches``."""
    if qkv.device.type == "cpu":
        return attention_reference(qkv)
    _check_qkv(qkv, "scalar")
    b, s, _, h, d = qkv.shape
    out = torch.empty((b, s, h, d), dtype=qkv.dtype, device=qkv.device)
    fn = _lib_fn("attention", "attention_fwd",
                 [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                  ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                  ctypes.c_void_p])
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    _build.check(fn(qkv.data_ptr(), out.data_ptr(), b, s, h, d,
                    _DTYPE_CODES[qkv.dtype], qk_scale(d, qkv.dtype), stream),
                 "attention_fwd launch")
    attention_fwd_scalar.launches += 1
    fused_attention.launches += 1
    return out


_KERNELS = {"mma": attention_fwd_mma, "mma_long": attention_fwd_mma_long,
            "scalar": attention_fwd_scalar}


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv):
        ctx.save_for_backward(qkv)
        if qkv.device.type == "cpu":
            return attention_reference(qkv)
        if qkv.device.type != "cuda":
            raise ValueError(f"unsupported device {qkv.device}")
        if qkv.dim() != 5 or qkv.shape[2] != 3:
            raise ValueError(f"expected qkv [B, S, 3, H, D], got {tuple(qkv.shape)}")
        return _KERNELS[kernel_for(qkv.dtype, qkv.shape[1], qkv.shape[-1])](qkv)

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
    launches the K2 variant ``kernel_for`` picks for a CUDA tensor and uses
    the plain version for a CPU one; the backward recomputes through the
    plain version. ``fused_attention.launches`` counts the launches of every
    variant."""
    return _FusedAttention.apply(qkv)


fused_attention.launches = 0
attention_fwd_mma.launches = 0
attention_fwd_mma_long.launches = 0
attention_fwd_scalar.launches = 0
