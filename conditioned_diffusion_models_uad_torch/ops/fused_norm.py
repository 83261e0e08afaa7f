"""Fused GroupNorm(32) + FiLM scale-shift + SiLU (counterpart of
``conditioned_diffusion_models_uad_tpu/ops/fused_norm.py``).

``groupnorm_silu_reference`` is the plain PyTorch version of the JAX twin:
flax ``nn.GroupNorm`` math (mean and mean of squares over the group),
float32 throughout, one cast to x's dtype at the end. ``fused_groupnorm_silu``
is the wrapper: it launches kernel K3 (``csrc/fused_norm.cu``) for a CUDA
tensor and takes the plain version only for a CPU one, as the JAX function's
default takes its twin off the TPU.

The kernel mirrors the TPU kernel's own numerics, not the twin's: the square
is taken in x's dtype, the folded per-channel ``a``, ``b`` are rounded to x's
dtype before ``x*a + b``, and the SiLU runs in y's dtype. In float32 it
matches the plain version to ~1e-6; in bfloat16 to one or two bf16 ulps.

No model of either package calls this op: the UNets keep their unfused
GroupNorm, whose eps and rounding differ (``models/unet.py::GroupNorm32``).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

Film = Optional[Tuple[torch.Tensor, torch.Tensor]]


def groupnorm_silu_reference(x: torch.Tensor, gamma: torch.Tensor,
                             beta: torch.Tensor, film: Film = None, *,
                             groups: int = 32, eps: float = 1e-6,
                             apply_silu: bool = True) -> torch.Tensor:
    """Plain version, x [B, N, C] -> [B, N, C] in x's dtype."""
    b, n, c = x.shape
    xf = x.float().reshape(b, n, groups, c // groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    mean2 = (xf * xf).mean(dim=(1, 3), keepdim=True)
    var = mean2 - mean * mean
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, n, c)
    y = y * gamma.float() + beta.float()
    if film is not None:
        fs, fsh = film
        y = y * (1.0 + fs.float()[:, None, :]) + fsh.float()[:, None, :]
    if apply_silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def _vec(x: torch.Tensor) -> int:
    """Elements a thread moves at once: 16 bytes where C and the pointer allow."""
    v = 16 // x.element_size()
    return v if x.shape[-1] % v == 0 and x.data_ptr() % 16 == 0 else 1


def _fused_cuda(x, gamma, beta, film, groups, eps, apply_silu):
    b, n, c = x.shape
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"fused_groupnorm_silu takes float32 or bfloat16, got {x.dtype}")
    if c % groups:
        raise ValueError(f"channels {c} do not split into {groups} groups")
    if not x.is_contiguous():
        raise ValueError("fused_groupnorm_silu needs a contiguous x")
    dev = x.device
    gamma = gamma.to(device=dev, dtype=torch.float32).contiguous()
    beta = beta.to(device=dev, dtype=torch.float32).contiguous()
    if gamma.shape != (c,) or beta.shape != (c,):
        raise ValueError(f"gamma and beta must be [{c}]")
    fs = fsh = None
    film_rows = 0
    if film is not None:
        fs, fsh = (f.to(device=dev, dtype=torch.float32).contiguous() for f in film)
        film_rows = fs.shape[0]
        if fs.shape != (film_rows, c) or fsh.shape != fs.shape or film_rows not in (1, b):
            raise ValueError(f"film must be two [1 or {b}, {c}] tensors")
    vec = _vec(x)
    lib = _build.load("fused_norm")
    tiles_fn = lib.fused_groupnorm_tiles
    tiles_fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    tiles_fn.restype = ctypes.c_int
    tiles = tiles_fn(n, c, vec)
    partial = torch.empty((b, tiles, groups, 2), dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    fn = lib.fused_groupnorm_silu
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p] + \
        [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(fn(x.data_ptr(), partial.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                    None if fs is None else fs.data_ptr(),
                    None if fsh is None else fsh.data_ptr(), film_rows,
                    out.data_ptr(), b, n, c, groups, _DTYPE_CODES[x.dtype], vec,
                    eps, int(apply_silu), stream),
                 "fused_groupnorm_silu launch")
    fused_groupnorm_silu.launches += 1
    return out


def fused_groupnorm_silu(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                         film: Film = None, *, groups: int = 32, eps: float = 1e-6,
                         apply_silu: bool = True) -> torch.Tensor:
    """GroupNorm + optional FiLM ``y*(1+scale)+shift`` + optional SiLU.

    x: [B, H, W, C] or [B, N, C], float32 or bfloat16; gamma, beta [C];
    film = (scale, shift), each [B or 1, C] of any float dtype. Returns x's
    shape and dtype. Launches K3 for a CUDA tensor (one call of the C entry
    point, two kernels); the plain version serves a CPU tensor only.
    ``fused_groupnorm_silu.launches`` counts the calls that launched K3."""
    shape = x.shape
    if x.dim() == 4:
        x = x.reshape(shape[0], shape[1] * shape[2], shape[3])
    if x.dim() != 3:
        raise ValueError(f"x must be [B, H, W, C] or [B, N, C], got {tuple(shape)}")
    if x.device.type == "cpu":
        out = groupnorm_silu_reference(x, gamma, beta, film, groups=groups, eps=eps,
                                       apply_silu=apply_silu)
    elif x.device.type == "cuda":
        out = _fused_cuda(x, gamma, beta, film, groups, eps, apply_silu)
    else:
        raise ValueError(f"unsupported device {x.device}")
    return out.reshape(shape)


fused_groupnorm_silu.launches = 0
