"""The ResBlock's output sum with its convolutions' biases, in one pass (the
port's own kernel, ``csrc/residual.cu``; no TPU kernel computes it).

``residual_bias_sum_reference`` is the plain version: ATen's chain that it
replaces, ``(s + b_skip) + (h + b_out)`` with each add rounded to the
tensors' dtype, as cuDNN's convolutions add their bias in a pass of their own
and ``ResBlock`` then adds the two outputs. ``residual_bias_sum`` launches
the kernel for CUDA tensors, writing into h unless given ``out``, and takes
the plain version only for CPU tensors. ``models/unet.py::ResBlock`` calls
it on the card wherever ``takes_fused_residual`` holds.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# both biases in float32 within a block's default 48 KB of shared memory
# (csrc/residual.cu::residual_max_channels)
MAX_CHANNELS = 6144

_ARGTYPES = {
    "residual_bias_sum": [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                                  ctypes.c_int, ctypes.c_void_p],
    "residual_max_channels": [],
}


@functools.lru_cache(maxsize=None)
def _fns():
    return _build.bind("residual", _ARGTYPES)


def channels_fit(c: int, dtype: torch.dtype) -> bool:
    """Whether the kernel takes C channels of ``dtype``: bfloat16 or float32,
    C a whole number of 16-byte vectors and at most MAX_CHANNELS."""
    if dtype not in _DTYPE_CODES:
        return False
    itemsize = torch.empty((), dtype=dtype).element_size()
    return 0 < c <= MAX_CHANNELS and (c * itemsize) % 16 == 0


def residual_bias_sum_reference(s: torch.Tensor, h: torch.Tensor,
                                b_skip: Optional[torch.Tensor],
                                b_out: torch.Tensor) -> torch.Tensor:
    """s, h [B, C, H, W]; biases [C], cast to s's dtype; b_skip None for an
    identity skip. Returns r(r(s + b_skip) + r(h + b_out))."""
    c = s.shape[1]
    t = s if b_skip is None else s + b_skip.to(s.dtype).reshape(1, c, 1, 1)
    return t + (h + b_out.to(h.dtype).reshape(1, c, 1, 1))


def _check(s: torch.Tensor, h: torch.Tensor, out: torch.Tensor) -> None:
    for name, t in (("s", s), ("h", h), ("out", out)):
        if t.dim() != 4 or t.shape != s.shape or t.dtype != s.dtype or t.device != s.device:
            raise ValueError(f"residual_bias_sum: {name} {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}, s {tuple(s.shape)} {s.dtype} on {s.device}")
        if not t.is_contiguous(memory_format=torch.channels_last) or t.data_ptr() % 16:
            raise ValueError(f"residual_bias_sum: {name} must be channels_last-contiguous "
                             "and 16-byte aligned")
    if not channels_fit(s.shape[1], s.dtype):
        raise ValueError(f"residual_bias_sum takes bfloat16 or float32 with C a multiple "
                         f"of 16 bytes up to {MAX_CHANNELS}, got C={s.shape[1]} {s.dtype}")
    if out.data_ptr() == s.data_ptr():
        raise ValueError("residual_bias_sum never writes into s")


def residual_bias_sum(s: torch.Tensor, h: torch.Tensor, b_skip: Optional[torch.Tensor],
                      b_out: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """r(r(s + b_skip) + r(h + b_out)) for s, h [B, C, H, W] channels_last
    (the skip's and the out convolution's outputs without their bias, or x
    for s and None for b_skip with an identity skip) and biases [C] of any
    float dtype, cast to s's as ``Conv2d.forward`` casts them. On the card
    one launch of ``csrc/residual.cu`` into ``out`` (h's storage by default),
    bit-equal to the plain version; a layout it does not take raises.
    ``residual_bias_sum.launches`` counts the launches."""
    if s.device.type == "cpu":
        return residual_bias_sum_reference(s, h, b_skip, b_out)
    out = h if out is None else out
    _check(s, h, out)
    dt = s.dtype
    b_out = b_out.to(device=s.device, dtype=dt).contiguous()
    if b_skip is not None:
        b_skip = b_skip.to(device=s.device, dtype=dt).contiguous()
    b, c, hh, ww = s.shape
    stream = torch.cuda.current_stream(s.device).cuda_stream
    _build.check(_fns()["residual_bias_sum"](
        s.data_ptr(), h.data_ptr(), None if b_skip is None else b_skip.data_ptr(),
        b_out.data_ptr(), out.data_ptr(), b * hh * ww, c, _DTYPE_CODES[dt], stream),
        "residual_bias_sum launch")
    residual_bias_sum.launches += 1
    return out


def max_channels_on_card() -> int:
    """The kernel's own MAX_CHANNELS."""
    return _fns()["residual_max_channels"]()


residual_bias_sum.launches = 0
