"""Device resolution for the port's entry points.

The default device is ``cuda``. Without a CUDA device the entry points raise
unless the caller asked for the CPU explicitly: nothing carries on quietly on
the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``. A CUDA device without CUDA raises RuntimeError."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


def to_tensor(x, dtype: torch.dtype, device: DeviceLike = None) -> torch.Tensor:
    """``x`` as a ``dtype`` tensor. A tensor stays on its device unless
    ``device`` names another; a host array (numpy, list, scalar) goes to
    ``resolve_device(device)``."""
    if torch.is_tensor(x):
        return x.to(dtype=dtype) if device is None else x.to(resolve_device(device), dtype)
    return torch.as_tensor(np.asarray(x), device=resolve_device(device)).to(dtype)
