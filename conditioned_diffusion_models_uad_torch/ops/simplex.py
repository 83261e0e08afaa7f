"""Noise sources of the diffusion process (counterpart of
``conditioned_diffusion_models_uad_tpu/ops/simplex.py``).

Only the hash-gradient simplex path (``ops/simplex_hash.py``, kernel K1) and
white Gaussian noise are ported. The permutation-table path
(``opensimplex2``, ``perm_from_seed_lcg``) is not on the GPU path yet.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

STRETCH2 = -0.211324865405187  # (1/sqrt(2+1)-1)/2
SQUISH2 = 0.366025403784439  # (sqrt(2+1)-1)/2
NORM2 = 47.0

# noise_fn(seeds [N] int32, shape (B, H, W, C)) -> [N*B, H, W, C] float32:
# block n holds seed n's noise over B samples
NoiseFn = Callable[[torch.Tensor, Tuple[int, int, int, int]], torch.Tensor]


def make_noise_fn(
    noisetype: Optional[str],
    octaves: int = 6,
    persistence: float = 0.8,
    frequency: float = 64.0,
) -> NoiseFn:
    """'simplex': one fractal field per seed, broadcast over its B samples
    and the channel (all N fields come from ONE kernel launch on CUDA).
    None/'gaussian': white noise from a generator seeded by each seed."""
    if noisetype == "simplex":
        from .simplex_hash import fractal_noise_2d

        def simplex_fn(seeds, shape):
            b, h, w, c = shape
            fields = fractal_noise_2d(seeds, (h, w), octaves, persistence, frequency)
            n = fields.shape[0]
            out = fields[:, None, :, :, None].expand(n, b, h, w, c)
            return out.reshape(n * b, h, w, c)

        return simplex_fn
    if noisetype not in (None, "gaussian"):
        raise ValueError(f"unknown noisetype {noisetype}")

    def gaussian_fn(seeds, shape):
        out = []
        for s in seeds.tolist():
            g = torch.Generator(device=seeds.device).manual_seed(int(s))
            out.append(torch.randn(shape, generator=g, device=seeds.device))
        return torch.cat(out)

    return gaussian_fn
