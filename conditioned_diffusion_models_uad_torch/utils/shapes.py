"""Shape arithmetic (counterpart of
``conditioned_diffusion_models_uad_tpu/utils/shapes.py``).

``calc_interres`` predicts intermediate feature-map resolutions after
repeated strided pooling (reference src/utils/utils.py:234-246): divide the
input dims by the rescale factor, then apply the conv/pool output formula
``num_pooling`` times."""
from __future__ import annotations

from typing import List, Sequence


def calc_interres(
    dims: Sequence[int], fac: float, num_pooling: int, k: int, p: int, s: int
) -> List[int]:
    dims = [int(x / fac) for x in dims]
    out = list(dims)
    for _ in range(num_pooling):
        out = [int((d - k + 2 * p) / s + 1) for d in out]
    return out
