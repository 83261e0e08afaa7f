"""3D connected components (26-connectivity) and the small-component filter
of the eval chain (counterpart of ``conditioned_diffusion_models_uad_tpu/
eval/cc.py``; reference ``skimage.label(connectivity=3)`` + area filter,
src/utils/utils_eval.py:489-503).

Label propagation with pointer jumping: every foreground voxel starts with
its flat C-order index over [H, W, D] and background with the sentinel N.
Each round takes the 3x3x3 window minimum (the 26-neighbourhood hook), puts
background back to N, and chases each label to its representative's
representative twice. At the fixed point every foreground voxel holds the
minimum flat index of its component, the same root the JAX package gives.

PyTorch has no min-pool, so the hook is ``-max_pool3d(-labels)`` over float
labels: float32 while N <= 2^24 (every index and the sentinel are exact; the
flagship scoring shape [96, 96, 50] has 460,800 voxels and full resolution
160x190x160 has 4,864,000), float64 past that. Each round's "changed?" test
is one host sync.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_F32_EXACT = 2**24  # the largest N whose indices and sentinel float32 holds exactly


def label_rounds(mask: torch.Tensor):
    """(roots int64 [H, W, D], rounds): for foreground voxels the minimum
    flat index of their component, for background H*W*D; and the number of
    propagation rounds the fixed point took (the JAX while-loop's trip
    count)."""
    h, w, d = mask.shape
    n = h * w * d
    fg = mask.reshape(n).bool()
    pool_dtype = torch.float32 if n <= _F32_EXACT else torch.float64
    sentinel = torch.tensor(n, device=mask.device)
    labels = torch.where(fg, torch.arange(n, device=mask.device), sentinel)
    padded = torch.full((n + 1,), n, device=mask.device)
    rounds = 0
    while True:
        rounds += 1
        win = -F.max_pool3d(-labels.to(pool_dtype).view(1, 1, h, w, d), 3, 1, 1)
        hooked = torch.where(fg, torch.minimum(labels, win.view(n).long()), sentinel)
        # pointer jumping, twice; roots and background are fixed points
        padded[:n] = hooked
        jumped = padded[hooked]
        padded[:n] = jumped
        jumped = padded[jumped]
        changed = bool((jumped != labels).any())
        labels = jumped
        if not changed:
            return labels.view(h, w, d), rounds


def label_components_3d(mask: torch.Tensor) -> torch.Tensor:
    """Connected-component roots of a 3D mask (26-connectivity), int64
    [H, W, D]; background holds H*W*D. Same partition as
    ``scipy.ndimage.label(structure=ones((3, 3, 3)))``."""
    return label_rounds(mask)[0]


def filter_3d_connected_components_device(mask: torch.Tensor, min_size: int = 8) -> torch.Tensor:
    """Zero out components of fewer than ``min_size`` voxels (ref
    utils_eval.py:489-503, 26-connectivity); returns bool. The sizes come
    from one count of the roots."""
    mask = mask.bool()
    n = mask.numel()
    roots = label_components_3d(mask).reshape(n)
    sizes = torch.bincount(roots, minlength=n + 1)  # background lands in slot n
    keep = mask.reshape(n) & (sizes[roots] >= min_size)
    return keep.view(mask.shape)
