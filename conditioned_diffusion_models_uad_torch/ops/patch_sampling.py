"""Patch boxes of the patched DDPM (pDDPM) (counterpart of
``conditioned_diffusion_models_uad_tpu/ops/patch_sampling.py``; reference
src/utils/patch_sampling.py).

Boxes are [N, 4] int32 ``(x0, y0, x1, y1)``, made into masks by
``diffusion.gaussian.box_to_mask``: ``sample_single_box`` one random box a
training sample, ``grid_boxes`` and ``grid_boxes_cut`` the static eval
grids, ``paste_patches`` the eval reconstruction from the per-box ones.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch


def sample_single_box(generator: torch.Generator, batch: int, image_hw: Tuple[int, int],
                      patch_hw: Tuple[int, int]) -> torch.Tensor:
    """One uniform patch position a sample, the box fully inside the image:
    x0 in [0, W - pw], y0 in [0, H - ph], drawn from ``generator`` on its
    device. int32 [batch, 4]."""
    (h, w), (ph, pw) = image_hw, patch_hw
    dev = generator.device
    x0 = torch.randint(0, max(w - pw, 0) + 1, (batch,), generator=generator, device=dev)
    y0 = torch.randint(0, max(h - ph, 0) + 1, (batch,), generator=generator, device=dev)
    return torch.stack([x0, y0, x0 + pw, y0 + ph], dim=1).int()


def grid_boxes(image_hw: Tuple[int, int], patch_hw: Tuple[int, int],
               equalize_overlap: bool = True) -> np.ndarray:
    """The eval grid of patch-sized boxes covering the image, row-major
    (y outer). With ``equalize_overlap`` the starts are spread evenly, so
    the overlap is shared out instead of piling up at the far border.
    int32 [N, 4]."""
    (h, w), (ph, pw) = image_hw, patch_hw

    def starts(size, p):
        n = max(1, math.ceil(size / p))
        if n == 1 or size <= p:
            return [0]
        if equalize_overlap:
            return [round(i * (size - p) / (n - 1)) for i in range(n)]
        return [min(i * p, size - p) for i in range(n)]

    return np.asarray([(x0, y0, x0 + pw, y0 + ph) for y0 in starts(h, ph)
                       for x0 in starts(w, pw)], dtype=np.int32)


def grid_boxes_cut(image_hw: Tuple[int, int], patch_hw: Tuple[int, int]) -> np.ndarray:
    """Non-overlapping tiles at multiples of the patch size, clipped at the
    image border. int32 [N, 4]."""
    (h, w), (ph, pw) = image_hw, patch_hw
    return np.asarray([(x0, y0, min(x0 + pw, w), min(y0 + ph, h))
                       for y0 in range(0, h, ph) for x0 in range(0, w, pw)], dtype=np.int32)


def paste_patches(reco_patches: torch.Tensor, originals: torch.Tensor, boxes,
                  aggregate: str = "avg") -> torch.Tensor:
    """The reconstruction [B, H, W, C] from per-box ones [N, B, H, W, C]:
    'avg' averages the boxes that cover a pixel, 'cut' lets a later box
    overwrite an earlier one; a pixel no box covers keeps ``originals``."""
    from ..diffusion.gaussian import box_to_mask

    _, h, w, _ = originals.shape
    boxes = torch.as_tensor(np.asarray(boxes), device=originals.device)
    masks = box_to_mask(boxes, h, w)[:, None].float()  # [N, 1, H, W, 1]
    if aggregate == "avg":
        num = (reco_patches * masks).sum(dim=0)
        den = masks.sum(dim=0)
        return torch.where(den > 0, num / torch.clamp_min(den, 1.0), originals)
    if aggregate != "cut":
        raise ValueError(f"unknown patch aggregation {aggregate!r} (avg | cut)")
    out = originals
    for i in range(reco_patches.shape[0]):
        out = torch.where(masks[i].bool(), reco_patches[i], out)
    return out
