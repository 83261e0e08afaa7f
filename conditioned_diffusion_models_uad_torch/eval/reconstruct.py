"""Volume reconstruction for the eval chain (counterpart of
``conditioned_diffusion_models_uad_tpu/eval/reconstruct.py``).

Depth is folded into the batch (reference src/models/DDPM_2D.py:193-257) and
padded up to a multiple of ``depth_bucket`` with edge-replicated slices, so
volumes of nearby depths share the UNet's batch shapes. A group of G
same-shape volumes runs as one reconstruction (one UNet call at batch
E * G * padded depth) and, in ``batch_call_scored``, is scored on the same
device by ``fused.group_eval_core``; its packed buffer is the group's one
host fetch.

Where the JAX reconstructor takes keys ([2], or [G, 2] of fold_in(key, i)),
this one takes simplex seeds [G, E] or a ``torch.Generator``, as
``DDPMTask.reconstruct_with_aux`` does. One card: no mesh.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..utils.device import DeviceLike, resolve_device, to_tensor
from .fused import group_eval_core


def pad_to_multiple(x: torch.Tensor, multiple: int, axis: int = 0):
    """Pad ``axis`` up to a multiple of ``multiple`` by repeating its last
    entry; returns (padded, original size)."""
    n = x.shape[axis]
    target = -(-n // multiple) * multiple
    if target == n:
        return x, n
    edge = x.narrow(axis, n - 1, 1)
    reps = [1] * x.dim()
    reps[axis] = target - n
    return torch.cat([x, edge.repeat(*reps)], dim=axis), n


class VolumeReconstructor:
    """``task.reconstruct_with_aux`` over the slice stack of a [H, W, D]
    volume in [0, 1]. ``num_eval_slices`` centre-crops the depth axis first
    (reference DDPM_2D.py:193-203). Runs on ``cuda`` unless ``device`` says
    otherwise; the task must live on the same kind of device."""

    def __init__(self, task, depth_bucket: int = 8, num_eval_slices: Optional[int] = None,
                 patched: bool = False, device: DeviceLike = None):
        if patched:
            raise NotImplementedError("the patched (pDDPM) reconstruction is not ported yet")
        self.device = resolve_device(device)
        if task.device.type != self.device.type:
            raise ValueError(f"task is on {task.device}, reconstructor on {self.device}")
        self.task = task
        self.num_eval_slices = num_eval_slices
        self.depth_multiple = max(int(depth_bucket), 1)

    def _prep(self, vol_hwd):
        """[H, W, D] volume (host array or tensor) -> ([D, H, W, 1] float32
        slice stack on the device, true depth)."""
        vol = to_tensor(vol_hwd, torch.float32, self.device)
        if self.num_eval_slices is not None and self.num_eval_slices < vol.shape[-1]:
            start = (vol.shape[-1] - self.num_eval_slices) // 2
            vol = vol[..., start:start + self.num_eval_slices]
        return vol.movedim(-1, 0)[..., None], vol.shape[-1]

    @staticmethod
    def _aux_out(aux, sl, d):
        latent = aux["latent_per_slice"][sl][:d]
        return {
            "loss": aux["loss_per_slice"][sl][:d].mean(),
            "latent": latent.mean(dim=0) if latent.shape[-1] else None,
        }

    def _seeds(self, seeds, generator, groups):
        if seeds is None:
            if generator is None:
                raise ValueError("pass seeds [G, E] or a torch.Generator")
            return self.task.draw_seeds(generator, groups)
        seeds = torch.as_tensor(seeds, dtype=torch.int32)
        if seeds.dim() != 2 or seeds.shape[0] != groups:
            raise ValueError(f"seeds must be [{groups}, E], got {tuple(seeds.shape)}")
        return seeds

    def __call__(self, vol_hwd, seeds=None, *, generator: Optional[torch.Generator] = None,
                 return_aux: bool = False):
        """Reconstruct one volume with seeds [1, E] (or drawn from
        ``generator``): reco [H, W, D] on the device, and with
        ``return_aux`` {'loss', 'latent'}, the eval-forward diffusion loss
        and the slice-mean conditioning latent over the true depth (padding
        slices left out, reference DDPM_2D.py:251-278)."""
        slices, d = self._prep(vol_hwd)
        slices, _ = pad_to_multiple(slices, self.depth_multiple, axis=0)
        reco, aux = self.task.reconstruct_with_aux(slices, self._seeds(seeds, generator, 1))
        reco_hwd = reco[:d, ..., 0].movedim(0, -1)
        if not return_aux:
            return reco_hwd
        return reco_hwd, self._aux_out(aux, slice(None), d)

    def _stack(self, vols):
        """The volumes' slice stacks, each padded to the group's common
        bucketed depth and concatenated: ([G * pad, H, W, 1], pad, depths)."""
        preps = [self._prep(v) for v in vols]
        pad = max(-(-p.shape[0] // self.depth_multiple) * self.depth_multiple
                  for p, _ in preps)
        stacks = [pad_to_multiple(p, pad, axis=0)[0] for p, _ in preps]
        return torch.cat(stacks, dim=0), pad, [d for _, d in preps]

    def batch_call(self, vols, seeds=None, *, generator: Optional[torch.Generator] = None):
        """Reconstruct several same-resolution volumes in one call; seeds
        [G, E], one row a volume, so each volume reconstructs as it would
        alone. Returns [(reco_hwd, {'loss', 'latent'})] in input order."""
        slices, pad, depths = self._stack(vols)
        g = len(depths)
        reco, aux = self.task.reconstruct_with_aux(slices, self._seeds(seeds, generator, g))
        out = []
        for i, d in enumerate(depths):
            sl = slice(i * pad, (i + 1) * pad)
            out.append((reco[sl][:d, ..., 0].movedim(0, -1), self._aux_out(aux, sl, d)))
        return out

    def latent_len(self) -> int:
        """Width of the conditioning latent in the packed buffer."""
        cfg = self.task.cfg
        return cfg.cond_dim if cfg.condition else 1

    def batch_call_scored(self, subs, flags: dict, seeds=None, *,
                          generator: Optional[torch.Generator] = None):
        """Reconstruct AND score a group of same-shape subjects. ``subs`` are
        eval subject dicts (vol / vol_orig / mask_orig / seg_orig, host
        arrays or tensors); seeds [G, E]; ``flags`` is
        ``EvalSession._fused_flags(...)``. Returns (diff [G, H, W, D],
        packed [G, B] uint8), both on the device: fetch ``packed`` once."""
        slices, pad, depths = self._stack([s["vol"] for s in subs])
        g = len(subs)
        d = depths[0]
        reco, aux = self.task.reconstruct_with_aux(slices, self._seeds(seeds, generator, g))
        h, w = reco.shape[1], reco.shape[2]
        reco_g = reco[..., 0].reshape(g, pad, h, w)[:, :d].movedim(1, -1)  # [G, H, W, d]
        loss_g = aux["loss_per_slice"].reshape(g, pad)[:, :d].mean(dim=1)
        lat = aux["latent_per_slice"]
        latent_g = lat.reshape(g, pad, lat.shape[-1])[:, :d].mean(dim=1)

        def stacked(key):
            return torch.stack([to_tensor(s[key], torch.float32, self.device) for s in subs])

        th_rec = torch.full((g,), flags["th_record"], dtype=torch.float32, device=self.device)
        th_app = torch.full((g,), flags["th_apply"], dtype=torch.float32, device=self.device)
        return group_eval_core(
            stacked("vol_orig"), reco_g, stacked("mask_orig"), stacked("seg_orig"),
            th_rec, th_app, loss_g, latent_g, **flags["statics"],
        )
