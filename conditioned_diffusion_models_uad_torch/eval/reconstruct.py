"""Volume reconstruction for the eval chain (counterpart of
``conditioned_diffusion_models_uad_tpu/eval/reconstruct.py``).

Depth is folded into the batch (reference src/models/DDPM_2D.py:193-257) and
padded up to a multiple of ``depth_bucket`` with edge-replicated slices, so
volumes of nearby depths share the UNet's batch shapes. A group of G
same-shape volumes is stacked, but each volume goes through the encoder and
UNet in a call of its own (``task.reconstruct_with_aux`` on that volume's
padded stack with its own draws, E * padded depth rows in the UNet) and the
results are concatenated: a volume's rows see the same shapes alone, in any
group and on any rank, so cuDNN, cuBLAS and oneDNN take the same algorithms
and reduction splits for them, and the rows are bit for bit the same
whatever ``eval.volumes_per_call`` and the rank count (the JAX package's
dispatch-invariance contract, tests/test_dispatch_invariance.py). In
``batch_call_scored`` the group is then scored on the same device by
``fused.group_eval_core`` (per volume too); its packed buffer is the group's
one host fetch.

Where the JAX reconstructor takes keys ([2], or [G, 2] of fold_in(key, i)),
this one takes the draws its task's reconstruction takes, one row a volume,
or a ``torch.Generator`` to draw them from (``task.draw_seeds``): simplex
seeds [G, E] for the cDDPM's single-shot reconstruction on the hash noise
path, the JAX-package keys [G, 2] of fold_in(key, i) for its iterative and
patched (``patched=True``: ``reconstruct_patched_with_aux``) ones, for table
noise and for SparK.

Within a process group (``parallel/mesh.py``) ``batch_call`` and
``batch_call_scored`` are volume-parallel when the group's G volumes divide
by the world size (rank r reconstructs, and scores, its contiguous share of
the volumes, and the results are gathered), so they equal one process's bit
for bit. ``__call__`` of one volume, and ``batch_call`` of a group that does
not divide, are slice-parallel as the JAX package's mesh program is: each
volume's bucketed depth, a multiple of the world size, is split into
contiguous parts, rank r reconstructs part r of every volume with the
volume's own draws, and the parts are gathered. That is the one path whose
rows depend on the layout: a rank's part runs at 1/W of the volume's rows.
Every rank calls each method with the same arguments and gets the whole
result.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..parallel.mesh import all_gather_cat, pad_to_multiple, sharded, world
from ..utils.device import DeviceLike, resolve_device, to_tensor
from ..utils.profiling import span
from .fused import group_eval_core

__all__ = ["VolumeReconstructor", "pad_to_multiple"]


class VolumeReconstructor:
    """``task.reconstruct_with_aux`` over the slice stack of a [H, W, D]
    volume in [0, 1]. ``num_eval_slices`` centre-crops the depth axis first
    (reference DDPM_2D.py:193-203). Runs on ``cuda`` unless ``device`` says
    otherwise; the task must live on the same kind of device."""

    def __init__(self, task, depth_bucket: int = 8, num_eval_slices: Optional[int] = None,
                 patched: bool = False, device: DeviceLike = None):
        self.device = resolve_device(device)
        if task.device.type != self.device.type:
            raise ValueError(f"task is on {task.device}, reconstructor on {self.device}")
        self.task = task
        self.patched = patched
        self._reconstruct = (task.reconstruct_patched_with_aux if patched
                             else task.reconstruct_with_aux)
        self.num_eval_slices = num_eval_slices
        # the process group's (rank, size) at construction, as the JAX
        # reconstructor binds its mesh; depth pads to a multiple of the size
        self.rank, self.size = world()
        self.depth_multiple = max(int(depth_bucket), self.size) // self.size * self.size

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
        """The task's draws for ``groups`` volumes, one row a volume (the
        task checks the row width)."""
        if seeds is None:
            if generator is None:
                raise ValueError("pass seeds (one row a volume) or a torch.Generator")
            if self.patched:
                return self.task.draw_seeds(generator, groups, keys=True)
            return self.task.draw_seeds(generator, groups)
        seeds = torch.as_tensor(seeds)
        if seeds.dim() != 2 or seeds.shape[0] != groups:
            raise ValueError(f"seeds must have {groups} rows, got {tuple(seeds.shape)}")
        return seeds

    def _per_volume(self, slices: torch.Tensor, draws, g: int):
        """(reco, aux) of a stack of ``g`` volumes' slices [g * n, H, W, 1]:
        each volume's n slices reconstructed in a call of their own with its
        own draws, the results concatenated in volume order."""
        if g == 1:
            return self._reconstruct(slices, draws)
        n = slices.shape[0] // g
        outs = [self._reconstruct(slices[v * n:(v + 1) * n], draws[v:v + 1])
                for v in range(g)]
        return (torch.cat([reco for reco, _ in outs]),
                {k: torch.cat([aux[k] for _, aux in outs]) for k in outs[0][1]})

    def _run(self, slices: torch.Tensor, draws, g: int):
        """The reconstruction (reco, aux) of a stack of ``g`` volumes' slices
        [g * pad, H, W, 1], a call a volume. Within a process group it is
        volume-parallel when ``g`` divides by the world size (rank r takes
        its contiguous share of the volumes) and otherwise slice-parallel
        (rank r takes part r of each volume's ``pad`` slices; ``task.shard``
        tells the task which part of each volume's draws it computes)."""
        if self.size == 1:
            return self._per_volume(slices, draws, g)
        rank, size = self.rank, self.size
        pad = slices.shape[0] // g
        rest = slices.shape[1:]
        volume_parallel = g % size == 0
        if volume_parallel:
            per = g // size
            lo = rank * per
            reco, aux = self._per_volume(slices[lo * pad:(lo + per) * pad],
                                         draws[lo:lo + per], per)
        else:
            part = pad // size
            local = slices.reshape(g, pad, *rest)[:, rank * part:(rank + 1) * part]
            with sharded(self.task, rank, size):
                reco, aux = self._per_volume(local.reshape(g * part, *rest), draws, g)

        def whole(t):  # every rank's rows -> [g * pad, ...] in volume order
            if t.numel() == 0:
                return t.new_zeros((g * pad, *t.shape[1:]))
            full = all_gather_cat(t)
            if volume_parallel:  # rank order is volume order
                return full
            full = full.reshape(size, g, part, *t.shape[1:])
            return full.transpose(0, 1).reshape(g * pad, *t.shape[1:])

        return whole(reco), {k: whole(v) for k, v in aux.items()}

    def __call__(self, vol_hwd, seeds=None, *, generator: Optional[torch.Generator] = None,
                 return_aux: bool = False):
        """Reconstruct one volume with seeds [1, E] (or drawn from
        ``generator``): reco [H, W, D] on the device, and with ``return_aux``
        {'loss', 'latent'}, the eval-forward diffusion loss and the
        slice-mean conditioning latent over the true depth (padding slices
        left out, reference DDPM_2D.py:251-278). Within a process group it is
        slice-parallel: the one path whose rows depend on the world size."""
        slices, d = self._prep(vol_hwd)
        slices, _ = pad_to_multiple(slices, self.depth_multiple, axis=0)
        reco, aux = self._run(slices, self._seeds(seeds, generator, 1), 1)
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
        """Reconstruct several same-resolution volumes, a model call each;
        seeds [G, E], one row a volume, so each volume reconstructs bit for
        bit as it does alone. Returns [(reco_hwd, {'loss', 'latent'})] in
        input order."""
        slices, pad, depths = self._stack(vols)
        g = len(depths)
        reco, aux = self._run(slices, self._seeds(seeds, generator, g), g)
        out = []
        for i, d in enumerate(depths):
            sl = slice(i * pad, (i + 1) * pad)
            out.append((reco[sl][:d, ..., 0].movedim(0, -1), self._aux_out(aux, sl, d)))
        return out

    def latent_len(self) -> int:
        """Width of the conditioning latent in the packed buffer (the
        patched reconstruction's zeros column is 1 wide)."""
        return 1 if self.patched else self.task.latent_len

    def batch_call_scored(self, subs, flags: dict, seeds=None, *,
                          generator: Optional[torch.Generator] = None):
        """Reconstruct AND score a group of same-shape subjects. ``subs`` are
        eval subject dicts (vol / vol_orig / mask_orig / seg_orig, host
        arrays or tensors); seeds [G, E]; ``flags`` is
        ``EvalSession._fused_flags(...)``. Returns (diff [G, H, W, D],
        packed [G, B] uint8), both on the device: fetch ``packed`` once.
        Within a process group G must divide by its size: rank r scores
        volumes [r * G / size, (r + 1) * G / size) and every rank gets the
        whole group's gathered buffers."""
        draws = self._seeds(seeds, generator, len(subs))
        if self.size == 1:
            return self._scored(subs, flags, draws)
        if len(subs) % self.size:
            raise ValueError(f"a group of {len(subs)} volumes does not split into "
                             f"{self.size} ranks")
        part = len(subs) // self.size
        lo = self.rank * part
        diff, packed = self._scored(subs[lo:lo + part], flags, draws[lo:lo + part])
        return all_gather_cat(diff), all_gather_cat(packed)

    def _scored(self, subs, flags: dict, draws):
        slices, pad, depths = self._stack([s["vol"] for s in subs])
        g = len(subs)
        d = depths[0]
        with span("eval.recon"):
            reco, aux = self._per_volume(slices, draws, g)
        h, w = reco.shape[1], reco.shape[2]
        reco_g = reco[..., 0].reshape(g, pad, h, w)[:, :d].movedim(1, -1)  # [G, H, W, d]
        loss_g = aux["loss_per_slice"].reshape(g, pad)[:, :d].mean(dim=1)
        lat = aux["latent_per_slice"]
        latent_g = lat.reshape(g, pad, lat.shape[-1])[:, :d].mean(dim=1)

        def stacked(key):
            return torch.stack([to_tensor(s[key], torch.float32, self.device) for s in subs])

        th_rec = torch.full((g,), flags["th_record"], dtype=torch.float32, device=self.device)
        th_app = torch.full((g,), flags["th_apply"], dtype=torch.float32, device=self.device)
        with span("eval.score"):
            return group_eval_core(
                stacked("vol_orig"), reco_g, stacked("mask_orig"), stacked("seg_orig"),
                th_rec, th_app, loss_g, latent_g, **flags["statics"],
            )
