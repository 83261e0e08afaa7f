"""The cDDPM task: conditioning encoder + UNet + schedule, with the
single-shot volume reconstruction the eval (and serving) path runs and the
training objective (counterpart of ``DDPMTaskConfig``/``DDPMTask`` in
``conditioned_diffusion_models_uad_tpu/models/tasks.py``).

Where the JAX task takes a PRNG key ([2], or [G, 2] for G grouped volumes),
this one takes explicit draws: for a reconstruction, simplex seeds ``[G, E]``
(int32, one per volume and noise draw) or a ``torch.Generator`` from which it
draws them, uniform in [0, 2**31 - 1) like ``randint(key, (), 0, int32max)``
in the JAX package; for a training step, a ``TrainDraws``.
Not ported yet: the iterative samplers (``reco_mode`` 'ancestral'/'ddim'),
UNet dropout in training, and the patched (pDDPM) variant.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..data.augment import AugDraws, draw_aug_intensity
from ..diffusion import GaussianDiffusionConfig, diffusion_call, make_schedule
from ..ops.simplex import make_noise_fn
from ..utils.device import DeviceLike, resolve_device
from .resnet import ResNetConfig, ResNetEncoder
from .unet import UNetConfig, UNetModel

INT32_MAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class DDPMTaskConfig:
    """The cDDPM knobs this port reads (same names and defaults as the JAX
    package's ``DDPMTaskConfig``; experiment cDDPM/DDPM_cond_spark_2D)."""

    image_hw: Tuple[int, int] = (96, 96)
    condition: bool = True
    cond_dim: int = 128
    encoder_backbone: str = "resnet50"
    timesteps: int = 1000
    beta_schedule: str = "cosine"
    objective: str = "pred_x0"
    loss_type: str = "l1"
    p2_gamma: float = 0.0
    p2_k: float = 1.0
    noisetype: Optional[str] = "simplex"
    simplex_octaves: int = 6
    simplex_persistence: float = 0.8
    simplex_frequency: float = 64.0
    test_timesteps: int = 500
    noise_ensemble: bool = True
    step_ensemble: Sequence[int] = (250, 500, 750)
    reco_mode: str = "single_shot"
    unet_dim: int = 128
    num_res_blocks: int = 3
    channel_mult: Sequence[int] = (1, 2, 2)
    attention_resolutions: Sequence[int] = (3, 6, 12)
    spatial_transformer: bool = False
    dropout_unet: float = 0.0
    fused_attention: bool = True
    norm_precision: str = "compute"
    film_fold: bool = False
    dtype: str = "bfloat16"
    lr: float = 1e-4  # Adam (train/loop.py::make_optimizer)

    def __post_init__(self):
        bad = [t for t in (*self.step_ensemble, self.test_timesteps)
               if t > self.timesteps or t < 1]
        if bad:
            raise ValueError(
                f"eval timesteps {bad} outside [1, timesteps={self.timesteps}] "
                "(step_ensemble / test_timesteps index the noise schedule "
                "1-based as t-1)"
            )
        if self.reco_mode != "single_shot":
            raise NotImplementedError(f"reco_mode={self.reco_mode!r} is not ported yet")

    @property
    def unet_config(self) -> UNetConfig:
        return UNetConfig(
            in_channels=1,
            model_channels=self.unet_dim,
            out_channels=1,
            num_res_blocks=self.num_res_blocks,
            attention_resolutions=tuple(self.attention_resolutions),
            channel_mult=tuple(self.channel_mult),
            cond_dim=self.cond_dim if self.condition else None,
            spatial_transformer=self.spatial_transformer,
            fused_attention=self.fused_attention,
            norm_precision=self.norm_precision,
            film_fold=self.film_fold,
            dropout=self.dropout_unet,
            dtype=self.dtype,
        )

    @property
    def ensemble_size(self) -> int:
        """Noise draws per volume: |step_ensemble| with the ensemble on, else 1."""
        if self.noise_ensemble and len(self.step_ensemble) > 0:
            return len(self.step_ensemble)
        return 1


@dataclasses.dataclass(frozen=True)
class TrainDraws:
    """The random draws of one training step: t [B] in [0, timesteps), one
    simplex seed [1] int32 (one noise field per step, broadcast over the
    batch) and the augmentation draws (None: no augmentation)."""

    t: torch.Tensor
    seed: torch.Tensor
    aug: Optional[AugDraws] = None


class DDPMTask(nn.Module):
    """The conditioned-DDPM anomaly-detection task.

    ``DDPMTask(cfg)`` runs on ``cuda``; ``device="cpu"`` runs on the CPU.
    Weights start as in the JAX package's ``init`` layout (zero output convs,
    BN stats mean 0 / var 1); load trained ones with ``load_state_dict`` (see
    ``utils/convert_jax.py``). The module stays in eval mode; ``encode`` and
    ``loss`` put the encoder's BatchNorm in the mode their ``train`` argument
    asks for during the call and restore the previous mode after it, as the
    JAX task passes ``train`` to each apply, so no result depends on
    ``nn.Module.train``/``eval``; the UNet has no mode (its dropout in
    training is not ported)."""

    def __init__(self, cfg: DDPMTaskConfig = DDPMTaskConfig(),
                 device: DeviceLike = None):
        super().__init__()
        self.device = resolve_device(device)
        self.cfg = cfg
        self.unet = UNetModel(cfg.unet_config)
        self.encoder = (
            ResNetEncoder(
                ResNetConfig(variant=cfg.encoder_backbone, dtype=cfg.dtype,
                             norm_precision=cfg.norm_precision),
                cond_dim=cfg.cond_dim,
            )
            if cfg.condition
            else None
        )
        self.to(self.device, memory_format=torch.channels_last)
        self.eval()
        self.sched = make_schedule(cfg.timesteps, cfg.beta_schedule, cfg.p2_gamma,
                                   cfg.p2_k, device=self.device)
        self.gd_cfg = GaussianDiffusionConfig(cfg.objective, cfg.loss_type)
        self.noise_fn = make_noise_fn(cfg.noisetype, cfg.simplex_octaves,
                                      cfg.simplex_persistence, cfg.simplex_frequency)

    def encode(self, x01: torch.Tensor, *, train: bool = False) -> Optional[torch.Tensor]:
        """Clean slices [B, H, W, 1] -> conditioning vector [B, cond_dim] f32
        (None when unconditional). ``train=True`` normalises with batch
        statistics and updates the running ones."""
        if self.encoder is None:
            return None
        mode = self.encoder.training
        self.encoder.train(train)
        try:
            return self.encoder(x01.to(self.device))
        finally:
            self.encoder.train(mode)

    def draw_seeds(self, generator: torch.Generator, groups: int = 1) -> torch.Tensor:
        """Simplex seeds [groups, E] uniform in [0, 2**31 - 1)."""
        return torch.randint(0, INT32_MAX, (groups, self.cfg.ensemble_size),
                             generator=generator, dtype=torch.int32,
                             device=generator.device)

    def draw_train(self, generator: torch.Generator, b: int, *,
                   augment: bool = True) -> TrainDraws:
        """One training step's draws for a batch of ``b``, on the generator's
        device: t uniform in [0, timesteps), one seed uniform in
        [0, 2**31 - 1), and the aug_intensity draws when ``augment``."""
        dev = generator.device
        seed = torch.randint(0, INT32_MAX, (1,), generator=generator, dtype=torch.int32,
                             device=dev)
        t = torch.randint(0, self.cfg.timesteps, (b,), generator=generator, device=dev)
        aug = draw_aug_intensity(generator, b) if augment else None
        return TrainDraws(t, seed, aug)

    def loss(self, batch: dict, draws: TrainDraws, *, train: bool = True):
        """The training (``train=True``) or validation objective on a batch
        ``{'vol': [B, H, W, 1] in [0, 1]}`` at the draws' t and noise seed.
        Returns (scalar loss, {'reco': [B, H, W, 1]}). Training normalises
        the encoder with batch statistics and updates its running ones;
        validation uses the running ones. Gradients flow to every parameter;
        augmentation is the caller's (``train/loop.py``)."""
        cfg = self.cfg
        if train and cfg.dropout_unet > 0:
            raise NotImplementedError("UNet dropout in training is not ported yet")
        x01 = batch["vol"].to(self.device).float()
        cond = self.encode(x01, train=train)
        seed = draws.seed.reshape(1).to(device=self.device, dtype=torch.int32)
        noise = self.noise_fn(seed, tuple(x01.shape))
        loss, reco = diffusion_call(self.sched, self.gd_cfg, self.unet, x01,
                                    t=draws.t.to(self.device), cond=cond, noise=noise)
        return loss, {"reco": reco}

    @torch.no_grad()
    def reconstruct(self, slices01, seeds=None, *, generator=None, groups: int = 1):
        """Single-shot reconstruction [D, H, W, 1] in [0, 1] (see
        ``reconstruct_with_aux``)."""
        return self.reconstruct_with_aux(slices01, seeds, generator=generator,
                                         groups=groups)[0]

    @torch.no_grad()
    def reconstruct_with_aux(
        self,
        slices01: torch.Tensor,  # [D, H, W, 1]: G same-depth volumes stacked
        seeds: Optional[torch.Tensor] = None,  # [G, E] int32
        *,
        generator: Optional[torch.Generator] = None,
        groups: int = 1,
    ):
        """Single-shot reconstruction of a slice stack at fixed t, with the
        noise ensemble over t in step_ensemble averaged. Returns (reco, aux):
        reco [D, H, W, 1] in [0, 1]; aux 'loss_per_slice' [D] (the LAST
        ensemble member's diffusion loss) and 'latent_per_slice' [D, cond_dim]
        (the conditioning vector; a zeros column when unconditional).

        The ensemble is flattened into the batch (one UNet call at batch
        E*D). Noise is member-major over the G volumes: block (m, v) is volume
        v's m-th field ``seeds[v, m]``, broadcast over its D//G slices — so a
        volume reconstructs the same whichever group it rides in. All E*G
        fields come from one noise-kernel launch."""
        cfg = self.cfg
        if seeds is None:
            if generator is None:
                raise ValueError("pass seeds [G, E] or a torch.Generator")
            seeds = self.draw_seeds(generator, groups)
        e = cfg.ensemble_size
        if seeds.dim() != 2 or seeds.shape[1] != e:
            raise ValueError(f"seeds must be [G, {e}], got {tuple(seeds.shape)}")
        seeds = seeds.to(device=self.device, dtype=torch.int32)
        slices01 = slices01.to(self.device)
        d, h, w, c = slices01.shape
        g = seeds.shape[0]
        if d % g:
            raise ValueError(f"depth {d} does not split into {g} volumes")

        cond = self.encode(slices01)
        latent = (cond.float() if cond is not None
                  else torch.zeros((d, 1), dtype=torch.float32, device=self.device))
        sub = (d // g, h, w, c)

        if cfg.noise_ensemble and len(cfg.step_ensemble) > 0:
            noises = self.noise_fn(seeds.t().reshape(-1), sub)  # [E*D, H, W, C]
            t_vec = torch.tensor([t - 1 for t in cfg.step_ensemble],
                                 device=self.device).repeat_interleave(d)
            imgs = slices01.repeat(e, 1, 1, 1)
            conds = None if cond is None else cond.repeat(e, 1)
            loss_ps, reco = diffusion_call(
                self.sched, self.gd_cfg, self.unet, imgs,
                t=t_vec, cond=conds, noise=noises, reduce=False,
            )
            aux = {"loss_per_slice": loss_ps.reshape(e, d)[-1],
                   "latent_per_slice": latent}
            return reco.reshape(e, d, h, w, -1).mean(dim=0), aux

        noise = self.noise_fn(seeds[:, 0].contiguous(), sub)
        loss_ps, reco = diffusion_call(
            self.sched, self.gd_cfg, self.unet, slices01,
            t=cfg.test_timesteps - 1, cond=cond, noise=noise, reduce=False,
        )
        return reco, {"loss_per_slice": loss_ps, "latent_per_slice": latent}

    def anomaly_scores(self, loss: float) -> dict:
        """Volume anomaly scores from the eval diffusion loss, used when
        ``use_postprocessed_score`` is off (reference DDPM_2D.py:251-254,
        267-280: Comb = Reg = Reco = loss; Combi = Reco·Reg; CombPrior =
        Reco + β·0; CombiPrior = Reco·0)."""
        return {
            "reco": loss,
            "reg": loss,
            "comb": loss,
            "combi": loss * loss,
            "comb_prior": loss,
            "combi_prior": 0.0,
        }
