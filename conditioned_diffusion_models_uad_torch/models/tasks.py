"""The tasks (counterpart of ``conditioned_diffusion_models_uad_tpu/models/
tasks.py``): the cDDPM (conditioning encoder + UNet + schedule) with its
single-shot and iterative (ancestral / DDIM) volume reconstructions and its
training objective, the patched DDPM (pDDPM: ``patched=True``, the
unconditional UNet noised and reconstructed a patch at a time) and the
unconditional DDPM (``condition=False``), SparK pretraining of the encoder,
and the import of the pretrained encoder into the cDDPM.

Where the JAX task takes a PRNG key ([2], or [G, 2] for G grouped volumes),
this one takes explicit draws, one row a volume, or a ``torch.Generator``
from which it draws them (``draw_seeds``):
* simplex seeds ``[G, E]`` (int32, one per volume and noise draw, uniform in
  [0, 2**31 - 1) like ``randint(key, (), 0, int32max)`` in the JAX package)
  for the single-shot reconstruction on the hash noise path;
* the JAX package's keys ``[G, 2]`` (int64 holding the uint32 words) for
  the iterative and patched reconstructions, and for every mode under
  ``noise_impl='table'``: the task splits each volume's key chain on the host
  as the JAX task does (``utils/prng.py``), and on the hash path turns each
  key into its seed with ``randint``;
* a ``TrainDraws`` for a training step, with the UNet's dropout keep masks
  when ``dropout_unet > 0``.
SparK takes per-volume keys [G, 2] for a reconstruction (its eval masks,
bit-equal to that package's) and a ``SparkDraws`` for a training step.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..data.augment import AugDraws, FullAugDraws, draw_aug
from ..diffusion import (
    GaussianDiffusionConfig,
    box_to_mask,
    ddim_sample,
    diffusion_call,
    make_schedule,
    normalize_to_neg_one_to_one,
    p_sample_loop,
)
from ..ops.patch_sampling import grid_boxes, grid_boxes_cut, paste_patches, sample_single_box
from ..ops.simplex import make_noise_fn
from ..utils import prng
from ..utils.device import DeviceLike, resolve_device
from ..utils.profiling import span
from .losses import l1_ae_loss, l1_error
from .resnet import ResNetConfig, ResNetEncoder
from .spark import (
    SparKConfig,
    SparKModel,
    random_mask,
    random_mask_from_key,
    random_mask_multi_ratio,
    random_mask_uniform_ratio,
    spark_spatial_loss,
)
from .unet import UNetConfig, UNetModel

INT32_MAX = 2**31 - 1
RECO_MODES = ("single_shot", "ancestral", "ddim")


def key_stack(keys) -> np.ndarray:
    """Per-volume keys [G, 2] (uint32 words, or int64 holding them; a
    tensor or an array) as uint32."""
    keys = prng.key_words(keys)
    if keys.ndim != 2 or keys.shape[1] != 2:
        raise ValueError(f"keys must be [G, 2], got {keys.shape}")
    return keys


@dataclasses.dataclass(frozen=True)
class DDPMTaskConfig:
    """The cDDPM knobs this port reads (same names and defaults as the JAX
    package's ``DDPMTaskConfig``; experiments cDDPM/DDPM_cond_spark_2D,
    cDDPM/DDPM and cDDPM/DDPM_patched)."""

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
    num_eval_slices: Optional[int] = None  # centre depth crop at eval
    # 'single_shot' (one forward at fixed t) | 'ancestral' | 'ddim'
    # (truncated reverse sampling from t = test_timesteps)
    reco_mode: str = "single_shot"
    sampling_steps: int = 50  # DDIM steps of reco_mode 'ddim'
    # patched (pDDPM) variant, off for the cDDPM
    patched: bool = False
    patch_hw: Tuple[int, int] = (48, 48)
    grid_boxes_eval: str = "equalized"  # 'equalized' | 'cut'
    patch_aggregation: str = "avg"  # 'avg' | 'cut'
    inpaint: bool = False
    unet_dim: int = 128
    num_res_blocks: int = 3
    channel_mult: Sequence[int] = (1, 2, 2)
    attention_resolutions: Sequence[int] = (3, 6, 12)
    spatial_transformer: bool = False
    use_checkpoint: bool = False  # per-ResBlock recompute in training
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
        for name, allowed in (("reco_mode", RECO_MODES),
                              ("grid_boxes_eval", ("equalized", "cut")),
                              ("patch_aggregation", ("avg", "cut"))):
            if getattr(self, name) not in allowed:
                raise ValueError(f"DDPMTaskConfig.{name}={getattr(self, name)!r} "
                                 f"is not one of {allowed}")

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
            use_checkpoint=self.use_checkpoint,
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
    """The random draws of one training step: t [B] in [0, timesteps), the
    noise draw (one field a step, broadcast over the batch): a simplex seed
    [1] int32 on the hash path, a key [1, 2] (int64 words) under
    ``noise_impl='table'``; the augmentation draws (None: no augmentation;
    an ``AugDraws`` for the intensity policy, a ``FullAugDraws`` for the
    full set); for the pDDPM the patch boxes [B, 4] int32 (x0, y0, x1, y1);
    and with UNet dropout in training, one bool keep mask a ResBlock
    ([B, C, H, W] in ``UNetModel.dropout_shapes`` order, the order of
    flax's dropout sites)."""

    t: torch.Tensor
    seed: torch.Tensor
    aug: Optional[AugDraws | FullAugDraws] = None
    box: Optional[torch.Tensor] = None
    dropout: Optional[Sequence[torch.Tensor]] = None


class DDPMTask(nn.Module):
    """The conditioned-DDPM anomaly-detection task, and its patched and
    unconditional variants.

    ``DDPMTask(cfg)`` runs on ``cuda``; ``device="cpu"`` runs on the CPU.
    ``noise_impl`` picks the simplex path (``ops/simplex.py::make_noise_fn``):
    'hash' (kernel K1 on the card) or 'table' (the JAX package's CPU path,
    for tests against that package's numbers). Weights start as in the JAX
    package's ``init`` layout (zero output convs, BN stats mean 0 / var 1);
    load trained ones with ``load_state_dict`` (see
    ``utils/convert_jax.py``). The module stays in eval mode; ``encode`` and
    ``loss`` put the encoder's BatchNorm in the mode their ``train`` argument
    asks for during the call and restore the previous mode after it, as the
    JAX task passes ``train`` to each apply, so no result depends on
    ``nn.Module.train``/``eval``; the UNet has no mode: its dropout runs
    in a training ``loss`` from the draws' keep masks."""

    def __init__(self, cfg: DDPMTaskConfig = DDPMTaskConfig(),
                 device: DeviceLike = None, noise_impl: str = "hash"):
        super().__init__()
        self.device = resolve_device(device)
        self.cfg = cfg
        self.noise_impl = noise_impl
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
        self.gd_cfg = GaussianDiffusionConfig(cfg.objective, cfg.loss_type, inpaint=cfg.inpaint)
        self.noise_fn = make_noise_fn(cfg.noisetype, cfg.simplex_octaves,
                                      cfg.simplex_persistence, cfg.simplex_frequency,
                                      impl=noise_impl)

    # (rank, world size) of the batches this task is given: set by
    # ``parallel.mesh.sharded`` while a rank computes its part of a batch
    shard = (0, 1)

    def _noise(self, draws: torch.Tensor, shape) -> torch.Tensor:
        """``noise_fn(draws, shape)``. Under a shard (rank r of W) each
        draw's block of B samples is rank r's part of the block of W * B
        the draw was made for: a simplex field is the same over its block,
        white noise is drawn for the whole block and sliced."""
        r, w = self.shard
        if w == 1 or self.cfg.noisetype == "simplex":
            return self.noise_fn(draws, shape)
        b = shape[0]
        full = self.noise_fn(draws, (b * w, *shape[1:]))
        return full.reshape(-1, w, b, *shape[1:])[:, r].reshape(-1, *shape[1:])

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

    @property
    def latent_len(self) -> int:
        """Width of ``reconstruct_with_aux``'s 'latent_per_slice' (the
        patched reconstruction's is 1)."""
        return self.cfg.cond_dim if self.cfg.condition else 1

    @property
    def draws_keys(self) -> bool:
        """Whether a reconstruction takes keys [G, 2] (iterative, patched or
        table noise) rather than seeds [G, E]."""
        return (self.noise_impl == "table" or self.cfg.patched
                or self.cfg.reco_mode != "single_shot")

    def key_noise(self, keys, shape) -> torch.Tensor:
        """Noise [N*B, H, W, C] from keys [N, 2] (uint32 words), block n from
        key n over ``shape``'s B samples: the table path on the keys
        themselves, the hash path on their seeds ``randint(key, (), 0,
        2**31 - 1)`` (all N fields from one kernel launch on the card), as
        the JAX package's Pallas path turns a key into its seed."""
        keys = np.asarray(keys, dtype=np.uint32).reshape(-1, 2)
        if self.noise_impl == "table":
            draws = torch.from_numpy(keys.astype(np.int64))
        else:
            draws = torch.from_numpy(prng.randint(keys))
        return self._noise(draws.to(self.device), tuple(shape))

    def draw_seeds(self, generator: torch.Generator, groups: int = 1,
                   keys: Optional[bool] = None) -> torch.Tensor:
        """A reconstruction's draws for ``groups`` volumes: keys [groups, 2]
        uniform in [0, 2**32) (int64) when ``keys`` (default:
        ``draws_keys``), else simplex seeds [groups, E] uniform in
        [0, 2**31 - 1)."""
        if self.draws_keys if keys is None else keys:
            return torch.randint(0, 2**32, (groups, 2), generator=generator,
                                 dtype=torch.int64, device=generator.device)
        return torch.randint(0, INT32_MAX, (groups, self.cfg.ensemble_size),
                             generator=generator, dtype=torch.int32,
                             device=generator.device)

    def draw_dropout(self, generator: torch.Generator, b: int):
        """Keep masks of the UNet's ResBlocks for a batch of ``b``, on the
        generator's device: uniform < 1 - dropout_unet, as flax's bernoulli
        draws them, each drawn [B, H, W, C] and returned as its NCHW view."""
        keep = 1.0 - self.cfg.dropout_unet
        h, w = self.cfg.image_hw
        return [(torch.rand((n, hh, ww, c), generator=generator, device=generator.device)
                 < keep).permute(0, 3, 1, 2)
                for n, c, hh, ww in self.unet.dropout_shapes(b, h, w)]

    def draw_train(self, generator: torch.Generator, b: int, *,
                   augment=True) -> TrainDraws:
        """One training step's draws for a batch of ``b``, on the generator's
        device: the noise draw (a seed uniform in [0, 2**31 - 1), or a key
        under table noise), t uniform in [0, timesteps), the augmentation's
        (``augment``: True for aug_intensity, 'full' for the full set, False
        for none), for the pDDPM one patch box a sample, and with
        ``dropout_unet > 0`` the dropout keep masks (a validation ``loss``
        ignores them)."""
        dev = generator.device
        if self.noise_impl == "table":
            seed = torch.randint(0, 2**32, (1, 2), generator=generator, dtype=torch.int64,
                                 device=dev)
        else:
            seed = torch.randint(0, INT32_MAX, (1,), generator=generator, dtype=torch.int32,
                                 device=dev)
        t = torch.randint(0, self.cfg.timesteps, (b,), generator=generator, device=dev)
        aug = draw_aug(generator, b, self.cfg.image_hw, augment)
        box = (sample_single_box(generator, b, self.cfg.image_hw, self.cfg.patch_hw)
               if self.cfg.patched else None)
        dropout = self.draw_dropout(generator, b) if self.cfg.dropout_unet > 0 else None
        return TrainDraws(t, seed, aug, box, dropout)

    def _train_noise(self, draw: torch.Tensor, shape) -> torch.Tensor:
        if self.noise_impl == "table":
            return self._noise(draw.reshape(1, 2).to(self.device), shape)
        return self._noise(draw.reshape(1).to(device=self.device, dtype=torch.int32), shape)

    def loss(self, batch: dict, draws: TrainDraws, *, train: bool = True):
        """The training (``train=True``) or validation objective on a batch
        ``{'vol': [B, H, W, 1] in [0, 1]}`` at the draws' t and noise (and,
        for the pDDPM, with only the draws' boxes noised). Returns (scalar
        loss, {'reco': [B, H, W, 1]}). Training normalises the encoder with
        batch statistics and updates its running ones; validation uses the
        running ones. With ``dropout_unet > 0`` training applies the
        draws' dropout masks (which it needs). Gradients flow to every
        parameter; augmentation is the caller's (``train/loop.py``)."""
        cfg = self.cfg
        model = self.unet
        if train and cfg.dropout_unet > 0:
            if draws.dropout is None:
                raise ValueError("UNet dropout in training needs the draws' keep masks "
                                 "(TrainDraws.dropout, from draw_train)")
            model = functools.partial(self.unet,
                                      dropout=[m.to(self.device) for m in draws.dropout])
        x01 = batch["vol"].to(self.device).float()
        with span("task.encode"):
            cond = self.encode(x01, train=train)
        with span("task.noise"):
            noise = self._train_noise(draws.seed, tuple(x01.shape))
        box_mask = None
        if cfg.patched:
            if draws.box is None:
                raise ValueError("the patched task's draws need boxes (TrainDraws.box)")
            box_mask = box_to_mask(draws.box.to(self.device), *cfg.image_hw)
        with span("task.unet"):
            loss, reco = diffusion_call(self.sched, self.gd_cfg, model, x01,
                                        t=draws.t.to(self.device), cond=cond, noise=noise,
                                        box_mask=box_mask)
        return loss, {"reco": reco}

    def _eval_draws(self, draws, generator, groups, depth, keys: bool = False):
        """The reconstruction's draws, one row a volume: keys [G, 2] (uint32,
        on the host) when ``keys`` or ``draws_keys``, else seeds [G, E] on
        the device."""
        keys = keys or self.draws_keys
        if draws is None:
            if generator is None:
                raise ValueError("pass the draws (one row a volume) or a torch.Generator")
            draws = self.draw_seeds(generator, groups, keys)
        if keys:
            draws = key_stack(draws)
        else:
            e = self.cfg.ensemble_size
            if draws.dim() != 2 or draws.shape[1] != e:
                raise ValueError(f"seeds must be [G, {e}], got {tuple(draws.shape)}")
            draws = draws.to(device=self.device, dtype=torch.int32)
        if depth % draws.shape[0]:
            raise ValueError(f"depth {depth} does not split into {draws.shape[0]} volumes")
        return draws

    @torch.no_grad()
    def reconstruct(self, slices01, seeds=None, *, generator=None, groups: int = 1):
        """The reconstruction [D, H, W, 1] in [0, 1] (see
        ``reconstruct_with_aux``)."""
        return self.reconstruct_with_aux(slices01, seeds, generator=generator,
                                         groups=groups)[0]

    @torch.no_grad()
    def reconstruct_with_aux(
        self,
        slices01: torch.Tensor,  # [D, H, W, 1]: G same-depth volumes stacked
        seeds: Optional[torch.Tensor] = None,  # [G, E] int32 or keys [G, 2]
        *,
        generator: Optional[torch.Generator] = None,
        groups: int = 1,
    ):
        """Reconstruction of a slice stack of G same-depth volumes. Returns
        (reco, aux): reco [D, H, W, 1] in [0, 1]; aux 'loss_per_slice' [D]
        and 'latent_per_slice' [D, cond_dim] (the conditioning vector; a
        zeros column when unconditional).

        Single-shot: at fixed t, with the noise ensemble over t in
        step_ensemble flattened into the batch (one UNet call at batch E*D)
        and averaged; the loss is the LAST member's. Noise is member-major
        over the G volumes: block (m, v) is volume v's m-th field (seed
        ``seeds[v, m]``, or key ``split(keys[v], E)[m]``), broadcast over its
        D // G slices, so a volume reconstructs the same whichever group it
        rides in. All E*G fields come from one noise-kernel launch.

        Iterative (``reco_mode`` 'ancestral' or 'ddim'): the stack noised to
        test_timesteps from each volume's key, then the ancestral chain (or
        ``sampling_steps`` DDIM steps) back to x0, one UNet call and one
        noise launch a step. No single diffusion loss exists on a chain:
        'loss_per_slice' is NaN."""
        cfg = self.cfg
        slices01 = slices01.to(self.device)
        d, h, w, c = slices01.shape
        draws = self._eval_draws(seeds, generator, groups, d)
        g = draws.shape[0]
        with span("task.encode"):
            cond = self.encode(slices01)
        latent = (cond.float() if cond is not None
                  else torch.zeros((d, 1), dtype=torch.float32, device=self.device))
        sub = (d // g, h, w, c)

        if cfg.reco_mode != "single_shot":
            aux = {"loss_per_slice": torch.full((d,), float("nan"), device=self.device),
                   "latent_per_slice": latent}
            x_start = normalize_to_neg_one_to_one(slices01.float())
            kw = dict(key=draws, noise_fn=self.key_noise, cond=cond,
                      start_t=cfg.test_timesteps, x_start=x_start)
            with span("task.unet"):  # the chain draws its noise a step at a time
                if cfg.reco_mode == "ddim":
                    return ddim_sample(self.sched, self.gd_cfg, self.unet,
                                       tuple(slices01.shape),
                                       sampling_timesteps=cfg.sampling_steps, **kw), aux
                return p_sample_loop(self.sched, self.gd_cfg, self.unet, tuple(slices01.shape),
                                     **kw), aux

        e = cfg.ensemble_size
        ensemble = cfg.noise_ensemble and len(cfg.step_ensemble) > 0
        with span("task.noise"):
            if not self.draws_keys:
                noises = self._noise(draws.t().reshape(-1), sub)  # [E*D, H, W, C]
            elif ensemble:
                noises = self.key_noise(prng.split_keys(draws, e).reshape(-1, 2), sub)
            else:  # one field a volume straight from its key
                noises = self.key_noise(draws, sub)
        if ensemble:
            t_vec = torch.tensor([t - 1 for t in cfg.step_ensemble],
                                 device=self.device).repeat_interleave(d)
            imgs = slices01.repeat(e, 1, 1, 1)
            conds = None if cond is None else cond.repeat(e, 1)
            with span("task.unet"):
                loss_ps, reco = diffusion_call(
                    self.sched, self.gd_cfg, self.unet, imgs,
                    t=t_vec, cond=conds, noise=noises, reduce=False,
                )
            aux = {"loss_per_slice": loss_ps.reshape(e, d)[-1],
                   "latent_per_slice": latent}
            return reco.reshape(e, d, h, w, -1).mean(dim=0), aux

        with span("task.unet"):
            loss_ps, reco = diffusion_call(
                self.sched, self.gd_cfg, self.unet, slices01,
                t=cfg.test_timesteps - 1, cond=cond, noise=noises, reduce=False,
            )
        return reco, {"loss_per_slice": loss_ps, "latent_per_slice": latent}

    def eval_boxes(self) -> np.ndarray:
        """The pDDPM eval grid [N, 4] (``grid_boxes_eval``)."""
        cfg = self.cfg
        if cfg.grid_boxes_eval == "cut":
            return grid_boxes_cut(cfg.image_hw, cfg.patch_hw)
        return grid_boxes(cfg.image_hw, cfg.patch_hw, equalize_overlap=True)

    @torch.no_grad()
    def reconstruct_patched(self, slices01, keys=None, *, generator=None, groups: int = 1):
        """The pDDPM reconstruction [D, H, W, 1] (see
        ``reconstruct_patched_with_aux``)."""
        return self.reconstruct_patched_with_aux(slices01, keys, generator=generator,
                                                 groups=groups)[0]

    @torch.no_grad()
    def reconstruct_patched_with_aux(self, slices01: torch.Tensor, keys=None, *,
                                     generator: Optional[torch.Generator] = None,
                                     groups: int = 1):
        """pDDPM eval (reference DDPM_2D_patched.py:173-216): each box of the
        static grid is noised at test_timesteps with the rest of the image
        clean and denoised, and the box reconstructions are pasted together
        (``patch_aggregation``). The boxes run in chunks flattened into the
        batch, the chunk being the largest divisor of the grid size with at
        most 512 // D boxes, so a chunk is one UNet call and one noise launch.
        Box b of volume v draws its noise from ``split(keys[v], N)[b]``.
        aux: 'loss_per_slice' is the LAST box's diffusion loss (the
        reference's box loop overwrites it) and 'latent_per_slice' a zeros
        column [D, 1]."""
        cfg = self.cfg
        slices01 = slices01.to(self.device)
        d, h, w, c = slices01.shape
        keys = self._eval_draws(keys, generator, groups, d, keys=True)
        g = keys.shape[0]
        boxes = self.eval_boxes()
        n = boxes.shape[0]
        max_chunk = max(1, 512 // max(d, 1))
        chunk = next((k for k in range(min(n, max_chunk), 0, -1) if n % k == 0), 1)
        cond = self.encode(slices01)
        box_keys = prng.split_keys(keys, n)  # [n, G, 2]
        masks = box_to_mask(torch.from_numpy(boxes).to(self.device), h, w)
        sub = (d // g, h, w, c)
        recos = []
        for b0 in range(0, n, chunk):
            noise = self.key_noise(box_keys[b0:b0 + chunk].reshape(-1, 2), sub)
            loss_ps, reco = diffusion_call(
                self.sched, self.gd_cfg, self.unet, slices01.repeat(chunk, 1, 1, 1),
                t=cfg.test_timesteps - 1,
                cond=None if cond is None else cond.repeat(chunk, 1), noise=noise,
                box_mask=masks[b0:b0 + chunk].repeat_interleave(d, dim=0), reduce=False,
            )
            recos.append(reco.reshape(chunk, d, h, w, -1))
        aux = {"loss_per_slice": loss_ps.reshape(chunk, d)[-1],
               "latent_per_slice": torch.zeros((d, 1), dtype=torch.float32, device=self.device)}
        return paste_patches(torch.cat(recos), slices01, boxes, cfg.patch_aggregation), aux

    @torch.no_grad()
    def sample(self, shape: tuple, keys, *, cond: Optional[torch.Tensor] = None,
               x_start01: Optional[torch.Tensor] = None, start_t: int = 0,
               use_ddim: bool = False, sampling_timesteps: Optional[int] = None):
        """Full or truncated reverse sampling (ancestral, or DDIM with
        ``sampling_timesteps`` steps, 50 by default) of ``shape`` [B, H, W,
        1] from keys [2] or per-volume [G, 2], with the task's noise a step.
        Returns [0, 1] images."""
        x_start = (normalize_to_neg_one_to_one(x_start01.to(self.device).float())
                   if x_start01 is not None else None)
        kw = dict(key=prng.key_words(keys),
                  noise_fn=self.key_noise, cond=cond, start_t=start_t, x_start=x_start)
        if use_ddim:
            return ddim_sample(self.sched, self.gd_cfg, self.unet, tuple(shape),
                               sampling_timesteps=sampling_timesteps or 50, **kw)
        return p_sample_loop(self.sched, self.gd_cfg, self.unet, tuple(shape), **kw)

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


# --------------------------------------------------------------------------- #
# SparK masked-image-modeling pretraining
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class SparkTaskConfig:
    """SparK pretraining knobs (same names and defaults as the JAX
    package's ``SparkTaskConfig``; experiment cDDPM/Spark_2D_pretrain)."""

    image_hw: Tuple[int, int] = (96, 96)
    backbone: str = "resnet50"
    mask_ratio: float = 0.65
    # ranged / multi-ratio masking (reference mask(), spark/Spark_2D.py:120-141):
    # mask_ratio_hi != mask_ratio enables the range; mask_uniform picks one
    # U(lo, hi) ratio per step, else per-batch-third ratios are permuted
    mask_ratio_hi: Optional[float] = None
    mask_uniform: bool = True
    dec_dim: int = 128
    pix_norm: int = 0
    loss_l2: bool = True
    loss_on_mask: bool = True
    mask_loss_weight: float = 1.0  # δ in full-L1 + δ·masked (ref Spark_2D.py:26-32)
    # eval score when loss_on_mask is off: L1_AE recon_error + delta_mask ·
    # masked loss (reference Spark_2D.forward, Spark_2D.py:26-33)
    delta_mask: float = 0.0
    loss_strategy: str = "sum"  # L1_AE 'sum' | 'mean'
    use_pos_emb: bool = False
    dtype: str = "bfloat16"
    # BatchNorm apply: 'float32' normalises in f32; 'compute' folds into one
    # compute-dtype a·x+b (statistics stay f32)
    norm_precision: str = "float32"
    # AdamW (reference Spark_2D.py:123-124; train/loop.py::make_optimizer)
    lr: float = 2e-4
    weight_decay: float = 0.05
    b1: float = 0.9
    b2: float = 0.95

    @property
    def spark_config(self) -> SparKConfig:
        return SparKConfig(
            backbone=self.backbone,
            input_size=self.image_hw[0],
            mask_ratio=self.mask_ratio,
            dec_dim=self.dec_dim,
            pix_norm=self.pix_norm,
            loss_l2=self.loss_l2,
            use_pos_emb=self.use_pos_emb,
            dtype=self.dtype,
            norm_precision=self.norm_precision,
        )


@dataclasses.dataclass(frozen=True)
class SparkDraws:
    """The random draws of one SparK training step: the active-site grid
    [B, f, f] (bool) and the augmentation draws (None: no augmentation; an
    ``AugDraws`` or a ``FullAugDraws``)."""

    active: torch.Tensor
    aug: Optional[AugDraws | FullAugDraws] = None


class SparkTask(nn.Module):
    """Masked-image-modeling pretraining of the conditioning encoder.

    ``SparkTask(cfg)`` runs on ``cuda``; ``device="cpu"`` runs on the CPU.
    As ``DDPMTask``, the module stays in eval mode and ``loss`` puts the
    model's BatchNorm in the mode its ``train`` argument asks for during the
    call."""

    def __init__(self, cfg: SparkTaskConfig = SparkTaskConfig(),
                 device: DeviceLike = None):
        super().__init__()
        self.device = resolve_device(device)
        self.cfg = cfg
        self.scfg = cfg.spark_config
        self.model = SparKModel(self.scfg)
        self.to(self.device, memory_format=torch.channels_last)
        self.eval()

    latent_len = 0  # SparK's test_step records no latent space
    shard = (0, 1)  # as DDPMTask.shard

    def forward(self, x01: torch.Tensor, active: torch.Tensor, *, train: bool = False):
        """The model on slices [B, H, W, 1] and the active grid, with
        BatchNorm in training (batch statistics, running ones updated) or
        eval mode: the reconstruction [B, H, W, 1] float32."""
        mode = self.model.training
        self.model.train(train)
        try:
            return self.model(x01.to(self.device), active.to(self.device))
        finally:
            self.model.train(mode)

    def draw_mask(self, generator: torch.Generator, b: int) -> torch.Tensor:
        """A training step's active grid [b, f, f]: ``len_keep`` sites a
        sample, or the ranged / multi-ratio variants when ``mask_ratio_hi``
        differs from ``mask_ratio``."""
        cfg, f = self.cfg, self.scfg.fmap_size
        if cfg.mask_ratio_hi is not None and cfg.mask_ratio_hi != cfg.mask_ratio:
            if cfg.mask_uniform:
                return random_mask_uniform_ratio(generator, b, f, cfg.mask_ratio,
                                                 cfg.mask_ratio_hi)
            return random_mask_multi_ratio(generator, b, f)
        return random_mask(generator, b, f, self.scfg.len_keep)

    def draw_train(self, generator: torch.Generator, b: int, *,
                   augment=True) -> SparkDraws:
        """One training step's draws on the generator's device: the active
        grid, and the augmentation's (``augment``: True for aug_intensity,
        'full' for the full set, False for none)."""
        active = self.draw_mask(generator, b)
        return SparkDraws(active, draw_aug(generator, b, self.cfg.image_hw, augment))

    def loss(self, batch: dict, draws: SparkDraws, *, train: bool = True):
        """The masked reconstruction objective (reference
        Spark_2D.training_step, Spark_2D.py:26-50) on ``{'vol': [B, H, W,
        1]}``: the masked-patch loss when ``loss_on_mask``, else the full L1
        plus ``mask_loss_weight`` times it. Returns (scalar, {'reco',
        'active'})."""
        cfg = self.cfg
        x01 = batch["vol"].to(self.device).float()
        active = draws.active.to(self.device)
        reco = self(x01, active, train=train)
        masked = spark_spatial_loss(self.scfg, x01, reco, active)
        loss = masked if cfg.loss_on_mask else (
            l1_error(reco, x01).mean() + cfg.mask_loss_weight * masked)
        return loss, {"reco": reco, "active": active}

    def draw_seeds(self, generator: torch.Generator, groups: int = 1) -> torch.Tensor:
        """Eval keys [groups, 2] uniform in [0, 2**32) (int64)."""
        return torch.randint(0, 2**32, (groups, 2), generator=generator, dtype=torch.int64,
                             device=generator.device)

    def eval_mask(self, keys, depth: int) -> torch.Tensor:
        """The active grid [depth, f, f] of G stacked volumes from their keys
        [G, 2]: volume v's depth // G slices take ``random_mask_from_key(
        keys[v], ...)``, so a volume draws the mask it draws alone (and the
        JAX package's mask for the same key)."""
        keys = key_stack(keys)
        g = keys.shape[0]
        if depth % g:
            raise ValueError(f"depth {depth} does not split into {g} volumes")
        f, per = self.scfg.fmap_size, depth // g
        r, w = self.shard  # rank r's part of each volume's masks
        return torch.cat([random_mask_from_key(k, per * w, f, self.scfg.len_keep)[r * per:
                                                                                (r + 1) * per]
                          for k in keys]).to(self.device)

    @torch.no_grad()
    def reconstruct(self, slices01, keys=None, *, generator=None, groups: int = 1):
        """The masked reconstruction [D, H, W, 1] (see ``reconstruct_with_aux``)."""
        return self.reconstruct_with_aux(slices01, keys, generator=generator,
                                         groups=groups)[0]

    @torch.no_grad()
    def reconstruct_with_aux(self, slices01: torch.Tensor, keys=None, *,
                             generator: Optional[torch.Generator] = None, groups: int = 1):
        """Masked reconstruction of a slice stack [D, H, W, 1] of G same-depth
        volumes, each masked from its key [G, 2] (reference Spark_2D.test_step,
        Spark_2D.py:60-116). Returns (reco, aux): aux 'loss_per_slice' [D] is
        the masked loss when ``loss_on_mask``, else L1_AE recon_error +
        ``delta_mask`` times it (Spark_2D.forward, :26-33); 'latent_per_slice'
        an empty [D, 0] column."""
        cfg = self.cfg
        if keys is None:
            if generator is None:
                raise ValueError("pass keys [G, 2] or a torch.Generator")
            keys = self.draw_seeds(generator, groups)
        x01 = slices01.to(self.device).float()
        d = x01.shape[0]
        active = self.eval_mask(keys, d)
        reco = self(x01, active)
        loss_ps = spark_spatial_loss(self.scfg, x01, reco, active, per_sample=True)
        if not cfg.loss_on_mask:
            l1 = l1_ae_loss(reco, x01, cfg.loss_strategy, per_sample=True)
            loss_ps = l1["recon_error"] + cfg.delta_mask * loss_ps
        aux = {"loss_per_slice": loss_ps,
               "latent_per_slice": torch.zeros((d, 0), dtype=torch.float32, device=self.device)}
        return reco, aux

    def anomaly_scores(self, loss: float) -> dict:
        """SparK eval scores (reference Spark_2D.test_step, :100-112): Reco
        is the forward loss; Reg and the Comb* family are 0."""
        return {"reco": loss, "reg": 0.0, "comb": 0.0, "combi": 0.0,
                "comb_prior": 0.0, "combi_prior": 0.0}


# --------------------------------------------------------------------------- #
# SparK pretrain -> cDDPM conditioning encoder
# --------------------------------------------------------------------------- #
def import_spark_encoder(ddpm_state: dict, spark_state: dict) -> dict:
    """A ``DDPMTask`` state_dict with its encoder backbone (weights and
    running statistics) replaced by the ``SparkTask`` state_dict's
    ``model.encoder.*`` and its ``encoder.fc`` head kept (the reference's
    ``sparse_encoder.sp_cnn.* -> encoder.*`` remap without ``fc``,
    DDPM_2D.py:79-96)."""
    out = dict(ddpm_state)
    for k in ddpm_state:
        if k.startswith("encoder.") and not k.startswith("encoder.fc."):
            src = "model.encoder." + k[len("encoder."):]
            if src not in spark_state:
                raise KeyError(f"{src} missing from the SparK state (another backbone?)")
            out[k] = spark_state[src]
    return out


TASKS = {
    "DDPM_2D": DDPMTask,
    "Spark_2D": SparkTask,
}
