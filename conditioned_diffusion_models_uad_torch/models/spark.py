"""SparK masked-image-modeling pretraining (sparse-conv MAE) of the ResNet
conditioning encoder (counterpart of
``conditioned_diffusion_models_uad_tpu/models/spark.py``; reference
src/models/modules/spark/Spark_2D.py, decoder.py, encoder.py).

* random patch masking on the stride-32 feature grid: training masks come
  from a ``torch.Generator``, eval masks from a JAX-package key through
  ``utils/prng.py`` (``random_mask_from_key``), bit-equal to that package's
* hierarchical masked encoding: dense convolutions with masked outputs
  (``resnet.ResNetBackbone.pyramid`` with ``active``)
* per level: BatchNorm over the active sites, a learned mask token at the
  inactive ones (+ an optional sin-cos position embedding), a 1x1 (level 0)
  or 3x3 projection to the decoder's width
* ``LightDecoder``: five transposed-conv upsampling stages summing in the
  pyramid, a 1x1 head
* patch-space loss over the masked patches (or all), with optional per-patch
  pixel normalisation

Modules take and return NHWC slices as the JAX package's do and compute in
NCHW (``channels_last``). Flax's ``ConvTranspose((4, 4), strides 2,
padding 'SAME')`` is ``conv_transpose2d(stride=2, padding=1)`` with the
kernel flipped in both spatial axes and laid out [in, out, kh, kw]
(``utils/convert_jax.py``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils import prng
from .resnet import MaskedBatchNorm, ResNetBackbone, ResNetConfig, upsample_mask
from .unet import Conv2d


@dataclasses.dataclass(frozen=True)
class SparKConfig:
    backbone: str = "resnet50"
    input_size: int = 96
    in_channels: int = 1
    mask_ratio: float = 0.65
    dec_dim: int = 128
    pyramid: int = 4
    pix_norm: int = 0  # 0: off, 1: per-patch norm, 2: mean-shift
    loss_l2: bool = True
    dense_loss: bool = False
    use_pos_emb: bool = False
    dtype: str = "float32"
    # 'float32': BN normalize in f32; 'compute': folded a·x+b in compute dtype
    norm_precision: str = "float32"

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def fold_norm(self) -> bool:
        return self.norm_precision == "compute"

    @property
    def downsample_ratio(self) -> int:
        return 32

    @property
    def fmap_size(self) -> int:
        return self.input_size // self.downsample_ratio

    @property
    def len_keep(self) -> int:
        f = self.fmap_size
        return round(f * f * (1 - self.mask_ratio))


def _keep_lowest(scores: torch.Tensor, len_keep, fmap_size: int) -> torch.Tensor:
    """Active where a site's rank among its row's scores is below
    ``len_keep``: bool [B, f, f]."""
    ranks = scores.argsort(dim=1, stable=True).argsort(dim=1, stable=True)
    return (ranks < len_keep).reshape(scores.shape[0], fmap_size, fmap_size)


def random_mask(generator: torch.Generator, batch: int, fmap_size: int,
                len_keep: int) -> torch.Tensor:
    """Per-sample active-site grid with exactly ``len_keep`` active sites
    (reference SparK_2D.mask, Spark_2D.py:139-141): bool [B, f, f] on the
    generator's device."""
    scores = torch.rand((batch, fmap_size * fmap_size), generator=generator,
                        device=generator.device)
    return _keep_lowest(scores, len_keep, fmap_size)


def random_mask_from_key(key, batch: int, fmap_size: int, len_keep: int) -> torch.Tensor:
    """``random_mask`` of the JAX package for its key [2] (uint32), bit for
    bit: ranks of ``uniform(key, (batch, f²))``. Bool [B, f, f] on the CPU."""
    scores = prng.uniform(key, (batch, fmap_size * fmap_size))
    ranks = np.argsort(np.argsort(scores, axis=1, kind="stable"), axis=1, kind="stable")
    return torch.from_numpy((ranks < len_keep).reshape(batch, fmap_size, fmap_size))


def random_mask_uniform_ratio(generator: torch.Generator, batch: int, fmap_size: int,
                              lo: float, hi: float) -> torch.Tensor:
    """Ranged-ratio variant (reference mask(), Spark_2D.py:125-127): one
    ratio r ~ U(lo, hi) per call; keep round(f² (1 - r)) sites."""
    f2 = fmap_size * fmap_size
    dev = generator.device
    r = lo + (hi - lo) * torch.rand((), generator=generator, device=dev)
    len_keep = torch.round(f2 * (1.0 - r)).to(torch.int32)
    scores = torch.rand((batch, f2), generator=generator, device=dev)
    return _keep_lowest(scores, len_keep, fmap_size)


def random_mask_multi_ratio(generator: torch.Generator, batch: int, fmap_size: int,
                            ratios=(0.55, 0.65, 0.75)) -> torch.Tensor:
    """Per-batch-third ratio variant (reference mask(), Spark_2D.py:129-137):
    the batch in thirds, each third Bernoulli-masked at one of the (permuted)
    ratios, with one site per sample kept active."""
    dev = generator.device
    perm = torch.randperm(3, generator=generator, device=dev)
    ratios = torch.tensor(ratios, dtype=torch.float32, device=dev)[perm]
    thirds = torch.from_numpy(np.linspace(0, batch, 4).astype(np.int32)).to(dev)
    third = torch.searchsorted(thirds[1:], torch.arange(batch, dtype=torch.int32, device=dev),
                               right=True).clamp(0, 2)
    r = ratios[third][:, None, None]
    active = torch.rand((batch, fmap_size, fmap_size), generator=generator, device=dev) >= r
    rr, cc = torch.randint(0, fmap_size, (2, batch), generator=generator, device=dev)
    active[torch.arange(batch, device=dev), rr, cc] = True
    return active


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int) -> np.ndarray:
    """2D sin-cos position embedding table [grid*grid, embed_dim] (row-major
    sites; the first half of the channels encodes the column)."""
    def emb_1d(dim, pos):
        omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
        omega = 1.0 / 10000**omega
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    g = np.arange(grid_size, dtype=np.float32)
    grid = np.stack(np.meshgrid(g, g), axis=0).reshape(2, -1)
    emb = np.concatenate(
        [emb_1d(embed_dim // 2, grid[0]), emb_1d(embed_dim // 2, grid[1])], axis=1
    )
    return emb.astype(np.float32)


def relu6(x: torch.Tensor) -> torch.Tensor:
    """min(relu(x), 6), the ReLU through this module's ``F`` (which
    ``utils/decisions.py`` can record and replay)."""
    return F.relu(x).clamp_max(6.0)


class ConvTranspose2d(nn.ConvTranspose2d):
    """ConvTranspose2d with float32 parameters applied in the input's dtype."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(x, self.weight.to(x.dtype), b, self.stride, self.padding)


class UNetBlock2x(nn.Module):
    """conv-BN-ReLU6 twice, the middle width = cin (reference
    decoder.py:17-31)."""

    def __init__(self, cin: int, cout: int, last_act: bool, bn):
        super().__init__()
        self.last_act = last_act
        self.conv1 = Conv2d(cin, cin, 3, padding=1, bias=False)
        self.bn1 = bn(cin)
        self.conv2 = Conv2d(cin, cout, 3, padding=1, bias=False)
        self.bn2 = bn(cout)

    def forward(self, x):
        h = relu6(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        return relu6(h) if self.last_act else h


class DecoderStage(nn.Module):
    """2x transposed-conv upsample + UNetBlock2x (reference decoder.py:34-43)."""

    def __init__(self, cin: int, cout: int, bn):
        super().__init__()
        self.up = ConvTranspose2d(cin, cin, 4, stride=2, padding=1, bias=True)
        self.block = UNetBlock2x(cin, cout, False, bn)

    def forward(self, x):
        return self.block(self.up(x))


class LightDecoder(nn.Module):
    """Five upsampling stages of widths dec_dim/2^i, summing in the pyramid
    features (smallest first), and a 1x1 projection to one channel
    (reference decoder.py:46-76)."""

    def __init__(self, dec_dim: int, bn, num_stages: int = 5):
        super().__init__()
        ch = [dec_dim // 2**i for i in range(num_stages + 1)]
        self.stages = nn.ModuleList(DecoderStage(ch[i], ch[i + 1], bn)
                                    for i in range(num_stages))
        self.proj = Conv2d(ch[-1], 1, 1, bias=True)

    def forward(self, to_dec: List[Optional[torch.Tensor]]):
        x = None
        for i, stage in enumerate(self.stages):
            if i < len(to_dec) and to_dec[i] is not None:
                x = to_dec[i] if x is None else x + to_dec[i]
            x = stage(x)
        return self.proj(x)


def patchify(bhwc: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, (H/p)*(W/p), p*p*C]."""
    b, h, w, c = bhwc.shape
    fh, fw = h // patch, w // patch
    x = bhwc.reshape(b, fh, patch, fw, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, fh * fw, patch * patch * c)


def unpatchify(bln: torch.Tensor, patch: int, fmap: int) -> torch.Tensor:
    """[B, f*f, p*p*C] -> [B, f*p, f*p, C]."""
    b, _, n = bln.shape
    c = n // (patch * patch)
    x = bln.reshape(b, fmap, fmap, patch, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, fmap * patch, fmap * patch, c)


class SparKModel(nn.Module):
    """Masked encode -> densify -> decode (reference SparK_2D.forward,
    Spark_2D.py:143-178). ``forward(x, active)`` takes x [B, H, W, 1] and the
    active grid [B, f, f] (bool) and returns the reconstruction [B, H, W, 1]
    float32. BatchNorm follows the module's ``training`` mode."""

    def __init__(self, cfg: SparKConfig):
        super().__init__()
        self.cfg = cfg
        dt, fold = cfg.compute_dtype, cfg.fold_norm

        def bn(c):
            return MaskedBatchNorm(c, dtype=dt, fold_apply=fold)

        rcfg = ResNetConfig(variant=cfg.backbone, in_channels=cfg.in_channels,
                            dtype=cfg.dtype, norm_precision=cfg.norm_precision)
        self.encoder = ResNetBackbone(rcfg)
        feas = [rcfg.fea_dim // 2**i for i in range(cfg.pyramid)]
        self.densify_bn = nn.ModuleList(bn(c) for c in feas)
        self.mask_token = nn.ParameterList(
            nn.Parameter(nn.init.trunc_normal_(torch.empty(1, c, 1, 1), std=0.02,
                                               a=-0.04, b=0.04))
            for c in feas)
        self.densify_proj = nn.ModuleList(
            Conv2d(c, cfg.dec_dim // 2**i, 1 if i == 0 else 3, padding=0 if i == 0 else 1,
                   bias=True)
            for i, c in enumerate(feas))
        if cfg.use_pos_emb:
            for i, c in enumerate(feas):
                g = cfg.fmap_size * 2**i
                pe = torch.from_numpy(get_2d_sincos_pos_embed(c, g))
                self.register_buffer(f"pos_emb{i}", pe.reshape(g, g, c).permute(2, 0, 1)[None],
                                     persistent=False)
        self.decoder = LightDecoder(cfg.dec_dim, bn)

    def forward(self, x, active):
        dt = self.cfg.compute_dtype
        xc = x.permute(0, 3, 1, 2)
        x_masked = xc.to(dt) * upsample_mask(active, xc.shape[2], xc.shape[3]).to(dt)
        feats = self.encoder.pyramid(x_masked, active)[::-1]  # smallest first
        to_dec = []
        for i in range(self.cfg.pyramid):
            bcff = feats[i]
            m = upsample_mask(active, bcff.shape[2], bcff.shape[3])
            h = self.densify_bn[i](bcff, m)
            token = self.mask_token[i].to(h.dtype)
            if self.cfg.use_pos_emb:
                token = token + getattr(self, f"pos_emb{i}").to(h.dtype)
            h = torch.where(m.bool(), h, token)
            to_dec.append(self.densify_proj[i](h))
        return self.decoder(to_dec).float().permute(0, 2, 3, 1)


def spark_spatial_loss(cfg: SparKConfig, inp, rec, active, per_sample: bool = False):
    """Patch-space reconstruction loss (reference spatial_loss,
    Spark_2D.py:180-199): optional per-patch pixel normalisation, L2 or L1,
    the mean over masked patches (or all patches with ``dense_loss``).
    ``per_sample=True`` returns one value a slice [B]."""
    p = cfg.downsample_ratio
    inp = inp.float()
    inp_p = patchify(inp, p)
    rec_p = patchify(rec.float(), p)
    if cfg.pix_norm == 2:
        rec_p = patchify(rec.float() + inp.mean(dim=(1, 2), keepdim=True), p)
    if cfg.pix_norm == 1:
        mean = inp_p.mean(dim=-1, keepdim=True)
        std = (inp_p.var(dim=-1, unbiased=False, keepdim=True) + 1e-6) ** 0.5
        inp_p = (inp_p - mean) / std
    err = (rec_p - inp_p) ** 2 if cfg.loss_l2 else (rec_p - inp_p).abs()
    if cfg.dense_loss:
        return err.mean(dim=(1, 2)) if per_sample else err.mean()
    per_patch = err.mean(dim=2)  # [B, L]
    non_active = 1.0 - active.reshape(active.shape[0], -1).float()
    if per_sample:
        return (per_patch * non_active).sum(dim=1) / (non_active.sum(dim=1) + 1e-8)
    return (per_patch * non_active).sum() / (non_active.sum() + 1e-8)
