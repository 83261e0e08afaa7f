"""Guided-diffusion UNet of the cDDPM (counterpart of
``conditioned_diffusion_models_uad_tpu/models/unet.py``).

Module and parameter names follow the reference torch UNet
(``time_embed``, ``label_emb``, ``input_blocks.N.M``, ``middle_block``,
``output_blocks.N.M``, ``out``; ResBlocks with ``in_layers``/``emb_layers``/
``out_layers``/``skip_connection``; attention with ``norm``/``qkv``/
``proj_out`` as ``Conv1d(k=1)`` in the head-major qkv layout), so the JAX
package's ``utils/convert_torch.py`` reads this module's ``state_dict``.

Parameters are float32; each layer casts its weights to the compute dtype of
its input, as flax's ``dtype=`` does. Activations are NCHW in
``channels_last`` memory format. ``use_checkpoint`` recomputes each
ResBlock's forward in the backward pass (the JAX package's ``nn.remat``)
whenever gradients are recorded. Not ported yet: ``film_fold``, the
``spatial_transformer`` attention sites, the conv up/down variants
(``resblock_updown=False``) and ``use_scale_shift_norm=False``; they raise
NotImplementedError.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import fused_attention, qk_scale


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: int = 10000):
    """Sinusoidal timestep embeddings [B] -> [B, dim] f32 (cos half, then sin)."""
    half = dim // 2
    ar = torch.arange(half, dtype=torch.float32, device=timesteps.device)
    freqs = torch.exp(-math.log(max_period) * ar / half)
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class Conv2d(nn.Conv2d):
    """Conv2d with float32 parameters applied in the input's dtype."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), b, self.stride, self.padding)


class Linear(nn.Linear):
    """Linear with float32 parameters applied in the input's dtype."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class GroupNorm32(nn.Module):
    """GroupNorm(32) with float32 statistics, var = max(0, E[x²] − E[x]²).

    ``f32_apply=True`` is flax ``nn.GroupNorm`` (eps 1e-6): normalize and
    affine in float32, then cast to the input dtype. ``f32_apply=False`` is
    the fold (eps 1e-5): per-(sample, channel) ``a``, ``b`` computed in
    float32, cast to the compute dtype, and one ``x*a+b``."""

    def __init__(self, channels: int, f32_apply: bool = True, num_groups: int = 32):
        super().__init__()
        self.num_groups = num_groups
        self.f32_apply = f32_apply
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        b, c = x.shape[:2]
        g = self.num_groups
        xf = x.float()
        # per-channel moments, then per-group (equal channel counts)
        mean = xf.mean(dim=(2, 3)).reshape(b, g, c // g).mean(dim=2)
        meansq = (xf * xf).mean(dim=(2, 3)).reshape(b, g, c // g).mean(dim=2)
        var = torch.clamp_min(meansq - mean * mean, 0.0)
        eps = 1e-6 if self.f32_apply else 1e-5
        inv = torch.rsqrt(var + eps)  # [b, g]
        mean_c = mean.repeat_interleave(c // g, dim=1)  # [b, c]
        inv_c = inv.repeat_interleave(c // g, dim=1)
        if self.f32_apply:
            mul = (inv_c * self.weight)[:, :, None, None]
            y = (xf - mean_c[:, :, None, None]) * mul + self.bias[:, None, None]
            return y.to(x.dtype)
        a = self.weight * inv_c
        b_ = self.bias - mean_c * a
        return x * a.to(x.dtype)[:, :, None, None] + b_.to(x.dtype)[:, :, None, None]


class ResBlock(nn.Module):
    """FiLM (scale-shift) residual block with optional avg-pool down /
    nearest up applied to both paths (``resblock_updown``)."""

    def __init__(self, in_ch: int, out_ch: int, emb_ch: int, *, up: bool = False,
                 down: bool = False, norm_f32: bool = True, dropout: float = 0.0):
        super().__init__()
        self.up, self.down = up, down
        self.in_layers = nn.Sequential(
            GroupNorm32(in_ch, norm_f32), nn.SiLU(), Conv2d(in_ch, out_ch, 3, padding=1)
        )
        self.emb_layers = nn.Sequential(nn.SiLU(), Linear(emb_ch, 2 * out_ch))
        self.out_layers = nn.Sequential(
            GroupNorm32(out_ch, norm_f32), nn.SiLU(), nn.Dropout(dropout),
            Conv2d(out_ch, out_ch, 3, padding=1),
        )
        self.skip_connection = (
            Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else nn.Identity()
        )

    def forward(self, x, emb):
        h = F.silu(self.in_layers[0](x))
        if self.up:
            h = F.interpolate(h, scale_factor=2, mode="nearest")
            x = F.interpolate(x, scale_factor=2, mode="nearest")
        elif self.down:
            h = F.avg_pool2d(h, 2)
            x = F.avg_pool2d(x, 2)
        h = self.in_layers[2](h)
        emb_out = self.emb_layers[1](F.silu(emb))[:, :, None, None]
        scale, shift = emb_out.chunk(2, dim=1)
        h = self.out_layers[0](h) * (1 + scale) + shift
        h = self.out_layers[2](F.silu(h))
        h = self.out_layers[3](h)
        return self.skip_connection(x) + h


def qkv_permutation(channels: int, heads: int) -> np.ndarray:
    """Row permutation taking the head-major (q,k,v per head) qkv projection
    to the qkv-major one (heads within each of q/k/v): ``perm[ours] = ref``."""
    ch = channels // heads
    perm = np.empty(3 * channels, np.int64)
    for q3 in range(3):
        for h in range(heads):
            for c in range(ch):
                perm[q3 * channels + h * ch + c] = h * 3 * ch + q3 * ch + c
    return perm


class AttentionBlock(nn.Module):
    """Self-attention over the flattened spatial grid, "new order" scaling
    (q and k each scaled by ch^-1/4, softmax in float32).

    The qkv weights are stored head-major (reference layout); their rows are
    permuted to qkv-major at call time (an O(C²) gather of the weights), so
    the projection writes the ``[B, S, 3, H, D]`` layout the kernel reads with
    no reorder of the activations."""

    def __init__(self, channels: int, heads: int, *, fused: bool = False,
                 norm_f32: bool = True):
        super().__init__()
        self.heads = heads
        self.fused = fused
        self.norm = GroupNorm32(channels, norm_f32)
        self.qkv = nn.Conv1d(channels, 3 * channels, 1)
        self.proj_out = nn.Conv1d(channels, channels, 1)
        self.register_buffer(
            "perm", torch.from_numpy(qkv_permutation(channels, heads)), persistent=False
        )

    def forward(self, x):
        b, c, hh, ww = x.shape
        s = hh * ww
        dt = x.dtype
        tokens = self.norm(x).permute(0, 2, 3, 1).reshape(b, s, c)
        w = self.qkv.weight[:, :, 0][self.perm].to(dt)
        qkv = F.linear(tokens, w, self.qkv.bias[self.perm].to(dt))
        qkv = qkv.reshape(b, s, 3, self.heads, c // self.heads)
        if self.fused:
            out = fused_attention(qkv)
        else:
            q, k, v = qkv.unbind(2)
            scale = torch.tensor(qk_scale(c // self.heads, dt), dtype=dt, device=x.device)
            logits = torch.einsum("bthc,bshc->bhts", q * scale, k * scale)
            weights = torch.softmax(logits.float(), dim=-1).to(v.dtype)
            out = torch.einsum("bhts,bshc->bthc", weights, v)
        out = F.linear(out.reshape(b, s, c), self.proj_out.weight[:, :, 0].to(dt),
                       self.proj_out.bias.to(dt))
        return x + out.reshape(b, hh, ww, c).permute(0, 3, 1, 2)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """cDDPM UNet hyperparameters (same names and defaults as the JAX
    package's ``UNetConfig``)."""

    in_channels: int = 1
    model_channels: int = 128
    out_channels: int = 1
    num_res_blocks: int = 3
    attention_resolutions: Sequence[int] = (3, 6, 12)
    dropout: float = 0.0
    channel_mult: Sequence[int] = (1, 2, 2)
    cond_dim: Optional[int] = 128
    num_heads: int = 1
    num_head_channels: int = 64
    use_scale_shift_norm: bool = True
    resblock_updown: bool = True
    spatial_transformer: bool = False
    use_checkpoint: bool = False  # recompute ResBlocks in the backward pass
    fused_attention: bool = False
    norm_precision: str = "float32"
    film_fold: bool = False
    dtype: str = "float32"

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def norm_f32(self) -> bool:
        return self.norm_precision != "compute"


class UNetModel(nn.Module):
    """``forward(x, t, cond)`` with x [B,H,W,C] in [-1,1], t [B] int, cond
    [B, cond_dim] (or None when unconditional) -> [B,H,W,out_channels] f32."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        for flag, what in ((cfg.film_fold, "film_fold"),
                           (cfg.spatial_transformer, "spatial_transformer"),
                           (not cfg.resblock_updown, "conv up/down (resblock_updown=False)"),
                           (not cfg.use_scale_shift_norm, "use_scale_shift_norm=False")):
            if flag:
                raise NotImplementedError(f"{what} is not ported yet")
        self.cfg = cfg
        mc = cfg.model_channels
        emb_dim = 4 * mc
        self.time_embed = nn.Sequential(Linear(mc, emb_dim), nn.SiLU(),
                                        Linear(emb_dim, emb_dim))
        emb_ch = emb_dim
        if cfg.cond_dim is not None:
            self.label_emb = nn.Sequential(Linear(cfg.cond_dim, emb_dim), nn.SiLU(),
                                           Linear(emb_dim, emb_dim))
            emb_ch = 2 * emb_dim

        def res(cin, cout, **kw):
            return ResBlock(cin, cout, emb_ch, norm_f32=cfg.norm_f32,
                            dropout=cfg.dropout, **kw)

        def attn(ch):
            heads = (ch // cfg.num_head_channels if cfg.num_head_channels > 0
                     else cfg.num_heads)
            return AttentionBlock(ch, heads, fused=cfg.fused_attention,
                                  norm_f32=cfg.norm_f32)

        self.input_blocks = nn.ModuleList(
            [nn.ModuleList([Conv2d(cfg.in_channels, mc, 3, padding=1)])]
        )
        skip_chs = [mc]
        ch, ds = mc, 1
        for level, mult in enumerate(cfg.channel_mult):
            for _ in range(cfg.num_res_blocks):
                layers = [res(ch, mult * mc)]
                ch = mult * mc
                if ds in cfg.attention_resolutions:
                    layers.append(attn(ch))
                self.input_blocks.append(nn.ModuleList(layers))
                skip_chs.append(ch)
            if level != len(cfg.channel_mult) - 1:
                self.input_blocks.append(nn.ModuleList([res(ch, ch, down=True)]))
                skip_chs.append(ch)
                ds *= 2

        self.middle_block = nn.ModuleList([res(ch, ch), attn(ch), res(ch, ch)])

        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(cfg.channel_mult))):
            for i in range(cfg.num_res_blocks + 1):
                layers = [res(ch + skip_chs.pop(), mult * mc)]
                ch = mult * mc
                if ds in cfg.attention_resolutions:
                    layers.append(attn(ch))
                if level and i == cfg.num_res_blocks:
                    layers.append(res(ch, ch, up=True))
                    ds //= 2
                self.output_blocks.append(nn.ModuleList(layers))

        self.out = nn.Sequential(GroupNorm32(ch, cfg.norm_f32), nn.SiLU(),
                                 Conv2d(ch, cfg.out_channels, 3, padding=1))
        for zero in self._zero_init_modules():
            nn.init.zeros_(zero.weight)
            nn.init.zeros_(zero.bias)

    def _zero_init_modules(self):
        """ResBlock out convs, attention proj_out and the final conv start at
        zero, as in the JAX package."""
        for m in self.modules():
            if isinstance(m, ResBlock):
                yield m.out_layers[3]
            elif isinstance(m, AttentionBlock):
                yield m.proj_out
        yield self.out[2]

    def _run(self, block, h, emb):
        recompute = self.cfg.use_checkpoint and torch.is_grad_enabled()
        for layer in block:
            if not isinstance(layer, ResBlock):
                h = layer(h)
            elif recompute:
                h = checkpoint(layer, h, emb, use_reentrant=False)
            else:
                h = layer(h, emb)
        return h

    def forward(self, x, t, cond=None):
        cfg = self.cfg
        dt = cfg.compute_dtype
        temb = timestep_embedding(t, cfg.model_channels).to(dt)
        emb = self.time_embed[2](F.silu(self.time_embed[0](temb)))
        if cfg.cond_dim is not None:
            if cond is None:
                raise ValueError("conditional UNet requires cond")
            cemb = self.label_emb[2](F.silu(self.label_emb[0](cond.to(dt))))
            emb = torch.cat([emb, cemb], dim=-1)

        h = x.to(dt).permute(0, 3, 1, 2)  # NHWC -> NCHW view, channels_last
        skips = []
        for block in self.input_blocks:
            h = self._run(block, h, emb)
            skips.append(h)
        h = self._run(self.middle_block, h, emb)
        for block in self.output_blocks:
            h = self._run(block, torch.cat([h, skips.pop()], dim=1), emb)
        h = self.out[2](F.silu(self.out[0](h)))
        return h.permute(0, 2, 3, 1).float()
