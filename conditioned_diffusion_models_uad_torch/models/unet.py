"""Guided-diffusion UNet of the cDDPM (counterpart of
``conditioned_diffusion_models_uad_tpu/models/unet.py``).

Module and parameter names follow the reference torch UNet
(``time_embed``, ``label_emb``, ``input_blocks.N.M``, ``middle_block``,
``output_blocks.N.M``, ``out``; ResBlocks with ``in_layers``/``emb_layers``/
``out_layers``/``skip_connection``; attention with ``norm``/``qkv``/
``proj_out`` as ``Conv1d(k=1)`` in the head-major qkv layout; ``op`` of a
``Downsample`` and ``conv`` of an ``Upsample``), so the JAX package's
``utils/convert_torch.py`` reads this module's ``state_dict``. The
``spatial_transformer`` attention sites take the LDM names (``norm``,
``proj_in``, ``transformer_blocks.i.{norm1..3, attn1, attn2, ff}``,
``proj_out``).

Parameters are float32; each layer casts its weights to the compute dtype of
its input, as flax's ``dtype=`` does. Activations are NCHW in
``channels_last`` memory format. ``use_checkpoint`` recomputes each
ResBlock's forward in the backward pass (the JAX package's ``nn.remat``)
whenever gradients are recorded. ResBlock dropout takes explicit keep masks
(``forward(..., dropout=masks)``, one per ResBlock in call order, the order
of flax's dropout sites), so a recomputed forward applies the same masks.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import fused_attention, qk_scale
from ..ops.fused_norm import fused_groupnorm_fold
from ..ops.residual import channels_fit, residual_bias_sum
from ..utils.profiling import span


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

    def forward(self, x, *, bias: bool = True):
        b = None if self.bias is None or not bias else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), b, self.stride, self.padding)


class Linear(nn.Linear):
    """Linear with float32 parameters applied in the input's dtype."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


def takes_k3(x, params, f32_apply: bool, film=()) -> bool:
    """Whether a ``GroupNorm32`` call takes kernel K3: x a CUDA tensor of
    bfloat16 or float32 in channels_last memory (so that ``x.permute(0, 2,
    3, 1)`` is K3's contiguous [B, N, C]), the module on the fold (not
    ``f32_apply``), the FiLM tensors of x's dtype, and nothing for autograd
    to record: grad mode off, or neither x, the parameters nor the FiLM
    require grad. Every other call takes the eager chain."""
    if f32_apply or x.device.type != "cuda" or x.dtype not in (torch.bfloat16, torch.float32):
        return False
    if not x.is_contiguous(memory_format=torch.channels_last):
        return False
    if any(f.dtype != x.dtype for f in film):
        return False
    return not records_grad(x, *params, *film)


def records_grad(*tensors) -> bool:
    """Whether autograd records a call on ``tensors``: grad mode on and one
    of them requiring grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def takes_fused_residual(x, h, c_out: int, params) -> bool:
    """Whether a ``ResBlock``'s output sum takes ``residual_bias_sum``: x
    (the block's input, the skip's) and h (the out convolution's input) CUDA
    tensors of one dtype, bfloat16 or float32, channels_last-contiguous, x
    16-byte aligned (an identity skip hands x itself to the kernel), the
    block's ``c_out`` channels a whole number of 16-byte vectors
    (``ops/residual.py::channels_fit``), cuDNN on (which adds a
    convolution's bias in a pass of its own, the rounding the kernel keeps)
    and nothing for autograd to record. The convolutions' outputs are then
    fresh channels_last tensors of one shape. Every other call takes the
    eager chain."""
    if x.device.type != "cuda" or h.dtype != x.dtype or not channels_fit(c_out, x.dtype):
        return False
    if not all(t.is_contiguous(memory_format=torch.channels_last) for t in (x, h)):
        return False
    if x.data_ptr() % 16 or not torch.backends.cudnn.enabled:
        return False
    return not records_grad(x, h, *params)


class GroupNorm32(nn.Module):
    """GroupNorm(32) with float32 statistics, var = max(0, E[x²] − E[x]²),
    and a norm site's FiLM and SiLU.

    ``f32_apply=True`` is flax ``nn.GroupNorm`` (eps 1e-6): normalize and
    affine in float32, then cast to the input dtype. ``f32_apply=False`` is
    the fold (eps 1e-5): per-(sample, channel) ``a``, ``b`` computed in
    float32, cast to the compute dtype, and one ``x*a+b``.

    ``forward(x, scale, shift, film_fold=, silu=)`` is the site's whole
    chain: a ResBlock's FiLM scale and shift [B, C, 1, 1], composed into the
    fold's coefficients in float32 with ``film_fold`` (``a·(1+s)``,
    ``b·(1+s)+t``), else applied after the norm in x's dtype,
    ``y*(1+scale)+shift``; then SiLU when ``silu``. On the card the fold
    takes K3 in one call (``ops/fused_norm.py::fused_groupnorm_fold``, the
    same roundings) wherever ``takes_k3`` holds, and ``eager`` otherwise.
    ``GroupNorm32.fold_calls`` counts the fold's calls on the card by route
    ("k3", "eager")."""

    fold_calls = {"k3": 0, "eager": 0}

    def __init__(self, channels: int, f32_apply: bool = True, num_groups: int = 32):
        super().__init__()
        self.num_groups = num_groups
        self.f32_apply = f32_apply
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, scale=None, shift=None, *, film_fold=False, silu=False):
        if x.device.type == "cuda" and not self.f32_apply:
            film = () if scale is None else (scale, shift)
            k3 = takes_k3(x, (self.weight, self.bias), self.f32_apply, film)
            GroupNorm32.fold_calls["k3" if k3 else "eager"] += 1
            if k3:
                c = x.shape[1]
                film_bc = None if scale is None else (scale.reshape(-1, c), shift.reshape(-1, c))
                y = fused_groupnorm_fold(x.permute(0, 2, 3, 1), self.weight, self.bias, film_bc,
                                         film_after=scale is not None and not film_fold,
                                         groups=self.num_groups, eps=1e-5, apply_silu=silu)
                return y.permute(0, 3, 1, 2)
        return self.eager(x, scale, shift, film_fold=film_fold, silu=silu)

    def eager(self, x, scale=None, shift=None, *, film_fold=False, silu=False):
        """The chain in PyTorch operations (the route off the card, for
        ``f32_apply`` and wherever autograd records)."""
        if film_fold:
            y = self._norm(x, scale, shift)
        else:
            y = self._norm(x)
            if scale is not None:
                y = y * (1 + scale) + shift
        return F.silu(y) if silu else y

    def _norm(self, x, film_scale=None, film_shift=None):
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
            if film_scale is not None:
                raise ValueError("the FiLM fold needs f32_apply=False")
            mul = (inv_c * self.weight)[:, :, None, None]
            y = (xf - mean_c[:, :, None, None]) * mul + self.bias[:, None, None]
            return y.to(x.dtype)
        a = self.weight * inv_c
        b_ = self.bias - mean_c * a
        if film_scale is not None:
            s1 = 1.0 + film_scale.float().reshape(b, c)
            a = a * s1
            b_ = b_ * s1 + film_shift.float().reshape(b, c)
        return x * a.to(x.dtype)[:, :, None, None] + b_.to(x.dtype)[:, :, None, None]


def apply_dropout(h: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    """flax ``nn.Dropout``: ``h / (1 - rate)`` where ``keep``, else 0. The
    divisor is rounded to ``h``'s dtype first, as JAX's weak-typed scalar is."""
    keep_prob = torch.tensor(1.0 - rate, dtype=h.dtype, device=h.device)
    return torch.where(keep, h / keep_prob, torch.zeros((), dtype=h.dtype, device=h.device))


def _same_pad(n: int, k: int, s: int):
    """flax's 'SAME' padding (low, high) of one axis."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class Downsample(nn.Module):
    """A 3x3 stride-2 conv with flax's 'SAME' padding (for an even side
    one row and column on the high side only), or a 2x2 average pool when
    ``use_conv`` is off."""

    def __init__(self, channels: int, use_conv: bool = True):
        super().__init__()
        self.use_conv = use_conv
        if use_conv:
            self.op = Conv2d(channels, channels, 3, stride=2)

    def forward(self, x):
        if not self.use_conv:
            return F.avg_pool2d(x, 2)
        (ht, hb), (wl, wr) = (_same_pad(n, 3, 2) for n in x.shape[2:])
        return self.op(F.pad(x, (wl, wr, ht, hb)))

    def out_hw(self, h: int, w: int):
        return ((-(-h // 2), -(-w // 2)) if self.use_conv else (h // 2, w // 2))


class Upsample(nn.Module):
    """Nearest x2, then a 3x3 conv when ``use_conv`` is on."""

    def __init__(self, channels: int, use_conv: bool = True):
        super().__init__()
        self.use_conv = use_conv
        if use_conv:
            self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        return self.conv(x) if self.use_conv else x


class ResBlock(nn.Module):
    """Residual block with optional avg-pool down / nearest up applied to both
    paths (``resblock_updown``). With ``use_scale_shift_norm`` the embedding
    is a FiLM scale and shift after the second GroupNorm (composed into the
    folded GroupNorm's coefficients with ``film_fold`` under
    ``norm_f32=False``); without it, it is added before that GroupNorm.
    ``keep`` (a bool mask of the block's output shape) applies dropout after
    the second SiLU.

    The output is ``skip_connection(x) + out_layers[3](h)``: on the card,
    wherever ``takes_fused_residual`` holds, both convolutions run without
    their bias and ``residual_bias_sum`` adds the two biases and the sum in
    one pass into the out convolution's output, with the eager chain's
    roundings. ``ResBlock.residual_calls`` counts the sum's calls on the
    card by route ("fused", "eager")."""

    residual_calls = {"fused": 0, "eager": 0}

    def __init__(self, in_ch: int, out_ch: int, emb_ch: int, *, up: bool = False,
                 down: bool = False, norm_f32: bool = True, dropout: float = 0.0,
                 use_scale_shift_norm: bool = True, film_fold: bool = False):
        super().__init__()
        self.up, self.down = up, down
        self.out_ch = out_ch
        self.rate = dropout
        self.use_scale_shift_norm = use_scale_shift_norm
        self.film_fold = film_fold and not norm_f32
        self.in_layers = nn.Sequential(
            GroupNorm32(in_ch, norm_f32), nn.SiLU(), Conv2d(in_ch, out_ch, 3, padding=1)
        )
        self.emb_layers = nn.Sequential(
            nn.SiLU(), Linear(emb_ch, 2 * out_ch if use_scale_shift_norm else out_ch))
        self.out_layers = nn.Sequential(
            GroupNorm32(out_ch, norm_f32), nn.SiLU(), nn.Dropout(dropout),
            Conv2d(out_ch, out_ch, 3, padding=1),
        )
        self.skip_connection = (
            Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else nn.Identity()
        )

    def forward(self, x, emb, keep=None):
        h = self.in_layers[0](x, silu=True)
        if self.up:
            h = F.interpolate(h, scale_factor=2, mode="nearest")
            x = F.interpolate(x, scale_factor=2, mode="nearest")
        elif self.down:
            h = F.avg_pool2d(h, 2)
            x = F.avg_pool2d(x, 2)
        h = self.in_layers[2](h)
        emb_out = self.emb_layers[1](F.silu(emb))[:, :, None, None]
        if not self.use_scale_shift_norm:
            h = self.out_layers[0](h + emb_out, silu=True)
        else:
            scale, shift = emb_out.chunk(2, dim=1)
            h = self.out_layers[0](h, scale, shift, film_fold=self.film_fold, silu=True)
        if keep is not None:
            h = apply_dropout(h, keep, self.rate)
        return self.residual(x, h)

    def residual(self, x, h):
        """``skip_connection(x) + out_layers[3](h)``, on the route
        ``takes_fused_residual`` picks."""
        out_conv, skip = self.out_layers[3], self.skip_connection
        if x.device.type == "cuda":
            params = (*out_conv.parameters(), *skip.parameters())
            fused = takes_fused_residual(x, h, self.out_ch, params)
            ResBlock.residual_calls["fused" if fused else "eager"] += 1
            if fused:
                conv_skip = isinstance(skip, Conv2d)
                s = skip(x, bias=False) if conv_skip else x
                return residual_bias_sum(s, out_conv(h, bias=False),
                                         skip.bias if conv_skip else None, out_conv.bias)
        return skip(x) + out_conv(h)


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

    def qkv_of(self, x):
        """The attention's input for x [B, C, H, W]: qkv [B, H*W, 3, heads,
        C/heads] in x's dtype."""
        b, c, hh, ww = x.shape
        dt = x.dtype
        tokens = self.norm(x).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        w = self.qkv.weight[:, :, 0][self.perm].to(dt)
        qkv = F.linear(tokens, w, self.qkv.bias[self.perm].to(dt))
        return qkv.reshape(b, hh * ww, 3, self.heads, c // self.heads)

    def forward(self, x):
        b, c, hh, ww = x.shape
        s = hh * ww
        dt = x.dtype
        qkv = self.qkv_of(x)
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


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` in float32 over the last axis: eps 1e-6,
    var = max(0, E[x²] − E[x]²), ``(x − μ)·(rsqrt(var + eps)·γ) + β``.
    Returns float32."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp_min((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, 0.0)
        return (xf - mean) * (torch.rsqrt(var + 1e-6) * self.weight) + self.bias


class CrossAttention(nn.Module):
    """Multi-head attention of tokens [B, N, C] over a context [B, M, Cc]
    (self-attention when the context is None): logits q·kᵀ/√d in the compute
    dtype, softmax in float32, weights cast back to the value dtype. Plain
    matmuls, as in the JAX package, where this block is an einsum."""

    def __init__(self, query_dim: int, context_dim: int, heads: int, dim_head: int):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Linear(query_dim, inner, bias=False)
        self.to_k = Linear(context_dim, inner, bias=False)
        self.to_v = Linear(context_dim, inner, bias=False)
        self.to_out = nn.Sequential(Linear(inner, query_dim), nn.Dropout(0.0))

    def forward(self, x, context=None):
        ctx = x if context is None else context
        b, n, _ = x.shape
        m = ctx.shape[1]
        hd = (self.heads, self.dim_head)
        q = self.to_q(x).reshape(b, n, *hd)
        k = self.to_k(ctx).reshape(b, m, *hd)
        v = self.to_v(ctx).reshape(b, m, *hd)
        scale = torch.tensor(math.sqrt(self.dim_head), dtype=q.dtype, device=q.device)
        logits = torch.einsum("bnhd,bmhd->bhnm", q, k) / scale
        w = torch.softmax(logits.float(), dim=-1).to(v.dtype)
        out = torch.einsum("bhnm,bmhd->bnhd", w, v).reshape(b, n, -1)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = Linear(dim, 2 * inner)

    def forward(self, x):
        a, g = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(g, approximate="tanh")  # flax nn.gelu is the tanh form


class FeedForward(nn.Module):
    """GEGLU feed-forward, inner width 4·dim (LDM ``FeedForward(glu=True)``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.Sequential(GEGLU(dim, 4 * dim), nn.Dropout(0.0), Linear(4 * dim, dim))

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    """Self-attention, cross-attention to the context, GEGLU feed-forward,
    each pre-LayerNorm (float32, cast back to the compute dtype) and
    residual."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int):
        super().__init__()
        self.attn1 = CrossAttention(dim, dim, heads, dim_head)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, context_dim, heads, dim_head)
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)
        self.norm3 = LayerNorm(dim)

    def forward(self, x, context=None):
        dt = x.dtype
        x = x + self.attn1(self.norm1(x).to(dt))
        x = x + self.attn2(self.norm2(x).to(dt), context)
        return x + self.ff(self.norm3(x).to(dt))


class SpatialTransformer(nn.Module):
    """GroupNorm, token projection, ``depth`` transformer blocks over the
    H·W tokens conditioned on the context, zero-initialised projection back,
    residual. ``proj_in``/``proj_out`` hold LDM's 1x1-conv weights and are
    applied as linears over the tokens."""

    def __init__(self, channels: int, heads: int, dim_head: int, depth: int,
                 context_dim: int, norm_f32: bool = True):
        super().__init__()
        self.norm = GroupNorm32(channels, norm_f32)
        self.proj_in = nn.Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(channels, heads, dim_head, context_dim)
             for _ in range(depth)])
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x, context=None):
        b, c, hh, ww = x.shape
        dt = x.dtype
        t = self.norm(x).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        t = F.linear(t, self.proj_in.weight[:, :, 0, 0].to(dt), self.proj_in.bias.to(dt))
        for block in self.transformer_blocks:
            t = block(t, context)
        t = F.linear(t, self.proj_out.weight[:, :, 0, 0].to(dt), self.proj_out.bias.to(dt))
        return x + t.reshape(b, hh, ww, c).permute(0, 3, 1, 2)


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
    conv_resample: bool = True  # Downsample/Upsample convs (resblock_updown=False)
    cond_dim: Optional[int] = 128
    num_heads: int = 1
    num_head_channels: int = 64
    use_scale_shift_norm: bool = True
    resblock_updown: bool = True
    # attention sites become SpatialTransformers with cond as a 1-token context
    spatial_transformer: bool = False
    transformer_depth: int = 1
    use_checkpoint: bool = False  # recompute ResBlocks in the backward pass
    fused_attention: bool = False
    norm_precision: str = "float32"
    film_fold: bool = False  # FiLM in the folded GroupNorm (norm_precision='compute')
    dtype: str = "float32"

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def norm_f32(self) -> bool:
        return self.norm_precision != "compute"


class UNetModel(nn.Module):
    """``forward(x, t, cond, dropout=None)`` with x [B,H,W,C] in [-1,1], t [B]
    int, cond [B, cond_dim] (or None when unconditional) ->
    [B,H,W,out_channels] f32. ``dropout``: one bool keep mask a ResBlock
    ([B, C, H, W], in ``dropout_shapes`` order), applied at each block's
    dropout site; None runs without dropout. Each block that ends at the
    input's resolution (the input convolution, the first level's input
    blocks, the output blocks that end there) and the output head is the
    span ``unet.full_res``."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
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
                            dropout=cfg.dropout,
                            use_scale_shift_norm=cfg.use_scale_shift_norm,
                            film_fold=cfg.film_fold, **kw)

        def attn(ch):
            heads = (ch // cfg.num_head_channels if cfg.num_head_channels > 0
                     else cfg.num_heads)
            if cfg.spatial_transformer:
                ctx = cfg.cond_dim if cfg.cond_dim is not None else ch
                return SpatialTransformer(ch, heads, ch // heads, cfg.transformer_depth,
                                          ctx, norm_f32=cfg.norm_f32)
            return AttentionBlock(ch, heads, fused=cfg.fused_attention,
                                  norm_f32=cfg.norm_f32)

        self.input_blocks = nn.ModuleList(
            [nn.ModuleList([Conv2d(cfg.in_channels, mc, 3, padding=1)])]
        )
        skip_chs = [mc]
        ch, ds = mc, 1
        # whether each input / output block ends at the input's resolution
        self._full_res_in, self._full_res_out = [True], []
        for level, mult in enumerate(cfg.channel_mult):
            for _ in range(cfg.num_res_blocks):
                layers = [res(ch, mult * mc)]
                ch = mult * mc
                if ds in cfg.attention_resolutions:
                    layers.append(attn(ch))
                self.input_blocks.append(nn.ModuleList(layers))
                self._full_res_in.append(ds == 1)
                skip_chs.append(ch)
            if level != len(cfg.channel_mult) - 1:
                down = (res(ch, ch, down=True) if cfg.resblock_updown
                        else Downsample(ch, cfg.conv_resample))
                self.input_blocks.append(nn.ModuleList([down]))
                self._full_res_in.append(False)
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
                    layers.append(res(ch, ch, up=True) if cfg.resblock_updown
                                  else Upsample(ch, cfg.conv_resample))
                    ds //= 2
                self.output_blocks.append(nn.ModuleList(layers))
                self._full_res_out.append(ds == 1)

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
            elif isinstance(m, (AttentionBlock, SpatialTransformer)):
                yield m.proj_out
        yield self.out[2]

    def _blocks(self):
        return [*self.input_blocks, self.middle_block, *self.output_blocks]

    def dropout_shapes(self, b: int, h: int, w: int):
        """The [B, C, H, W] shape of each ResBlock's output, in call order,
        for an input of ``b`` samples at ``h`` x ``w``."""
        shapes = []
        for block in self._blocks():
            for layer in block:
                if isinstance(layer, ResBlock):
                    if layer.down:
                        h, w = h // 2, w // 2
                    elif layer.up:
                        h, w = 2 * h, 2 * w
                    shapes.append((b, layer.out_ch, h, w))
                elif isinstance(layer, Downsample):
                    h, w = layer.out_hw(h, w)
                elif isinstance(layer, Upsample):
                    h, w = 2 * h, 2 * w
        return shapes

    def _run(self, block, h, emb, context, masks):
        recompute = self.cfg.use_checkpoint and torch.is_grad_enabled()
        for layer in block:
            if isinstance(layer, SpatialTransformer):
                h = layer(h, context)
            elif not isinstance(layer, ResBlock):
                h = layer(h)
            else:
                keep = None if masks is None else next(masks)
                if recompute:
                    h = checkpoint(layer, h, emb, keep, use_reentrant=False)
                else:
                    h = layer(h, emb, keep)
        return h

    def forward(self, x, t, cond=None, dropout=None):
        cfg = self.cfg
        dt = cfg.compute_dtype
        temb = timestep_embedding(t, cfg.model_channels).to(dt)
        emb = self.time_embed[2](F.silu(self.time_embed[0](temb)))
        if cfg.cond_dim is not None:
            if cond is None:
                raise ValueError("conditional UNet requires cond")
            cemb = self.label_emb[2](F.silu(self.label_emb[0](cond.to(dt))))
            emb = torch.cat([emb, cemb], dim=-1)
        context = None
        if cfg.spatial_transformer and cond is not None:
            context = cond.to(dt)[:, None, :]  # [B, 1, cond_dim]: one token
        masks = None
        if dropout is not None:
            want = self.dropout_shapes(x.shape[0], x.shape[1], x.shape[2])
            if [tuple(m.shape) for m in dropout] != want:
                raise ValueError(f"dropout masks must have the shapes {want}")
            masks = iter(dropout)

        h = x.to(dt).permute(0, 3, 1, 2)  # NHWC -> NCHW view, channels_last
        skips = []
        for block, full in zip(self.input_blocks, self._full_res_in):
            with _full_res_span(full):
                h = self._run(block, h, emb, context, masks)
            skips.append(h)
        h = self._run(self.middle_block, h, emb, context, masks)
        for block, full in zip(self.output_blocks, self._full_res_out):
            with _full_res_span(full):
                h = self._run(block, torch.cat([h, skips.pop()], dim=1), emb, context, masks)
        with span("unet.full_res"):
            h = self.out[2](self.out[0](h, silu=True))
        return h.permute(0, 2, 3, 1).float()


_NO_SPAN = contextlib.nullcontext()


def _full_res_span(full: bool):
    """The span ``unet.full_res`` over a block that ends at the input's
    resolution; nothing over any other."""
    return span("unet.full_res") if full else _NO_SPAN


def count_params(params) -> int:
    """Number of elements of an iterable of tensors (``module.parameters()``,
    a state_dict's values)."""
    return sum(int(p.numel()) for p in params)
