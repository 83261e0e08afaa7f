"""Plain float32 PyTorch forms of the cDDPM's two networks: the ResNet
conditioning encoder and the guided-diffusion UNet with its middle-block
self-attention.

Written from the architecture (Behrendt et al., "Guided Reconstruction with
Conditioned Diffusion Models for Unsupervised Anomaly Detection in Brain
MRIs", and the OpenAI guided-diffusion UNet it uses), with the parameter
names of the reference torch code, so one state dict loads into this module
and into the system under test. No kernel, no cache, no compute dtype: every
operation runs in float32 on the device of its input.

Departures from a textbook form, each as the configuration states it:
* GroupNorm(32) and BatchNorm apply their statistics folded into one
  ``x * a + b`` (``norm_precision: compute``): GroupNorm with eps 1e-5 and
  var = max(E[x^2] - E[x]^2, 0), BatchNorm with eps 1e-5, biased batch
  variance, running statistics moved as 0.9 * running + 0.1 * batch.
* The stride-2 downsampling ResBlocks average-pool both paths, the upsampling
  ones repeat each pixel (``resblock_updown``); FiLM scale and shift follow
  the second GroupNorm (``use_scale_shift_norm``).
* Attention scales q and k by D^-1/4 each; its qkv projection is stored head
  by head (q, k, v of head 0, then of head 1, ...).

``quant`` rounds the operands and the result of every convolution, linear
layer and attention product, and each operand and result of the folded
normalisations: the tensors a compute dtype would hold (the identity in the
reference; a lower precision in the control, ``precision.py``).
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

Quant = Callable[[torch.Tensor], torch.Tensor]


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


class Conv2d(nn.Conv2d):
    quant: Quant = staticmethod(_identity)

    def forward(self, x):
        q = self.quant
        return q(F.conv2d(q(x), q(self.weight), self.bias, self.stride, self.padding))


class Linear(nn.Linear):
    quant: Quant = staticmethod(_identity)

    def forward(self, x):
        q = self.quant
        return q(F.linear(q(x), q(self.weight), self.bias))


def _fold(x, a, b, q):
    """x * a + b, each operand and each result rounded by ``q``."""
    return q(q(q(x) * q(a)) + q(b))


def timestep_embedding(t: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class GroupNorm32(nn.Module):
    quant: Quant = staticmethod(_identity)

    def __init__(self, channels: int, groups: int = 32):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        b, c = x.shape[:2]
        g = self.groups
        xg = x.reshape(b, g, -1)
        mean = xg.mean(dim=2)
        var = torch.clamp_min((xg * xg).mean(dim=2) - mean * mean, 0.0)
        inv = torch.rsqrt(var + 1e-5).repeat_interleave(c // g, dim=1)
        a = self.weight * inv
        shift = self.bias - mean.repeat_interleave(c // g, dim=1) * a
        return _fold(x, a[:, :, None, None], shift[:, :, None, None], self.quant)


class ResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, emb_ch: int, up: bool = False,
                 down: bool = False):
        super().__init__()
        self.up, self.down = up, down
        self.in_layers = nn.Sequential(GroupNorm32(cin), nn.SiLU(),
                                       Conv2d(cin, cout, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(), Linear(emb_ch, 2 * cout))
        self.out_layers = nn.Sequential(GroupNorm32(cout), nn.SiLU(), nn.Identity(),
                                        Conv2d(cout, cout, 3, padding=1))
        self.skip_connection = Conv2d(cin, cout, 1) if cin != cout else nn.Identity()

    def forward(self, x, emb):
        h = F.silu(self.in_layers[0](x))
        if self.up:
            h = F.interpolate(h, scale_factor=2, mode="nearest")
            x = F.interpolate(x, scale_factor=2, mode="nearest")
        elif self.down:
            h = F.avg_pool2d(h, 2)
            x = F.avg_pool2d(x, 2)
        h = self.in_layers[2](h)
        scale, shift = self.emb_layers[1](F.silu(emb))[:, :, None, None].chunk(2, dim=1)
        h = F.silu(self.out_layers[0](h) * (1 + scale) + shift)
        return self.skip_connection(x) + self.out_layers[3](h)


class AttentionBlock(nn.Module):
    def __init__(self, channels: int, heads: int):
        super().__init__()
        self.heads = heads
        self.norm = GroupNorm32(channels)
        self.qkv = nn.Conv1d(channels, 3 * channels, 1)
        self.proj_out = nn.Conv1d(channels, channels, 1)
        self.quant: Quant = _identity

    def forward(self, x):
        b, c, h, w = x.shape
        s, n, d = h * w, self.heads, c // self.heads
        q8 = self.quant
        tokens = self.norm(x).reshape(b, c, s)
        qkv = F.conv1d(q8(tokens), q8(self.qkv.weight), self.qkv.bias)  # [b, 3c, s]
        q, k, v = qkv.reshape(b, n, 3, d, s).unbind(2)  # head-major storage
        scale = 1.0 / math.sqrt(math.sqrt(d))
        logits = torch.einsum("bncs,bnct->bnst", q8(q * scale), q8(k * scale))
        weights = torch.softmax(logits, dim=-1)
        out = torch.einsum("bnst,bnct->bncs", q8(weights), q8(v)).reshape(b, c, s)
        out = q8(F.conv1d(q8(out), q8(self.proj_out.weight), self.proj_out.bias))
        return x + out.reshape(b, c, h, w)


class UNet(nn.Module):
    """x [B, H, W, 1] in [-1, 1], t [B], cond [B, cond_dim] -> [B, H, W, 1]."""

    def __init__(self, model_channels: int, channel_mult: Sequence[int], num_res_blocks: int,
                 attention_resolutions: Sequence[int], cond_dim: int,
                 num_head_channels: int = 64):
        super().__init__()
        mc = model_channels
        emb = 4 * mc
        self.mc = mc
        self.time_embed = nn.Sequential(Linear(mc, emb), nn.SiLU(), Linear(emb, emb))
        self.label_emb = nn.Sequential(Linear(cond_dim, emb), nn.SiLU(), Linear(emb, emb))
        emb_ch = 2 * emb

        def attn(ch):
            return AttentionBlock(ch, ch // num_head_channels)

        self.input_blocks = nn.ModuleList([nn.ModuleList([Conv2d(1, mc, 3, padding=1)])])
        skips = [mc]
        ch, ds = mc, 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [ResBlock(ch, mult * mc, emb_ch)]
                ch = mult * mc
                if ds in attention_resolutions:
                    layers.append(attn(ch))
                self.input_blocks.append(nn.ModuleList(layers))
                skips.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(nn.ModuleList([ResBlock(ch, ch, emb_ch, down=True)]))
                skips.append(ch)
                ds *= 2
        self.middle_block = nn.ModuleList([ResBlock(ch, ch, emb_ch), attn(ch),
                                           ResBlock(ch, ch, emb_ch)])
        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(channel_mult))):
            for i in range(num_res_blocks + 1):
                layers = [ResBlock(ch + skips.pop(), mult * mc, emb_ch)]
                ch = mult * mc
                if ds in attention_resolutions:
                    layers.append(attn(ch))
                if level and i == num_res_blocks:
                    layers.append(ResBlock(ch, ch, emb_ch, up=True))
                    ds //= 2
                self.output_blocks.append(nn.ModuleList(layers))
        self.out = nn.Sequential(GroupNorm32(ch), nn.SiLU(), Conv2d(ch, 1, 3, padding=1))

    @staticmethod
    def _run(block, h, emb):
        for layer in block:
            h = layer(h, emb) if isinstance(layer, ResBlock) else layer(h)
        return h

    def forward(self, x, t, cond):
        emb = self.time_embed[2](F.silu(self.time_embed[0](timestep_embedding(t, self.mc))))
        emb = torch.cat([emb, self.label_emb[2](F.silu(self.label_emb[0](cond)))], dim=-1)
        h = x.permute(0, 3, 1, 2)
        skips = []
        for block in self.input_blocks:
            h = self._run(block, h, emb)
            skips.append(h)
        h = self._run(self.middle_block, h, emb)
        for block in self.output_blocks:
            h = self._run(block, torch.cat([h, skips.pop()], dim=1), emb)
        return self.out[2](F.silu(self.out[0](h))).permute(0, 2, 3, 1)


class BatchNorm(nn.Module):
    quant: Quant = staticmethod(_identity)

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            var = x.var(dim=(0, 2, 3), unbiased=False)
            with torch.no_grad():
                self.running_mean.mul_(0.9).add_(0.1 * mean)
                self.running_var.mul_(0.9).add_(0.1 * var)
        else:
            mean, var = self.running_mean, self.running_var
        a = torch.rsqrt(var + 1e-5) * self.weight
        return _fold(x, a[:, None, None], (self.bias - mean * a)[:, None, None], self.quant)


def _conv(cin, cout, k, stride=1):
    return Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, width: int, stride: int):
        super().__init__()
        out = 4 * width
        self.conv1, self.bn1 = _conv(cin, width, 1), BatchNorm(width)
        self.conv2, self.bn2 = _conv(width, width, 3, stride), BatchNorm(width)
        self.conv3, self.bn3 = _conv(width, out, 1), BatchNorm(out)
        self.downsample = (nn.Sequential(_conv(cin, out, 1, stride), BatchNorm(out))
                           if cin != out or stride != 1 else None)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        return F.relu(h + (x if self.downsample is None else self.downsample(x)))


class Basic(nn.Module):
    expansion = 1

    def __init__(self, cin: int, width: int, stride: int):
        super().__init__()
        self.conv1, self.bn1 = _conv(cin, width, 3, stride), BatchNorm(width)
        self.conv2, self.bn2 = _conv(width, width, 3), BatchNorm(width)
        self.downsample = (nn.Sequential(_conv(cin, width, 1, stride), BatchNorm(width))
                           if cin != width or stride != 1 else None)

    def forward(self, x):
        h = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        return F.relu(h + (x if self.downsample is None else self.downsample(x)))


RESNETS = {"resnet18": (Basic, (2, 2, 2, 2)), "resnet50": (Bottleneck, (3, 4, 6, 3))}


class Encoder(nn.Module):
    """Clean slices [B, H, W, 1] -> conditioning vector [B, cond_dim]: the
    ResNet trunk (7x7/2 stem, 3x3/2 max-pool, four stages), a global average
    pool and ``fc``."""

    def __init__(self, variant: str, cond_dim: int):
        super().__init__()
        block, sizes = RESNETS[variant]
        self.conv1, self.bn1 = _conv(1, 64, 7, 2), BatchNorm(64)
        cin = 64
        for si, (n, w) in enumerate(zip(sizes, (64, 128, 256, 512))):
            blocks = []
            for bi in range(n):
                blocks.append(block(cin, w, 2 if si > 0 and bi == 0 else 1))
                cin = w * block.expansion
            setattr(self, f"layer{si + 1}", nn.Sequential(*blocks))
        self.fc = Linear(cin, cond_dim)

    def forward(self, x):
        h = F.max_pool2d(F.relu(self.bn1(self.conv1(x.permute(0, 3, 1, 2)))), 3, 2, 1)
        for i in range(1, 5):
            h = getattr(self, f"layer{i}")(h)
        return self.fc(h.mean(dim=(2, 3)))


class CDDPM(nn.Module):
    """The two networks under the system's state-dict prefixes."""

    def __init__(self, model: dict, quant: Optional[Quant] = None):
        super().__init__()
        self.unet = UNet(model["unet_dim"], model["channel_mult"], model["num_res_blocks"],
                         model["attention_resolutions"], model["cond_dim"],
                         model.get("num_head_channels", 64))
        self.encoder = Encoder(model["encoder_backbone"], model["cond_dim"])
        if quant is not None:
            for m in self.modules():
                if isinstance(m, (Conv2d, Linear, AttentionBlock, GroupNorm32, BatchNorm)):
                    m.quant = quant
