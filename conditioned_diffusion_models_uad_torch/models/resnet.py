"""ResNet conditioning encoder (counterpart of
``conditioned_diffusion_models_uad_tpu/models/resnet.py``), eval and
training mode.

Parameter names follow torchvision (``conv1``/``bn1``/``layerX.i.convJ``/
``bnJ``/``downsample.{0,1}``/``fc``), so the JAX package's
``convert_reference_resnet_state_dict`` reads this module's ``state_dict``.
``MaskedBatchNorm`` follows flax, not ``nn.BatchNorm2d``: eps 1e-5, biased
batch variance, running statistics updated as ``0.9*ra + 0.1*batch``, and the
statistics applied in float32 or folded into one compute-dtype ``x*a+b``.
The SparK active-site mask is not ported yet.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from .unet import Conv2d, Linear

MOMENTUM = 0.9  # flax's: running = MOMENTUM * running + (1 - MOMENTUM) * batch


class MaskedBatchNorm(nn.Module):
    """BatchNorm (``mask=None``). Eval mode applies the running statistics;
    training mode applies the batch's float32 mean and biased variance and
    moves the running statistics toward them."""

    def __init__(self, channels: int, *, dtype: torch.dtype = torch.float32,
                 fold_apply: bool = False, eps: float = 1e-5):
        super().__init__()
        self.dtype = dtype
        self.fold_apply = fold_apply
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        if self.training:
            xf = x.float()
            mean = xf.mean(dim=(0, 2, 3))
            var = xf.var(dim=(0, 2, 3), unbiased=False)
            with torch.no_grad():
                self.running_mean.copy_(MOMENTUM * self.running_mean + (1 - MOMENTUM) * mean)
                self.running_var.copy_(MOMENTUM * self.running_var + (1 - MOMENTUM) * var)
        else:
            mean, var = self.running_mean, self.running_var
        if self.fold_apply:
            a = torch.rsqrt(var + self.eps) * self.weight
            b = self.bias - mean * a
            dt = self.dtype
            return x.to(dt) * a.to(dt)[:, None, None] + b.to(dt)[:, None, None]
        y = ((x.float() - mean[:, None, None]) * torch.rsqrt(var + self.eps)[:, None, None]
             * self.weight[:, None, None] + self.bias[:, None, None])
        return y.to(x.dtype if x.dtype != torch.float32 else self.dtype)


def _conv(cin, cout, k, stride=1):
    return Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, width: int, stride: int, bn):
        super().__init__()
        self.conv1 = _conv(cin, width, 3, stride)
        self.bn1 = bn(width)
        self.conv2 = _conv(width, width, 3)
        self.bn2 = bn(width)
        self.downsample = None
        if cin != width or stride != 1:
            self.downsample = nn.Sequential(_conv(cin, width, 1, stride), bn(width))

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(h + x)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, cin: int, width: int, stride: int, bn):
        super().__init__()
        out = width * 4
        self.conv1 = _conv(cin, width, 1)
        self.bn1 = bn(width)
        self.conv2 = _conv(width, width, 3, stride)
        self.bn2 = bn(width)
        self.conv3 = _conv(width, out, 1)
        self.bn3 = bn(out)
        self.downsample = None
        if cin != out or stride != 1:
            self.downsample = nn.Sequential(_conv(cin, out, 1, stride), bn(out))

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(h + x)


_VARIANTS = {
    "resnet18": (BasicBlock, (2, 2, 2, 2), 512),
    "resnet34": (BasicBlock, (3, 4, 6, 3), 512),
    "resnet50": (BottleneckBlock, (3, 4, 6, 3), 2048),
    "resnet101": (BottleneckBlock, (3, 4, 23, 3), 2048),
}


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    variant: str = "resnet50"
    in_channels: int = 1
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
    def fea_dim(self) -> int:
        return _VARIANTS[self.variant][2]


class ResNetBackbone(nn.Module):
    """Trunk: 7x7/2 stem, BN, ReLU, 3x3/2 max-pool (pad 1), four stages.
    ``forward`` takes NCHW and returns the last stage's features."""

    def __init__(self, cfg: ResNetConfig):
        super().__init__()
        self.cfg = cfg
        block_cls, stage_sizes, _ = _VARIANTS[cfg.variant]

        def bn(c):
            return MaskedBatchNorm(c, dtype=cfg.compute_dtype, fold_apply=cfg.fold_norm)

        self.conv1 = _conv(cfg.in_channels, 64, 7, 2)
        self.bn1 = bn(64)
        cin = 64
        for si, (n_blocks, w) in enumerate(zip(stage_sizes, (64, 128, 256, 512))):
            blocks = []
            for bi in range(n_blocks):
                stride = 2 if (si > 0 and bi == 0) else 1
                blocks.append(block_cls(cin, w, stride, bn))
                cin = w * block_cls.expansion
            setattr(self, f"layer{si + 1}", nn.Sequential(*blocks))

    def forward_features(self, x):
        h = F.relu(self.bn1(self.conv1(x.to(self.cfg.compute_dtype))))
        h = F.max_pool2d(h, 3, 2, 1)
        for i in range(1, 5):
            h = getattr(self, f"layer{i}")(h)
        return h


class ResNetEncoder(ResNetBackbone):
    """Conditioning encoder: backbone -> global average pool -> ``fc``.
    ``forward`` takes NHWC slices [B, H, W, C] and returns [B, cond_dim] f32."""

    def __init__(self, cfg: ResNetConfig, cond_dim: int = 128):
        super().__init__(cfg)
        self.fc = Linear(cfg.fea_dim, cond_dim)

    def forward(self, x):
        h = self.forward_features(x.permute(0, 3, 1, 2))
        return self.fc(h.mean(dim=(2, 3))).float()
