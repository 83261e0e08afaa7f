"""ADM-256 in plain float32 PyTorch: the unconditional 256x256 UNet of
Dhariwal and Nichol, "Diffusion Models Beat GANs on Image Synthesis"
(arXiv 2105.05233; openai/guided-diffusion, ``guided_diffusion/unet.py``,
README "256x256_diffusion_uncond": 256 channels, 2 res blocks a level,
channel_mult (1, 1, 2, 2, 4, 4), attention at 32, 16 and 8 pixels with
64-channel heads, scale-shift norm, res blocks that resample), as the DDPM
baseline's denoiser, and its single-shot reconstruction of a volume.

Built from ``model.py``'s blocks (GroupNorm32, the scale-shift ResBlock that
average-pools down and repeats pixels up, legacy-order attention), under the
system's state-dict names, so one state dict loads here and into the system
under test. No kernel, no cache, no compute dtype; TF32 is set off by the
caller (``harness/checks.py::no_tf32``). Imports nothing of the system.

Departures from guided-diffusion's ``unet.py``, each as the configuration
states it (``configs/adm_256.json``, 'assumed'):
* One input and one output channel: the image is one MRI slice, and the
  output is ``pred_x0`` under a fixed variance, so ``learn_sigma``'s
  variance half is left out (``out_channels`` 1, not 6).
* float32 everywhere: ``use_fp16`` is the system's bfloat16, which the
  reference does not copy.
* GroupNorm32 applies its statistics folded into one ``x * a + b`` with
  var = max(E[x^2] - E[x]^2, 0), eps 1e-5 (``norm_precision: compute``);
  guided-diffusion's ``nn.GroupNorm`` is the same map up to float32 rounding.
* Attention is ``QKVAttentionLegacy`` (q, k, v of head 0, then of head 1,
  ...), the layout the system stores; the system permutes the rows to its
  own order at call time (``models/unet.py::qkv_permutation``).
* The time embedding alone: no class embedding, no label.
* The diffusion around it is the system's: the cosine schedule, the x0
  objective, simplex noise, one forward at t = test_timesteps
  (``diffusion.py``), not ADM's linear schedule and sampler.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .diffusion import denoise, model_noise
from .model import AttentionBlock, Conv2d, GroupNorm32, Linear, Quant, ResBlock
from .model import timestep_embedding


class ADMUNet(nn.Module):
    """x [B, H, W, 1] in [-1, 1], t [B] -> [B, H, W, 1]; ``cond`` is taken
    and ignored, as the unconditional model has none."""

    def __init__(self, model_channels: int, channel_mult: Sequence[int], num_res_blocks: int,
                 attention_resolutions: Sequence[int], num_head_channels: int = 64):
        super().__init__()
        mc = model_channels
        emb = 4 * mc
        self.mc = mc
        self.time_embed = nn.Sequential(Linear(mc, emb), nn.SiLU(), Linear(emb, emb))

        def attn(ch):
            return AttentionBlock(ch, ch // num_head_channels)

        self.input_blocks = nn.ModuleList([nn.ModuleList([Conv2d(1, mc, 3, padding=1)])])
        skips = [mc]
        ch, ds = mc, 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [ResBlock(ch, mult * mc, emb)]
                ch = mult * mc
                if ds in attention_resolutions:
                    layers.append(attn(ch))
                self.input_blocks.append(nn.ModuleList(layers))
                skips.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(nn.ModuleList([ResBlock(ch, ch, emb, down=True)]))
                skips.append(ch)
                ds *= 2
        self.middle_block = nn.ModuleList([ResBlock(ch, ch, emb), attn(ch),
                                           ResBlock(ch, ch, emb)])
        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(channel_mult))):
            for i in range(num_res_blocks + 1):
                layers = [ResBlock(ch + skips.pop(), mult * mc, emb)]
                ch = mult * mc
                if ds in attention_resolutions:
                    layers.append(attn(ch))
                if level and i == num_res_blocks:
                    layers.append(ResBlock(ch, ch, emb, up=True))
                    ds //= 2
                self.output_blocks.append(nn.ModuleList(layers))
        self.out = nn.Sequential(GroupNorm32(ch), nn.SiLU(), Conv2d(ch, 1, 3, padding=1))

    @staticmethod
    def _run(block, h, emb):
        for layer in block:
            h = layer(h, emb) if isinstance(layer, ResBlock) else layer(h)
        return h

    def forward(self, x, t, cond=None):
        emb = self.time_embed[2](F.silu(self.time_embed[0](timestep_embedding(t, self.mc))))
        h = x.permute(0, 3, 1, 2)
        skips = []
        for block in self.input_blocks:
            h = self._run(block, h, emb)
            skips.append(h)
        h = self._run(self.middle_block, h, emb)
        for block in self.output_blocks:
            h = self._run(block, torch.cat([h, skips.pop()], dim=1), emb)
        return self.out[2](F.silu(self.out[0](h))).permute(0, 2, 3, 1)


class ADM(nn.Module):
    """The UNet under the system's state-dict prefix (``unet.``); no encoder.
    ``quant`` rounds what a compute dtype would hold, as in ``model.py``."""

    encoder = None

    def __init__(self, model: dict, quant: Optional[Quant] = None):
        super().__init__()
        self.unet = ADMUNet(model["unet_dim"], model["channel_mult"], model["num_res_blocks"],
                            model["attention_resolutions"], model.get("num_head_channels", 64))
        if quant is not None:
            for m in self.modules():
                if isinstance(m, (Conv2d, Linear, AttentionBlock, GroupNorm32)):
                    m.quant = quant


@torch.no_grad()
def reconstruct_volume(model: ADM, vol_hwd, seed: int, model_cfg: dict, sched,
                       row_chunk: int = 8):
    """A volume's single-shot reconstruction [H, W, D]: every slice noised
    with the volume's one field at t = test_timesteps and denoised, in blocks
    of ``row_chunk`` rows (rows are independent: no batch statistic)."""
    h, w, d = vol_hwd.shape
    slices = vol_hwd.movedim(-1, 0)[..., None].float()
    field = model_noise([seed], (h, w), model_cfg, vol_hwd.device)[0]
    noise = field[None, :, :, None].expand(d, h, w, 1)
    t = torch.full((d,), model_cfg["test_timesteps"] - 1, dtype=torch.long,
                   device=vol_hwd.device)
    model.eval()
    reco = torch.cat([denoise(model, slices[i:i + row_chunk], t[i:i + row_chunk], None,
                              noise[i:i + row_chunk], sched)[1]
                      for i in range(0, d, row_chunk)])
    return reco[..., 0].movedim(0, -1)
