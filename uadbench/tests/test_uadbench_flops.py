"""The benchmark's own operation counts against torch's FLOP counter on the
plain reference networks, and against a count by hand."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from uadbench.harness import flops
from uadbench.reference.model import CDDPM

from conftest import TINY_MODEL

MODEL = {"cond_dim": 16, "step_ensemble": [250, 500, 750], **TINY_MODEL}


def counted(fn) -> float:
    with FlopCounterMode(display=False) as fc:
        fn()
    return float(fc.get_total_flops())


@pytest.mark.parametrize("hw", [(32, 32), (48, 48)])
@pytest.mark.parametrize("backbone", ["resnet18", "resnet50"])
def test_counts_match_the_flop_counter(hw, backbone):
    model = dict(MODEL, encoder_backbone=backbone)
    net = CDDPM(model).eval()
    x = torch.zeros((2, *hw, 1))
    with torch.no_grad():
        enc = counted(lambda: net.encoder(x))
        unet = counted(lambda: net.unet(x, torch.zeros(2, dtype=torch.long),
                                        torch.zeros((2, model["cond_dim"]))))
    assert flops.encoder_forward(model, hw) * 2 == pytest.approx(enc, rel=1e-12)
    assert flops.unet_forward(model, hw) * 2 == pytest.approx(unet, rel=1e-12)


def test_attention_by_hand():
    # s = 576 tokens of 256 channels: qkv 2*576*256*768, out 2*576*256*256,
    # products 4*576^2*256
    assert flops.attention_flops(576, 256) == (226492416 + 75497472 + 339738624)
    # one row in and out in bf16, and 4*256^2 + 6*256 float32 weights
    assert flops.attention_bytes(1, 576, 256) == 2 * 576 * 256 * 2 + (262144 + 1536) * 4


def test_flagship_scale():
    """The flagship's counts at 96x96: 149 GFLOP a UNet row (the system's own
    estimate, 123, leaves out parts of the decoder), 56 padded rows a volume."""
    model = {"unet_dim": 128, "channel_mult": [1, 2, 2], "num_res_blocks": 3,
             "attention_resolutions": [3, 6, 12], "cond_dim": 128,
             "encoder_backbone": "resnet50", "step_ensemble": [250, 500, 750]}
    unet = flops.unet_forward(model, (96, 96))
    assert unet == pytest.approx(149.14e9, rel=1e-3)
    assert flops.eval_volume_flops(model, (96, 96), 56) == pytest.approx(
        56 * (flops.encoder_forward(model, (96, 96)) + 3 * unet))
    assert flops.train_step_flops(model, (96, 96), 32) == pytest.approx(
        96 * (flops.encoder_forward(model, (96, 96)) + unet))
