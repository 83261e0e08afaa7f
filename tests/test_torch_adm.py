"""ADM-256 (guided-diffusion's unconditional 256x256 UNet) on the port's
normal path, against the plain reference of the benchmark
(``uadbench/reference/adm.py``) on seeded random weights:

* a small ADM of the same topology on the CPU (channel_mult (1, 1, 2, 2,
  4, 4), 2 res blocks a level, attention at three resolutions with 16-channel
  heads, resampling ResBlocks, no label, 64x64), float32 and bfloat16;
* the published widths on the meta device: the parameter count in both, and
  the benchmark's operation count against torch's FLOP counter;
* the UNet's span ``unet.full_res`` in a profiler trace, and K2's launch
  counter left alone by the attention blocks off the card (the plain
  route)."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conditioned_diffusion_models_uad_torch.models.unet import (
    AttentionBlock,
    UNetConfig,
    UNetModel,
    count_params,
)
from uadbench.drivers.eval_uncond import attention_sites, unet_forward
from uadbench.harness.weights import make_weights
from uadbench.reference.adm import ADM

torch.set_num_threads(2)

ADM_256 = {"unet_dim": 256, "num_res_blocks": 2, "channel_mult": [1, 1, 2, 2, 4, 4],
           "attention_resolutions": [8, 16, 32], "num_head_channels": 64}
SMALL = dict(ADM_256, unet_dim=32, num_head_channels=16)
# The gap is the RMS of port minus reference over the reference's RMS.
# float32: both sides run the same operations in float32 in other orders (the
# port's qkv-major projection, the reference's head-major one); through the
# network that reads 8.6e-7 to 9.9e-7 on three weight seeds.
TOL_F32 = 2e-5
# bfloat16: every layer of the port rounds its activations to bf16 (an ulp of
# 2^-8 relative) while the reference keeps float32; the gap compounds through
# the network to ~5 ulps of the output's RMS, 0.021 to 0.024 on three weight
# seeds. 0.05 is the benchmark's limit on the same gap over a reconstruction.
TOL_BF16 = 0.05


def port_unet(model: dict, dtype: str) -> UNetModel:
    return UNetModel(UNetConfig(
        model_channels=model["unet_dim"], num_res_blocks=model["num_res_blocks"],
        channel_mult=tuple(model["channel_mult"]),
        attention_resolutions=tuple(model["attention_resolutions"]), cond_dim=None,
        num_head_channels=model["num_head_channels"], fused_attention=True,
        norm_precision="compute", dtype=dtype))


@pytest.fixture(scope="module")
def small_pair():
    ref = ADM(SMALL).eval()
    weights = make_weights(ref.state_dict(), 2**31 + 7, "cpu")
    ref.load_state_dict(weights)
    nets = {}
    for dtype in ("float32", "bfloat16"):
        net = port_unet(SMALL, dtype).to(memory_format=torch.channels_last)
        net.load_state_dict({k[len("unet."):]: v for k, v in weights.items()})
        nets[dtype] = net.eval()
    g = torch.Generator().manual_seed(5)
    x = torch.rand((2, 64, 64, 1), generator=g) * 2 - 1
    t = torch.tensor([499, 120])
    with torch.no_grad():
        want = ref.unet(x, t)
    return nets, x, t, want


@pytest.mark.parametrize("dtype,tol", [("float32", TOL_F32), ("bfloat16", TOL_BF16)])
def test_small_adm_matches_reference(small_pair, dtype, tol):
    nets, x, t, want = small_pair
    with torch.no_grad():
        got = nets[dtype](x, t)
    gap = float((got - want).pow(2).mean().sqrt() / want.pow(2).mean().sqrt())
    assert gap <= tol, gap


def test_published_widths_on_meta():
    with torch.device("meta"):
        port = port_unet(ADM_256, "bfloat16")
        ref = ADM(ADM_256)
        x = torch.empty((1, 256, 256, 1))
        t = torch.zeros(1, dtype=torch.long)
        with FlopCounterMode(display=False) as fc:
            ref.unet(x, t)
    assert count_params(port.parameters()) == 552_797_953
    assert count_params(ref.parameters()) == 552_797_953
    counted = float(fc.get_total_flops())
    assert counted == pytest.approx(2237.6e9, rel=1e-4)
    assert unet_forward(ADM_256, (256, 256)) == pytest.approx(counted, rel=5e-3)
    sites = attention_sites(ADM_256, (256, 256))
    assert len(sites) == sum(isinstance(m, AttentionBlock) for m in port.modules()) == 16
    assert sorted(set(sites)) == [(64, 1024), (256, 1024), (1024, 512)]


def test_spans_and_route_counter(small_pair):
    """``unet.full_res`` over the input convolution, the first level's two
    input blocks, the four output blocks that end at the input's resolution
    and the head; the 16 attention blocks called, none launching K2 off the
    card."""
    from torch.profiler import ProfilerActivity, profile

    from conditioned_diffusion_models_uad_torch.ops.attention import fused_attention

    nets, x, t, _ = small_pair
    net = nets["float32"]
    calls = []
    hooks = [m.register_forward_pre_hook(lambda m, a: calls.append(m))
             for m in net.modules() if isinstance(m, AttentionBlock)]
    before = fused_attention.launches
    try:
        with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
            net(x[:1, :32, :32], t[:1])
    finally:
        for h in hooks:
            h.remove()
    names = [e.name for e in prof.events()]
    assert names.count("unet.full_res") == 8
    assert "unet.attention" not in names
    assert len(calls) == 16
    assert fused_attention.launches == before
