"""The ResBlock's output sum on the card: ``ResBlock.residual`` through the
kernel of ``csrc/residual.cu`` (``ops/residual.py::residual_bias_sum``)
against the eager chain (both convolutions with their bias, then the sum), on
the same inputs, bit for bit.

Needs a CUDA card; skipped without one. On the chip, which has no JAX
(tests/conftest.py imports it):

    python -m pytest --noconftest tests/test_torch_residual_card.py -q

- bfloat16 and float32, an identity skip and a skip convolution, at the
  cells' channel counts (128, 256, 512, 1024) and at the 192x192 cell's
  largest residual sites [312, 128, 192, 192];
- a whole no_grad UNet forward of the 96x96 cell's configuration and of an
  ADM-256 of published widths at one res block a level, fused against
  eager; under grad no call takes the kernel;
- channel counts that are not a whole number of 16-byte vectors take the
  eager chain;
- x is never written, and the wrapper writes only ``out``.
"""
import pytest
import torch

from conditioned_diffusion_models_uad_torch.models import unet as U
from conditioned_diffusion_models_uad_torch.models.tasks import DDPMTask
from conditioned_diffusion_models_uad_torch.models.unet import (
    ResBlock,
    UNetConfig,
    UNetModel,
    takes_fused_residual,
)
from conditioned_diffusion_models_uad_torch.ops import residual as R
from conditioned_diffusion_models_uad_torch.utils.random_init import randomize_
from uadbench.harness.cell import Cell

pytestmark = pytest.mark.card

DTYPES = [torch.bfloat16, torch.float32]
CHANNELS = [128, 256, 512, 1024]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on the chip: python -m pytest --noconftest "
                    "tests/test_torch_residual_card.py)")
    return torch.device("cuda")


def _block(in_ch, out_ch, seed, device):
    rb = randomize_(ResBlock(in_ch, out_ch, 64, norm_f32=False), seed)
    return rb.to(device, memory_format=torch.channels_last)


def _input(shape, dtype, gen, device):
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32).to(dtype)
    return x.contiguous(memory_format=torch.channels_last)


def _both_routes(rb, x, h):
    """(the fused route's output, the eager chain's, the fused call's count
    and launches), x checked unwritten."""
    x_before = x.clone()
    calls0, launches0 = dict(ResBlock.residual_calls), R.residual_bias_sum.launches
    with torch.no_grad():
        got = rb.residual(x, h)
        took = ({k: v - calls0[k] for k, v in ResBlock.residual_calls.items()},
                R.residual_bias_sum.launches - launches0)
        want = rb.skip_connection(x) + rb.out_layers[3](h)
    assert torch.equal(x, x_before)
    return got, want, took


@pytest.mark.parametrize("c", CHANNELS)
@pytest.mark.parametrize("skip", ["identity", "conv"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_fused_route_is_the_eager_chain_bit_for_bit(card, dtype, skip, c):
    gen = torch.Generator(device=card).manual_seed(c)
    in_ch = c if skip == "identity" else c + 128
    rb = _block(in_ch, c, c + len(skip), card)
    x = _input((4, in_ch, 24, 24), dtype, gen, card)
    h = _input((4, c, 24, 24), dtype, gen, card)
    got, want, took = _both_routes(rb, x, h)
    assert took == ({"fused": 1, "eager": 0}, 1)
    assert got.dtype == dtype and got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want)


@pytest.mark.parametrize("in_ch", [128, 384], ids=["identity", "skip_384_to_128"])
def test_fused_route_at_the_192_cells_largest_residual_site(card, in_ch):
    """[312, 128, 192, 192] bf16: an eval volume's rows at 192x192, the
    decoder's first-level ResBlocks (a 384->128 skip convolution) and the
    encoder's (identity)."""
    gen = torch.Generator(device=card).manual_seed(in_ch)
    rb = _block(in_ch, 128, 7, card)
    x = _input((312, in_ch, 192, 192), torch.bfloat16, gen, card)
    h = _input((312, 128, 192, 192), torch.bfloat16, gen, card)
    got, want, took = _both_routes(rb, x, h)
    assert took == ({"fused": 1, "eager": 0}, 1)
    assert torch.equal(got, want)


def _cddpm96_unet(device):
    task = DDPMTask(Cell("cddpm96.eval").task_config(), device=device)
    return randomize_(task, 3).unet


def _adm_unet(device):
    """ADM-256 (guided-diffusion's 256x256 unconditional UNet) at its
    published widths, with one res block a level for two."""
    cfg = UNetConfig(model_channels=256, num_res_blocks=1, channel_mult=(1, 1, 2, 2, 4, 4),
                     attention_resolutions=(8, 16, 32), cond_dim=None,
                     num_head_channels=64, fused_attention=True, norm_precision="compute",
                     dtype="bfloat16")
    net = randomize_(UNetModel(cfg), 4)
    return net.to(device, memory_format=torch.channels_last)


@pytest.mark.parametrize("net,hw,cond", [(_cddpm96_unet, 96, 128), (_adm_unet, 64, None)],
                         ids=["cddpm96", "adm_reduced_depth"])
def test_unet_forward_is_bit_equal_on_both_routes(card, monkeypatch, net, hw, cond):
    unet = net(card).eval()
    blocks = sum(isinstance(m, ResBlock) for m in unet.modules())
    gen = torch.Generator(device=card).manual_seed(hw)
    b = 6
    x = torch.rand((b, hw, hw, 1), generator=gen, device=card) * 2 - 1
    t = torch.randint(0, 1000, (b,), generator=gen, device=card)
    c = None if cond is None else torch.randn((b, cond), generator=gen, device=card)

    def run(grad=False):
        calls0 = dict(ResBlock.residual_calls)
        with torch.set_grad_enabled(grad):
            y = unet(x, t, c)
        return y.detach(), {k: v - calls0[k] for k, v in ResBlock.residual_calls.items()}

    fused, calls = run()
    assert calls == {"fused": blocks, "eager": 0}
    _, calls = run(grad=True)
    assert calls == {"fused": 0, "eager": blocks}
    monkeypatch.setattr(U, "takes_fused_residual", lambda *a: False)
    eager, calls = run()
    assert calls == {"fused": 0, "eager": blocks}
    assert torch.equal(fused, eager)


@pytest.mark.parametrize("in_ch,c,dtype", [(36, 36, torch.bfloat16), (36, 44, torch.bfloat16),
                                           (34, 34, torch.float32)],
                         ids=["bf16_36_identity", "bf16_36_to_44", "f32_34_identity"])
def test_channels_off_the_vector_take_the_eager_chain(card, in_ch, c, dtype):
    gen = torch.Generator(device=card).manual_seed(c)
    rb = _block(in_ch, c, 2, card)
    x = _input((3, in_ch, 10, 10), dtype, gen, card)
    h = _input((3, c, 10, 10), dtype, gen, card)
    assert not takes_fused_residual(x, h, c, ())
    got, want, took = _both_routes(rb, x, h)
    assert took == ({"fused": 0, "eager": 1}, 0)
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        R.residual_bias_sum(h.clone(), h, None, rb.out_layers[3].bias)


@pytest.mark.parametrize("c", [8, 136, 1024, R.MAX_CHANNELS])
@pytest.mark.parametrize("skip_bias", [True, False])
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_kernel_alone_against_the_plain_version(card, dtype, skip_bias, c):
    """The wrapper on raw tensors (M = 5*7*3 rows, not a multiple of the
    grid), into a separate ``out`` and into h: bit-equal to the plain
    version; s and, with ``out``, h left as they were."""
    assert R.max_channels_on_card() == R.MAX_CHANNELS
    gen = torch.Generator(device=card).manual_seed(c + skip_bias)
    s, h = (_input((5, c, 7, 3), dtype, gen, card) * 8 for _ in range(2))
    b_skip = torch.randn(c, generator=gen, device=card) if skip_bias else None
    b_out = torch.randn(c, generator=gen, device=card)
    want = R.residual_bias_sum_reference(s, h, b_skip, b_out)
    s0, h0 = s.clone(), h.clone()
    out = torch.empty_like(h)
    got = R.residual_bias_sum(s, h, b_skip, b_out, out=out)
    assert got is out and torch.equal(got, want)
    assert torch.equal(s, s0) and torch.equal(h, h0)
    got = R.residual_bias_sum(s, h, b_skip, b_out)
    assert got.data_ptr() == h.data_ptr() and torch.equal(got, want) and torch.equal(s, s0)
