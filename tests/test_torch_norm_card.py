"""The UNet's norm chain on the card: ``GroupNorm32``'s route through kernel
K3 in the fold numerics (``ops/fused_norm.py::fused_groupnorm_fold``)
against its eager chain (``GroupNorm32.eager``), on the same inputs.

Needs a CUDA card; skipped without one. On the chip, which has no JAX
(tests/conftest.py imports it):

    python -m pytest --noconftest tests/test_torch_norm_card.py -q

- at every site shape of the flagship UNet at 96x96 and 192x192 (the
  benchmark's two eval configurations): at least 99.9% of the elements
  bit-equal, and none further apart than one bf16 ulp of the chain's
  largest term (``_compare``);
- on inputs whose statistics every summation order gives exactly (values
  k/8, powers of two for H*W and C/G): every element bit-equal, in each
  variant, mode, dtype, with and without SiLU;
- a sample's output alone equals its output within a batch of 168 rows;
- a UNet forward takes K3 at every norm site under no_grad, and at none
  while autograd records.
"""
import pytest
import torch

from conditioned_diffusion_models_uad_torch.models.unet import (
    GroupNorm32,
    UNetConfig,
    UNetModel,
)
from conditioned_diffusion_models_uad_torch.ops import fused_norm as F3
from conditioned_diffusion_models_uad_torch.utils.random_init import randomize_

pytestmark = pytest.mark.card

# (C, H) of the flagship UNet's norm sites at 96x96 (model_channels 128,
# channel_mult (1, 2, 2), three res blocks, attention in the middle block),
# with whether the site carries a ResBlock's FiLM and a SiLU; 192x192 doubles H
SITES_96 = [(128, 48, False, True), (128, 48, True, True), (128, 96, False, True),
            (128, 96, True, True), (256, 24, False, False), (256, 24, False, True),
            (256, 24, True, True), (256, 48, False, True), (256, 48, True, True),
            (256, 96, False, True), (256, 96, True, True), (384, 48, False, True),
            (384, 96, False, True), (512, 24, False, True), (512, 48, False, True)]
SITES = [(c, h, film, silu) for c, h, film, silu in SITES_96] + [
    (c, 2 * h, film, silu) for c, h, film, silu in SITES_96]
BIT_EQUAL_SHARE = 0.999


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on the chip: python -m pytest --noconftest "
                    "tests/test_torch_norm_card.py)")
    return torch.device("cuda")


def _site_inputs(b, c, h, film, dtype, gen, device):
    """x [B, C, H, H] channels_last with a mean and spread of its own per
    sample and channel, the module with seeded weights, and a FiLM (scale,
    shift) [B, C, 1, 1] of x's dtype, as a ResBlock hands it over."""
    mu = torch.randn((b, c, 1, 1), generator=gen, device=device)
    sd = 0.5 + torch.rand((b, c, 1, 1), generator=gen, device=device)
    x = (torch.randn((b, c, h, h), generator=gen, device=device) * sd + mu).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    norm = randomize_(GroupNorm32(c, f32_apply=False), c + h).to(device)
    fs = tuple((0.3 * torch.randn((b, c, 1, 1), generator=gen, device=device)).to(dtype)
               for _ in range(2)) if film else ()
    return x, norm, fs


def _ulp(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """One ulp of |v| in ``dtype`` (v float32)."""
    bits = 8 if dtype == torch.bfloat16 else 24
    _, e = torch.frexp(v.abs().clamp_min(torch.finfo(torch.float32).tiny))
    return torch.ldexp(torch.ones_like(v), e - bits)


def _eager_terms(norm, x, fs):
    """The largest magnitude the eager chain rounds on the way to each
    element: |x*a|, |b| and |y| of the fold, and with a FiLM after the norm
    |y*(1+s)| and |shift|. A coefficient a or b one rounding apart (the
    statistics summed in another order) moves an element by up to one ulp of
    this term, however small the element."""
    b, c = x.shape[:2]
    g = norm.num_groups
    xf = x.float()
    mean = xf.mean(dim=(2, 3)).reshape(b, g, c // g).mean(dim=2)
    meansq = (xf * xf).mean(dim=(2, 3)).reshape(b, g, c // g).mean(dim=2)
    inv = torch.rsqrt(torch.clamp_min(meansq - mean * mean, 0.0) + 1e-5)
    a = norm.weight * inv.repeat_interleave(c // g, dim=1)
    bb = norm.bias - mean.repeat_interleave(c // g, dim=1) * a
    a, bb = (v.to(x.dtype).float()[:, :, None, None] for v in (a, bb))
    y = xf * a + bb
    terms = torch.maximum(torch.maximum((xf * a).abs(), bb.abs()), y.abs())
    if fs:
        y = y * (1 + fs[0].float())
        terms = torch.maximum(torch.maximum(terms, y.abs()), fs[1].float().abs())
    return terms


def _compare(got, want, terms):
    """(share of elements bit-equal, largest gap in ulps of the element's
    largest term)."""
    g, w = got.float(), want.float()
    equal = (got.view(torch.int16 if got.dtype == torch.bfloat16 else torch.int32)
             == want.view(torch.int16 if want.dtype == torch.bfloat16 else torch.int32))
    gap = ((g - w).abs() / _ulp(torch.maximum(terms, torch.maximum(g.abs(), w.abs())),
                                got.dtype)).max().item()
    return equal.float().mean().item(), gap


@pytest.mark.parametrize("c,h,film,silu", SITES,
                         ids=[f"C{c}-H{h}-{'film' if f else 'nofilm'}-{'silu' if s else 'id'}"
                              for c, h, f, s in SITES])
def test_fold_route_at_every_site_shape(card, c, h, film, silu):
    gen = torch.Generator(device=card).manual_seed(c * 1000 + h)
    x, norm, fs = _site_inputs(8, c, h, film, torch.bfloat16, gen, card)
    with torch.no_grad():
        before = (GroupNorm32.fold_calls["k3"], F3.fused_groupnorm_silu.launches)
        got = norm(x, *fs, silu=silu)
        after = (GroupNorm32.fold_calls["k3"], F3.fused_groupnorm_silu.launches)
        want = norm.eager(x, *fs, silu=silu)
        terms = _eager_terms(norm, x, fs)
    assert after[0] - before[0] == 1 and after[1] - before[1] == 1
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    share, gap = _compare(got, want, terms)
    assert share >= BIT_EQUAL_SHARE and gap <= 1.0, (share, gap)


# (B, C, H, dtype, k_max, variant) whose statistics are exact in any order: x = k/8 with
# |k| <= k_max, H*H and C/32 powers of two, so each group's sums stay below
# 2^24 units; one shape for each variant kernel_for picks
EXACT = [(3, 128, 32, torch.bfloat16, 8, "cluster"),
         (2, 128, 128, torch.float32, 8, "coop"),
         (2, 256, 256, torch.bfloat16, 2, "two_pass")]


@pytest.mark.parametrize("b,c,h,dtype,kmax,variant", EXACT, ids=[e[-1] for e in EXACT])
@pytest.mark.parametrize("film", [None, "fold", "after"])
@pytest.mark.parametrize("silu", [True, False])
def test_fold_route_is_bit_equal_where_the_statistics_are_exact(card, b, c, h, dtype, kmax,
                                                                variant, film, silu):
    assert F3._card_plan(torch.empty((1, h * h, c), dtype=dtype, device=card),
                         32).variant == variant
    gen = torch.Generator(device=card).manual_seed(h + c)
    x = (torch.randint(-kmax, kmax + 1, (b, c, h, h), generator=gen, device=card) / 8.0)
    x = x.to(dtype).contiguous(memory_format=torch.channels_last)
    norm = randomize_(GroupNorm32(c, f32_apply=False), 9).to(card)
    fs = () if film is None else tuple(
        (0.3 * torch.randn((b, c, 1, 1), generator=gen, device=card)).to(dtype) for _ in range(2))
    with torch.no_grad():
        got = norm(x, *fs, film_fold=film == "fold", silu=silu)
        want = norm.eager(x, *fs, film_fold=film == "fold", silu=silu)
    assert torch.equal(got, want)


@pytest.mark.parametrize("c,h,dtype,variant", [(128, 96, torch.bfloat16, "cluster"),
                                                (128, 96, torch.float32, "coop"),
                                                (384, 96, torch.bfloat16, "two_pass")],
                         ids=["cluster", "coop", "two_pass"])
def test_a_sample_alone_equals_its_row_in_a_batch_of_168(card, c, h, dtype, variant):
    gen = torch.Generator(device=card).manual_seed(7)
    x, norm, fs = _site_inputs(168, c, h, True, dtype, gen, card)
    assert F3._card_plan(x.permute(0, 2, 3, 1).reshape(168, h * h, c), 32).variant == variant
    with torch.no_grad():
        batch = norm(x, *fs, silu=True)
        for i in (0, 77, 167):
            alone = norm(x[i:i + 1], *(f[i:i + 1] for f in fs), silu=True)
            assert torch.equal(alone, batch[i:i + 1])


def test_unet_takes_k3_at_every_norm_site_where_autograd_records_nothing(card):
    cfg = UNetConfig(model_channels=64, channel_mult=(1, 2), num_res_blocks=1,
                     attention_resolutions=(2,), cond_dim=16, norm_precision="compute",
                     fused_attention=True, dtype="bfloat16")
    unet = randomize_(UNetModel(cfg), 3).to(card, memory_format=torch.channels_last)
    sites = sum(isinstance(m, GroupNorm32) for m in unet.modules())
    gen = torch.Generator(device=card).manual_seed(1)
    x = torch.rand((4, 32, 32, 1), generator=gen, device=card) * 2 - 1
    t = torch.randint(0, 1000, (4,), generator=gen, device=card)
    cond = torch.randn((4, 16), generator=gen, device=card)

    def run(grad):
        calls0, launches0 = dict(GroupNorm32.fold_calls), F3.fused_groupnorm_silu.launches
        with torch.set_grad_enabled(grad):
            y = unet(x, t, cond)
        calls = {k: v - calls0[k] for k, v in GroupNorm32.fold_calls.items()}
        return y.detach(), calls, F3.fused_groupnorm_silu.launches - launches0

    y_k3, calls, launches = run(False)
    assert calls == {"k3": sites, "eager": 0} and launches == sites
    y_eager, calls, launches = run(True)
    assert calls == {"k3": 0, "eager": sites} and launches == 0
    rel = ((y_k3 - y_eager).norm() / y_eager.norm()).item()
    assert rel < 2e-2, rel
