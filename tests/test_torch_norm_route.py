"""The UNet's norm sites (conditioned_diffusion_models_uad_torch/models/unet.py::
GroupNorm32) with the ResBlock's FiLM and SiLU inside the call, on the CPU:
the call against the chain it replaced, bit for bit, and the route's
decision (``takes_k3``) on fake card tensors. The card's side of the route
is in tests/test_torch_norm_card.py."""
import pytest
import torch
import torch.nn.functional as F

from conditioned_diffusion_models_uad_torch.models.unet import (
    GroupNorm32,
    ResBlock,
    apply_dropout,
    takes_k3,
)
from conditioned_diffusion_models_uad_torch.ops.fused_norm import fused_groupnorm_fold
from conditioned_diffusion_models_uad_torch.utils.random_init import randomize_

torch.set_num_threads(2)


def _old_norm(norm, x, film_scale=None, film_shift=None):
    """GroupNorm32.forward before the FiLM and SiLU joined the call."""
    b, c = x.shape[:2]
    g = norm.num_groups
    xf = x.float()
    mean = xf.mean(dim=(2, 3)).reshape(b, g, c // g).mean(dim=2)
    meansq = (xf * xf).mean(dim=(2, 3)).reshape(b, g, c // g).mean(dim=2)
    var = torch.clamp_min(meansq - mean * mean, 0.0)
    eps = 1e-6 if norm.f32_apply else 1e-5
    inv = torch.rsqrt(var + eps)
    mean_c = mean.repeat_interleave(c // g, dim=1)
    inv_c = inv.repeat_interleave(c // g, dim=1)
    if norm.f32_apply:
        mul = (inv_c * norm.weight)[:, :, None, None]
        y = (xf - mean_c[:, :, None, None]) * mul + norm.bias[:, None, None]
        return y.to(x.dtype)
    a = norm.weight * inv_c
    b_ = norm.bias - mean_c * a
    if film_scale is not None:
        s1 = 1.0 + film_scale.float().reshape(b, c)
        a = a * s1
        b_ = b_ * s1 + film_shift.float().reshape(b, c)
    return x * a.to(x.dtype)[:, :, None, None] + b_.to(x.dtype)[:, :, None, None]


def _old_resblock(rb, x, emb, keep=None):
    """ResBlock.forward before: SiLU and the FiLM around the norm calls."""
    h = F.silu(_old_norm(rb.in_layers[0], x))
    h = rb.in_layers[2](h)
    emb_out = rb.emb_layers[1](F.silu(emb))[:, :, None, None]
    if not rb.use_scale_shift_norm:
        h = _old_norm(rb.out_layers[0], h + emb_out)
    elif rb.film_fold:
        scale, shift = emb_out.chunk(2, dim=1)
        h = _old_norm(rb.out_layers[0], h, scale, shift)
    else:
        scale, shift = emb_out.chunk(2, dim=1)
        h = _old_norm(rb.out_layers[0], h) * (1 + scale) + shift
    h = F.silu(h)
    if keep is not None:
        h = apply_dropout(h, keep, rb.rate)
    return rb.skip_connection(x) + rb.out_layers[3](h)


def _nchw(shape, dtype, gen):
    return torch.randn(shape, generator=gen).to(dtype).to(memory_format=torch.channels_last)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("film_fold", [False, True])
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("use_scale_shift_norm", [False, True])
def test_norm_call_is_the_old_chain_bit_for_bit(dtype, film_fold, silu, use_scale_shift_norm):
    """The folded norm site's call ``norm(h, scale, shift, film_fold=,
    silu=)`` and the whole ResBlock, against the composition they replaced
    (FiLM after the call, or composed in it, then ``F.silu``)."""
    gen = torch.Generator().manual_seed(5)
    rb = randomize_(ResBlock(64, 96, 32, norm_f32=False, dropout=0.1,
                             use_scale_shift_norm=use_scale_shift_norm,
                             film_fold=film_fold), 3)
    x = _nchw((2, 64, 8, 8), dtype, gen)
    h = _nchw((2, 96, 8, 8), dtype, gen)
    emb = torch.randn((2, 32), generator=gen).to(dtype)
    keep = torch.rand((2, 96, 8, 8), generator=gen) > 0.1
    norm = rb.out_layers[0]
    with torch.no_grad():
        emb_out = rb.emb_layers[1](F.silu(emb))[:, :, None, None]
        if use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=1)
            got = norm(h, scale, shift, film_fold=film_fold, silu=silu)
            want = (_old_norm(norm, h, scale, shift) if film_fold
                    else _old_norm(norm, h) * (1 + scale) + shift)
        else:
            got = norm(h + emb_out, silu=silu)
            want = _old_norm(norm, h + emb_out)
        if silu:
            want = F.silu(want)
        assert got.dtype == dtype and torch.equal(got, want)
        assert torch.equal(rb(x, emb), _old_resblock(rb, x, emb))
        assert torch.equal(rb(x, emb, keep), _old_resblock(rb, x, emb, keep))


class _Fake:
    """What ``takes_k3`` reads of a tensor, for a card this host lacks."""

    def __init__(self, device="cuda", dtype=torch.bfloat16, channels_last=True,
                 requires_grad=False):
        self.device = torch.device(device)
        self.dtype = dtype
        self.channels_last = channels_last
        self.requires_grad = requires_grad

    def is_contiguous(self, memory_format=torch.contiguous_format):
        return self.channels_last == (memory_format == torch.channels_last)


@pytest.mark.parametrize("x_kw,other,want", [
    ({}, {}, True),                                    # a bf16 card call, nothing needs grad
    ({"dtype": torch.float32}, {}, True),
    ({"device": "cpu"}, {}, False),
    ({"dtype": torch.float16}, {}, False),
    ({"channels_last": False}, {}, False),             # x.permute is not [B, N, C]
    ({}, {"f32_apply": True}, False),                  # flax numerics, not the fold
    ({"requires_grad": True}, {}, False),
    ({"requires_grad": True}, {"grad": False}, True),
    ({}, {"params_grad": True}, False),                # a training forward
    ({}, {"params_grad": True, "grad": False}, True),  # eval under no_grad
    ({}, {"film": {}}, True),
    ({}, {"film": {"requires_grad": True}}, False),
    ({}, {"film": {"dtype": torch.float32}}, False),   # the FiLM would promote y
], ids=["card", "float32", "cpu", "float16", "not_channels_last", "f32_apply",
        "x_grad", "x_grad_no_grad_mode", "params_grad", "params_grad_no_grad_mode",
        "film", "film_grad", "film_other_dtype"])
def test_takes_k3_only_where_autograd_records_nothing(x_kw, other, want):
    x = _Fake(**x_kw)
    params = tuple(torch.zeros(4, requires_grad=other.get("params_grad", False))
                   for _ in range(2))
    film = (_Fake(**other["film"]),) * 2 if "film" in other else ()
    with torch.set_grad_enabled(other.get("grad", True)):
        assert takes_k3(x, params, other.get("f32_apply", False), film) is want


def test_cpu_calls_take_the_eager_chain_uncounted():
    norm = randomize_(GroupNorm32(64, f32_apply=False), 1)
    x = _nchw((2, 64, 4, 4), torch.bfloat16, torch.Generator().manual_seed(2))
    before = dict(GroupNorm32.fold_calls)
    with torch.no_grad():
        assert torch.equal(norm(x, silu=True), norm.eager(x, silu=True))
    assert GroupNorm32.fold_calls == before
    with pytest.raises(ValueError):
        fused_groupnorm_fold(x.permute(0, 2, 3, 1), norm.weight, norm.bias)
