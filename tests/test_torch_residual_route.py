"""The ResBlock's output sum (conditioned_diffusion_models_uad_torch/models/unet.py::
ResBlock.residual) on the CPU: the route's decision (``takes_fused_residual``)
on fake card tensors, the eager chain against the composition it replaced,
the plain version's arithmetic as the kernel computes it (flat rows of C,
each sum in float32 rounded to the dtype), and the fused route's wiring and
counter on tensors that report a card. The kernel itself
(csrc/residual.cu) is held to the eager chain in
tests/test_torch_residual_card.py."""
import pytest
import torch
import torch.nn.functional as F

from conditioned_diffusion_models_uad_torch.models import unet as U
from conditioned_diffusion_models_uad_torch.models.unet import ResBlock, takes_fused_residual
from conditioned_diffusion_models_uad_torch.ops import residual as R
from conditioned_diffusion_models_uad_torch.utils.random_init import randomize_

torch.set_num_threads(2)


def _nchw(shape, dtype, gen):
    return torch.randn(shape, generator=gen).to(dtype).to(memory_format=torch.channels_last)


def _old_resblock(rb, x, emb):
    """ResBlock.forward before the output sum had a route of its own."""
    h = rb.in_layers[0](x, silu=True)
    if rb.up:
        h = F.interpolate(h, scale_factor=2, mode="nearest")
        x = F.interpolate(x, scale_factor=2, mode="nearest")
    elif rb.down:
        h = F.avg_pool2d(h, 2)
        x = F.avg_pool2d(x, 2)
    h = rb.in_layers[2](h)
    emb_out = rb.emb_layers[1](F.silu(emb))[:, :, None, None]
    scale, shift = emb_out.chunk(2, dim=1)
    h = rb.out_layers[0](h, scale, shift, film_fold=rb.film_fold, silu=True)
    h = rb.out_layers[3](h)
    return rb.skip_connection(x) + h


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("in_ch,up,down", [(64, False, False), (96, False, False),
                                           (64, True, False), (96, False, True)],
                         ids=["identity", "skip_conv", "up", "down_skip_conv"])
def test_eager_chain_is_the_old_sum_bit_for_bit(dtype, in_ch, up, down):
    """On the CPU every call takes the eager chain: forward values, and under
    grad the gradients of x and of every parameter, equal the composition
    before, and the card's counter does not move."""
    gen = torch.Generator().manual_seed(in_ch + 2 * up + down)
    rb = randomize_(ResBlock(in_ch, 64, 32, up=up, down=down, norm_f32=False), 4)
    x = _nchw((2, in_ch, 8, 8), dtype, gen)
    emb = torch.randn((2, 32), generator=gen).to(dtype)
    before = dict(ResBlock.residual_calls)
    with torch.no_grad():
        assert torch.equal(rb(x, emb), _old_resblock(rb, x, emb))
    grads = []
    for fn in (rb, lambda a, e: _old_resblock(rb, a, e)):
        xg = x.clone().requires_grad_(True)
        rb.zero_grad(set_to_none=True)
        fn(xg, emb).float().square().sum().backward()
        grads.append([xg.grad] + [p.grad.clone() for p in rb.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    assert ResBlock.residual_calls == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("skip_bias", [True, False])
def test_plain_version_is_the_kernels_arithmetic(dtype, skip_bias):
    """``residual_bias_sum_reference`` (ATen's broadcast adds on NCHW) equals
    the kernel's reading of the same storage: flat rows of C, the channel of
    element i being i mod C, r(r(s + b_skip) + r(h + b_out)) with each sum
    in float32 and r the rounding to the dtype."""
    gen = torch.Generator().manual_seed(11)
    b, c, hh, ww = 3, 40, 5, 7
    s, h = (_nchw((b, c, hh, ww), dtype, gen) * 4 for _ in range(2))
    b_skip = torch.randn(c, generator=gen) if skip_bias else None
    b_out = torch.randn(c, generator=gen)
    want = R.residual_bias_sum_reference(s, h, b_skip, b_out)
    assert want.dtype == dtype

    def rows(t):  # the channels_last storage as [M, C]
        return t.permute(0, 2, 3, 1).reshape(-1, c).float()

    def r(v):
        return v.to(dtype).float()

    bo = b_out.to(dtype).float()
    t = rows(s) if b_skip is None else r(rows(s) + b_skip.to(dtype).float())
    got = r(t + r(rows(h) + bo))
    assert torch.equal(got, rows(want))
    assert torch.equal(R.residual_bias_sum(s, h, b_skip, b_out), want)


class _Fake:
    """What ``takes_fused_residual`` reads of a tensor, for a card this host
    lacks."""

    def __init__(self, device="cuda", dtype=torch.bfloat16, channels_last=True,
                 requires_grad=False, offset=0):
        self.device = torch.device(device)
        self.dtype = dtype
        self.channels_last = channels_last
        self.requires_grad = requires_grad
        self.offset = offset

    def is_contiguous(self, memory_format=torch.contiguous_format):
        return self.channels_last == (memory_format == torch.channels_last)

    def data_ptr(self):
        return 0x7F0000000000 + self.offset


@pytest.mark.parametrize("x_kw,h_kw,other,want", [
    ({}, {}, {}, True),                                      # a bf16 card call
    ({"dtype": torch.float32}, {"dtype": torch.float32}, {}, True),
    ({"device": "cpu"}, {"device": "cpu"}, {}, False),
    ({"dtype": torch.float16}, {"dtype": torch.float16}, {}, False),
    ({}, {"dtype": torch.float32}, {}, False),               # two dtypes
    ({"channels_last": False}, {}, {}, False),
    ({}, {"channels_last": False}, {}, False),
    ({"offset": 8}, {}, {}, False),                          # x not 16-byte aligned
    ({}, {"offset": 8}, {}, True),                           # h is only the conv's input
    ({}, {}, {"c_out": 12}, False),                          # 12 bf16 = 24 bytes
    ({"dtype": torch.float32}, {"dtype": torch.float32}, {"c_out": 12}, True),
    ({"dtype": torch.float32}, {"dtype": torch.float32}, {"c_out": 6}, False),
    ({}, {}, {"c_out": R.MAX_CHANNELS + 8}, False),
    ({"requires_grad": True}, {}, {}, False),
    ({}, {"requires_grad": True}, {}, False),
    ({"requires_grad": True}, {}, {"grad": False}, True),
    ({}, {}, {"params_grad": True}, False),                  # a training forward
    ({}, {}, {"params_grad": True, "grad": False}, True),    # eval under no_grad
    ({}, {}, {"cudnn": False}, False),                       # the bias inside the conv
], ids=["card", "float32", "cpu", "float16", "mixed_dtypes", "x_not_channels_last",
        "h_not_channels_last", "x_unaligned", "h_unaligned", "c_not_a_vector",
        "c12_float32", "c6_float32", "c_beyond_max", "x_grad", "h_grad",
        "x_grad_no_grad_mode", "params_grad", "params_grad_no_grad_mode", "cudnn_off"])
def test_takes_fused_residual_decides_on_what_the_call_shows(x_kw, h_kw, other, want,
                                                             monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "enabled", other.get("cudnn", True))
    params = tuple(torch.zeros(4, requires_grad=other.get("params_grad", False))
                   for _ in range(4))
    with torch.set_grad_enabled(other.get("grad", True)):
        assert takes_fused_residual(_Fake(**x_kw), _Fake(**h_kw), other.get("c_out", 128),
                                    params) is want


def test_a_training_resblock_never_takes_the_route():
    """A ResBlock's own parameters require grad: under grad mode its output
    sum never takes the kernel, under no_grad it does."""
    rb = ResBlock(64, 128, 32, norm_f32=False)
    params = (*rb.out_layers[3].parameters(), *rb.skip_connection.parameters())
    assert len(params) == 4 and all(p.requires_grad for p in params)
    assert not takes_fused_residual(_Fake(), _Fake(), rb.out_ch, params)
    with torch.no_grad():
        assert takes_fused_residual(_Fake(), _Fake(), rb.out_ch, params)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a card, to drive the fused route's wiring."""

    @property
    def device(self):
        return torch.device("cuda")


@pytest.mark.parametrize("in_ch", [64, 96], ids=["identity", "skip_conv"])
def test_fused_route_hands_the_unbiased_convs_to_the_kernel_and_counts_once(in_ch,
                                                                            monkeypatch):
    """On tensors that report a card, under no_grad: one call of the kernel's
    wrapper a ResBlock call, with the skip's and the out convolution's
    outputs computed without their bias (x itself for an identity skip) and
    the two biases; one count under "fused"; x left as it was. Under grad:
    no kernel call, one count under "eager"."""
    gen = torch.Generator().manual_seed(in_ch)
    rb = randomize_(ResBlock(in_ch, 64, 32, norm_f32=False), 5)
    x = _nchw((2, in_ch, 8, 8), torch.bfloat16, gen)
    h = _nchw((2, 64, 8, 8), torch.bfloat16, gen)
    seen = []

    def launch(s, hh, b_skip, b_out):
        seen.append((s, hh, b_skip, b_out))
        return R.residual_bias_sum_reference(s.as_subclass(torch.Tensor),
                                             hh.as_subclass(torch.Tensor), b_skip, b_out)

    monkeypatch.setattr(U, "residual_bias_sum", launch)
    monkeypatch.setattr(ResBlock, "residual_calls", {"fused": 0, "eager": 0})
    x_card, h_card = x.as_subclass(_OnCard), h.as_subclass(_OnCard)
    x_before = x.clone()
    out_conv, skip = rb.out_layers[3], rb.skip_connection
    with torch.no_grad():
        got = rb.residual(x_card, h_card)
        s_want = x if in_ch == 64 else F.conv2d(x, skip.weight.to(x.dtype))
        h_want = F.conv2d(h, out_conv.weight.to(h.dtype), None, 1, 1)
    assert ResBlock.residual_calls == {"fused": 1, "eager": 0} and len(seen) == 1
    s, hh, b_skip, b_out = seen[0]
    assert torch.equal(s.as_subclass(torch.Tensor), s_want)
    assert torch.equal(hh.as_subclass(torch.Tensor), h_want)
    assert b_out is out_conv.bias and (b_skip is None if in_ch == 64 else b_skip is skip.bias)
    assert torch.equal(got.as_subclass(torch.Tensor),
                       R.residual_bias_sum_reference(s_want, h_want, b_skip, b_out))
    assert torch.equal(x, x_before)
    rb.residual(x_card, h_card)
    assert ResBlock.residual_calls == {"fused": 1, "eager": 1} and len(seen) == 1


def test_kernel_wrapper_checks_its_inputs():
    """On the CPU the wrapper is the plain version; the card's checks raise
    on what the kernel does not take, before any launch."""
    gen = torch.Generator().manual_seed(3)
    s = _nchw((2, 16, 4, 4), torch.bfloat16, gen)
    h = _nchw((2, 16, 4, 4), torch.bfloat16, gen)
    b = torch.randn(16, generator=gen)
    assert torch.equal(R.residual_bias_sum(s, h, None, b),
                       R.residual_bias_sum_reference(s, h, None, b))
    assert R.channels_fit(16, torch.bfloat16) and not R.channels_fit(12, torch.bfloat16)
    assert R.channels_fit(12, torch.float32) and not R.channels_fit(16, torch.float16)
    with pytest.raises(ValueError):
        R._check(s, h.contiguous(), h)                     # h not channels_last
    with pytest.raises(ValueError):
        R._check(s, h, s)                                  # out into s
    with pytest.raises(ValueError):
        R._check(s, h[:, :12], h[:, :12])                  # two shapes
    odd = _nchw((2, 12, 4, 4), torch.bfloat16, gen)
    with pytest.raises(ValueError):
        R._check(odd, odd.clone(), odd.clone())            # C not a whole vector
