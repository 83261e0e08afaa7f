"""The port's middle-block attention (conditioned_diffusion_models_uad_torch/
ops/attention.py) against the JAX package's plain twin and its Pallas kernel
in interpret mode, on the CPU; the autograd Function's backward against
jax.grad of attention_reference; the rule that picks the card's K2 variant;
and float32 emulations of the tensor-core kernels' arithmetic
(csrc/attention_mma.cu, csrc/attention_mma_long.cu) against the Pallas
kernel.

Tolerances are those tests/test_attention_pallas.py holds the TPU kernel to:
fp32 2e-6 (the same float32 ops, summed in another order) and bf16 2e-2
(a weight or an output one bf16 ulp apart)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conditioned_diffusion_models_uad_torch.ops.attention import (
    MMA_MAX_SEQ,
    _check_qkv,
    attention_fwd_mma,
    attention_fwd_mma_long,
    attention_fwd_scalar,
    attention_reference,
    fused_attention,
    kernel_for,
    qk_scale,
)
from conditioned_diffusion_models_uad_torch.utils import kernel_variants
from conditioned_diffusion_models_uad_tpu.ops import attention_pallas as jattn

torch.set_num_threads(2)

TOL = {"float32": 2e-6, "bfloat16": 2e-2}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    b, s, h, d = shape
    return rng.normal(0, 1, size=(b, s, 3, h, d)).astype(np.float32)


def _compare(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("shape", [(2, 64, 2, 32), (1, 576, 4, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_matches_jax_reference(shape, dtype):
    tdt, jdt = DTYPES[dtype]
    x = _qkv(shape)
    got = attention_reference(torch.from_numpy(x).to(tdt))
    want = jattn.attention_reference(jnp.asarray(x, jdt)).astype(jnp.float32)
    assert got.shape == (shape[0], shape[1], shape[2], shape[3]) and got.dtype == tdt
    _compare(got, want, dtype)


@pytest.mark.parametrize("shape", [(2, 64, 2, 32), (1, 576, 4, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_matches_pallas_interpret(shape, dtype):
    tdt, jdt = DTYPES[dtype]
    x = _qkv(shape, seed=1)
    got = fused_attention(torch.from_numpy(x).to(tdt))
    want = jattn.fused_attention(jnp.asarray(x, jdt), True).astype(jnp.float32)
    _compare(got, want, dtype)


def test_fused_on_cpu_is_the_plain_version_and_not_counted():
    x = torch.from_numpy(_qkv((2, 64, 2, 32), seed=2))
    before = fused_attention.launches
    assert torch.equal(fused_attention(x), attention_reference(x))
    assert fused_attention.launches == before


def test_backward_matches_jax_grad():
    x = _qkv((2, 64, 2, 32), seed=3)
    cot = np.random.default_rng(4).normal(size=(2, 64, 2, 32)).astype(np.float32)
    want = jax.grad(
        lambda q: jnp.sum(jattn.attention_reference(q) * jnp.asarray(cot))
    )(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (fused_attention(xt) * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype,s,d,want", [
    (torch.bfloat16, 576, 64, "mma"),
    (torch.bfloat16, 100, 64, "mma"),
    (torch.bfloat16, 1, 32, "mma"),
    (torch.bfloat16, MMA_MAX_SEQ + 1, 64, "mma_long"),
    (torch.bfloat16, 2304, 64, "mma_long"),  # the full-resolution middle block
    (torch.bfloat16, 2401, 32, "mma_long"),
    (torch.float32, 576, 64, "scalar"),
    (torch.float32, 4096, 32, "scalar"),
])
def test_kernel_for_picks_the_variant(dtype, s, d, want):
    assert kernel_for(dtype, s, d) == want


@pytest.mark.parametrize("dtype,s,d", [
    (torch.bfloat16, 576, 48),
    (torch.float32, 64, 128),
    (torch.float16, 64, 64),
    (torch.bfloat16, 0, 64),
])
def test_kernel_for_raises_on_what_no_kernel_takes(dtype, s, d):
    with pytest.raises(ValueError):
        kernel_for(dtype, s, d)


def test_mma_check_raises_on_misaligned_or_unfit_qkv():
    aligned = torch.zeros((2, 64, 3, 2, 32), dtype=torch.bfloat16)
    assert aligned.data_ptr() % 16 == 0
    _check_qkv(aligned, "mma")
    base = torch.zeros(aligned.numel() + 1, dtype=torch.bfloat16)
    shifted = base[1:].view(aligned.shape)  # a view with a storage offset
    assert shifted.data_ptr() % 16 != 0
    with pytest.raises(ValueError, match="aligned"):
        _check_qkv(shifted, "mma")
    with pytest.raises(ValueError):
        _check_qkv(aligned.float(), "mma")
    _check_qkv(aligned.float(), "scalar")
    with pytest.raises(ValueError):
        _check_qkv(torch.zeros((1, MMA_MAX_SEQ + 1, 3, 1, 64), dtype=torch.bfloat16), "mma")
    with pytest.raises(ValueError, match="contiguous"):
        _check_qkv(aligned.transpose(0, 1), "scalar")


def test_mma_long_check_takes_bf16_of_any_length():
    for s in (1, 100, MMA_MAX_SEQ, MMA_MAX_SEQ + 1, 2304):
        _check_qkv(torch.zeros((1, s, 3, 1, 64), dtype=torch.bfloat16), "mma_long")
    with pytest.raises(ValueError):
        _check_qkv(torch.zeros((1, 2304, 3, 1, 64)), "mma_long")  # float32
    with pytest.raises(ValueError):
        _check_qkv(torch.zeros((1, 2304, 3, 1, 48), dtype=torch.bfloat16), "mma_long")
    shifted = torch.zeros(2304 * 3 * 64 + 1, dtype=torch.bfloat16)[1:].view(1, 2304, 3, 1, 64)
    with pytest.raises(ValueError, match="aligned"):
        _check_qkv(shifted, "mma_long")


@pytest.mark.parametrize("wrapper", [attention_fwd_mma, attention_fwd_mma_long,
                                     attention_fwd_scalar])
def test_variant_on_cpu_is_the_plain_version_and_not_counted(wrapper):
    x = torch.from_numpy(_qkv((2, 64, 2, 32), seed=5)).to(torch.bfloat16)
    before = (wrapper.launches, fused_attention.launches)
    assert torch.equal(wrapper(x), attention_reference(x))
    assert (wrapper.launches, fused_attention.launches) == before


LOG2E = 1.4426950408889634
SPLIT = 4  # warps that share a query slice, each over its own keys


def mma_kernel_emulation(qkv: torch.Tensor) -> torch.Tensor:
    """csrc/attention_mma.cu's arithmetic in float32 on the CPU, for bf16 qkv
    [B, S, 3, H, D]: q*s and k*s rounded to bf16; the keys split 4 ways in
    steps of 16 (ceil(S/64) steps a warp); row max and sum combined across the
    split in split order; exp2((s - m) * log2e); the reciprocal of the sum
    multiplied in; weights rounded to bf16; P.V partials per split summed in
    split order; the output rounded to bf16."""
    d = qkv.shape[-1]
    s = qkv.shape[1]
    scale = torch.tensor(qk_scale(d, torch.bfloat16), dtype=torch.bfloat16)
    q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))  # [B, H, S, D]
    q = (q * scale).float()
    k = (k * scale).float()
    v = v.float()
    width = 16 * -(-s // (SPLIT * 16))
    parts = [slice(w * width, min((w + 1) * width, s)) for w in range(SPLIT)
             if w * width < s]
    logits = q @ k.transpose(-1, -2)  # [B, H, S, S] f32
    m = logits[..., parts[0]].amax(-1)
    for p in parts[1:]:
        m = torch.maximum(m, logits[..., p].amax(-1))
    e = torch.exp2((logits - m[..., None]) * LOG2E)
    sums = [e[..., p].sum(-1) for p in parts]
    total = sums[0]
    for x in sums[1:]:
        total = total + x
    weights = (e * (1.0 / total)[..., None]).to(torch.bfloat16).float()
    out = weights[..., parts[0]] @ v[..., parts[0], :]
    for p in parts[1:]:
        out = out + weights[..., p] @ v[..., p, :]
    return out.permute(0, 2, 1, 3).to(torch.bfloat16)


@pytest.mark.parametrize("shape", [(1, 576, 4, 64), (2, 100, 2, 32)])
def test_mma_emulation_matches_pallas_interpret(shape):
    x = _qkv(shape, seed=6)
    got = mma_kernel_emulation(torch.from_numpy(x).to(torch.bfloat16))
    want = jattn.fused_attention(jnp.asarray(x, jnp.bfloat16), True).astype(jnp.float32)
    assert got.shape == (shape[0], shape[1], shape[2], shape[3])
    _compare(got, want, "bfloat16")


@pytest.mark.parametrize("shape", [(3, 100, 2, 64), (2, 64, 2, 32), (1, 17, 1, 32)])
def test_mma_emulation_matches_plain_version(shape):
    x = torch.from_numpy(_qkv(shape, seed=7)).to(torch.bfloat16)
    _compare(mma_kernel_emulation(x), attention_reference(x).float().numpy(), "bfloat16")


KEY_TILE_LONG = 64  # keys a tile of csrc/attention_mma_long.cu


def mma_long_kernel_emulation(qkv: torch.Tensor) -> torch.Tensor:
    """csrc/attention_mma_long.cu's arithmetic in float32 on the CPU, for
    bf16 qkv [B, S, 3, H, D]: q*s and k*s rounded to bf16; pass 1 over tiles
    of 64 keys, each of a quad's four threads keeping a running max and a
    rescaled running sum over its own columns (keys 2t, 2t + 1 of every 8),
    the four merged after the last tile; pass 2 the weights
    exp2((s - m) * log2e) times the reciprocal of the sum, rounded to bf16,
    times V; the output rounded to bf16."""
    d, s = qkv.shape[-1], qkv.shape[1]
    scale = torch.tensor(qk_scale(d, torch.bfloat16), dtype=torch.bfloat16)
    q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))  # [B, H, S, D]
    logits = (q * scale).float() @ (k * scale).float().transpose(-1, -2)
    lane = (torch.arange(s) % 8) // 2  # the quad thread that holds each key
    ms, ls = [], []
    for t in range(4):
        cols = logits.masked_fill(lane != t, -float("inf"))
        m = torch.full(logits.shape[:-1], -float("inf"))
        l = torch.zeros(logits.shape[:-1])
        for k0 in range(0, s, KEY_TILE_LONG):
            tile = cols[..., k0:k0 + KEY_TILE_LONG]
            mn = torch.maximum(m, tile.amax(-1))
            live = mn > -float("inf")
            safe = torch.where(live, mn, torch.zeros_like(mn))
            step = l * torch.exp2((m - safe) * LOG2E) + torch.exp2(
                (tile - safe[..., None]) * LOG2E).sum(-1)
            l = torch.where(live, step, l)
            m = torch.where(live, mn, m)
        ms.append(m)
        ls.append(l)
    mq = torch.stack(ms).amax(0)
    total = sum(l * torch.exp2((m - mq) * LOG2E) for m, l in zip(ms, ls))
    weights = (torch.exp2((logits - mq[..., None]) * LOG2E)
               * (1.0 / total)[..., None]).to(torch.bfloat16).float()
    return (weights @ v.float()).permute(0, 2, 1, 3).to(torch.bfloat16)


@pytest.mark.parametrize("shape", [(1, 700, 2, 64), (2, 130, 1, 32)])
def test_mma_long_emulation_matches_pallas_interpret(shape):
    x = _qkv(shape, seed=10)
    got = mma_long_kernel_emulation(torch.from_numpy(x).to(torch.bfloat16))
    want = jattn.fused_attention(jnp.asarray(x, jnp.bfloat16), True).astype(jnp.float32)
    assert got.shape == (shape[0], shape[1], shape[2], shape[3])
    _compare(got, want, "bfloat16")


@pytest.mark.parametrize("shape", [(1, 2401, 1, 64), (2, 1, 1, 32), (1, 65, 2, 64)])
def test_mma_long_emulation_matches_plain_version(shape):
    x = torch.from_numpy(_qkv(shape, seed=11)).to(torch.bfloat16)
    _compare(mma_long_kernel_emulation(x), attention_reference(x).float().numpy(), "bfloat16")


@pytest.mark.parametrize("name", sorted(kernel_variants.K2_VARIANTS))
def test_k2_variants_apply_to_the_shipped_source(name):
    src = kernel_variants.variant_source("attention_mma", name)
    assert src is not None
    assert src != (kernel_variants._build.CSRC / "attention_mma.cu").read_text()
    assert "attention_mma_fwd_kernel" in src


@pytest.mark.parametrize("name", sorted(kernel_variants.K2_LONG_VARIANTS))
def test_k2_long_variants_apply_to_the_shipped_source(name):
    src = kernel_variants.variant_source("attention_mma_long", name)
    assert src is not None
    assert src != (kernel_variants._build.CSRC / "attention_mma_long.cu").read_text()
    assert "attention_mma_long_fwd_kernel" in src


KEY_TILE = 64  # keys a shared-memory tile of csrc/attention.cu


def scalar_kernel_emulation(qkv: torch.Tensor) -> torch.Tensor:
    """csrc/attention.cu's arithmetic on the CPU, for qkv [B, S, 3, H, D].
    float32, one pass: q scaled by round(D^-1/4) twice (K's factor folded
    in); per tile of 64 keys the row max updated, the running sum and output
    rescaled by exp(m_old - m_new), the weights exp(s - m) multiplied into
    V; the output divided by the sum at the end. bf16, two passes: q*s and
    k*s rounded to bf16; the max and the sum over all keys (the sum tile by
    tile, rescaled), then the weights exp(s - m) / l rounded to bf16 and
    multiplied into V; the output rounded to bf16."""
    d, s = qkv.shape[-1], qkv.shape[1]
    dt = qkv.dtype
    scale = torch.tensor(qk_scale(d, dt), dtype=dt)
    q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))  # [B, H, S, D]
    one_pass = dt == torch.float32
    if one_pass:
        q = (q * scale) * scale
        k = k.clone()
    else:
        q = (q * scale).float()
        k = (k * scale).float()
    v = v.float()
    logits = q @ k.transpose(-1, -2)  # [B, H, S, S] f32
    tiles = [slice(t, min(t + KEY_TILE, s)) for t in range(0, s, KEY_TILE)]
    m = torch.full(logits.shape[:-1], -float("inf"))
    l = torch.zeros(logits.shape[:-1])
    out = torch.zeros((*logits.shape[:-1], d))
    for t in tiles:
        mn = torch.maximum(m, logits[..., t].amax(-1))
        alpha = torch.exp(m - mn)
        p = torch.exp(logits[..., t] - mn[..., None])
        l = l * alpha + p.sum(-1)
        if one_pass:
            out = out * alpha[..., None] + p @ v[..., t, :]
        m = mn
    if one_pass:
        out = out / l[..., None]
    else:
        weights = (torch.exp(logits - m[..., None]) / l[..., None]).to(dt).float()
        out = weights @ v
    return out.permute(0, 2, 1, 3).to(dt)


@pytest.mark.parametrize("dtype,shape", [("float32", (1, 576, 4, 64)),
                                         ("float32", (2, 100, 2, 32)),
                                         ("bfloat16", (1, 600, 2, 64))])
def test_scalar_emulation_matches_pallas_interpret(dtype, shape):
    tdt, jdt = DTYPES[dtype]
    x = _qkv(shape, seed=8)
    got = scalar_kernel_emulation(torch.from_numpy(x).to(tdt))
    want = jattn.fused_attention(jnp.asarray(x, jdt), True).astype(jnp.float32)
    assert got.shape == (shape[0], shape[1], shape[2], shape[3]) and got.dtype == tdt
    _compare(got, want, dtype)


def test_scalar_check_raises_on_misaligned_qkv():
    aligned = torch.zeros((2, 64, 3, 2, 32), dtype=torch.float32)
    _check_qkv(aligned, "scalar")
    shifted = torch.zeros(aligned.numel() + 1)[1:].view(aligned.shape)
    assert shifted.data_ptr() % 16 != 0
    with pytest.raises(ValueError, match="aligned"):
        _check_qkv(shifted, "scalar")
