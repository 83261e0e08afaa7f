"""The port's middle-block attention (conditioned_diffusion_models_uad_torch/
ops/attention.py) against the JAX package's plain twin and its Pallas kernel
in interpret mode, on the CPU; and the autograd Function's backward against
jax.grad of attention_reference.

Tolerances are those tests/test_attention_pallas.py holds the TPU kernel to:
fp32 2e-6 (the same float32 ops, summed in another order) and bf16 2e-2
(a weight or an output one bf16 ulp apart)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conditioned_diffusion_models_uad_torch.ops.attention import (
    attention_reference,
    fused_attention,
)
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
