"""The port's fused GroupNorm+FiLM+SiLU (conditioned_diffusion_models_uad_torch/
ops/fused_norm.py) against the JAX package's plain twin and its Pallas kernel
in interpret mode, on the CPU, from the same numpy inputs.

On the CPU the port's wrapper is its plain version (float32 math, one cast at
the end), so it is held at the tolerances tests/test_fused_norm.py holds the
TPU kernel to against the twin: 2e-5 in float32 (the same float32 operations
summed in another order) and rtol = atol = 2e-2 in bfloat16 (the kernel folds
the affine into bf16 coefficients; one or two bf16 ulps at |y| ~ 1-4)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conditioned_diffusion_models_uad_torch.ops.fused_norm import (
    fused_groupnorm_silu,
    groupnorm_silu_reference,
)
from conditioned_diffusion_models_uad_tpu.ops import fused_norm as jnorm

torch.set_num_threads(2)

TOL = {"float32": dict(atol=2e-5, rtol=0.0), "bfloat16": dict(atol=2e-2, rtol=2e-2)}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
SHAPE = (3, 8, 8, 256)  # tests/test_fused_norm.py's shape: 8 channels a group


def _inputs(film_rows, seed=0, shape=SHAPE):
    rng = np.random.default_rng(seed)
    b, c = shape[0], shape[-1]
    x = rng.normal(0.3, 1.5, size=shape).astype(np.float32)
    gamma = (rng.normal(size=c) * 0.1 + 1.0).astype(np.float32)
    beta = (rng.normal(size=c) * 0.1).astype(np.float32)
    film = None
    if film_rows is not None:
        rows = b if film_rows == "B" else 1
        film = tuple((rng.normal(size=(rows, c)) * 0.2).astype(np.float32) for _ in range(2))
    return x, gamma, beta, film


def _torch_args(x, gamma, beta, film, tdt):
    tf = None if film is None else tuple(torch.from_numpy(f) for f in film)
    return torch.from_numpy(x).to(tdt), torch.from_numpy(gamma), torch.from_numpy(beta), tf


def _jax_args(x, gamma, beta, film, jdt):
    jf = None if film is None else tuple(jnp.asarray(f) for f in film)
    return jnp.asarray(x, jdt), jnp.asarray(gamma), jnp.asarray(beta), jf


def _compare(got, want, dtype):
    assert got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **TOL[dtype])


CASES = [(film, silu) for film in (None, "B", "1") for silu in (True, False)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("film,silu", CASES)
def test_reference_matches_jax_reference(dtype, film, silu):
    tdt, jdt = DTYPES[dtype]
    x, gamma, beta, f = _inputs(film)
    b, h, w, c = x.shape
    got = groupnorm_silu_reference(*_torch_args(x.reshape(b, h * w, c), gamma, beta, f, tdt),
                                   apply_silu=silu)
    want = jnorm.groupnorm_silu_reference(
        *_jax_args(x.reshape(b, h * w, c), gamma, beta, f, jdt), apply_silu=silu)
    assert got.dtype == tdt
    _compare(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("film,silu", CASES)
def test_fused_matches_pallas_interpret(dtype, film, silu):
    tdt, jdt = DTYPES[dtype]
    x, gamma, beta, f = _inputs(film, seed=1)
    got = fused_groupnorm_silu(*_torch_args(x, gamma, beta, f, tdt), apply_silu=silu)
    want = jnorm.fused_groupnorm_silu(*_jax_args(x, gamma, beta, f, jdt), apply_silu=silu,
                                      use_pallas=True, interpret=True)
    _compare(got, want, dtype)


def test_three_dim_input_eps_and_groups():
    """[B, N, C] input, a non-default eps and group count, at a variance
    where eps matters."""
    x, gamma, beta, f = _inputs("B", seed=2, shape=(2, 24, 64))
    x = x * 1e-3
    got = fused_groupnorm_silu(*_torch_args(x, gamma, beta, f, torch.float32),
                               groups=16, eps=1e-5)
    want = jnorm.fused_groupnorm_silu(*_jax_args(x, gamma, beta, f, jnp.float32),
                                      groups=16, eps=1e-5, use_pallas=True, interpret=True)
    _compare(got, want, "float32")


def test_cpu_is_the_plain_version_and_not_counted():
    x, gamma, beta, f = _torch_args(*_inputs("1", seed=3), torch.float32)
    before = fused_groupnorm_silu.launches
    got = fused_groupnorm_silu(x, gamma, beta, f)
    b, h, w, c = x.shape
    want = groupnorm_silu_reference(x.reshape(b, h * w, c), gamma, beta, f).reshape(x.shape)
    assert torch.equal(got, want)
    assert fused_groupnorm_silu.launches == before
    with pytest.raises(ValueError):
        fused_groupnorm_silu(x[0, 0], gamma, beta)
