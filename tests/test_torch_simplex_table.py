"""The table simplex path (ops/simplex.py) and prng.permutation against the
JAX package's table path on the CPU (conditioned_diffusion_models_uad_tpu/
ops/simplex.py), no tolerance: the reference's LCG permutation and
``jax.random.permutation(key, 256)`` on 1,000 keys are equal; opensimplex2,
fractal_noise_2d and ``make_noise_fn(impl='table')`` are bit-equal to the
jitted JAX functions (the port rounds as XLA:CPU's program does: folded
offset constants, and FMAs where LLVM contracts a multiply into an add)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conditioned_diffusion_models_uad_torch.ops import simplex as P
from conditioned_diffusion_models_uad_torch.utils import prng
from conditioned_diffusion_models_uad_tpu.diffusion.gaussian import split_keys
from conditioned_diffusion_models_uad_tpu.ops import simplex as J

N = 1000


def _keys(n, seed=0):
    return np.random.default_rng(seed).integers(0, 2**32, (n, 2), dtype=np.uint64).astype(
        np.uint32)


@pytest.mark.parametrize("seed", [0, 3, 12345, 2**40 + 7])
def test_perm_from_seed_lcg_equal(seed):
    np.testing.assert_array_equal(P.perm_from_seed_lcg(seed), J.perm_from_seed_lcg(seed))


@pytest.mark.parametrize("n", [256, 5, 2000])
def test_permutation_bit_equal(n):
    """One sort round for n <= 1625, two above."""
    keys = _keys(N if n == 256 else 50, seed=n)
    want = np.asarray(jax.vmap(lambda k: jax.random.permutation(k, n))(jnp.asarray(keys)))
    got = np.stack([prng.permutation(k, n) for k in keys])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(P.perm_from_key(keys[0]), np.asarray(J.perm_from_key(
        jnp.asarray(keys[0]))))


def test_stacked_split_and_randint_bit_equal():
    keys = _keys(64, seed=1)
    np.testing.assert_array_equal(prng.split_keys(keys, 3),
                                  np.asarray(split_keys(jnp.asarray(keys), 3)))
    np.testing.assert_array_equal(prng.split_keys(keys[0], 3),
                                  np.asarray(jax.random.split(jnp.asarray(keys[0]), 3)))
    want = jax.vmap(lambda k: jax.random.randint(k, (), 0, 2**31 - 1))(jnp.asarray(keys))
    np.testing.assert_array_equal(prng.randint(keys), np.asarray(want))


def test_opensimplex2_bit_equal():
    rng = np.random.default_rng(2)
    x = rng.uniform(-60, 60, 20000).astype(np.float32)
    y = rng.uniform(-60, 60, 20000).astype(np.float32)
    for key in _keys(3, seed=3):
        perm = P.perm_from_key(key)
        want = jax.jit(J.opensimplex2)(jnp.asarray(x), jnp.asarray(y), jnp.asarray(perm))
        got = P.opensimplex2(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(perm))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape,octaves", [((96, 96), 6), ((32, 32), 6), ((40, 24), 3),
                                           ((16, 16), 1)])
def test_fractal_and_noise_fn_bit_equal(shape, octaves):
    keys = _keys(4, seed=shape[0] + octaves)
    fn = P.make_noise_fn("simplex", octaves, impl="table")
    got = fn(torch.from_numpy(keys.astype(np.int64)), (2, *shape, 1))
    assert got.shape == (8, *shape, 1) and got.dtype == torch.float32
    for i, key in enumerate(keys):
        want = np.asarray(J.gen_simplex_noise_nhwc(jnp.asarray(key), (2, *shape, 1), octaves))
        np.testing.assert_array_equal(got[2 * i:2 * i + 2].numpy(), want)
        perm = P.perm_from_key(key)
        field = P.fractal_noise_2d(shape, torch.from_numpy(perm), octaves)
        np.testing.assert_array_equal(field.numpy(), want[0, :, :, 0])
        np.testing.assert_array_equal(
            P.gen_simplex_noise(key, (3, *shape), octaves).numpy(),
            np.asarray(J.gen_simplex_noise(jnp.asarray(key), (3, *shape), octaves)))


def test_table_is_picked_only_by_name():
    """'hash' stays the default; 'table' takes keys; no other name."""
    seeds = torch.tensor([5, 6], dtype=torch.int32)
    hashed = P.make_noise_fn("simplex")(seeds, (1, 16, 16, 1))
    assert hashed.shape == (2, 16, 16, 1)
    with pytest.raises(ValueError):
        P.make_noise_fn("simplex", impl="pallas")
    with pytest.raises(ValueError):
        P.make_noise_fn("gaussian", impl="table")
