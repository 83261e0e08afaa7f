"""utils/prng.py against jax.random on the CPU (threefry2x32, partitionable
threefry, 32-bit integers: this JAX's defaults): PRNGKey, split, fold_in,
bits and randint, scalar and [b], on 1000 random keys and indices. Bit-equal;
no tolerance. Also the orchestrator's per-volume eval seeds against the
draws of the JAX task's noise (split of the volume key, randint to int32
max)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conditioned_diffusion_models_uad_torch.orchestrate import eval_key, volume_seeds
from conditioned_diffusion_models_uad_torch.utils import prng

N = 1000


def _keys(seed=0):
    rng = np.random.default_rng(seed)
    seeds = rng.integers(0, 2**31 - 1, N)
    data = rng.integers(0, 2**32, N, dtype=np.uint64)
    return seeds, data


def test_defaults_are_the_ported_ones():
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert jax.config.jax_threefry_partitionable
    assert not jax.config.jax_enable_x64


def test_prngkey_split_fold_in_bits_bit_equal():
    seeds, data = _keys()
    keys = jnp.stack([jax.random.PRNGKey(int(s)) for s in seeds])
    pkeys = np.stack([prng.PRNGKey(int(s)) for s in seeds])
    np.testing.assert_array_equal(np.asarray(keys), pkeys)
    want_fold = np.asarray(jax.vmap(jax.random.fold_in)(keys, jnp.asarray(data, jnp.uint32)))
    got_fold = np.stack([prng.fold_in(k, int(d)) for k, d in zip(pkeys, data)])
    np.testing.assert_array_equal(got_fold, want_fold)
    # fold_in over an index array at once
    np.testing.assert_array_equal(prng.fold_in(pkeys[0], data[:7]),
                                  np.asarray(jax.vmap(lambda d: jax.random.fold_in(
                                      keys[0], d))(jnp.asarray(data[:7], jnp.uint32))))
    want_split = np.asarray(jax.vmap(lambda k: jax.random.split(k, 3))(keys))
    got_split = np.stack([prng.split(k, 3) for k in pkeys])
    np.testing.assert_array_equal(got_split, want_split)
    np.testing.assert_array_equal(prng.split(pkeys[1], (2, 3)),
                                  np.asarray(jax.random.split(keys[1], (2, 3))))
    want_bits = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (5,), jnp.uint32))(keys))
    got_bits = np.stack([prng.random_bits(k, (5,)) for k in pkeys])
    np.testing.assert_array_equal(got_bits, want_bits)


@pytest.mark.parametrize("shape,lo,hi", [((), 0, 2**31 - 1), ((6,), 0, 2**31 - 1),
                                         ((6,), 0, 1000), ((2, 3), -50, 17),
                                         ((4,), -2**31, 2**31 - 1), ((3,), 5, 5),
                                         ((3,), 0, 2**16)])
def test_randint_bit_equal(shape, lo, hi):
    seeds, _ = _keys(1)
    keys = jnp.stack([jax.random.PRNGKey(int(s)) for s in seeds])
    want = np.asarray(jax.vmap(lambda k: jax.random.randint(k, shape, lo, hi, jnp.int32))(keys))
    got = np.stack([prng.randint(prng.PRNGKey(int(s)), shape, lo, hi) for s in seeds])
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_randint_rejects_bounds_outside_int32():
    with pytest.raises(ValueError):
        prng.randint(prng.PRNGKey(0), (), 0, 2**31)


def test_volume_seeds_are_the_jax_task_draws():
    """Row v: randint(split(fold_in(PRNGKey(seed + 1000 + fold), i_v), E)[m],
    (), 0, int32 max), the seeds the JAX orchestrator's grouped dispatch
    gives volume i_v (orchestrate.py:110-120,312-317; models/tasks.py:380)."""
    from conditioned_diffusion_models_uad_tpu.diffusion.gaussian import split_keys

    key = jax.random.PRNGKey(3141 + 1000 + 1)
    idxs = np.array([0, 5, 2, 2], np.int32)
    vol_keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.asarray(idxs))
    member = split_keys(vol_keys, 3)  # [E, G, 2]
    want = np.asarray(jax.vmap(jax.vmap(
        lambda k: jax.random.randint(k, (), 0, 2**31 - 1, jnp.int32)))(member)).T
    got = volume_seeds(eval_key(3141, 1), idxs, 3)
    assert got.dtype.is_floating_point is False and tuple(got.shape) == (4, 3)
    np.testing.assert_array_equal(got.numpy(), want)
