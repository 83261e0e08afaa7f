"""The threefry2x32 keys of the JAX package, in numpy (counterpart of the
``jax.random`` calls that package makes: ``PRNGKey``, ``split`` (and
``split_keys`` over a stack of keys), ``fold_in``, ``randint`` for int32,
``uniform`` for float32 and ``permutation``).

Bit-equal to ``jax.random`` with its defaults (``jax_default_prng_impl``
threefry2x32, ``jax_threefry_partitionable`` on, 32-bit integers): a key is a
[2] uint32 array, and the i-th of ``n`` split keys, the key folded with
``i`` and the bits drawn at flat position ``i`` all hash the counter pair
(i >> 32, i & 0xFFFFFFFF) under the parent key. The port draws each eval
volume's noise seeds with it, so a volume gets the seeds the JAX package
gives it (``orchestrate.volume_seeds``), each SparK eval volume its mask
(``models/spark.py::eval_random_mask``), and the iterative samplers and the
patched reconstruction their key chains (``diffusion/gaussian.py``,
``models/tasks.py``).
"""
from __future__ import annotations

from typing import Sequence, Union

import numpy as np

INT32_MAX = 2**31 - 1
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _u32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.uint32)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def key_words(keys) -> np.ndarray:
    """Keys [..., 2] held as uint32 words or as int64 (a tensor's form of
    them), an array or a tensor, as uint32."""
    if hasattr(keys, "numpy"):
        keys = keys.cpu().numpy()
    return np.asarray(keys).astype(np.int64).astype(np.uint32)


def threefry2x32(key, x1, x2):
    """The Threefry-2x32 block cipher (20 rounds) of counters (x1, x2) under
    ``key`` [2]; returns the two uint32 output words, broadcast together."""
    key = _u32(key)
    ks = [key[..., 0], key[..., 1], key[..., 0] ^ key[..., 1] ^ _PARITY]
    with np.errstate(over="ignore"):
        x = [np.atleast_1d(_u32(x1) + ks[0]), np.atleast_1d(_u32(x2) + ks[1])]
        x = list(np.broadcast_arrays(*x))
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    shape = np.broadcast_shapes(np.shape(x1), np.shape(x2), np.shape(key)[:-1])
    return x[0].reshape(shape), x[1].reshape(shape)


def _counters(shape) -> tuple:
    """The uint64 iota over ``shape`` as (high, low) uint32 words."""
    n = np.arange(int(np.prod(shape, dtype=np.int64)), dtype=np.uint64).reshape(shape)
    return _u32(n >> np.uint64(32)), _u32(n & np.uint64(0xFFFFFFFF))


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a seed in int32 range: [0, seed]."""
    return np.array([0, int(seed) & 0xFFFFFFFF], dtype=np.uint32)


def split(key, num: Union[int, Sequence[int]] = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: keys [*num, 2]."""
    shape = (num,) if isinstance(num, int) else tuple(num)
    b1, b2 = threefry2x32(key, *_counters(shape))
    return np.stack([b1, b2], axis=-1)


def split_keys(keys, num: int = 2) -> np.ndarray:
    """``split`` over a stack of keys (the JAX package's
    ``diffusion/gaussian.py::split_keys``): keys [2] -> [num, 2], as
    ``split``; keys [G, 2] -> [num, G, 2], slot [m, v] being
    ``split(keys[v], num)[m]``."""
    keys = _u32(keys)
    if keys.ndim == 1:
        return split(keys, num)
    return np.moveaxis(split(keys[..., None, :], num), -2, 0)


def fold_in(key, data) -> np.ndarray:
    """``jax.random.fold_in(key, data)``; ``data`` may be an array of
    indices, giving keys [*data.shape, 2]."""
    d = _u32(np.asarray(data).astype(np.int64) & 0xFFFFFFFF)
    b1, b2 = threefry2x32(key, np.zeros_like(d), d)
    return np.stack([b1, b2], axis=-1)


def random_bits(key, shape=()) -> np.ndarray:
    """``jax.random.bits(key, shape, uint32)``."""
    b1, b2 = threefry2x32(key, *_counters(tuple(shape)))
    return b1 ^ b2


def randint(key, shape=(), minval: int = 0, maxval: int = INT32_MAX) -> np.ndarray:
    """``jax.random.randint(key, shape, minval, maxval, jnp.int32)`` for
    bounds in int32 range: two bit streams combined modulo the span, in
    wrapping uint32 arithmetic. ``key`` may be a stack [N, 2] when
    ``shape`` is (): one draw a key, [N]."""
    lo, hi = int(minval), int(maxval)
    if not (-2**31 <= lo <= INT32_MAX and -2**31 <= hi <= INT32_MAX):
        raise ValueError(f"randint bounds [{lo}, {hi}) outside int32")
    key = _u32(key)
    bits_shape = tuple(shape)
    if key.ndim > 1:
        if bits_shape != ():
            raise ValueError("a stack of keys draws scalars only")
        shape = key.shape[:-1]
    k1, k2 = split_keys(key)
    higher, lower = random_bits(k1, bits_shape), random_bits(k2, bits_shape)
    span = np.uint32(1 if hi <= lo else hi - lo)
    # 2**32 % span as JAX computes it: the square wraps at 2**32 first
    mult = np.uint32(((2**16 % int(span)) ** 2 & 0xFFFFFFFF) % int(span))
    with np.errstate(over="ignore"):
        offset = ((higher % span) * mult + lower % span) % span
    return (lo + offset.astype(np.int64)).astype(np.int32).reshape(tuple(shape))


def uniform(key, shape=(), minval: float = 0.0, maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: the top
    23 bits of each draw as the mantissa of a float in [1, 2), minus 1,
    scaled to [minval, maxval) with one rounding (XLA:CPU contracts the
    multiply-add) and clamped below at minval. Bits are drawn by flat
    position, so the first rows of a draw of shape (n + k, m) are the draw
    of shape (n, m)."""
    bits = random_bits(key, tuple(shape))
    one = np.array(1.0, np.float32).view(np.uint32)
    floats = ((bits >> np.uint32(9)) | one).view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    scaled = (floats.astype(np.float64) * np.float64(hi - lo) + np.float64(lo)).astype(np.float32)
    return np.maximum(lo, scaled).reshape(tuple(shape))


def permutation(key, n: int) -> np.ndarray:
    """``jax.random.permutation(key, n)`` for an int ``n``: ``arange(n)``
    sorted on 32-bit random keys, ties kept in index order (``lax.
    sort_key_val`` is stable), in ceil(3 ln n / ln(2**32 - 1)) rounds, each
    drawing its keys from the second half of a split (one round up to
    n = 1625). int32 [n]."""
    x = np.arange(n, dtype=np.int32)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    key = _u32(key)
    for _ in range(rounds):
        key, sub = split(key)
        bits = random_bits(sub, (n,))
        x = x[np.argsort(bits, kind="stable")]
    return x
