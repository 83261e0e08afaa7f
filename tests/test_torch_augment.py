"""The port's intensity augmentation (conditioned_diffusion_models_uad_torch/
data/augment.py) against the JAX package's, on the CPU. The JAX functions
draw from a PRNG key; the test reads the same draws out of that key (the
split structure of data/augment.py:23-97,202-216) and hands them to the port.

Tolerance 1e-5 absolute on slices in [0, 1]-ish: float32 pow/exp and FFTs
(pocketfft in XLA, PocketFFT/MKL in PyTorch) round differently by a few ulps."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conditioned_diffusion_models_uad_torch.data import augment as aug
from conditioned_diffusion_models_uad_tpu.data import augment as jaug

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)
B, H, W = 6, 32, 24


def _x(seed=0):
    return np.random.default_rng(seed).uniform(0, 1, size=(B, H, W, 1)).astype(np.float32)


def _t(a, dtype=None):
    return torch.from_numpy(np.array(a, dtype))


def jax_draws(key, b):
    """The draws ``aug_intensity_batch(key, x)`` makes, as an ``AugDraws``."""
    keys = jax.random.split(key, 8)

    def gate(k, p):
        return _t(jax.random.bernoulli(k, p, (b, 1, 1, 1))).reshape(b)

    k_ng, k_int, k_ax = jax.random.split(keys[7], 3)
    return aug.AugDraws(
        gamma_gate=gate(keys[0], 0.5),
        log_gamma=_t(jax.random.uniform(keys[1], (b, 1, 1, 1), minval=-0.3,
                                        maxval=0.3)).reshape(b),
        bias_gate=gate(keys[2], 0.25),
        bias_coeffs=_t(jax.random.uniform(keys[3], (b, aug.n_bias_coeffs()),
                                          minval=-0.5, maxval=0.5)),
        blur_gate=gate(keys[4], 0.25),
        blur_std=_t(jax.random.uniform(keys[5], (b,), minval=0.0, maxval=2.0)),
        ghost_gate=gate(keys[6], 0.5),
        ghost_num=_t(jax.random.randint(k_ng, (b,), 4, 11), np.int64),
        ghost_intensity=_t(jax.random.uniform(k_int, (b,), minval=0.5, maxval=1.0)),
        ghost_along_h=_t(jax.random.bernoulli(k_ax, 0.5, (b,))),
    )


def _compare(got, want):
    assert got.shape == want.shape == (B, H, W, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_gamma_matches_jax(seed):
    key = jax.random.PRNGKey(seed)
    x = _x(seed)
    lg = _t(jax.random.uniform(key, (B, 1, 1, 1), minval=-0.3, maxval=0.3)).reshape(B)
    _compare(aug.apply_gamma(torch.from_numpy(x), lg), jaug._rand_gamma(key, jnp.asarray(x)))


@pytest.mark.parametrize("seed", [0, 1])
def test_bias_field_matches_jax(seed):
    key = jax.random.PRNGKey(10 + seed)
    x = _x(seed)
    coeffs = _t(jax.random.uniform(key, (B, aug.n_bias_coeffs()), minval=-0.5, maxval=0.5))
    _compare(aug.apply_bias_field(torch.from_numpy(x), coeffs),
             jaug._rand_bias_field(key, jnp.asarray(x)))


@pytest.mark.parametrize("seed", [0, 1])
def test_blur_matches_jax(seed):
    key = jax.random.PRNGKey(20 + seed)
    x = _x(seed)
    std = _t(jax.random.uniform(key, (B,), minval=0.0, maxval=2.0))
    _compare(aug.apply_blur(torch.from_numpy(x), std), jaug._rand_blur(key, jnp.asarray(x)))


def test_blur_below_std_005_is_the_identity():
    x = torch.from_numpy(_x(5))
    std = torch.full((B,), 0.01)
    assert torch.equal(aug.apply_blur(x, std), x)


@pytest.mark.parametrize("seed", [0, 1])
def test_ghosting_matches_jax(seed):
    key = jax.random.PRNGKey(30 + seed)
    x = _x(seed)
    k_ng, k_int, k_ax = jax.random.split(key, 3)
    got = aug.apply_ghosting(
        torch.from_numpy(x),
        _t(jax.random.randint(k_ng, (B,), 4, 11), np.int64),
        _t(jax.random.uniform(k_int, (B,), minval=0.5, maxval=1.0)),
        _t(jax.random.bernoulli(k_ax, 0.5, (B,))))
    _compare(got, jaug._rand_ghosting(key, jnp.asarray(x)))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_aug_intensity_batch_matches_jax(seed):
    key = jax.random.PRNGKey(40 + seed)
    x = _x(seed)
    draws = jax_draws(key, B)
    _compare(aug.aug_intensity_apply(torch.from_numpy(x), draws),
             jaug.aug_intensity_batch(key, jnp.asarray(x)))


def test_draws_shapes_ranges_and_device():
    g = torch.Generator().manual_seed(0)
    d = aug.draw_aug_intensity(g, 500)
    assert d.gamma_gate.dtype == torch.bool and d.gamma_gate.shape == (500,)
    assert d.bias_coeffs.shape == (500, aug.n_bias_coeffs()) == (500, 10)
    assert -0.3 <= d.log_gamma.min() and d.log_gamma.max() <= 0.3
    assert 0.0 <= d.blur_std.min() and d.blur_std.max() <= 2.0
    assert d.ghost_num.min() == 4 and d.ghost_num.max() == 10
    assert 0.5 <= d.ghost_intensity.min() and d.ghost_intensity.max() <= 1.0
    for gate, p in ((d.gamma_gate, 0.5), (d.bias_gate, 0.25), (d.blur_gate, 0.25),
                    (d.ghost_gate, 0.5)):
        assert abs(gate.float().mean().item() - p) < 0.08
    again = aug.draw_aug_intensity(torch.Generator().manual_seed(0), 500)
    assert torch.equal(again.bias_coeffs, d.bias_coeffs)
    assert d.to("cpu").ghost_num.device.type == "cpu"
