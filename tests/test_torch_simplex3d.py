"""The port's 3D simplex noise (conditioned_diffusion_models_uad_torch/ops/
simplex3d.py) against the JAX package's ``ops/simplex3d.py`` on the CPU:
``fractal_noise_3d``, ``fractal_noise_3d_fixed_t``, the random-parameter
pool and the ``SimplexNoise`` API.

Tolerance 2e-6 absolute on fields of magnitude up to ~3: both compute the
same float32 operations, and XLA:CPU contracts some multiply-adds into FMAs
(measured 6e-7). ``rand_2d_octaves`` is the 2D hash field, held at
tests/test_torch_simplex.py's 1e-5 against the JAX package's plain twin of
its Pallas kernel."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conditioned_diffusion_models_uad_torch.ops import simplex3d as s3
from conditioned_diffusion_models_uad_tpu.ops import simplex3d as js3

torch.set_num_threads(2)

TOL = dict(atol=2e-6, rtol=0)


@pytest.mark.parametrize("seed", [0, 12345, -7, 2**31 - 1])
@pytest.mark.parametrize("octaves,persistence,frequency", [(6, 0.8, 16.0), (3, 0.5, 5.0)])
def test_fractal_noise_3d_matches_jax(seed, octaves, persistence, frequency):
    shape = (7, 20, 24)
    got = s3.fractal_noise_3d(seed, shape, octaves, persistence, frequency, device="cpu")
    want = js3.fractal_noise_3d(jnp.int32(seed), shape, octaves, persistence, frequency)
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("seed", [0, 99, -123456])
@pytest.mark.parametrize("t", [0.0, 3.7, 250.0])
def test_fractal_noise_3d_fixed_t_matches_jax(seed, t):
    got = s3.fractal_noise_3d_fixed_t(seed, t, (20, 24), 4, 0.6, 8.0, device="cpu")
    want = js3.fractal_noise_3d_fixed_t(jnp.int32(seed), t, (20, 24), 4, 0.6, 8.0)
    assert got.shape == (1, 20, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_hash_gradients_are_the_twelve_edges():
    ii = torch.arange(-50, 50, dtype=torch.int32)
    gx, gy, gz = s3._hash_grad3(ii, ii * 7, ii * 13, torch.tensor(5))
    g = torch.stack([gx, gy, gz], 1)
    assert ((g.abs().sum(1) == 2) & ((g == 0).sum(1) == 1)).all()
    assert len({tuple(r) for r in g.tolist()}) == 12


def test_random_param_pool_and_draw_order():
    assert s3.RANDOM_PARAM_POOL == js3.RANDOM_PARAM_POOL
    got = s3.gen_simplex_noise_random_param(np.random.default_rng(3), (16, 20), 7.0,
                                            device="cpu")
    want = js3.gen_simplex_noise_random_param(np.random.default_rng(3), (16, 20), 7.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_simplex_noise_api_matches_jax():
    ours, theirs = s3.SimplexNoise(seed=42, device="cpu"), js3.SimplexNoise(seed=42)
    np.testing.assert_allclose(ours.rand_3d_octaves((5, 12, 16), 2, 0.5, 8).numpy(),
                               np.asarray(theirs.rand_3d_octaves((5, 12, 16), 2, 0.5, 8)),
                               **TOL)
    np.testing.assert_allclose(
        ours.rand_3d_fixed_T_octaves((12, 16), 9, 3, 0.7, 8).numpy(),
        np.asarray(theirs.rand_3d_fixed_T_octaves((12, 16), 9, 3, 0.7, 8)), **TOL)
    got2d = ours.rand_2d_octaves((24, 20), 6, 0.8, 64)
    assert got2d.shape == (24, 20)
    np.testing.assert_allclose(got2d.numpy(),
                               np.asarray(theirs.rand_2d_octaves((24, 20), 6, 0.8, 64)),
                               atol=1e-5, rtol=0)
    ours.newSeed(7)
    theirs.newSeed(7)
    np.testing.assert_allclose(ours.rand_3d_octaves((4, 8, 8)).numpy(),
                               np.asarray(theirs.rand_3d_octaves((4, 8, 8))), **TOL)
    ours.newSeed()
    assert 0 <= ours._seed < 2**31 - 1


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        s3.SimplexNoise(0)
    with pytest.raises(RuntimeError):
        s3.fractal_noise_3d(0, (2, 4, 4))
    # a CPU seed tensor keeps the CPU
    assert s3.fractal_noise_3d(torch.tensor(3), (2, 4, 4)).device.type == "cpu"
