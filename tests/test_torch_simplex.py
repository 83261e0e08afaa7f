"""The port's hash-gradient fractal simplex noise
(conditioned_diffusion_models_uad_torch/ops/simplex_hash.py) against the JAX
package's plain twin and its Pallas kernel in interpret mode, on the CPU.

Tolerance 1e-5 absolute, as tests/test_simplex_pallas.py holds the TPU
kernel against its twin: both sides evaluate the same float32 operations, in
the same order, on fields of magnitude ~2."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conditioned_diffusion_models_uad_torch.ops.simplex import make_noise_fn
from conditioned_diffusion_models_uad_torch.ops.simplex_hash import (
    fractal_noise_2d,
    fractal_noise_2d_hash,
)
from conditioned_diffusion_models_uad_tpu.ops import simplex as jsimplex
from conditioned_diffusion_models_uad_tpu.ops.simplex_pallas import (
    fractal_noise_2d_hash as jax_hash,
    fractal_noise_2d_pallas,
)

torch.set_num_threads(2)

SEEDS = [0, 1, 1234, 2**31 - 2]
TOL = 1e-5


@pytest.mark.parametrize("shape", [(96, 96), (37, 130)])
def test_plain_matches_jax_twin(shape):
    got = fractal_noise_2d_hash(torch.tensor(SEEDS, dtype=torch.int32), shape)
    assert got.shape == (len(SEEDS), *shape) and got.dtype == torch.float32
    for i, s in enumerate(SEEDS):
        want = np.asarray(jax_hash(jnp.int32(s), shape))
        np.testing.assert_allclose(got[i].numpy(), want, atol=TOL, rtol=0)
        assert np.abs(want).max() > 0.5


@pytest.mark.parametrize("shape", [(96, 96), (37, 130)])
def test_plain_matches_pallas_interpret(shape):
    seeds = [1234, 2**31 - 2]
    got = fractal_noise_2d(torch.tensor(seeds, dtype=torch.int32), shape)
    for i, s in enumerate(seeds):
        want = np.asarray(fractal_noise_2d_pallas(jnp.int32(s), shape, interpret=True))
        np.testing.assert_allclose(got[i].numpy(), want, atol=TOL, rtol=0)


def test_octave_parameters_match_jax():
    got = fractal_noise_2d_hash(torch.tensor([7], dtype=torch.int32), (40, 50),
                                octaves=3, persistence=0.5, frequency=16.0)
    want = np.asarray(jax_hash(jnp.int32(7), (40, 50), 3, 0.5, 16.0))
    np.testing.assert_allclose(got[0].numpy(), want, atol=TOL, rtol=0)


def test_wrapper_takes_plain_version_on_cpu_without_counting():
    before = fractal_noise_2d.launches
    seeds = torch.tensor([5, 6], dtype=torch.int32)
    assert torch.equal(fractal_noise_2d(seeds, (16, 16)),
                       fractal_noise_2d_hash(seeds, (16, 16)))
    assert fractal_noise_2d.launches == before
    with pytest.raises(ValueError):
        fractal_noise_2d(seeds.long(), (16, 16))


def test_ensemble_noise_fn_matches_jax_broadcast():
    """make_noise_fn: block n is seed n's field broadcast over its B slices
    and the channel, as the JAX Pallas noise path broadcasts one field."""
    noise_fn = make_noise_fn("simplex")
    seeds = [11, 2**31 - 2, 0]
    got = noise_fn(torch.tensor(seeds, dtype=torch.int32), (4, 96, 96, 1))
    assert got.shape == (12, 96, 96, 1)
    key = jax.random.PRNGKey(3)
    jfn = jsimplex.make_noise_fn("simplex", impl="pallas")
    for i, s in enumerate(seeds):
        block = got[4 * i:4 * (i + 1)].numpy()
        assert (block == block[:1]).all()
        want = np.asarray(jax_hash(jnp.int32(s), (96, 96)))
        np.testing.assert_allclose(block[0, :, :, 0], want, atol=TOL, rtol=0)
    # the JAX noise path draws its seed as randint(key, (), 0, int32max)
    seed = int(jax.random.randint(key, (), 0, jnp.iinfo(jnp.int32).max, jnp.int32))
    want = np.asarray(jfn(key, (2, 96, 96, 1)))
    got = noise_fn(torch.tensor([seed], dtype=torch.int32), (2, 96, 96, 1)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_gaussian_noise_fn_is_seeded():
    noise_fn = make_noise_fn("gaussian")
    seeds = torch.tensor([1, 2], dtype=torch.int32)
    a = noise_fn(seeds, (3, 8, 8, 1))
    assert a.shape == (6, 8, 8, 1)
    assert torch.equal(a, noise_fn(seeds, (3, 8, 8, 1)))
    assert not torch.equal(a[:3], a[3:])


# --------------------------------------------------------------------------- #
# the per-octave constants K1 takes from the host
# --------------------------------------------------------------------------- #
from conditioned_diffusion_models_uad_torch.ops.simplex_hash import octave_constants  # noqa: E402
from conditioned_diffusion_models_uad_tpu.ops import simplex_pallas  # noqa: E402

OCTAVE_PARAMS = [(6, 0.8, 64.0), (3, 0.5, 16.0), (5, 0.7, 10.3), (0, 0.8, 64.0)]


def _jax_loop_octaves(monkeypatch, octaves, persistence, frequency, w=8):
    """What the JAX loop (``simplex_pallas._fractal_body``) hands each octave:
    the x coordinates jj / f it passes, and the weight amp of that octave's
    term in float32, read with a stub octave that is 1 for octave o only."""
    xs, amps = [], []
    for o in range(octaves):
        calls = []

        def stub(x, y, seed, calls=calls, o=o):
            calls.append(x)
            return jnp.full_like(x, 1.0 if len(calls) - 1 == o else 0.0)

        monkeypatch.setattr(simplex_pallas, "_simplex2_hash", stub)
        out = simplex_pallas._fractal_body(1, w, jnp.uint32(0), octaves, persistence,
                                           frequency)
        xs.append(np.asarray(calls[o])[0])
        amps.append(np.asarray(out)[0, 0])
    return xs, amps


@pytest.mark.parametrize("octaves,persistence,frequency", OCTAVE_PARAMS)
def test_octave_constants_are_the_jax_loops_float32_values(monkeypatch, octaves,
                                                           persistence, frequency):
    consts = octave_constants(octaves, persistence, frequency)
    assert consts.dtype == torch.float32 and consts.shape == (2, octaves)
    xs, amps = _jax_loop_octaves(monkeypatch, octaves, persistence, frequency)
    jj = np.arange(8, dtype=np.float32)
    for o in range(octaves):
        ff, amp = consts[0, o].item(), consts[1, o].item()
        np.testing.assert_array_equal(jj / np.float32(ff), xs[o])
        assert np.float32(amp) == amps[o]
    # the double-precision recurrence, rounded once
    f, a = float(frequency), 1.0
    for o in range(octaves):
        assert consts[0, o].item() == np.float32(f) and consts[1, o].item() == np.float32(a)
        f, a = f / 2.0, a * persistence


@pytest.mark.parametrize("octaves,persistence,frequency", OCTAVE_PARAMS[1:3])
def test_plain_version_on_octave_constants_matches_jax_twin(octaves, persistence,
                                                            frequency):
    got = fractal_noise_2d_hash(torch.tensor([7, 2**31 - 2], dtype=torch.int32), (24, 40),
                                octaves, persistence, frequency)
    for i, s in enumerate((7, 2**31 - 2)):
        want = np.asarray(jax_hash(jnp.int32(s), (24, 40), octaves, persistence, frequency))
        np.testing.assert_allclose(got[i].numpy(), want, atol=TOL, rtol=0)
