"""data/transforms.py against the JAX package's transforms on the CPU, on odd
shapes (21x18x13 and others) of seeded [0, 1] data, with empty-mask,
all-zero and bucket-padded inputs.

Tolerances: crop_or_pad, crop_or_pad_dynamic, zero_beyond_extent,
nearest_downsample, percentile_rescale and bspline_prefilter are bit-equal
(the port rounds the percentile interpolation and the prefilter's
multiply-adds once, where XLA:CPU fuses them). curvature_flow (both forms)
and the B-spline resample are held at 1e-5 absolute: XLA:CPU contracts
some of their multiply-adds and the port does not follow each one (measured
at most 1.2e-7 and 3.6e-7 on these inputs)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conditioned_diffusion_models_uad_torch.data import transforms as T
from conditioned_diffusion_models_uad_tpu.data import transforms as J

torch.set_num_threads(2)

TOL = 1e-5
SHAPES = [(21, 18, 13), (9, 14, 5), (3, 4, 2), (1, 6, 7)]


def _vol(shape, seed=0, zero_share=0.3):
    rng = np.random.default_rng(seed)
    vol = rng.uniform(0, 1, shape).astype(np.float32)
    vol[rng.uniform(size=shape) < zero_share] = 0
    return vol


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _exact(got, want):
    got = got.numpy() if torch.is_tensor(got) else got
    np.testing.assert_array_equal(got, np.asarray(want))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("target", [(16, 24, 13), (7, 7, 7), (22, 17, 14)])
def test_crop_or_pad_exact(shape, target):
    vol = _vol(shape)
    _exact(T.crop_or_pad(_t(vol), target), J.crop_or_pad(vol, target))
    _exact(T.crop_or_pad(_t(vol), target, pad_value=-1.0), J.crop_or_pad(vol, target, -1.0))


@pytest.mark.parametrize("shape", SHAPES)
def test_extent_forms_exact(shape):
    """Bucket-padded inputs: zero_beyond_extent and crop_or_pad_dynamic of
    a volume end-padded to a multiple of 8 against the JAX forms (traced
    extent)."""
    vol = _vol(shape, 1)
    ext = shape
    padded = np.zeros(tuple(-(-s // 8) * 8 for s in shape), np.float32)
    padded[tuple(slice(0, s) for s in shape)] = vol
    noisy = padded + 0.5  # nonzero past the extent: zero_beyond_extent's job
    _exact(T.zero_beyond_extent(_t(noisy), ext),
           J.zero_beyond_extent(jnp.asarray(noisy), jnp.asarray(ext)))
    for target in [(16, 24, 13), (7, 7, 7)]:
        want = J.crop_or_pad_dynamic(jnp.asarray(padded), jnp.asarray(ext, jnp.int32), target)
        _exact(T.crop_or_pad_dynamic(_t(padded), ext, target), want)
        _exact(T.crop_or_pad_dynamic(_t(padded), ext, target), J.crop_or_pad(vol, target))


@pytest.mark.parametrize("case", ["random", "empty_mask", "all_zero", "constant", "one_voxel"])
def test_percentile_rescale_exact(case):
    for seed, shape in enumerate(SHAPES[:2] + [(40, 36, 20)]):
        vol = _vol(shape, seed) * (1 + seed)
        mask = (np.random.default_rng(seed + 7).uniform(size=shape) < 0.7).astype(np.float32)
        if case == "empty_mask":
            mask[:] = 0
        elif case == "all_zero":
            vol[:] = 0
        elif case == "constant":
            vol[:] = 0.25
        elif case == "one_voxel":
            mask[:] = 0
            mask[0, 0, 0] = 1
        want = J.percentile_rescale(jnp.asarray(vol), jnp.asarray(mask))
        got = T.percentile_rescale(_t(vol), _t(mask))
        assert not torch.isnan(got).any()
        _exact(got, want)
    got = T.percentile_rescale(_t(vol), _t(mask), 0.1, 0.9, 5.0, 95.0)
    _exact(got, J.percentile_rescale(jnp.asarray(vol), jnp.asarray(mask), 0.1, 0.9, 5.0, 95.0))


@pytest.mark.parametrize("shape", SHAPES[:3])
def test_curvature_flow_within_tolerance(shape):
    vol = _vol(shape, 2)
    got = T.curvature_flow(_t(vol))
    _close(got, J.curvature_flow(jnp.asarray(vol)))
    _exact(T.curvature_flow(torch.zeros(shape)), np.zeros(shape, np.float32))
    # the extent form on a bucket-padded copy equals the plain form on the
    # unpadded volume, zero beyond
    padded = np.zeros(tuple(-(-s // 8) * 8 for s in shape), np.float32)
    padded[tuple(slice(0, s) for s in shape)] = vol
    got_e = T.curvature_flow(_t(padded), ext=shape)
    _close(got_e, J.curvature_flow(jnp.asarray(padded), ext=jnp.asarray(shape)))
    inner = tuple(slice(0, s) for s in shape)
    _exact(got_e[inner], got)
    got_e[inner] = 0
    assert not got_e.any()


@pytest.mark.parametrize("shape", SHAPES)
def test_bspline_prefilter_exact(shape):
    vol = _vol(shape, 3)
    _exact(T.bspline_prefilter(_t(vol)), J.bspline_prefilter(jnp.asarray(vol)))


@pytest.mark.parametrize("shape", SHAPES[:3] + [(40, 36, 20)])
def test_bspline_resample_within_tolerance(shape):
    vol = _vol(shape, 4)
    got = T.bspline_downsample(_t(vol), 2.0)
    assert tuple(got.shape) == tuple(-(-s // 2) for s in shape)
    _close(got, J.bspline_downsample(jnp.asarray(vol), 2.0))
    out = (max(1, shape[0] // 2), shape[1] + 3, max(1, shape[2] - 1))
    _close(T.bspline_resample_to(_t(vol), out),
           J.bspline_resample_to(jnp.asarray(vol), out))
    _close(T.bspline_downsample(torch.zeros(shape), 2.0),
           np.zeros(got.shape, np.float32))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("factor", [2.0, 1.5, 3.0])
def test_nearest_downsample_exact(shape, factor):
    lab = (_vol(shape, 5) > 0.5).astype(np.float32)
    _exact(T.nearest_downsample(_t(lab), factor), J.nearest_downsample(jnp.asarray(lab), factor))


def test_round_half_to_even_as_jnp():
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, 3.5])
    _exact(torch.round(x), jnp.round(jnp.asarray(x.numpy())))
