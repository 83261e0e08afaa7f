"""The port's eval post-processing (eval/postprocess.py) against the JAX
package's on the CPU, same numpy inputs.

Tolerance: bit-equal where the arithmetic is a selection or one rounding per
voxel: the residual, the brain-mask erosion (0-3 iterations), the median
filter at kernels 3 and 5 on odd shapes (border voxels included, where the
symmetric pad decides the window) and the whole residual chain. Masked
means are float32 sums in another order: 1e-6 relative. ``resize_trilinear``
rounds its source positions otherwise than linspace + map_coordinates:
1e-5 absolute on values in [0, 1]."""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from conditioned_diffusion_models_uad_torch.eval import postprocess as P
from conditioned_diffusion_models_uad_tpu.eval import postprocess as JP

RTOL_MEAN = 1e-6
TOL_RESIZE = 1e-5


def _vols(shape, seed):
    rng = np.random.default_rng(seed)
    orig = rng.random(shape, np.float32)
    reco = np.clip(orig + 0.2 * rng.standard_normal(shape).astype(np.float32), 0, 1)
    mask = np.zeros(shape, np.float32)
    h, w, _ = shape
    mask[1:h - 1, 2:w - 1] = 1.0
    mask[h // 2, w // 2] = 0.0  # a hole that erodes outwards
    return orig, reco, mask


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("iterations", [0, 1, 2, 3])
def test_erosion_bit_equal(iterations):
    rng = np.random.default_rng(iterations)
    mask = (rng.random((15, 17, 4)) < 0.85).astype(np.float32)
    diff = rng.random((15, 17, 4), np.float32)
    got = P._erode_cross_2d(_t(mask), iterations).numpy()
    want = np.asarray(JP._erode_cross_2d(jnp.asarray(mask), iterations))
    np.testing.assert_array_equal(got, want)
    if iterations:
        # scipy's own erosion per depth slice, border_value 0
        cross = ndi.generate_binary_structure(2, 1)
        for s in range(mask.shape[-1]):
            np.testing.assert_array_equal(
                got[..., s], ndi.binary_erosion(mask[..., s] > 0, cross, iterations))
    np.testing.assert_array_equal(
        P.apply_brainmask_volume(_t(diff), _t(mask), iterations).numpy(),
        np.asarray(JP.apply_brainmask_volume(jnp.asarray(diff), jnp.asarray(mask),
                                              iterations)) if iterations else diff * (mask > 0))


@pytest.mark.parametrize("kernel,shape", [(3, (9, 7, 5)), (3, (6, 11, 3)),
                                          (5, (9, 7, 5)), (5, (11, 2, 7))])
def test_median_bit_equal_at_borders(kernel, shape):
    rng = np.random.default_rng(kernel * 10 + shape[1])
    vol = rng.random(shape, np.float32)
    got = P.median_filter_3d(_t(vol), kernel).numpy()
    want = np.asarray(JP.median_filter_3d(jnp.asarray(vol), kernel))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ndi.median_filter(vol, size=kernel, mode="reflect"))


@pytest.mark.parametrize("mode", ["l1", "l2"])
def test_postprocess_chain_bit_equal(mode):
    orig, reco, mask = _vols((13, 11, 7), 3)
    kw = dict(residualmode=mode, erode_iterations=1, median_kernel=5)
    got = P.postprocess_residual(_t(orig), _t(reco), _t(mask), **kw)
    want = JP.postprocess_residual(jnp.asarray(orig), jnp.asarray(reco), jnp.asarray(mask), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(P.slice_anomaly_scores(got, _t(mask)).numpy(),
                               np.asarray(JP.slice_anomaly_scores(want, jnp.asarray(mask))),
                               rtol=RTOL_MEAN)
    np.testing.assert_allclose(float(P.volume_anomaly_score(got, _t(mask))),
                               float(JP.volume_anomaly_score(want, jnp.asarray(mask))),
                               rtol=RTOL_MEAN)


@pytest.mark.parametrize("seg_kind", ["lesion", "empty", "full"])
def test_reco_errors(seg_kind):
    orig, reco, _ = _vols((12, 10, 6), 4)
    seg = {"lesion": np.pad(np.ones((4, 3, 2), np.float32), ((2, 6), (3, 4), (1, 3))),
           "empty": np.zeros(orig.shape, np.float32),
           "full": np.ones(orig.shape, np.float32)}[seg_kind]
    got = {k: float(v) for k, v in P.reco_errors(_t(orig), _t(reco), _t(seg)).items()}
    want = {k: float(v) for k, v in JP.reco_errors(
        jnp.asarray(orig), jnp.asarray(reco), jnp.asarray(seg)).items()}
    assert got.keys() == want.keys()
    for k in want:
        assert np.isnan(got[k]) == np.isnan(want[k]), k
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL_MEAN, err_msg=k)
    if seg_kind == "empty":
        assert np.isnan(got["l1recoErrorUnhealthy"]) and np.isnan(got["l2recoErrorUnhealthy"])
    if seg_kind == "full":
        assert np.isnan(got["l1recoErrorHealthy"])


@pytest.mark.parametrize("src,size", [((7, 9, 5), (13, 17, 9)), ((12, 10, 8), (5, 7, 3)),
                                      ((6, 6, 4), (6, 11, 1))])
def test_resize_trilinear(src, size):
    vol = np.random.default_rng(5).random(src, np.float32)
    got = P.resize_trilinear(_t(vol), size).numpy()
    want = np.asarray(JP.resize_trilinear(jnp.asarray(vol), size))
    assert got.shape == tuple(size)
    np.testing.assert_allclose(got, want, atol=TOL_RESIZE, rtol=0)
