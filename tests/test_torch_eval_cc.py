"""The port's connected components (eval/cc.py) and Hausdorff distance
(eval/hausdorff.py) against the JAX package's and scipy's on the CPU.

Tolerance: none. Roots are integers (the minimum flat index of each
component) and must equal the JAX labeler's; partitions and the size filter
must equal scipy's; squared distances are integers exact in float32, so the
EDT and the squared Hausdorff pair equal JAX's and scipy's bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from conditioned_diffusion_models_uad_torch.eval import cc, hausdorff
from conditioned_diffusion_models_uad_torch.eval.metrics import (
    filter_3d_connected_components,
    hausdorff_distance,
)
from conditioned_diffusion_models_uad_tpu.eval import cc as jcc
from conditioned_diffusion_models_uad_tpu.eval import hausdorff as jhd


def _partition_equal(mask, labels) -> bool:
    ref, n = ndi.label(mask, structure=np.ones((3, 3, 3), bool))
    pairs = set(zip(ref[mask].tolist(), labels[mask].tolist()))
    return len(pairs) == n == len({a for a, _ in pairs}) == len({b for _, b in pairs})


def _snake():
    """One serpentine component of geodesic length ~H*W/2."""
    mask = np.zeros((20, 20, 3), bool)
    mask[0:20:2, :, 1] = True
    for r in range(0, 18, 4):
        mask[r + 1, 19, 1] = True
    for r in range(2, 18, 4):
        mask[r + 1, 0, 1] = True
    return mask


@pytest.mark.parametrize("density", [0.05, 0.3, 0.7])
def test_roots_equal_jax_and_partition_equals_scipy(density):
    rng = np.random.default_rng(int(density * 100))
    mask = rng.random((19, 23, 11)) < density
    roots, rounds = cc.label_rounds(torch.from_numpy(mask))
    roots = roots.numpy()
    np.testing.assert_array_equal(roots, np.asarray(jcc.label_components_3d(mask)))
    assert _partition_equal(mask, roots)
    assert (roots[~mask] == mask.size).all()
    assert rounds >= 1


def test_long_snake_converges_in_few_rounds():
    mask = _snake()
    roots, rounds = cc.label_rounds(torch.from_numpy(mask))
    roots = roots.numpy()
    assert len(np.unique(roots[mask])) == 1
    assert roots[mask][0] == np.flatnonzero(mask.ravel())[0]
    np.testing.assert_array_equal(roots, np.asarray(jcc.label_components_3d(mask)))
    # 209 voxels end to end: the hook alone takes ~209 rounds, pointer
    # jumping 21 (the JAX while-loop takes the same steps)
    assert rounds <= mask.sum() // 8


def test_float64_labels_past_float32_range(monkeypatch):
    """Past 2^24 voxels the hook pools float64 labels; forced here on a small
    volume, it must give the same roots."""
    mask = np.random.default_rng(3).random((9, 10, 7)) < 0.4
    want = cc.label_components_3d(torch.from_numpy(mask))
    monkeypatch.setattr(cc, "_F32_EXACT", 0)
    np.testing.assert_array_equal(cc.label_components_3d(torch.from_numpy(mask)).numpy(),
                                  want.numpy())


@pytest.mark.parametrize("min_size", [1, 8, 30])
def test_size_filter(min_size):
    mask = np.random.default_rng(min_size).random((21, 18, 13)) < 0.25
    got = cc.filter_3d_connected_components_device(torch.from_numpy(mask), min_size).numpy()
    np.testing.assert_array_equal(got, filter_3d_connected_components(mask, min_size))
    np.testing.assert_array_equal(
        got, np.asarray(jcc.filter_3d_connected_components_device(mask, min_size)))


def test_size_filter_boundary_empty_full():
    mask = np.zeros((12, 12, 6), bool)
    mask[1, 1:8, 1] = True  # 7 voxels: dropped at min_size 8
    mask[5, 1:9, 3] = True  # 8 voxels: kept
    got = cc.filter_3d_connected_components_device(torch.from_numpy(mask), 8).numpy()
    assert not got[1].any() and got[5, 1:9, 3].all()
    for m in (np.zeros((5, 6, 4), bool), np.ones((5, 6, 4), bool)):
        np.testing.assert_array_equal(
            cc.filter_3d_connected_components_device(torch.from_numpy(m), 8).numpy(), m)


def _mask_pair(seed, shape=(17, 14, 9)):
    rng = np.random.default_rng(seed)
    pred = ndi.binary_dilation(rng.random(shape) < 0.02, iterations=2)
    target = np.zeros(shape, bool)
    target[4:11, 3:9, 2:7] = True
    return pred, target


@pytest.mark.parametrize("seed", [0, 1])
def test_edt_equals_jax_and_scipy(seed):
    mask = _mask_pair(seed)[0]
    got = hausdorff._edt2(torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jhd._edt2(jnp.asarray(mask))))
    np.testing.assert_array_equal(got, np.round(ndi.distance_transform_edt(~mask) ** 2))
    np.testing.assert_array_equal(hausdorff._surface(torch.from_numpy(mask)).numpy(),
                                  np.asarray(jhd._surface(jnp.asarray(mask))))


@pytest.mark.parametrize("case", ["overlap", "apart", "empty_pred"])
def test_hausdorff_pair(case):
    pred, target = _mask_pair(4)
    if case == "apart":
        pred = np.zeros_like(pred)
        pred[13:16, 10:13, 0:2] = True
    elif case == "empty_pred":
        pred = np.zeros_like(pred)
    got = [float(v) for v in hausdorff.hausdorff_sq_pair(torch.from_numpy(pred),
                                                         torch.from_numpy(target))]
    want = [float(v) for v in jhd.hausdorff_sq_pair(jnp.asarray(pred), jnp.asarray(target))]
    assert got == want
    host = hausdorff_distance(pred, target)
    dev = hausdorff.hausdorff_distance_device(pred, target, device="cpu")
    if case == "empty_pred":
        assert got == [-1.0, -1.0] and np.isnan(host) and np.isnan(dev)
    else:
        assert dev == host == np.sqrt(max(got))
