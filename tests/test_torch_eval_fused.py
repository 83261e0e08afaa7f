"""The port's per-volume scoring core (eval/fused.py) against the JAX
package's ``volume_eval_program`` on the CPU, for each combination of static
flags that ``EvalSession._fused_flags`` produces, same numpy inputs.

Tolerance: bit-equal for the residual, the packed maps, every count (the
confusion counts, lesion size, per-slice seg/TP/FP/FN), the thresholds, the
best dice, the squared Hausdorff pair, the loss and the latent. The float32
means and sums (reco errors, volume and slice scores, AUROC/AUPRC) are
summed in another order: 2e-6 absolute (values below 1). Both packages' own
``parse_packed`` read the port's buffer alike."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conditioned_diffusion_models_uad_torch.eval import fused as F
from conditioned_diffusion_models_uad_torch.eval.harness import EvalConfig, EvalSession
from conditioned_diffusion_models_uad_tpu.eval import fused as JF

SHAPE = (24, 26, 10)
TOL_SUM = 2e-6
EXACT_SCALARS = ("best_dice", "th_record", "th_apply", "lesion_size", "haus_pt",
                 "haus_tp", "aux_loss", "tp", "fp", "tn", "fn")


def _volume(seed):
    rng = np.random.default_rng(seed)
    vol = rng.random(SHAPE, np.float32)
    reco = np.clip(vol + 0.15 * rng.standard_normal(SHAPE).astype(np.float32), 0, 1)
    reco[6:14, 7:15, 2:7] *= 0.2  # an anomaly the residual shows
    seg = np.zeros(SHAPE, np.float32)
    seg[6:14, 7:15, 2:7] = 1.0
    mask = np.zeros(SHAPE, np.float32)
    mask[2:22, 2:24] = 1.0
    return vol, reco, mask, seg


# (dataset, stage, EvalConfig kwargs, seg on the device, latent length)
CASES = {
    "host_maps": ("Brats21", "val", {}, False, 0),
    "host_maps_device_seg": ("Brats21", "val", {}, True, 5),
    "device_cc": ("Brats21", "test", {"cc_backend": "device"}, False, 0),
    "device_cc_device_seg": ("Brats21", "test", {"cc_backend": "device"}, True, 3),
    "device_cc_hausdorff": ("Brats21", "val", {"cc_backend": "device",
                                              "hausdorff_backend": "device"}, True, 4),
    "fixed_threshold_l2": ("Brats21", "val", {"cc_backend": "device",
                                             "hausdorff_backend": "device", "threshold": 0.05,
                                             "residualmode": "l2", "median_filtering": False,
                                             "erode_brainmask": False}, False, 0),
    "healthy": ("IXI", "val", {"cc_backend": "device", "hausdorff_backend": "device"},
                False, 2),
}


def _flags(name):
    dataset, stage, kw, seg_dev, llen = CASES[name]
    sess = EvalSession(EvalConfig(**kw), dataset, stage,
                       threshold={"total": 0.21} if stage == "test" else None, device="cpu")
    return sess._fused_flags(SHAPE, seg_is_host=not seg_dev), llen


def _compare(got_buf, want_buf, statics, llen):
    args = (SHAPE, llen, statics["pack_seg"], statics["pack_maps"])
    got = F.parse_packed(got_buf, *args)
    want = JF.parse_packed(np.asarray(want_buf), *args)
    read_by_jax = JF.parse_packed(got_buf.numpy(), *args)
    for k in F.SCALAR_KEYS:
        g, w = got["scalars"][k], want["scalars"][k]
        assert read_by_jax["scalars"][k] == g or (np.isnan(g) and np.isnan(read_by_jax["scalars"][k]))
        assert np.isnan(g) == np.isnan(w), k
        if k in EXACT_SCALARS:
            assert g == w or np.isnan(w), (k, g, w)
        else:
            np.testing.assert_allclose(g, w, atol=TOL_SUM, rtol=0, err_msg=k)
    np.testing.assert_array_equal(got["per_slice"][:, 1:], want["per_slice"][:, 1:])
    np.testing.assert_allclose(got["per_slice"][:, 0], want["per_slice"][:, 0], atol=TOL_SUM)
    np.testing.assert_array_equal(got["latent"], want["latent"])
    for k in ("thresholded", "seg"):
        assert (got[k] is None) == (want[k] is None), k
        if got[k] is not None:
            np.testing.assert_array_equal(got[k], want[k])
    return got


@pytest.mark.parametrize("name", sorted(CASES))
def test_core_matches_jax(name):
    flags, llen = _flags(name)
    vol, reco, mask, seg = _volume(1)
    latent = np.linspace(-1, 1, llen).astype(np.float32)
    th = (flags["th_record"], flags["th_apply"])
    got_diff, got_buf = F.volume_eval_program(
        *(torch.from_numpy(a) for a in (vol, reco, mask, seg)),
        *(torch.tensor(t, dtype=torch.float32) for t in th),
        torch.tensor(0.375), torch.from_numpy(latent), **flags["statics"])
    want_diff, want_buf = JF.volume_eval_program(
        *(jnp.asarray(a) for a in (vol, reco, mask, seg)),
        *(jnp.float32(t) for t in th), jnp.float32(0.375), jnp.asarray(latent),
        **flags["statics"])
    np.testing.assert_array_equal(got_diff.numpy(), np.asarray(want_diff))
    assert got_buf.dtype == torch.uint8 and got_buf.shape == want_buf.shape
    parsed = _compare(got_buf, want_buf, flags["statics"], llen)
    if flags["statics"]["eval_seg"]:
        assert parsed["scalars"]["lesion_size"] == seg.sum() > 0


def test_group_core_matches_jax():
    """G = 2 volumes through ``group_eval_core`` (a loop here, a vmap there)."""
    flags, llen = _flags("device_cc")
    vols = [_volume(s) for s in (2, 3)]
    stack = [np.stack([v[i] for v in vols]) for i in range(4)]
    g = 2
    th = [np.full(g, flags[k], np.float32) for k in ("th_record", "th_apply")]
    loss = np.array([0.25, 0.5], np.float32)
    lat = np.zeros((g, llen), np.float32)
    got_diff, got_buf = F.group_eval_core(*(torch.from_numpy(a) for a in (*stack, *th, loss, lat)),
                                          **flags["statics"])
    want_diff, want_buf = JF.group_eval_core(*(jnp.asarray(a) for a in (*stack, *th, loss, lat)),
                                             **flags["statics"])
    np.testing.assert_array_equal(got_diff.numpy(), np.asarray(want_diff))
    for j in range(g):
        _compare(got_buf[j], np.asarray(want_buf)[j], flags["statics"], llen)


def test_packbits_and_layout():
    m = np.random.default_rng(3).random((13, 7, 5)) > 0.6  # 455 voxels: a padded byte
    packed = F._packbits(torch.from_numpy(m))
    np.testing.assert_array_equal(packed.numpy(), np.packbits(m.ravel()))
    np.testing.assert_array_equal(F.unpack_thresholded(packed, m.shape), m)
    for pack_seg in (False, True):
        for pack_maps in (False, True):
            assert F.packed_layout(SHAPE, 7, pack_seg, pack_maps) == JF.packed_layout(
                SHAPE, 7, pack_seg, pack_maps)
    assert F.SCALAR_KEYS == JF.SCALAR_KEYS and F.PER_SLICE_KEYS == JF.PER_SLICE_KEYS
    with pytest.raises(ValueError):
        F.parse_packed(np.zeros(3, np.uint8), SHAPE, 0, False)
