"""The port's EvalSession (eval/harness.py) against the JAX package's on the
CPU, on the volumes of tests/test_fused_eval.py (64 x 64 x 30, two a
session): host and fused paths, lesion and healthy sets, val and test
stages, the val -> test threshold handoff, the histogram pool and the
ordered commits.

Tolerance: rows built from counts or from the bit-equal residual (confusion
counts and every ratio of them, lesion sizes, labels, Hausdorff, best dice
and threshold, the pooled val threshold, per-slice Dice/precision/recall)
are equal; rows from float32 means and sums (reco errors, AUROC/AUPRC,
anomaly scores) within 1e-5 relative and 1e-6 absolute."""
import functools
import threading

import numpy as np
import pytest

import conditioned_diffusion_models_uad_torch.eval.harness as H
import conditioned_diffusion_models_uad_tpu.eval.harness as JH

SHAPE = (64, 64, 30)
RTOL, ATOL = 1e-5, 1e-6
# tests/test_fused_eval.py COMPARE_KEYS, split into exact and float rows
EXACT_KEYS = (
    "BestDicePerVol", "BestThresholdPerVol", "DiceScorePerVol", "TPPerVol", "FPPerVol",
    "TNPerVol", "FNPerVol", "TPRPerVol", "FPRPerVol", "PrecisionPerVol", "RecallPerVol",
    "SpecificityPerVol", "AccuracyPerVol", "HausPerVol", "lesionSizePerVol",
    "DiceScorePerSlice", "PrecisionPerSlice", "RecallPerSlice", "lesionSizePerSlice",
    "labelPerSlice", "labelPerVol",
)
FLOAT_KEYS = (
    "l1recoErrorAll", "l2recoErrorAll", "l1recoErrorUnhealthy", "l1recoErrorHealthy",
    "AUCPerVol", "AUPRCPerVol", "AnomalyScoreRecoPerSlice", "AUCAnomalyRecoPerSlice",
    "AUPRCAnomalyRecoPerSlice", "AnomalyScoreRecoPerVol",
)


def _volume(rng):
    vol = rng.random(SHAPE, np.float32)
    reco = np.clip(vol + 0.15 * rng.standard_normal(SHAPE).astype(np.float32), 0, 1)
    seg = np.zeros(SHAPE, np.float32)
    seg[20:34, 18:30, 8:20] = 1.0
    mask = np.zeros(SHAPE, np.float32)
    mask[4:60, 4:60, :] = 1.0
    return vol, reco, seg, mask


def _run(mod, sess, dataset, order):
    rng = np.random.default_rng(7)
    vols = [_volume(rng) for _ in range(2)]
    for i in order:
        vol, reco, seg, mask = vols[i]
        sess.test_step(reco, vol, None if dataset in H.HEALTHY_SETS else seg, mask,
                       batch_idx=i, ID=f"id{i}", label_vol=1)
    sess.test_end()
    return sess


def _port(monkeypatch, fused: bool, stage: str, dataset="Brats21", threshold=None,
          order=(0, 1), **cfg_kw):
    monkeypatch.setattr(H, "FUSED_MIN_VOXELS", 100_000 if fused else 10**12)
    sess = H.EvalSession(H.EvalConfig(**cfg_kw), dataset, stage, threshold=threshold,
                         device="cpu")
    return _run(H, sess, dataset, order)


@functools.lru_cache(maxsize=None)
def _jax(fused: bool, stage: str, dataset="Brats21", threshold=None, **cfg_kw):
    """The JAX session, in dataset order; cached, as several tests compare
    against the same one (``threshold`` is the val fit's float or None)."""
    saved = JH.FUSED_MIN_VOXELS
    JH.FUSED_MIN_VOXELS = 100_000 if fused else 10**12
    try:
        sess = JH.EvalSession(JH.EvalConfig(**cfg_kw), dataset, stage,
                              threshold=None if threshold is None else {"total": threshold})
        return _run(JH, sess, dataset, (0, 1))
    finally:
        JH.FUSED_MIN_VOXELS = saved


def _compare(a, b):
    for k in EXACT_KEYS + FLOAT_KEYS:
        va = np.asarray(a.eval_dict[k], np.float64)
        vb = np.asarray(b.eval_dict[k], np.float64)
        assert va.shape == vb.shape, k
        if k in EXACT_KEYS:
            np.testing.assert_array_equal(va, vb, err_msg=k)
        else:
            np.testing.assert_allclose(va, vb, rtol=RTOL, atol=ATOL, err_msg=k)
    assert a.threshold == b.threshold
    for k in ("t_1p", "t_5p", "t_10p"):
        assert (k in a.eval_dict) == (k in b.eval_dict)
        if k in a.eval_dict:
            assert a.eval_dict[k] == b.eval_dict[k], k


# (fused, stage, cc_backend, hausdorff_backend)
CASES = [
    (False, "val", "host", "host"),
    (False, "test", "host", "host"),
    (True, "val", "host", "host"),
    (True, "val", "device", "device"),
    (True, "test", "device", "host"),
]


@pytest.mark.parametrize("fused,stage,cc_b,hd_b", CASES)
def test_session_matches_jax(monkeypatch, fused, stage, cc_b, hd_b):
    threshold = 0.21 if stage == "test" else None
    kw = dict(cc_backend=cc_b, hausdorff_backend=hd_b)
    port = _port(monkeypatch, fused, stage,
                 threshold=None if threshold is None else {"total": threshold}, **kw)
    _compare(port, _jax(fused, stage, threshold=threshold, **kw))
    assert np.isfinite(port.eval_dict["DicePerVolMean"])
    if stage == "val":
        assert port.threshold["total"] > 0


@pytest.mark.parametrize("fused", [False, True])
def test_healthy_set_matches_jax(monkeypatch, fused):
    port = _port(monkeypatch, fused, "val", dataset="IXI")
    _compare(port, _jax(fused, "val", dataset="IXI"))
    assert port.eval_dict["AUCPerVol"] == [] and port.eval_dict["t_1p"] > 0


def test_val_to_test_threshold_handoff(monkeypatch):
    """The val session's pooled fit feeds the test session, in both packages."""
    cfg = dict(cc_backend="device", hausdorff_backend="device")
    val = _port(monkeypatch, True, "val", **cfg)
    jval = _jax(True, "val", **cfg)
    assert val.threshold == jval.threshold
    test = _port(monkeypatch, True, "test", threshold=val.threshold, **cfg)
    _compare(test, _jax(True, "test", threshold=jval.threshold["total"], **cfg))
    assert test.eval_dict["BestThresholdPerVol"] == [val.threshold["total"]] * 2


@pytest.mark.parametrize("dataset", ["Brats21", "IXI"])
def test_histogram_pool_matches_jax(monkeypatch, dataset):
    """pool_device_budget_mb=0: histograms from the first volume."""
    port = _port(monkeypatch, True, "val", dataset=dataset, pool_device_budget_mb=0)
    assert port._hist is not None and not port._diffs_list
    _compare(port, _jax(True, "val", dataset=dataset, pool_device_budget_mb=0))


def test_out_of_order_commits_land_in_order(monkeypatch):
    """batch_idx 1 scored before 0: its commit parks until 0 lands, and the
    rows come out as the JAX session's in dataset order."""
    kw = dict(cc_backend="device", hausdorff_backend="device")
    reversed_ = _port(monkeypatch, True, "val", order=(1, 0), **kw)
    in_order = _jax(True, "val", **kw)
    _compare(reversed_, in_order)
    assert reversed_.eval_dict["IDs"] == in_order.eval_dict["IDs"] == ["id0", "id1"]


def test_failed_step_releases_its_turn(monkeypatch):
    """A step that raises gives up its slot, so the commits after it land,
    and threads committing concurrently keep dataset order."""
    monkeypatch.setattr(H, "FUSED_MIN_VOXELS", 10**12)
    sess = H.EvalSession(H.EvalConfig(), "Brats21", "val", device="cpu")
    rng = np.random.default_rng(7)
    vols = [_volume(rng) for _ in range(3)]
    with pytest.raises(Exception):
        sess.test_step(np.zeros((3, 3, 3), np.float32), *vols[0][:1], vols[0][2], vols[0][3],
                       batch_idx=0, ID="bad")
    threads = [threading.Thread(target=sess.test_step,
                                args=(vols[i][1], vols[i][0], vols[i][2], vols[i][3]),
                                kwargs=dict(batch_idx=i, ID=f"id{i}"))
               for i in (2, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert sess.eval_dict["IDs"] == ["id1", "id2"]


def test_session_default_device_is_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        H.EvalSession(H.EvalConfig(), "Brats21", "val")
    with pytest.raises(ValueError):
        H.EvalConfig(cc_backend="gpu")
