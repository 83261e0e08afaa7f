"""The port's metrics (eval/metrics.py) against the JAX package's on the CPU,
same numpy inputs.

Tolerance: the host functions equal the JAX package's (scikit-learn here)
exactly, NaN for NaN and -0.0 for -0.0, ties and degenerate labels
included. On the sorted device path BestDice/BestThreshold, the pooled fit,
the quantiles and the histogram counts are bit-equal (the port rounds the
multiply-adds that XLA:CPU fuses once, as the FMA does); AUROC and AP are
float32 sums in another order: 2e-6 absolute (values in [0, 1]). The fuzz
holds the port's device path against its host path and scikit-learn at the
2e-5 of tests/test_metrics_fuzz.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from sklearn.metrics import average_precision_score, roc_auc_score

from conditioned_diffusion_models_uad_torch.eval import metrics as M
from conditioned_diffusion_models_uad_tpu.eval import metrics as JM

TOL_F32_SUM = 2e-6
TOL_FUZZ = 2e-5


def _case(seed, n=4000, levels=16, rate=0.1, zero_frac=0.2):
    """Scores with ties (quantised, a share set to 0) and a lesion share."""
    rng = np.random.default_rng(seed)
    y = rng.random(n) < rate
    x = (y * 0.3 + rng.random(n)).astype(np.float32)
    if levels:
        x = np.round(x * levels).astype(np.float32) / levels
    x[rng.random(n) < zero_frac] = 0.0
    return x, y


def _same(a, b) -> bool:
    """Equal floats, NaN equal to NaN, and the sign of zero kept."""
    a, b = float(a), float(b)
    if np.isnan(a) or np.isnan(b):
        return np.isnan(a) and np.isnan(b)
    return a == b and np.signbit(a) == np.signbit(b)


def _arrays_same(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b)
    assert (np.signbit(a) == np.signbit(b)).all()


HOST_CASES = {
    "ties": _case(0, n=300, levels=8),
    "no_ties": _case(1, n=300, levels=0, zero_frac=0.0),
    "no_positives": (_case(2, n=200)[0], np.zeros(200, bool)),
    "all_positives": (_case(3, n=200)[0], np.ones(200, bool)),
    "constant_scores": (np.full(50, 0.25, np.float32), _case(4, n=50, rate=0.3)[1]),
    "constant_no_positives": (np.full(20, 0.5, np.float32), np.zeros(20, bool)),
    "two_points": (np.array([0.2, 0.7], np.float32), np.array([1, 0])),
}


@pytest.mark.filterwarnings("ignore")
@pytest.mark.parametrize("name", sorted(HOST_CASES))
def test_host_roc_prc_prsa_equal_jax(name):
    x, y = HOST_CASES[name]
    for got, want in ((M.compute_roc(x, y), JM.compute_roc(x, y)),
                      (M.compute_prc(x, y), JM.compute_prc(x, y))):
        assert _same(got[0], want[0]), (name, got[0], want[0])
        for g, w in zip(got[1:], want[1:]):
            _arrays_same(g, w)
    pred = x > np.median(x)
    for p in (pred, np.zeros_like(pred), np.ones_like(pred)):
        got = M.precision_recall_specificity_accuracy(p, y)
        want = JM.precision_recall_specificity_accuracy(p, y)
        assert all(_same(a, b) for a, b in zip(got, want)), (name, got, want)
        assert M.confusion_counts(p, y) == JM.confusion_counts(p, y)
        for fn in ("dice", "tpr", "fpr"):
            assert _same(getattr(M, fn)(p, y), getattr(JM, fn)(p, y)), (name, fn)
    assert M.find_best_val(x, y, val_range=(0, float(x.max()))) == JM.find_best_val(
        x, y, val_range=(0, float(x.max())))


def test_host_cc_filter_and_hausdorff_equal_jax():
    rng = np.random.default_rng(7)
    pred = rng.random((14, 12, 9)) < 0.2
    seg = np.zeros_like(pred)
    seg[3:9, 2:8, 1:6] = True
    np.testing.assert_array_equal(M.filter_3d_connected_components(pred, 8),
                                  JM.filter_3d_connected_components(pred, 8))
    assert M.hausdorff_distance(pred, seg) == JM.hausdorff_distance(pred, seg)
    hist = rng.integers(0, 50, 1024).astype(np.float32)
    assert M.quantiles_from_hist(hist, [0.99, 0.5]) == JM.quantiles_from_hist(hist, [0.99, 0.5])


@pytest.mark.parametrize("seed,levels", [(10, 0), (11, 16), (12, 1024)])
def test_sorted_device_metrics_equal_jax(seed, levels):
    x, y = _case(seed, levels=levels)
    got = M.seg_metrics_device(torch.from_numpy(x), torch.from_numpy(y))
    want = JM.seg_metrics_device(x, y)
    np.testing.assert_allclose(got[:2], want[:2], atol=TOL_F32_SUM, rtol=0)
    assert got[2:] == want[2:]  # best dice and threshold, bit for bit
    # the direct forms, kept as cross-checks
    np.testing.assert_allclose(M.compute_roc_prc_device(x, y, device="cpu"),
                               JM.compute_roc_prc_device(x, y), atol=TOL_F32_SUM, rtol=0)
    np.testing.assert_allclose(got[:2], M.compute_roc_prc_device(x, y, device="cpu"),
                               atol=TOL_F32_SUM, rtol=0)
    lo, hi = torch.tensor(0.0), torch.tensor(float(x.max()))
    direct = M._greedy_search_device_impl(torch.from_numpy(x), torch.from_numpy(y).float(),
                                          lo, hi)
    assert tuple(float(v) for v in direct) == got[2:]


def test_greedy_quartile_rounds_as_jax():
    """A case whose 0.75 quartile rounds differently with and without the
    multiply-add fused (XLA:CPU fuses it): the threshold must still be JAX's."""
    rng = np.random.default_rng(125)
    y = rng.random(3000) < rng.uniform(0.01, 0.5)
    x = (y * rng.uniform(0, 0.6) + rng.random(3000) * rng.uniform(0.1, 3)).astype(np.float32)
    got = M.seg_metrics_device(torch.from_numpy(x), torch.from_numpy(y))
    assert got[2:] == JM.seg_metrics_device(x, y)[2:]


@pytest.mark.parametrize("seed", [20, 21])
def test_pooled_fit_quantiles_equal_jax(seed):
    x, y = _case(seed, n=20000, levels=64)
    for val_range in ((0.0, float(x.max())), (0.1, 0.1)):
        got = M.find_best_val_device(x, y, val_range=val_range, device="cpu")
        assert got == JM.find_best_val_device(x, y, val_range=val_range)
    qs = (0.99, 0.95, 0.90, 0.5)
    assert M.quantiles_device(x, qs, device="cpu") == JM.quantiles_device(x, qs)


def test_histogram_pool_equal_jax():
    rng = np.random.default_rng(30)
    diffs = (rng.random(50000) * 0.6).astype(np.float32)
    diffs[:10] = 1.5  # clips into the top bin
    segs = diffs + 0.1 * rng.standard_normal(diffs.shape) > 0.45
    hp, hn = M.hist_pool_init(device="cpu")
    jhp, jhn = JM.hist_pool_init()
    for sl in (slice(0, 20000), slice(20000, None)):
        hp, hn = M.hist_pool_update(hp, hn, torch.from_numpy(diffs[sl]),
                                    torch.from_numpy(segs[sl]))
        jhp, jhn = JM.hist_pool_update(jhp, jhn, diffs[sl], segs[sl])
    np.testing.assert_array_equal(hp.numpy(), np.asarray(jhp))
    np.testing.assert_array_equal(hn.numpy(), np.asarray(jhn))
    assert M.find_best_val_hist(hp, hn) == JM.find_best_val_hist(jhp, jhn)


def test_device_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        M.seg_metrics_device(np.zeros(4, np.float32), np.zeros(4, bool))
    with pytest.raises(RuntimeError, match="CUDA"):
        M.hist_pool_init()


@st.composite
def _fuzz_case(draw):
    seed = draw(st.integers(0, 2**32 - 1))
    n = draw(st.integers(16, 3000))
    rate = draw(st.floats(0.005, 0.6))
    levels = draw(st.sampled_from([0, 4, 16, 64, 1024]))
    zero_frac = draw(st.sampled_from([0.0, 0.1, 0.5]))
    x, y = _case(seed, n=n, levels=levels, rate=rate, zero_frac=zero_frac)
    y[0], y[-1] = True, False  # both classes present
    return x, y


@settings(max_examples=40, deadline=None, derandomize=True, database=None)
@given(_fuzz_case())
def test_device_metrics_fuzz_vs_host_and_sklearn(case):
    x, y = case
    auc_d, ap_d, bd_d, bt_d = M.seg_metrics_device(torch.from_numpy(x), torch.from_numpy(y))
    auc_h = M.compute_roc(x, y)[0]
    ap_h = M.compute_prc(x, y)[0]
    assert auc_h == pytest.approx(roc_auc_score(y, x), abs=1e-12)
    assert ap_h == pytest.approx(average_precision_score(y, x), abs=1e-12)
    assert auc_d == pytest.approx(auc_h, abs=TOL_FUZZ)
    assert ap_d == pytest.approx(ap_h, abs=TOL_FUZZ)
    bd_h, bt_h = M.find_best_val(x, y, val_range=(0, float(x.max())), max_steps=10)
    assert bd_d == pytest.approx(bd_h, abs=1e-5)
    assert bt_d == pytest.approx(bt_h, abs=1e-5)
