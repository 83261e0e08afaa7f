"""The port's data layer against the JAX package's on the CPU, on
data/synthetic.py fixtures:

* build_synthetic_root writes the same volumes and the same CSV rows from
  one seed;
* load_subject, host and device backends (device on CPU tensors), against
  the JAX load_subject: keep_orig with and without resized evaluation, t2
  mode, and shape_bucket (against the JAX device path, which is the one
  that buckets). Labels and masks bit-equal; images within 1e-5 absolute
  (the curvature flow and B-spline tolerances of
  tests/test_torch_transforms.py);
* TrainSliceSource.epoch_indices streams identical for one generator;
* the split CSVs parsed as pandas parses them (IXI, Brats21, t2 keep-list,
  empty cells)."""
import csv
import math
import os

import numpy as np
import pytest
import torch

from conditioned_diffusion_models_uad_torch.data import datamodules as P
from conditioned_diffusion_models_uad_torch.data.nifti import read_nifti
from conditioned_diffusion_models_uad_torch.data.synthetic import build_synthetic_root
from conditioned_diffusion_models_uad_torch.train.loop import gathered_batch
from conditioned_diffusion_models_uad_tpu.data import datamodules as J
from conditioned_diffusion_models_uad_tpu.data.nifti import read_nifti as jread_nifti
from conditioned_diffusion_models_uad_tpu.data.synthetic import (
    build_synthetic_root as jbuild_synthetic_root,
)

torch.set_num_threads(2)

TOL = 1e-5
RAW = (26, 23, 15)
DIM = (24, 24, 12)
SETS = ("Brats21", "MSLUB")


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("dm")
    kw = dict(shape=RAW, n_train=3, n_val=2, n_test=2, n_eval=2, eval_sets=SETS, seed=4,
              with_t2=True)
    return (build_synthetic_root(str(base / "port"), **kw),
            jbuild_synthetic_root(str(base / "jax"), **kw))


def _files(root):
    out = []
    for d, _, names in os.walk(root):
        out += [os.path.relpath(os.path.join(d, n), root) for n in names]
    return sorted(out)


def test_synthetic_root_same_arrays_and_rows(roots):
    port, jax_root = roots
    files = _files(port)
    assert files == _files(jax_root) and len(files) > 20
    for rel in files:
        a, b = os.path.join(port, rel), os.path.join(jax_root, rel)
        if rel.endswith(".csv"):
            assert open(a).read() == open(b).read(), rel
        else:
            va, ha = read_nifti(a)
            vb, hb = read_nifti(b)
            np.testing.assert_array_equal(va, vb)
            np.testing.assert_array_equal(va, jread_nifti(b)[0])
            assert ha.shape == hb.shape == RAW and ha.dtype == hb.dtype, rel


def _same_row(got: dict, want) -> None:
    want = dict(want)
    assert set(got) == set(want), (set(got) ^ set(want))
    for k, w in want.items():
        g = got[k]
        if isinstance(w, float) and math.isnan(w):
            assert isinstance(g, float) and math.isnan(g), (k, g)
        else:
            assert g == w and type(g) in (type(w), int, float, str, type(None)), (k, g, w)


@pytest.mark.parametrize("mode", ["t1", "t2"])
def test_split_csvs_parse_as_pandas(roots, mode):
    root = roots[0]
    cfg_p = P.DataConfig(data_dir=root, mode=mode)
    cfg_j = J.DataConfig(data_dir=root, mode=mode)
    ixi_p, ixi_j = P.IXI(cfg_p, device="cpu"), J.IXI(cfg_j)
    for state in ("train", "val", "test"):
        rows = ixi_p.csv[state]
        df = ixi_j.csv[state]
        assert len(rows) == len(df) > 0
        for r, (_, w) in zip(rows, df.iterrows()):
            _same_row(r, w)
    if mode == "t2":
        assert all("_t2.nii.gz" in r["img_path"] for r in ixi_p.csv["train"])
    for name in SETS:
        mp, mj = P.EVAL_MODULES[name](cfg_p, device="cpu"), J.EVAL_MODULES[name](cfg_j)
        for state in ("val", "test"):
            for r, (_, w) in zip(mp.csv[state], mj.csv[state].iterrows()):
                _same_row(r, w)


def test_csv_cells_typed_as_pandas(tmp_path):
    import pandas as pd

    path = str(tmp_path / "x.csv")
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["img_path", "mask_path", "seg_path", "img_name", "age", "label", "w"])
        w.writerow(["/a_t1_t1.nii.gz", "", "/s.nii.gz", "a", "31", "1", "0.5"])
        w.writerow(["/b.nii.gz", "/m.nii.gz", "NA", "b", "", "", "x"])
        w.writerow(["/c.nii.gz", "/m2.nii.gz", "", "7", "40", "0", "2"])
    rows = P.read_csv(path)
    df = pd.read_csv(path)
    for r, (_, want) in zip(rows, df.iterrows()):
        _same_row(r, want)
    assert [P._int_label(r["label"]) for r in rows] == [J._int_label(v) for v in df["label"]]
    prefixed = P._prefix_paths(rows, "/data", with_seg=True)
    jpref = J._prefix_paths(df, "/data", with_seg=True)
    for r, (_, want) in zip(prefixed, jpref.iterrows()):
        _same_row(r, want)
        for k in ("mask_path", "seg_path"):
            assert P._present(r[k]) == (isinstance(want[k], str) and bool(want[k]))


def _check_subject(got: dict, want: dict, keys) -> None:
    for k in keys:
        g = got[k].cpu().numpy() if torch.is_tensor(got[k]) else got[k]
        w = np.asarray(want[k])
        assert g.shape == w.shape and g.dtype == np.float32, (k, g.shape, w.shape)
        if k.startswith("vol"):
            np.testing.assert_allclose(g, w, atol=TOL, rtol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
    for k in ("seg_available", "ID", "age", "label"):
        assert got[k] == want[k], k


@pytest.mark.parametrize("backend", ["host", "device"])
@pytest.mark.parametrize("keep_orig,resized", [(False, True), (True, True), (True, False)])
def test_load_subject_matches_jax(roots, backend, keep_orig, resized):
    root = roots[0]
    kw = dict(data_dir=root, image_dim=DIM, resized_evaluation=resized, batch_size=2)
    cfg_p = P.DataConfig(preprocess_backend=backend, **kw)
    cfg_j = J.DataConfig(**kw)
    for name in ("IXI", "Brats21"):
        mod_p = (P.IXI if name == "IXI" else P.Brats21)(cfg_p, device="cpu")
        mod_j = (J.IXI if name == "IXI" else J.Brats21)(cfg_j)
        row_p, row_j = mod_p.csv["val"][0], mod_j.csv["val"].iloc[0]
        got = P.load_subject(row_p, cfg_p, keep_orig=keep_orig, device="cpu")
        want = J.load_subject(row_j, cfg_j, keep_orig=keep_orig)
        keys = ["vol", "mask"] + (["seg"] if name != "IXI" else [])
        if keep_orig:
            keys += ["vol_orig", "mask_orig", "seg_orig"]
        assert set(got) == set(want)
        _check_subject(got, want, keys)
        if backend == "device":
            assert all(torch.is_tensor(got[k]) for k in keys)
        else:
            assert all(isinstance(got[k], np.ndarray) for k in keys)


def test_load_subject_t2_and_shape_bucket(roots):
    root = roots[0]
    kw = dict(data_dir=root, image_dim=DIM, batch_size=2, mode="t2")
    cfg_p = P.DataConfig(preprocess_backend="device", shape_bucket=8, **kw)
    cfg_j = J.DataConfig(preprocess_backend="device", shape_bucket=8, **kw)
    host_p = P.DataConfig(**kw)
    for name in ("IXI", "MSLUB"):
        mod_p = (P.IXI if name == "IXI" else P.MSLUB)(cfg_p, device="cpu")
        mod_j = (J.IXI if name == "IXI" else J.MSLUB)(cfg_j)
        row_p, row_j = mod_p.csv["test"][0], mod_j.csv["test"].iloc[0]
        assert "_t2" in row_p["img_path"]
        keys = ["vol", "mask", "vol_orig", "mask_orig", "seg_orig"]
        got = P.load_subject(row_p, cfg_p, keep_orig=True, device="cpu")
        want = J.load_subject(row_j, cfg_j, keep_orig=True)
        _check_subject(got, want, keys)
        # bucketed device preprocessing equals the host path's
        _check_subject(P.load_subject(row_p, host_p, keep_orig=True), want, keys)


@pytest.mark.parametrize("opts", [dict(), dict(drop_last=False), dict(unique_slice=True),
                                  dict(start_slice=2, seq_slices=3), dict(start_slice=4),
                                  dict(batch_size=16)])
def test_epoch_indices_identical(opts):
    vols = np.zeros((7, 4, 4, 9), np.float32)
    kw = {"batch_size": 3, **opts}
    src_p = P.TrainSliceSource(torch.from_numpy(vols), torch.from_numpy(vols), P.DataConfig(**kw))
    src_j = J.TrainSliceSource(vols, vols, J.DataConfig(**kw))
    for epoch in range(3):
        got = list(src_p.epoch_indices(np.random.default_rng([5, epoch])))
        want = list(src_j.epoch_indices(np.random.default_rng([5, epoch])))
        assert len(got) == len(want) > 0
        for (a, b), (c, d) in zip(got, want):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)
            assert a.dtype == c.dtype and b.dtype == d.dtype


def test_train_source_built_on_the_device(roots):
    cfg = P.DataConfig(data_dir=roots[0], image_dim=DIM, batch_size=2,
                       preprocess_backend="device")
    dm = P.IXI(cfg, device="cpu")
    src = dm.train_slices()
    assert src is dm.train_slices() and len(src) == 3
    assert tuple(src.vols.shape) == (3, 12, 12, 6) and src.vols.device.type == "cpu"
    host = P.IXI(P.DataConfig(data_dir=roots[0], image_dim=DIM, batch_size=2),
                 device="cpu").train_slices()
    np.testing.assert_allclose(src.vols.numpy(), host.vols.numpy(), atol=TOL, rtol=0)
    np.testing.assert_array_equal(src.masks.numpy(), host.masks.numpy())
    batch = gathered_batch((src.vols, src.masks), np.array([2, 0]), np.array([1, 5]))
    assert torch.equal(batch["vol"][0, ..., 0], src.vols[2, :, :, 1].float())
    assert torch.equal(batch["mask"][1, ..., 0], src.masks[0, :, :, 5])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            P.IXI(cfg)
