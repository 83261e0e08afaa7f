"""The port's data-preparation entry point
(``python -m conditioned_diffusion_models_uad_torch.data.prepare_cli``) on a
tiny raw tree on the CPU, against the JAX package's CLI on the same tree:
the same files in the same layout, the same brain masks and segmentations,
the volumes to 1e-4 of their range (tests/test_torch_preprocessing.py's
tolerance); with an atlas, registration on and the same files. The prepared
tree then loads through the port's datamodule, where the run-from-files
entry point reads it."""
import json
import os

import numpy as np
import pytest
import torch

from conditioned_diffusion_models_uad_torch.data.datamodules import DataConfig, load_subject
from conditioned_diffusion_models_uad_torch.data.nifti import read_nifti, write_nifti
from conditioned_diffusion_models_uad_torch.data.prepare_cli import main as cli
from conditioned_diffusion_models_uad_tpu.data.prepare_cli import main as jcli
from test_torch_preprocessing import phantom

torch.set_num_threads(2)


def _raw_tree(root, dataset, n=2, seg=False):
    os.makedirs(root, exist_ok=True)
    spacing = (1.0, 1.0, 1.0) if dataset == "Brats21" else (0.94, 0.94, 1.2)
    for i in range(n):
        vol = 900 * phantom((26, 24, 15), 20 + i)
        write_nifti(os.path.join(root, f"{dataset}_{i:03d}.nii.gz"), vol, spacing=spacing)
        if seg:
            s = np.zeros(vol.shape, np.float32)
            s[10:14, 9:13, 6:9] = 1
            write_nifti(os.path.join(root, f"{dataset}_{i:03d}_seg.nii.gz"), s,
                        spacing=spacing)
    return root


def _compare_trees(ours, theirs):
    names = sorted(os.listdir(ours))
    assert names == sorted(os.listdir(theirs)) and names
    for name in names:
        got, want = read_nifti(os.path.join(ours, name))[0], read_nifti(
            os.path.join(theirs, name))[0]
        if name.endswith("_t1.nii.gz"):
            np.testing.assert_allclose(got, want, atol=1e-4 * float(np.abs(want).max()),
                                       rtol=0)
        else:
            assert np.array_equal(got, want), name
    return names


@pytest.mark.parametrize("dataset,seg", [("IXI", False), ("MSLUB", True),
                                         ("Brats21", True)])
def test_cli_writes_the_jax_clis_tree(tmp_path, dataset, seg):
    raw = _raw_tree(str(tmp_path / "raw"), dataset, seg=seg)
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    report = str(tmp_path / "report.jsonl")
    assert cli(["--dataset", dataset, "--input", raw, "--output", ours, "--device", "cpu",
                "--threads", "2", "--report", report]) == 0
    assert jcli(["--dataset", dataset, "--input", raw, "--output", theirs]) == 0
    names = _compare_trees(ours, theirs)
    want = {f"{dataset}_{i:03d}_{k}.nii.gz" for i in range(2)
            for k in (("t1", "mask", "seg") if seg else ("t1", "mask"))}
    assert set(names) == want
    rows = [json.loads(line) for line in open(report)]
    assert [r["subject"] for r in rows] == [f"{dataset}_{i:03d}.nii.gz" for i in range(2)]
    assert all(r["total_s"] > 0 and "n4" in r["seconds"] for r in rows)


def test_cli_with_an_atlas_registers(tmp_path):
    raw = _raw_tree(str(tmp_path / "raw"), "IXI", n=1)
    atlas = str(tmp_path / "atlas.nii.gz")
    write_nifti(atlas, 700 * phantom((24, 22, 18), 20))
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    report = str(tmp_path / "r.jsonl")
    assert cli(["--dataset", "IXI", "--input", raw, "--output", ours, "--atlas", atlas,
                "--device", "cpu", "--report", report]) == 0
    assert jcli(["--dataset", "IXI", "--input", raw, "--output", theirs,
                 "--atlas", atlas]) == 0
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs))
    (row,) = [json.loads(line) for line in open(report)]
    assert len(row["affine"]) == 12 and "register" in row["seconds"]
    vol = read_nifti(os.path.join(ours, "IXI_000_t1.nii.gz"))[0]
    mask = read_nifti(os.path.join(ours, "IXI_000_mask.nii.gz"))[0]
    assert vol.shape == mask.shape and all(a <= b for a, b in zip(vol.shape, (24, 22, 18)))
    assert np.isfinite(vol).all() and set(np.unique(mask)) <= {0.0, 1.0}


def test_prepared_tree_loads_through_the_datamodule(tmp_path):
    """The two entry points meet: a prepared subject read by ``load_subject``
    on both of its backends."""
    raw = _raw_tree(str(tmp_path / "raw"), "Brats21", n=1, seg=True)
    out = str(tmp_path / "Data" / "Brats21")
    assert cli(["--dataset", "Brats21", "--input", raw, "--output", out,
                "--device", "cpu"]) == 0
    row = {"img_path": os.path.join(out, "Brats21_000_t1.nii.gz"),
           "mask_path": os.path.join(out, "Brats21_000_mask.nii.gz"),
           "seg_path": os.path.join(out, "Brats21_000_seg.nii.gz"),
           "img_name": "Brats21_000_t1", "age": 40, "label": 1}
    host = load_subject(row, DataConfig(image_dim=(32, 32, 16), rescale_factor=1.0),
                        keep_orig=True)
    dev = load_subject(row, DataConfig(image_dim=(32, 32, 16), rescale_factor=1.0,
                                       preprocess_backend="device"), keep_orig=True,
                       device="cpu")
    assert host["vol"].shape == (32, 32, 16) and host["seg_available"]
    assert np.isfinite(host["vol"]).all() and host["mask"].sum() > 0 and host["seg"].sum() > 0
    np.testing.assert_allclose(dev["vol"].numpy(), host["vol"], atol=1e-5, rtol=0)


def test_cli_errors(tmp_path):
    empty = tmp_path / "empty"
    empty.mkdir()
    assert cli(["--dataset", "IXI", "--input", str(empty), "--output", str(tmp_path / "o"),
                "--device", "cpu"]) == 1
    if not torch.cuda.is_available():
        raw = _raw_tree(str(tmp_path / "raw"), "IXI", n=1)
        with pytest.raises(RuntimeError):
            cli(["--dataset", "IXI", "--input", raw, "--output", str(tmp_path / "o")])
