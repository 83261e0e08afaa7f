"""Synthetic brain-MRI-like NIfTI fixtures + CSV splits (the port's copy of
``conditioned_diffusion_models_uad_tpu/data/synthetic.py``: one seed writes
the same arrays and CSV rows as that module).

The reference depends on a 37 GB preprocessed download (reference README.md:21);
SURVEY.md §4 mandates a synthetic fixture generator shaped like the real data so
every pipeline (train, eval, metrics) is testable hermetically. Volumes contain an
ellipsoidal "brain" with smooth low-frequency intensity structure; unhealthy
subjects get ellipsoidal hyper-intense "lesions" recorded in a segmentation map.

CSV layout matches the reference split files consumed by the datamodules
(reference src/datamodules/Datamodules_train.py:30-49, Datamodules_eval.py:21-32):
columns img_path/mask_path/seg_path (relative to <root>/Data), img_name, age,
label; the datamodule prefixes `<pathBase>/Data` and adds setname/settype."""
from __future__ import annotations

import csv
import os

import numpy as np

from .nifti import write_nifti


def make_volume(
    rng: np.random.Generator,
    shape=(64, 64, 40),
    n_lesions: int = 0,
    lesion_mode: str = "hyper",
):
    """Returns (vol, brain_mask, seg) float32 arrays of `shape` in (x, y, z).

    lesion_mode: 'hyper' adds intensity (BraTS-like T1 contrast); 'hypo'
    subtracts it (ATLAS-like stroke lesions in T1); 'midgray' replaces the
    tissue with a FLAT patch at intensity 0.5 — a pure texture anomaly.
    'midgray' exists for learning proofs: an untrained zero-init diffusion
    model predicts exactly mid-gray everywhere (0 in the model's [-1,1]
    range), so after brain-masking its residual |x-0.5| is already a strong
    detector of ANY intensity-contrasted lesion (measured ~0.97 pixel AUROC
    untrained) — but it scores a flat mid-gray patch LOWEST of the whole
    brain. Only a model that learned the healthy intensity texture ranks
    such a patch as anomalous."""
    x, y, z = shape
    gx, gy, gz = np.meshgrid(
        np.linspace(-1, 1, x), np.linspace(-1, 1, y), np.linspace(-1, 1, z),
        indexing="ij",
    )
    # ellipsoidal brain with mild random anisotropy
    rad = rng.uniform(0.75, 0.9, size=3)
    brain = (gx / rad[0]) ** 2 + (gy / rad[1]) ** 2 + (gz / rad[2]) ** 2 <= 1.0

    # smooth intensity: sum of a few random low-frequency cosines
    vol = np.zeros(shape, np.float32)
    for _ in range(6):
        fx, fy, fz = rng.uniform(0.5, 3.0, size=3)
        px, py, pz = rng.uniform(0, 2 * np.pi, size=3)
        vol += rng.uniform(0.1, 0.4) * np.cos(
            fx * np.pi * gx + px
        ) * np.cos(fy * np.pi * gy + py) * np.cos(fz * np.pi * gz + pz)
    vol = (vol - vol.min()) / (vol.max() - vol.min() + 1e-8)
    vol = (0.25 + 0.6 * vol) * brain
    vol += rng.normal(0, 0.01, size=shape).astype(np.float32) * brain

    seg = np.zeros(shape, np.float32)
    for _ in range(n_lesions):
        c = rng.uniform(-0.35, 0.35, size=3)
        r = rng.uniform(0.15, 0.3, size=3)
        lesion = (
            ((gx - c[0]) / r[0]) ** 2
            + ((gy - c[1]) / r[1]) ** 2
            + ((gz - c[2]) / r[2]) ** 2
        ) <= 1.0
        lesion &= brain
        seg[lesion] = 1.0
        if lesion_mode == "hypo":
            vol[lesion] = np.clip(vol[lesion] - rng.uniform(0.25, 0.4), 0.05, 1.2)
        elif lesion_mode == "midgray":
            vol[lesion] = 0.5 + rng.normal(0, 0.01, size=int(lesion.sum()))
        else:
            vol[lesion] = np.clip(vol[lesion] + rng.uniform(0.3, 0.5), 0, 1.2)

    return vol.astype(np.float32), brain.astype(np.float32), seg


def build_synthetic_root(
    root: str,
    shape=(64, 64, 40),
    n_train: int = 4,
    n_val: int = 2,
    n_test: int = 2,
    n_eval: int = 2,
    eval_sets=("Brats21", "MSLUB"),
    num_folds: int = 1,
    seed: int = 0,
    with_t2: bool = False,
    lesion_mode: str = "hyper",
) -> str:
    """Create <root>/Data/{IXI,<eval sets>}/... and <root>/Data/splits/*.csv
    mirroring the reference dataset layout. Returns `root` (the DATA_DIR).

    with_t2 additionally writes a *_t2.nii.gz companion per subject plus the
    IXI `avail_t2.csv` keep-list (the reference's t2-mode inputs,
    Datamodules_train.py:34-49)."""
    rng = np.random.default_rng(seed)
    data = os.path.join(root, "Data")
    splits = os.path.join(data, "splits")
    os.makedirs(splits, exist_ok=True)
    t2_names: list = []

    def write_subject(setname, name, lesions):
        d = os.path.join(data, setname)
        os.makedirs(d, exist_ok=True)
        vol, mask, seg = make_volume(rng, shape, n_lesions=lesions,
                                     lesion_mode=lesion_mode)
        img_rel = f"/{setname}/{name}_t1.nii.gz"
        mask_rel = f"/{setname}/{name}_mask.nii.gz"
        write_nifti(data + img_rel, vol)
        # binary labels are stored uint8 like real dataset masks (BraTS et al.)
        # — ingest reads exercise the narrow-dtype path and ship 1/4 the bytes
        write_nifti(data + mask_rel, mask.astype(np.uint8))
        if with_t2:
            # t2 contrast proxy: inverted intensities inside the brain
            t2 = np.where(mask > 0, vol.max() - vol, vol).astype(np.float32)
            write_nifti(data + img_rel.replace("t1", "t2"), t2)
            t2_names.append(f"{name}_t2")
        row = {
            "img_path": img_rel,
            "mask_path": mask_rel,
            "img_name": f"{name}_t1",
            "age": int(rng.integers(20, 80)),
            "label": 1 if lesions else 0,
        }
        if lesions:
            seg_rel = f"/{setname}/{name}_seg.nii.gz"
            write_nifti(data + seg_rel, seg.astype(np.uint8))
            row["seg_path"] = seg_rel
        return row

    def write_csv(path, rows, with_seg):
        cols = ["img_path", "mask_path", "img_name", "age", "label"]
        if with_seg:
            cols = cols[:2] + ["seg_path"] + cols[2:]
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=cols, extrasaction="ignore")
            w.writeheader()
            for r in rows:
                w.writerow(r)

    # IXI healthy train/val per fold + test
    for fold in range(num_folds):
        tr = [write_subject("IXI", f"IXI{fold}_{i:03d}", 0) for i in range(n_train)]
        va = [write_subject("IXI", f"IXIv{fold}_{i:03d}", 0) for i in range(n_val)]
        write_csv(os.path.join(splits, f"IXI_train_fold{fold}.csv"), tr, False)
        write_csv(os.path.join(splits, f"IXI_val_fold{fold}.csv"), va, False)
    te = [write_subject("IXI", f"IXIt_{i:03d}", 0) for i in range(n_test)]
    write_csv(os.path.join(splits, "IXI_test.csv"), te, False)

    # unhealthy eval sets with segmentations
    for setname in eval_sets:
        va = [
            write_subject(setname, f"{setname}v_{i:03d}", int(rng.integers(1, 3)))
            for i in range(n_eval)
        ]
        tr = [
            write_subject(setname, f"{setname}t_{i:03d}", int(rng.integers(1, 3)))
            for i in range(n_eval)
        ]
        write_csv(os.path.join(splits, f"{setname}_val.csv"), va, True)
        write_csv(os.path.join(splits, f"{setname}_test.csv"), tr, True)

    if with_t2:
        with open(os.path.join(splits, "avail_t2.csv"), "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["0"])
            for n in t2_names:
                w.writerow([n])
    return root
