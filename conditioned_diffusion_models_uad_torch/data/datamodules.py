"""Datamodules: IXI (train) + Brats21 / MSLUB / ATLAS / WMH (eval)
(counterpart of ``conditioned_diffusion_models_uad_tpu/data/datamodules.py``;
reference src/datamodules/Datamodules_train.py, Datamodules_eval.py,
create_dataset.py).

* CSV splits with the ``<data_dir>/Data`` prefix, per-fold train/val CSVs,
  t2-mode path rewriting and the ``avail_t2.csv`` keep-list
* per subject: read (+ curvature flow on images), CropOrPad(image_dim),
  masked percentile rescale, B-spline downsample by rescale_factor (labels
  nearest); eval subjects keep ``*_orig`` copies
* vol2slice: one random depth slice per subject per epoch, optional fixed or
  sequential slice windows and ``unique_slice``
* ``sample_set`` debug subsets

The CSVs are read with ``csv``, not pandas, keeping pandas' meanings: a cell
in pandas' default missing-value set is NaN, and a column whose other cells
all parse as integers (floats) is integer (float).

``preprocess_backend='host'`` preprocesses on CPU tensors and returns numpy
arrays, as the JAX package does on its host; ``'device'`` uploads the file's
stored dtype in the file's memory order and widens, scales, transposes and
preprocesses on the datamodule's device, returning tensors there. The whole
training set then lives on that device as stacked [N, H, W, D] tensors.
"""
from __future__ import annotations

import csv
import dataclasses
import math
import os
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device
from ..utils.prefetch import PrefetchLoader
from .nifti import read_nifti, read_nifti_raw
from .transforms import (
    bspline_downsample,
    crop_or_pad,
    crop_or_pad_dynamic,
    curvature_flow,
    nearest_downsample,
    percentile_rescale,
    zero_beyond_extent,
)


@dataclasses.dataclass
class DataConfig:
    data_dir: str = ""
    image_dim: Sequence[int] = (192, 192, 100)
    rescale_factor: float = 2.0
    mode: str = "t1"
    batch_size: int = 32
    num_folds: int = 1
    sample_set: bool = False
    perc_low: float = 1.0
    perc_high: float = 99.0
    use_curvature_flow: bool = True
    resized_evaluation: bool = True
    aug_intensity: bool = True
    # 'host': per-subject transforms on CPU tensors (reference semantics:
    # torchio on dataloader workers); 'device': on the datamodule's device
    preprocess_backend: str = "host"
    # > 0: end-pad each raw array to the next multiple of `shape_bucket` per
    # axis before upload and carry the true extent (device backend; the
    # extent-aware curvature flow and crop give the unbucketed result)
    shape_bucket: int = 0
    unique_slice: bool = False
    start_slice: Optional[int] = None
    seq_slices: Optional[int] = None
    drop_last: bool = True
    testsets: Sequence[str] = ("Brats21",)

    def __post_init__(self):
        if self.preprocess_backend not in ("host", "device"):
            raise ValueError(
                f"preprocess_backend must be 'host' or 'device', got "
                f"{self.preprocess_backend!r}"
            )
        if int(self.shape_bucket) < 0:
            raise ValueError(f"shape_bucket must be >= 0, got {self.shape_bucket}")

    @property
    def model_hw(self):
        # ceil, matching bspline_downsample's new-size formula
        return (
            int(math.ceil(self.image_dim[0] / self.rescale_factor)),
            int(math.ceil(self.image_dim[1] / self.rescale_factor)),
        )


# --------------------------------------------------------------------------- #
# CSV splits with pandas' meanings
# --------------------------------------------------------------------------- #
# pandas.read_csv's default missing-value strings
_NA = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
       "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"}


def _column(cells: List[str]) -> list:
    """One CSV column typed as pandas types it: int when every cell is an
    integer, float when every non-missing cell is a number (missing -> NaN),
    else strings with NaN for the missing cells."""
    present = [c for c in cells if c not in _NA]
    try:
        ints = [int(c) for c in cells]
    except ValueError:
        ints = None
    if ints is not None:
        return ints
    try:
        floats = {c: float(c) for c in present}
    except ValueError:
        return [float("nan") if c in _NA else c for c in cells]
    return [float("nan") if c in _NA else floats[c] for c in cells]


def read_csv(path: str) -> List[dict]:
    """The rows of a split CSV as dicts, typed per column (``_column``)."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        body = [r + [""] * (len(header) - len(r)) for r in reader]
    cols = [_column([r[j] for r in body]) for j in range(len(header))]
    return [{h: cols[j][i] for j, h in enumerate(header)} for i in range(len(body))]


def _present(v) -> bool:
    """A path cell that names a file (pandas: a str, not NaN, not empty)."""
    return isinstance(v, str) and bool(v)


def _int_label(v) -> int:
    """Label cell -> int; missing or unparseable -> 0."""
    try:
        f = float(v)
    except (TypeError, ValueError):
        return 0
    return 0 if f != f else int(f)


def _prefix_paths(rows: List[dict], base: str, with_seg: bool) -> List[dict]:
    """``<base>/Data`` + each path cell; NaN stays NaN, as pandas' string
    concatenation keeps it."""
    out = []
    for r in rows:
        r = dict(r)
        for k in ("img_path", "mask_path") + (("seg_path",) if with_seg else ()):
            if k in r and isinstance(r[k], str):
                r[k] = base + "/Data" + r[k]
        if not with_seg or "seg_path" not in r:
            r["seg_path"] = None
        out.append(r)
    return out


# --------------------------------------------------------------------------- #
# per-subject loading
# --------------------------------------------------------------------------- #
def _read_raw(path: str) -> np.ndarray:
    """Raw NIfTI read as float32 (x, y, z); 4D volumes keep their first
    channel."""
    vol, _ = read_nifti(path)
    if vol.ndim == 4:
        vol = vol[..., 0]
    return vol


def _read_image(path: str, cfg: DataConfig, is_label: bool) -> torch.Tensor:
    vol = torch.from_numpy(np.ascontiguousarray(_read_raw(path), dtype=np.float32))
    if not is_label and cfg.use_curvature_flow:
        vol = curvature_flow(vol)
    return vol


def _subject_meta(row, out: dict, seg_available: bool) -> dict:
    out["seg_available"] = seg_available
    out["ID"] = str(row.get("img_name", ""))
    out["age"] = row.get("age", 0)
    out["label"] = _int_label(row.get("label", 0))
    return out


def _resample(vol, mask, seg, cfg: DataConfig, keep_orig: bool) -> dict:
    """Percentile-rescaled, cropped arrays -> the model-grid subject (and
    the ``*_orig`` copies of an eval subject)."""
    out = {"vol": bspline_downsample(vol, cfg.rescale_factor),
           "mask": nearest_downsample(mask, cfg.rescale_factor)}
    if seg is not None:
        out["seg"] = nearest_downsample(seg, cfg.rescale_factor)
    if keep_orig:
        if cfg.resized_evaluation:
            out["vol_orig"] = out["vol"]
            out["mask_orig"] = out["mask"]
            out["seg_orig"] = out["seg"] if seg is not None else torch.zeros_like(out["mask"])
        else:
            out["vol_orig"] = vol
            out["mask_orig"] = mask
            out["seg_orig"] = seg if seg is not None else torch.zeros_like(mask)
    return out


def _read_raw_rev(path: str):
    """(payload in the file's dtype and memory order [.., z, y, x], slope,
    inter); 4D volumes keep their first channel, float64 is scaled and
    narrowed to float32 on the host."""
    vol, _, slope, inter = read_nifti_raw(path)
    if vol.ndim == 4:
        vol = vol[0]
    if vol.dtype == np.float64:
        vol = (vol * slope + inter).astype(np.float32)
        slope, inter = 1.0, 0.0
    return vol, float(np.float32(slope)), float(np.float32(inter))


def _pad_to_bucket(arr: np.ndarray, bucket: int) -> np.ndarray:
    """End-pad each axis with zeros to the next multiple of ``bucket``."""
    tgt = tuple(-(-s // bucket) * bucket for s in arr.shape)
    if tgt == arr.shape:
        return arr
    out = np.zeros(tgt, arr.dtype)
    out[tuple(slice(0, s) for s in arr.shape)] = arr
    return out


_TORCH_DTYPES = {np.dtype(np.uint8): torch.uint8, np.dtype(np.int8): torch.int8,
                 np.dtype(np.int16): torch.int16, np.dtype(np.int32): torch.int32,
                 np.dtype(np.float32): torch.float32}


def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """The stored payload to ``device`` at its stored width (dtypes torch
    lacks widen on the host first)."""
    if arr.dtype not in _TORCH_DTYPES:
        arr = arr.astype(np.float32 if arr.dtype.kind == "f" else np.int64)
    if not (arr.flags.c_contiguous and arr.flags.writeable):  # a view of the file's bytes
        arr = np.array(arr, order="C")
    return torch.from_numpy(arr).to(device)


def _load_subject_device(row, cfg: DataConfig, keep_orig: bool,
                         device: torch.device) -> dict:
    """The device path of ``load_subject``: the raw payload goes up in its
    stored dtype and memory order, then the widen, the scl scaling, the
    transpose to (x, y, z) and the whole preprocess run on ``device``.
    Binary labels go up as stored: the JAX package bit-packs them for a slow
    host link, which PCIe does not need.

    ``cfg.shape_bucket > 0``: each raw array is end-padded to the next bucket
    multiple and its true (x, y, z) extent carried beside it; the result
    equals the unbucketed one."""
    bucket = int(cfg.shape_bucket)

    def ingest(path):
        arr, slope, inter = _read_raw_rev(path)
        ext = arr.shape[::-1]
        if bucket:
            arr = _pad_to_bucket(arr, bucket)
        x = _upload(arr, device).float() * slope + inter
        x = x.permute(*reversed(range(x.dim())))
        if bucket:
            # bucket padding was zeros in stored units; a nonzero inter
            # turned it into `inter`: re-zero past the true extent
            x = zero_beyond_extent(x, ext)
        return x, (ext if bucket else None)

    vol, ext_v = ingest(row["img_path"])
    has_mask = _present(row.get("mask_path", None))
    mask, ext_m = ingest(row["mask_path"]) if has_mask else (None, ext_v)
    seg_available = _present(row.get("seg_path", None))
    seg, ext_s = ingest(row["seg_path"]) if seg_available else (None, None)

    if cfg.use_curvature_flow:
        vol = curvature_flow(vol, ext=ext_v)
    if mask is None:
        mask = (vol > 0).float()

    def cop(x, ext):
        if ext is None:
            return crop_or_pad(x, tuple(cfg.image_dim))
        return crop_or_pad_dynamic(x, ext, tuple(cfg.image_dim))

    vol, mask = cop(vol, ext_v), cop(mask, ext_m)
    seg = cop(seg, ext_s) if seg is not None else None
    vol = percentile_rescale(vol, mask, 0.0, 1.0, cfg.perc_low, cfg.perc_high)
    return _subject_meta(row, _resample(vol, mask, seg, cfg, keep_orig), seg_available)


def load_subject(row, cfg: DataConfig, keep_orig: bool = False,
                 device: DeviceLike = None) -> dict:
    """Read + preprocess one subject: numpy arrays [H, W, D] (host backend)
    or tensors on ``device`` (device backend)."""
    if cfg.preprocess_backend == "device":
        return _load_subject_device(row, cfg, keep_orig, resolve_device(device))
    vol = _read_image(row["img_path"], cfg, is_label=False)
    if _present(row.get("mask_path", None)):
        mask = _read_image(row["mask_path"], cfg, is_label=True)
    else:
        mask = (vol > 0).float()
    seg_available = _present(row.get("seg_path", None))
    seg = _read_image(row["seg_path"], cfg, is_label=True) if seg_available else None

    target = tuple(cfg.image_dim)
    vol, mask = crop_or_pad(vol, target), crop_or_pad(mask, target)
    seg = crop_or_pad(seg, target) if seg is not None else None
    vol = percentile_rescale(vol, mask, 0.0, 1.0, cfg.perc_low, cfg.perc_high)
    out = _resample(vol, mask, seg, cfg, keep_orig)
    out = {k: v.contiguous().numpy() for k, v in out.items()}
    return _subject_meta(row, out, seg_available)


# --------------------------------------------------------------------------- #
# datasets
# --------------------------------------------------------------------------- #
class EvalDataset:
    """Per-volume eval dataset yielding the reference's subject dict
    (vol/vol_orig/mask_orig/seg_orig/ID/label/stage/Dataset)."""

    def __init__(self, rows: List[dict], cfg: DataConfig, setname: str, stage: str,
                 device: DeviceLike = None):
        self.rows = list(rows)
        self.cfg = cfg
        self.setname = setname
        self.stage = stage
        self.device = device

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i: int) -> dict:
        # no caching: each index is read once a stage
        sub = load_subject(self.rows[i], self.cfg, keep_orig=True, device=self.device)
        sub["Dataset"] = self.setname
        sub["stage"] = self.stage
        return sub

    def __iter__(self) -> Iterator[dict]:
        for i in range(len(self)):
            yield self[i]


class TrainSliceSource:
    """Stacked training volumes on the device + the vol2slice sampler.

    ``epoch_indices(rng)`` yields (vol_idx, slice_idx) int32 arrays a batch:
    each epoch visits every subject once in random order and draws one
    random depth slice per subject. numpy, so the stream is the JAX
    package's for the same generator."""

    def __init__(self, vols: torch.Tensor, masks: torch.Tensor, cfg: DataConfig):
        self.cfg = cfg
        self.vols = vols  # [N, H, W, D]
        self.masks = masks
        self.depth = int(vols.shape[-1])
        self.n = int(vols.shape[0])

    def __len__(self):
        return self.n

    def epoch_indices(self, rng: np.random.Generator):
        cfg = self.cfg
        order = rng.permutation(self.n)
        bs = cfg.batch_size
        end = self.n - (self.n % bs) if (cfg.drop_last and self.n >= bs) else self.n
        lo, hi = 0, self.depth
        if cfg.start_slice is not None:
            if cfg.seq_slices is not None:
                lo, hi = cfg.start_slice, cfg.start_slice + cfg.seq_slices
            else:
                lo, hi = cfg.start_slice, cfg.start_slice + 1
        for i in range(0, max(end, min(bs, self.n)), bs):
            idx = order[i : i + bs]
            if len(idx) == 0 or (cfg.drop_last and len(idx) < bs and self.n >= bs):
                break
            if cfg.unique_slice:
                s = np.full(len(idx), rng.integers(lo, hi))
            else:
                s = rng.integers(lo, hi, size=len(idx))
            yield idx.astype(np.int32), s.astype(np.int32)


class IXI:
    """Healthy-train datamodule (reference Datamodules_train.IXI). Runs on
    ``device`` (``cuda`` unless the caller says otherwise): the training set
    is stacked there, and the device backend preprocesses there."""

    def __init__(self, cfg: DataConfig, fold: int = 0, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        base = cfg.data_dir
        splits = os.path.join(base, "Data", "splits")
        self.csv = {
            "train": read_csv(os.path.join(splits, f"IXI_train_fold{fold}.csv")),
            "val": read_csv(os.path.join(splits, f"IXI_val_fold{fold}.csv")),
            "test": read_csv(os.path.join(splits, "IXI_test.csv")),
        }
        for state, rows in self.csv.items():
            rows = _prefix_paths(rows, base, with_seg=False)
            if cfg.mode == "t2":
                keep_path = os.path.join(splits, "avail_t2.csv")
                if os.path.exists(keep_path):
                    keep = {str(r["0"]).replace("t2", "t1") for r in read_csv(keep_path)}
                    rows = [r for r in rows if r["img_name"] in keep]
                for r in rows:
                    if isinstance(r["img_path"], str):
                        r["img_path"] = r["img_path"].replace("t1", "t2")
            for r in rows:
                r["setname"], r["settype"] = "IXI", state
            if cfg.sample_set:
                rows = rows[0:2]
            self.csv[state] = rows
        self._train_source = None
        self._val_source = None

    def _build_source(self, state: str) -> TrainSliceSource:
        rows = self.csv[state]
        subs = list(PrefetchLoader(
            rows, lambda r: load_subject(r, self.cfg, device=self.device), num_threads=4))
        vols = torch.stack([torch.as_tensor(s["vol"], device=self.device) for s in subs])
        masks = torch.stack([torch.as_tensor(s["mask"], device=self.device) for s in subs])
        return TrainSliceSource(vols, masks, self.cfg)

    def train_slices(self) -> TrainSliceSource:
        if self._train_source is None:
            self._train_source = self._build_source("train")
        return self._train_source

    def val_slices(self) -> TrainSliceSource:
        if self._val_source is None:
            self._val_source = self._build_source("val")
        return self._val_source

    def val_eval(self) -> EvalDataset:
        return EvalDataset(self.csv["val"], self.cfg, "IXI", "val", self.device)

    def test_eval(self) -> EvalDataset:
        return EvalDataset(self.csv["test"], self.cfg, "IXI", "test", self.device)


class _EvalModule:
    """Shared shape of the eval datamodules (reference Datamodules_eval.py)."""

    SETNAME = ""
    SAMPLE_N = 8

    def __init__(self, cfg: DataConfig, fold: int = 0, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        base = cfg.data_dir
        splits = os.path.join(base, "Data", "splits")
        self.csv = {}
        for state in ("val", "test"):
            rows = read_csv(os.path.join(splits, f"{self.SETNAME}_{state}.csv"))
            rows = _prefix_paths(rows, base, with_seg=True)
            for r in rows:
                r["setname"], r["settype"] = self.SETNAME, state
                if cfg.mode != "t1" and isinstance(r["img_path"], str):
                    r["img_path"] = r["img_path"].replace("t1", cfg.mode)
            if cfg.sample_set:
                rows = rows[0:self.SAMPLE_N]
            self.csv[state] = rows

    def val_eval(self) -> EvalDataset:
        return EvalDataset(self.csv["val"], self.cfg, self.SETNAME, "val", self.device)

    def test_eval(self) -> EvalDataset:
        return EvalDataset(self.csv["test"], self.cfg, self.SETNAME, "test", self.device)


class Brats21(_EvalModule):
    SETNAME = "Brats21"
    SAMPLE_N = 8


class MSLUB(_EvalModule):
    SETNAME = "MSLUB"
    SAMPLE_N = 4


class ATLAS(_EvalModule):
    """t1-only stroke-lesion set."""

    SETNAME = "ATLAS"
    SAMPLE_N = 8


class WMH(_EvalModule):
    """t1-mode white-matter-hyperintensity set."""

    SETNAME = "WMH"
    SAMPLE_N = 8


EVAL_MODULES = {"Brats21": Brats21, "MSLUB": MSLUB, "ATLAS": ATLAS, "WMH": WMH}

# modality gating of the reference train loop (src/train.py:187-190)
SETS_BY_MODE = {
    "t1": ["Brats21", "MSLUB", "ATLAS", "WMH", "IXI"],
    "t2": ["Brats21", "MSLUB", "IXI"],
}
