"""Offline dataset preparation: resample, skull-strip, register, N4, crop
(counterpart of ``conditioned_diffusion_models_uad_tpu/data/preprocessing.py``;
reference prepare_IXI.sh / prepare_Brats21.sh / prepare_MSLUB.sh).

Each stage is the JAX package's algorithm; the array stages run in PyTorch
on ``device`` (default ``cuda``; ``device="cpu"`` asks for the CPU) and take
and return numpy arrays:

* ``resample_iso``: ``jax.image.resize`` to isotropic voxels (trilinear with
  its antialiasing when an axis shrinks; nearest for labels);
* ``extract_brain_mask``: scaled Otsu threshold, largest 3D component,
  binary closing, hole filling (numpy and scipy on the host, as in the JAX
  package; a classical stand-in for HD-BET);
* ``affine_register``: a 12-dof affine fitted by Adam (optax's
  hyperparameters) on the MSE of the trilinearly warped moving volume,
  coarse to fine; ``apply_affine`` warps another volume with it;
* ``n4_bias_correct``: a weighted least-squares polynomial log-bias field,
  removed ``iters`` times;
* ``crop_to_brain_bbox`` and the per-dataset stage gating
  (``DATASET_STAGES``) of ``prepare_subject``.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.interp import map_coordinates, resize
from ..utils.device import DeviceLike, resolve_device
from .nifti import read_nifti, write_nifti


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _tensor(arr, dev: torch.device) -> torch.Tensor:
    """A float32 copy of a host array on ``dev`` (read-only arrays, such as
    a NIfTI file's payload, included)."""
    return torch.from_numpy(np.array(arr, dtype=np.float32)).to(dev)


# --------------------------------------------------------------------------- #
# resampling
# --------------------------------------------------------------------------- #
def resample_iso(vol: np.ndarray, spacing: Sequence[float], target: float = 1.0,
                 method: str = "trilinear", device: DeviceLike = None) -> np.ndarray:
    """Resample to isotropic ``target`` mm voxels given the current spacing;
    labels pass ``method='nearest'``."""
    shape = tuple(max(1, int(round(s * sp / target))) for s, sp in zip(vol.shape, spacing))
    m = "nearest" if method == "nearest" else "linear"
    return resize(_tensor(vol, resolve_device(device)), shape, m).cpu().numpy()


# --------------------------------------------------------------------------- #
# brain mask (HD-BET stand-in), on the host
# --------------------------------------------------------------------------- #
def _otsu_threshold(vol: np.ndarray, bins: int = 256) -> float:
    v = vol[vol > 0]
    if v.size == 0:
        return 0.0
    hist, edges = np.histogram(v, bins=bins)
    centers = (edges[:-1] + edges[1:]) / 2
    w = hist.astype(np.float64)
    total = w.sum()
    best_t, best_var = centers[0], -1.0
    cum_w = np.cumsum(w)
    cum_m = np.cumsum(w * centers)
    for i in range(1, bins - 1):
        w0 = cum_w[i]
        w1 = total - w0
        if w0 == 0 or w1 == 0:
            continue
        m0 = cum_m[i] / w0
        m1 = (cum_m[-1] - cum_m[i]) / w1
        var = w0 * w1 * (m0 - m1) ** 2
        if var > best_var:
            best_var, best_t = var, centers[i]
    return float(best_t)


def _largest_cc(mask: np.ndarray) -> np.ndarray:
    from scipy import ndimage

    labels, n = ndimage.label(mask)
    if n == 0:
        return mask
    sizes = ndimage.sum(mask, labels, index=np.arange(1, n + 1))
    return labels == (1 + int(np.argmax(sizes)))


def extract_brain_mask(vol: np.ndarray, closing_iters: int = 3,
                       threshold_scale: float = 0.5) -> np.ndarray:
    """Scaled-Otsu threshold -> largest 3D component -> binary closing ->
    hole fill, as float32 0/1."""
    from scipy import ndimage

    t = _otsu_threshold(vol) * threshold_scale
    m = vol > t
    m = _largest_cc(m)
    if closing_iters > 0:
        m = ndimage.binary_closing(m, iterations=closing_iters)
    m = ndimage.binary_fill_holes(m)
    return m.astype(np.float32)


# --------------------------------------------------------------------------- #
# affine registration: autograd + Adam on the device
# --------------------------------------------------------------------------- #
def _affine_grid(params: torch.Tensor, shape: Tuple[int, int, int]) -> torch.Tensor:
    """12 affine dofs (a 3x3 deviation from the identity, then a translation
    in tenths of the extent) -> absolute sample positions [3, D, H, W] in the
    moving volume, about the centre of ``shape``. The 3x3 product is written
    out as elementwise multiply-adds (not a matmul), so the CPU and the card
    compute the same positions and an order-0 warp picks the same voxels."""
    dev = params.device
    ext = torch.tensor(shape, dtype=torch.float32, device=dev)
    mat = torch.eye(3, device=dev) + params[:9].reshape(3, 3)
    trans = params[9:12] * ext / 10.0
    c = (ext - 1.0) / 2.0
    axes = [torch.arange(s, dtype=torch.float32, device=dev) - c[i]
            for i, s in enumerate(shape)]
    grid = torch.meshgrid(*axes, indexing="ij")
    tc = trans + c
    return torch.stack([mat[i, 0] * grid[0] + mat[i, 1] * grid[1] + mat[i, 2] * grid[2]
                        + tc[i] for i in range(3)])


def _trilinear_sample(vol: torch.Tensor, coords: torch.Tensor, order: int = 1) -> torch.Tensor:
    """``map_coordinates(vol, coords, order, mode='nearest')`` of one volume."""
    return map_coordinates(vol[None], coords[None], order)[0]


def _register_level(fixed: torch.Tensor, moving: torch.Tensor, params0: torch.Tensor,
                    lr: float, iters: int):
    """``iters`` Adam steps (optax.adam(lr): b1 0.9, b2 0.999, eps 1e-8) on
    mean((warp(moving) - fixed)²). Returns (params, losses [iters])."""
    p = params0.detach().clone().requires_grad_(True)
    opt = torch.optim.Adam([p], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    losses = []
    for _ in range(iters):
        opt.zero_grad(set_to_none=True)
        warped = _trilinear_sample(moving, _affine_grid(p, tuple(fixed.shape)))
        loss = torch.mean((warped - fixed) ** 2)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    return p.detach(), torch.stack(losses)


def affine_register(fixed: np.ndarray, moving: np.ndarray, iters_per_level: int = 200,
                    levels: Sequence[int] = (4, 2, 1), lr: float = 1e-2,
                    device: DeviceLike = None, report: Optional[dict] = None):
    """Affine registration of ``moving`` onto ``fixed`` (the grid of the
    result), coarse to fine over the strides ``levels``, each volume scaled
    by its maximum. Returns (warped_moving, params[12]) as numpy. ``report``
    gets 'reg_mse', the first and last loss of each level."""
    dev = resolve_device(device)
    fixed = np.asarray(fixed, np.float32)
    moving = np.asarray(moving, np.float32)
    fmax = fixed.max() or 1.0
    mmax = moving.max() or 1.0
    params = torch.zeros((12,), dtype=torch.float32, device=dev)
    mse = []
    for lv in levels:
        f = _tensor(fixed[::lv, ::lv, ::lv] / fmax, dev)
        m = _tensor(moving[::lv, ::lv, ::lv] / mmax, dev)
        params, losses = _register_level(f, m, params, lr, iters_per_level)
        mse.append(losses[[0, -1]] if len(losses) else losses)
    with torch.no_grad():
        warped = _trilinear_sample(_tensor(moving, dev), _affine_grid(params, fixed.shape))
    if report is not None:
        report["reg_mse"] = [x.tolist() for x in mse]
    return warped.cpu().numpy(), params.cpu().numpy()


def apply_affine(vol: np.ndarray, params: np.ndarray, shape: Tuple[int, int, int],
                 order: int = 1, device: DeviceLike = None) -> np.ndarray:
    """Warp another volume with a fitted affine (order 0 for labels)."""
    dev = resolve_device(device)
    coords = _affine_grid(_tensor(params, dev), tuple(shape))
    return _trilinear_sample(_tensor(vol, dev), coords, order).cpu().numpy()


# --------------------------------------------------------------------------- #
# crop to the brain's bounding box
# --------------------------------------------------------------------------- #
def crop_to_brain_bbox(vols: Sequence[np.ndarray], mask: np.ndarray,
                       margin: int = 2) -> Tuple[list, np.ndarray]:
    """Crop all ``vols`` and the mask to the mask's bounding box + margin."""
    idx = np.where(mask > 0)
    if idx[0].size == 0:
        return list(vols), mask
    sl = tuple(
        slice(max(0, int(i.min()) - margin), min(s, int(i.max()) + 1 + margin))
        for i, s in zip(idx, mask.shape)
    )
    return [v[sl] for v in vols], mask[sl]


# --------------------------------------------------------------------------- #
# N4-style bias correction
# --------------------------------------------------------------------------- #
def _n4_fit(vol: torch.Tensor, mask: torch.Tensor, order: int, iters: int):
    """The log-bias fit: monomials z^i y^j x^k (i + j + k <= order) over
    [-1, 1]^3, weighted by the mask, solved ``iters`` times on the current
    log image (the normal equations do not change between iterations, so
    they are formed once). The fit runs in float64: the JAX package's
    float32 normal equations sum ~1e7 voxels, and their rounding (~1e-3 of
    the volume at full size) would otherwise depend on the device's
    summation order. Returns (corrected, bias) in float32."""
    d, h, w = vol.shape
    dev = vol.device
    f64 = torch.float64
    zz = torch.linspace(-1, 1, d, device=dev, dtype=f64)[:, None, None].expand(d, h, w)
    yy = torch.linspace(-1, 1, h, device=dev, dtype=f64)[None, :, None].expand(d, h, w)
    xx = torch.linspace(-1, 1, w, device=dev, dtype=f64)[None, None, :].expand(d, h, w)
    feats = [(zz ** i) * (yy ** j) * (xx ** k)
             for i in range(order + 1)
             for j in range(order + 1 - i)
             for k in range(order + 1 - i - j)]
    a = torch.stack([f.reshape(-1) for f in feats], dim=1)  # [N, F]
    wv = mask.reshape(-1).to(f64)
    log_v = torch.log(torch.clamp_min(vol, 1e-4)).reshape(-1).to(f64)
    aw = a * wv[:, None]
    ata = a.T @ aw + 1e-6 * torch.eye(a.shape[1], device=dev, dtype=f64)
    wsum = wv.sum() + 1e-8
    log_corr = log_v
    for _ in range(iters):
        coef = torch.linalg.solve(ata, aw.T @ log_corr)
        field = a @ coef
        mean_f = (field * wv).sum() / wsum
        log_corr = log_corr - (field - mean_f)
    return (torch.exp(log_corr).float().reshape(vol.shape),
            torch.exp(log_v - log_corr).float().reshape(vol.shape))


def n4_bias_correct(vol: np.ndarray, mask: Optional[np.ndarray] = None, order: int = 3,
                    iters: int = 4, device: DeviceLike = None):
    """Remove a smooth multiplicative bias field inside the mask (default
    vol > 0). Returns (corrected, bias_field) as float32 numpy; the
    background keeps its original value."""
    dev = resolve_device(device)
    v = np.asarray(vol, np.float32)
    m = ((np.asarray(mask) > 0) if mask is not None else (v > 0)).astype(np.float32)
    corrected, bias = _n4_fit(_tensor(v, dev), _tensor(m, dev), order, iters)
    out = np.where(m > 0, corrected.cpu().numpy(), v)
    return out.astype(np.float32), bias.cpu().numpy().astype(np.float32)


# --------------------------------------------------------------------------- #
# per-dataset pipelines (prepare_*.sh)
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class PrepareConfig:
    resample: bool = True  # Brats21 ships 1 mm isotropic already
    skull_strip: bool = True
    register: bool = False  # needs an atlas volume
    n4: bool = True
    crop: bool = True
    target_spacing: float = 1.0


def prepare_subject(img_path: str, out_dir: str, cfg: PrepareConfig,
                    atlas: Optional[np.ndarray] = None, seg_path: Optional[str] = None,
                    device: DeviceLike = None, affine: Optional[np.ndarray] = None,
                    report: Optional[dict] = None) -> dict:
    """Run the staged pipeline on one subject; writes <name>_{t1,mask[,seg]}
    NIfTIs into ``out_dir`` and returns their paths. ``affine``: a fitted
    registration to apply instead of fitting one. ``report`` gets the
    seconds of each stage ('seconds'), the registration's params
    ('affine') and its losses ('reg_mse')."""
    dev = resolve_device(device)
    name = os.path.basename(img_path).split(".")[0]
    vol, meta = read_nifti(img_path)
    spacing = tuple(meta.spacing) if meta.spacing else (1.0, 1.0, 1.0)
    seg = read_nifti(seg_path)[0] if seg_path else None
    return _prepare_stages(name, vol, spacing, seg, out_dir, cfg, atlas, dev, affine,
                           {} if report is None else report)


def _prepare_stages(name, vol, spacing, seg, out_dir, cfg, atlas, dev, affine, report):
    seconds = report.setdefault("seconds", {})
    t0 = time.perf_counter()

    def lap(stage):
        nonlocal t0
        _sync(dev)
        now = time.perf_counter()
        seconds[stage] = now - t0
        t0 = now

    if cfg.resample:
        vol = resample_iso(vol, spacing, cfg.target_spacing, device=dev)
        if seg is not None:
            seg = resample_iso(seg, spacing, cfg.target_spacing, method="nearest", device=dev)
        lap("resample")

    mask = extract_brain_mask(vol) if cfg.skull_strip else (vol > 0).astype(np.float32)
    if cfg.skull_strip:
        vol = vol * mask
    lap("mask")

    if cfg.register and atlas is not None:
        if affine is None:
            vol, params = affine_register(atlas, vol, device=dev, report=report)
        else:
            params = np.asarray(affine, np.float32)
            vol = apply_affine(vol, params, atlas.shape, order=1, device=dev)
        report["affine"] = np.asarray(params).tolist()
        mask = (apply_affine(mask, params, atlas.shape, order=0, device=dev) > 0.5
                ).astype(np.float32)
        if seg is not None:
            seg = apply_affine(seg, params, atlas.shape, order=0, device=dev)
        lap("register")

    if cfg.n4:
        vol, _ = n4_bias_correct(vol, mask, device=dev)
        lap("n4")

    if cfg.crop:
        vols = [vol] + ([seg] if seg is not None else [])
        vols, mask = crop_to_brain_bbox(vols, mask)
        vol = vols[0]
        if seg is not None:
            seg = vols[1]

    os.makedirs(out_dir, exist_ok=True)
    out = {"img": os.path.join(out_dir, f"{name}_t1.nii.gz"),
           "mask": os.path.join(out_dir, f"{name}_mask.nii.gz")}
    write_nifti(out["img"], vol.astype(np.float32))
    write_nifti(out["mask"], mask.astype(np.float32))
    if seg is not None:
        out["seg"] = os.path.join(out_dir, f"{name}_seg.nii.gz")
        write_nifti(out["seg"], seg.astype(np.float32))
    lap("crop_write")
    return out


DATASET_STAGES = {
    # prepare_IXI.sh: resample -> HD-BET -> (register) -> N4 -> crop
    "IXI": PrepareConfig(resample=True, skull_strip=True, n4=True, crop=True),
    # prepare_Brats21.sh: already 1 mm and skull-stripped; N4 + crop only
    "Brats21": PrepareConfig(resample=False, skull_strip=False, n4=True, crop=True),
    # prepare_MSLUB.sh: the full pipeline, the consensus seg carried through
    "MSLUB": PrepareConfig(resample=True, skull_strip=True, n4=True, crop=True),
}
