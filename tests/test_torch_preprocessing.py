"""The port's offline data preparation (conditioned_diffusion_models_uad_torch/
data/preprocessing.py) against the JAX package's, stage by stage and per
dataset, on the CPU at small sizes, with numpy-seeded phantoms.

Tolerances (float32): the resample and the warps 1e-5 absolute on values in
[0, 1]; the sample grid 1e-4 on coordinates of up to ~30; the N4 correction
2e-4 relative (the port solves the normal equations in float64, the JAX
package in float32; measured 4e-5 on the bias field, 1.4e-6 on the
corrected volume); the registration's params 1e-4 after 30 Adam steps from
zero (measured 4.8e-7) and after a whole fit that converges (measured
6.8e-6). The brain mask and every label volume are held bit for bit."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conditioned_diffusion_models_uad_torch.data import preprocessing as P
from conditioned_diffusion_models_uad_torch.data.nifti import read_nifti, write_nifti
from conditioned_diffusion_models_uad_tpu.data import preprocessing as JP

torch.set_num_threads(2)

CPU = "cpu"


def phantom(shape, seed=0, coords=None):
    """A head-like phantom: a bright ellipsoid 'brain' with smooth texture
    inside a thin 'skull' shell, on a dark background; evaluated at
    ``coords`` [3, ...] (voxel positions) or on the grid of ``shape``."""
    rng = np.random.default_rng(seed)
    if coords is None:
        coords = np.stack(np.meshgrid(*[np.arange(s, dtype=np.float64) for s in shape],
                                      indexing="ij"))
    c = (np.asarray(shape, np.float64) - 1) / 2
    u = [(coords[i] - c[i]) / (0.42 * shape[i]) for i in range(3)]
    r = np.sqrt(u[0] ** 2 + u[1] ** 2 + u[2] ** 2)
    tex = 0.0
    for _ in range(4):
        f = rng.uniform(1.0, 3.0, 3)
        ph = rng.uniform(0, 2 * np.pi, 3)
        tex = tex + 0.1 * np.cos(f[0] * u[0] + ph[0]) * np.cos(f[1] * u[1] + ph[1]) * np.cos(
            f[2] * u[2] + ph[2])
    # off-centre blobs break the ellipsoid's symmetries, so an affine is
    # determined by the image
    for centre, amp in (((0.35, -0.2, 0.1), 0.25), ((-0.3, 0.3, -0.25), -0.2),
                        ((0.05, 0.45, 0.4), 0.15)):
        d2 = sum((u[i] - centre[i]) ** 2 for i in range(3))
        tex = tex + amp * np.exp(-d2 / 0.03)
    # edges a voxel or two wide, so that trilinear warps of it are accurate
    def inside(a):
        return 1.0 / (1.0 + np.exp(-a / 0.04))

    brain = inside(0.8 - r) * (0.7 + tex)
    skull = 0.35 * inside(r - 0.9) * inside(1.0 - r)
    return (brain + skull).astype(np.float32)


def _close(got, want, atol, rtol=0.0):
    want = np.asarray(want)
    assert np.shape(got) == want.shape
    np.testing.assert_allclose(np.asarray(got), want, atol=atol, rtol=rtol)


@pytest.mark.parametrize("spacing", [(0.94, 0.94, 1.2), (1.3, 0.8, 1.0)])
@pytest.mark.parametrize("method", ["trilinear", "nearest"])
def test_resample_iso_matches_jax(spacing, method):
    vol = phantom((26, 24, 15), 1)
    got = P.resample_iso(vol, spacing, method=method, device=CPU)
    want = JP.resample_iso(vol, spacing, method=method)
    if method == "nearest":
        assert np.array_equal(got, np.asarray(want))
    else:
        _close(got, want, 1e-5)


def test_brain_mask_is_the_jax_packages():
    vol = phantom((30, 28, 20), 2) + np.random.default_rng(3).normal(
        0, 0.02, (30, 28, 20)).astype(np.float32)
    assert P._otsu_threshold(vol) == JP._otsu_threshold(vol)
    m = P.extract_brain_mask(vol)
    assert np.array_equal(m, JP.extract_brain_mask(vol))
    # the skull shell is dropped, the brain kept
    assert 0.1 < m.mean() < 0.4 and m[15, 14, 10] == 1 and m[0, 0, 0] == 0


def _params(seed=0, scale=0.04):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(-scale, scale, 9),
                           rng.uniform(-0.2, 0.2, 3)]).astype(np.float32)


def test_affine_grid_and_warps_match_jax():
    shape = (18, 16, 12)
    p = _params(1)
    got = P._affine_grid(torch.from_numpy(p), shape)
    want = JP._affine_grid(jnp.asarray(p), shape)
    _close(got, want, 1e-4)
    vol = phantom((20, 17, 13), 4)
    for order in (0, 1):
        got = P.apply_affine(vol, p, shape, order=order, device=CPU)
        want = JP.apply_affine(vol, p, shape, order=order)
        if order == 0:
            # coordinates agree to ~1e-6, so a nearest pick can only differ
            # for a position within that of a voxel boundary: none here
            assert np.array_equal(got, np.asarray(want))
        else:
            _close(got, want, 1e-5)


def test_register_level_matches_jax():
    fixed = phantom((16, 16, 12), 5)
    moving = P.apply_affine(fixed, _params(2), fixed.shape, device=CPU)
    p0 = np.zeros(12, np.float32)
    got, losses = P._register_level(torch.from_numpy(fixed), torch.from_numpy(moving),
                                    torch.from_numpy(p0), 1e-2, 30)
    want, wlosses = JP._register_level(jnp.asarray(fixed), jnp.asarray(moving),
                                       jnp.asarray(p0), 1e-2, 30)
    _close(losses.numpy(), wlosses, 1e-6, 1e-4)
    _close(got.numpy(), want, 1e-4)


def _planted(shape, p, seed):
    """fixed = phantom on its grid; moving = the phantom seen through the
    inverse of the affine ``p``, so that registering moving onto fixed
    recovers ``p``."""
    ext = np.asarray(shape, np.float64)
    mat = np.eye(3) + p[:9].reshape(3, 3).astype(np.float64)
    trans = p[9:12] * ext / 10.0
    c = (ext - 1) / 2
    grid = np.stack(np.meshgrid(*[np.arange(s, dtype=np.float64) for s in shape],
                                indexing="ij")).reshape(3, -1)
    src = np.linalg.solve(mat, grid - c[:, None] - trans[:, None]) + c[:, None]
    return phantom(shape, seed), phantom(shape, seed, src.reshape(3, *shape))


def test_affine_register_recovers_a_planted_affine():
    """Registering the planted view back onto the phantom: the port's fit
    equals the JAX package's to 1e-4 (measured 1e-5), recovers the planted
    translation to 2e-3 and the matrix to 0.05 (the trilinear warp's error
    on the phantom moves the objective's minimum that far; the fit's loss
    is below the planted affine's), and cuts the loss 15-fold."""
    shape = (32, 30, 24)
    planted = _params(3, 0.05)
    fixed, moving = _planted(shape, planted, 6)
    kw = dict(iters_per_level=150, levels=(2, 1))
    report = {}
    warped, got = P.affine_register(fixed, moving, device=CPU, report=report, **kw)
    jwarped, want = JP.affine_register(fixed, moving, **kw)
    assert np.abs(got - np.asarray(want)).max() < 1e-4
    _close(warped, jwarped, 1e-4 * float(moving.max()))
    assert np.abs(got[9:] - planted[9:]).max() < 2e-3
    assert np.abs(got[:9] - planted[:9]).max() < 0.05
    f = torch.from_numpy(fixed / fixed.max())
    m = torch.from_numpy(moving / moving.max())

    def loss(p):
        grid = P._affine_grid(torch.from_numpy(np.asarray(p, np.float32)), shape)
        return float(((P._trilinear_sample(m, grid) - f) ** 2).mean())

    assert loss(got) <= loss(planted) and 15 * loss(got) < loss(np.zeros(12))
    first, last = report["reg_mse"][0][0], report["reg_mse"][-1][1]
    assert 15 * last < first


def test_n4_bias_correct_matches_jax():
    shape = (20, 18, 14)
    vol = phantom(shape, 7)
    zz, yy, xx = np.meshgrid(*[np.linspace(-1, 1, s) for s in shape], indexing="ij")
    bias = np.exp(0.3 * zz - 0.2 * yy * xx + 0.1 * xx ** 2).astype(np.float32)
    biased = vol * bias
    mask = (vol > 0.5).astype(np.float32)
    got, got_bias = P.n4_bias_correct(biased, mask, device=CPU)
    want, want_bias = JP.n4_bias_correct(biased, mask)
    _close(got, want, 0.0, 2e-4)
    _close(got_bias, want_bias, 0.0, 2e-4)
    assert np.array_equal(got[mask == 0], biased[mask == 0])  # background kept
    g2, _ = P.n4_bias_correct(biased, None, device=CPU)
    w2, _ = JP.n4_bias_correct(biased, None)
    _close(g2, w2, 0.0, 2e-4)


def test_crop_to_brain_bbox_is_the_jax_packages():
    mask = np.zeros((12, 10, 8), np.float32)
    mask[3:7, 2:9, 1:4] = 1
    vols = [np.arange(mask.size, dtype=np.float32).reshape(mask.shape)]
    (got,), gm = P.crop_to_brain_bbox(vols, mask)
    (want,), wm = JP.crop_to_brain_bbox(vols, mask)
    assert np.array_equal(got, want) and np.array_equal(gm, wm)
    assert P.crop_to_brain_bbox(vols, np.zeros_like(mask))[1].shape == mask.shape


def _raw_subject(tmp, name, shape, spacing, seed, seg=False):
    vol = 800 * phantom(shape, seed)
    path = os.path.join(tmp, f"{name}.nii.gz")
    write_nifti(path, vol, spacing=spacing)
    seg_path = None
    if seg:
        s = np.zeros(shape, np.float32)
        c = [x // 2 for x in shape]
        s[c[0] - 2:c[0] + 2, c[1] - 3:c[1] + 1, c[2] - 1:c[2] + 2] = 1
        seg_path = os.path.join(tmp, f"{name}_seg.nii.gz")
        write_nifti(seg_path, s, spacing=spacing)
    return path, seg_path


def _jax_fitted_affine(img, atlas, cfg):
    """The affine the JAX package's ``prepare_subject`` fits for ``img``
    (its stages up to the registration, rerun)."""
    vol, meta = read_nifti(img)
    if cfg.resample:
        vol = JP.resample_iso(vol, tuple(meta.spacing), cfg.target_spacing)
    mask = JP.extract_brain_mask(vol) if cfg.skull_strip else None
    if mask is not None:
        vol = vol * mask
    return np.asarray(JP.affine_register(atlas, vol)[1])


@pytest.mark.parametrize("dataset", sorted(P.DATASET_STAGES))
@pytest.mark.parametrize("register", [False, True])
def test_prepare_subject_matches_jax_per_dataset(tmp_path, dataset, register):
    """Each dataset's stage gating on a raw subject with an anisotropic
    grid and a lesion segmentation, without and with registration to an
    atlas: the same files, the same brain mask and segmentation, the volume
    to 1e-4 of its range. With registration the port applies the affine the
    JAX package fitted (``affine=``): on a subject this small the coarse
    levels see 6 voxels a side and the two fits part ways (the fit itself is
    held against JAX above, on a planted affine)."""
    cfg = dataclasses.replace(P.DATASET_STAGES[dataset], register=register)
    jcfg = dataclasses.replace(JP.DATASET_STAGES[dataset], register=register)
    assert cfg == P.PrepareConfig(**dataclasses.asdict(jcfg))
    img, seg = _raw_subject(str(tmp_path), f"{dataset}_s0", (26, 24, 15), (0.94, 0.94, 1.2),
                            8, seg=True)
    atlas = 600 * phantom((24, 22, 18), 8)
    affine = _jax_fitted_affine(img, atlas, jcfg) if register else None
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    report = {}
    out = P.prepare_subject(img, ours, cfg, atlas=atlas, seg_path=seg, device=CPU,
                            affine=affine, report=report)
    want = JP.prepare_subject(img, theirs, jcfg, atlas=atlas, seg_path=seg)
    assert {k: os.path.basename(v) for k, v in out.items()} == \
        {k: os.path.basename(v) for k, v in want.items()}
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs))
    gm, wm = read_nifti(out["mask"])[0], read_nifti(want["mask"])[0]
    gv, wv = read_nifti(out["img"])[0], read_nifti(want["img"])[0]
    gs, ws = read_nifti(out["seg"])[0], read_nifti(want["seg"])[0]
    assert np.array_equal(gm, wm) and np.array_equal(gs, ws)
    _close(gv, wv, 1e-4 * float(np.abs(wv).max()))
    assert set(report["seconds"]) <= {"resample", "mask", "register", "n4", "crop_write"}
    assert ("affine" in report) == register


def test_prepare_subject_replays_an_affine(tmp_path):
    """``affine=`` applies a fitted registration instead of fitting one:
    with the affine a fit found, the same files as the fit."""
    img, _ = _raw_subject(str(tmp_path), "IXI_r", (26, 24, 15), (0.94, 0.94, 1.2), 9)
    atlas = 600 * phantom((24, 22, 18), 9)
    cfg = dataclasses.replace(P.DATASET_STAGES["IXI"], register=True)
    report = {}
    a = P.prepare_subject(img, str(tmp_path / "a"), cfg, atlas=atlas, device=CPU,
                          report=report)
    b = P.prepare_subject(img, str(tmp_path / "b"), cfg, atlas=atlas, device=CPU,
                          affine=np.asarray(report["affine"], np.float32))
    for k in a:
        assert np.array_equal(read_nifti(a[k])[0], read_nifti(b[k])[0])


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        P.resample_iso(np.zeros((4, 4, 4), np.float32), (1, 1, 1))
    with pytest.raises(RuntimeError):
        P.n4_bias_correct(np.ones((4, 4, 4), np.float32))
