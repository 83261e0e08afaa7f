"""The slice as a whole: the port's VolumeReconstructor (__call__,
batch_call, batch_call_scored) against the JAX package's on the CPU, from
the same seeded weights and noise, on the TINY config of
tests/test_torch_reconstruct.py; then the packed scores through
parse_packed and EvalSession.test_step_precomputed.

The JAX task's noise is pinned to the hash-simplex Pallas path (interpret
mode on the CPU); each volume's seeds are the ones the JAX task draws from
its key, split(key_v, E)[m].

Tolerance: reconstructions, losses and the residual 2e-5 absolute
(convolution summation order, as in tests/test_torch_reconstruct.py); the
reco errors and scores 2e-5 absolute; AUROC/AUPRC 1e-3 and best dice 1e-3
(a voxel whose residual moves past another's flips a pair); thresholds 2e-5.
Counts may differ only by voxels whose residual lies within 2e-5 (plus the
thresholds' difference) of the threshold; the test counts those voxels.
Also: no module of the port imports jax, sklearn or matplotlib when
imported."""
import functools
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conditioned_diffusion_models_uad_torch.eval.fused import parse_packed
from conditioned_diffusion_models_uad_torch.eval.harness import EvalConfig, EvalSession
from conditioned_diffusion_models_uad_torch.eval.reconstruct import (
    VolumeReconstructor,
    pad_to_multiple,
)
from conditioned_diffusion_models_uad_torch.models.tasks import DDPMTask, DDPMTaskConfig
from conditioned_diffusion_models_uad_torch.utils.random_init import randomize_
from conditioned_diffusion_models_uad_tpu.eval import fused as JF
from conditioned_diffusion_models_uad_tpu.eval.harness import EvalConfig as JEvalConfig
from conditioned_diffusion_models_uad_tpu.eval.harness import EvalSession as JEvalSession
from conditioned_diffusion_models_uad_tpu.eval.reconstruct import (
    VolumeReconstructor as JVolumeReconstructor,
)
from conditioned_diffusion_models_uad_tpu.models import tasks as jtasks
from conditioned_diffusion_models_uad_tpu.ops.simplex import make_noise_fn
from conditioned_diffusion_models_uad_tpu.utils.convert_torch import (
    convert_reference_ddpm_checkpoint,
)

torch.set_num_threads(2)

TINY = dict(
    image_hw=(32, 32), cond_dim=16, encoder_backbone="resnet18",
    timesteps=20, unet_dim=64, num_res_blocks=1, channel_mult=(1, 2),
    attention_resolutions=(), test_timesteps=10, step_ensemble=(5, 10),
    dtype="float32",
)
SHAPE = (32, 32, 6)  # depth 6: padded to the bucket of 8
TOL = 2e-5
TOL_RANK = 1e-3
CFG = dict(cc_backend="device", hausdorff_backend="device")  # the device_fast preset
INT32_MAX = int(jnp.iinfo(jnp.int32).max)


def _seeds(key, e):
    """[E] seeds the JAX task draws from one volume's key."""
    return [int(jax.random.randint(k, (), 0, INT32_MAX, jnp.int32))
            for k in jax.random.split(key, e)]


def _subjects():
    rng = np.random.default_rng(11)
    subs = []
    for _ in range(2):
        vol = rng.uniform(0, 1, SHAPE).astype(np.float32)
        seg = np.zeros(SHAPE, np.float32)
        seg[8:20, 10:22, 1:5] = 1.0
        mask = np.zeros(SHAPE, np.float32)
        mask[2:30, 2:30] = 1.0
        subs.append({"vol": vol, "vol_orig": vol, "mask_orig": mask, "seg_orig": seg})
    return subs


def _port_task():
    task = DDPMTask(DDPMTaskConfig(**TINY), device="cpu")
    return randomize_(task, 21)


@functools.lru_cache(maxsize=None)
def _jax_run():
    """The JAX reconstructor's batch_call and batch_call_scored, and the
    port seeds [G, E] of the same noise."""
    jtask = jtasks.DDPMTask(jtasks.DDPMTaskConfig(**TINY))
    jtask.noise_fn = make_noise_fn("simplex", impl="pallas")
    sd = {}
    for k, v in _port_task().state_dict().items():
        sd[("diffusion.model." + k[len("unet."):]) if k.startswith("unet.") else k] = v.numpy()
    variables = convert_reference_ddpm_checkpoint(sd, jtask)
    recon = JVolumeReconstructor(jtask)
    subs = _subjects()
    keys = jax.random.split(jax.random.PRNGKey(5), len(subs))
    batch = recon.batch_call(variables, [s["vol"] for s in subs], keys)
    flags = JEvalSession(JEvalConfig(**CFG), "Brats21", "val")._fused_flags(
        SHAPE, seg_is_host=True)
    diff_g, packed_g = recon.batch_call_scored(variables, subs, keys, flags)
    e = len(TINY["step_ensemble"])
    seeds = torch.tensor([_seeds(k, e) for k in keys], dtype=torch.int32)
    llen = recon.latent_len(variables, subs[0]["vol"], keys[0])
    return (
        [(np.asarray(r), {k: np.asarray(v) for k, v in a.items()}) for r, a in batch],
        np.asarray(diff_g), np.asarray(packed_g), flags, seeds, llen,
    )


def test_call_and_batch_call_match_jax():
    want, _, _, _, seeds, _ = _jax_run()
    recon = VolumeReconstructor(_port_task(), device="cpu")
    subs = _subjects()
    got = recon.batch_call([s["vol"] for s in subs], seeds)
    for (reco, aux), (w_reco, w_aux), sub, row in zip(got, want, subs, seeds):
        assert reco.shape == SHAPE and w_reco.std() > 0.05
        np.testing.assert_allclose(reco.numpy(), w_reco, atol=TOL, rtol=0)
        np.testing.assert_allclose(float(aux["loss"]), float(w_aux["loss"]), atol=TOL)
        np.testing.assert_allclose(aux["latent"].numpy(), w_aux["latent"], atol=1e-4, rtol=1e-4)
        # alone, a volume draws the noise it draws in its group (the CPU's
        # convolutions may round otherwise at another batch size)
        alone, alone_aux = recon(sub["vol"], row[None], return_aux=True)
        np.testing.assert_allclose(alone.numpy(), reco.numpy(), atol=TOL, rtol=0)
        np.testing.assert_allclose(alone_aux["latent"].numpy(), aux["latent"].numpy(),
                                   atol=1e-4, rtol=1e-4)


def test_batch_call_scored_matches_jax_and_records():
    _, w_diff, w_packed, flags, seeds, llen = _jax_run()
    task = _port_task()
    recon = VolumeReconstructor(task, device="cpu")
    assert recon.latent_len() == llen
    session = EvalSession(EvalConfig(**CFG), "Brats21", "val", device="cpu")
    pflags = session._fused_flags(SHAPE, seg_is_host=True)
    assert pflags["statics"] == flags["statics"]
    assert np.isnan(pflags["th_record"]) and np.isnan(flags["th_record"])
    subs = _subjects()
    diff_g, packed_g = recon.batch_call_scored(subs, pflags, seeds)
    assert diff_g.shape == (2, *SHAPE) and packed_g.dtype == torch.uint8
    np.testing.assert_allclose(diff_g.numpy(), w_diff, atol=TOL, rtol=0)
    buf = packed_g.cpu().numpy()  # the group's one fetch
    args = (SHAPE, llen, flags["statics"]["pack_seg"], flags["statics"]["pack_maps"])
    for j, sub in enumerate(subs):
        got = parse_packed(buf[j], *args)
        want = JF.parse_packed(w_packed[j], *args)
        g, w = got["scalars"], want["scalars"]
        for k in ("l1recoErrorAll", "l2recoErrorAll", "l1recoErrorUnhealthy",
                  "l1recoErrorHealthy", "vol_score", "aux_loss", "th_record", "th_apply"):
            np.testing.assert_allclose(g[k], w[k], atol=TOL, err_msg=k)
        for k in ("auroc", "auprc", "best_dice"):
            np.testing.assert_allclose(g[k], w[k], atol=TOL_RANK, err_msg=k)
        np.testing.assert_allclose(got["latent"], want["latent"], atol=1e-4, rtol=1e-4)
        # counts: only voxels within the tolerance of the threshold may move
        th = w["th_apply"]
        band = TOL + abs(g["th_apply"] - th)
        near = int(np.sum(np.abs(w_diff[j] - th) <= band)
                   + np.sum(np.abs(diff_g[j].numpy() - g["th_apply"]) <= band))
        moved = sum(abs(g[k] - w[k]) for k in ("tp", "fp", "tn", "fn")) / 2
        assert moved <= near, (moved, near)
        assert g["lesion_size"] == w["lesion_size"] == sub["seg_orig"].sum()
        np.testing.assert_array_equal(got["per_slice"][:, 1], want["per_slice"][:, 1])
        session.test_step_precomputed(
            got, diff_g[j], pflags, seg_available=True, batch_idx=j, ID=f"s{j}",
            label_vol=1, score_fn=task.anomaly_scores, data_seg=sub["seg_orig"],
            seg_dev=torch.from_numpy(sub["seg_orig"]))
    d = session.test_end()
    assert d["IDs"] == ["s0", "s1"] and np.isfinite(d["DicePerVolMean"])
    assert session.threshold["total"] > 0
    assert d["AnomalyScoreRegPerVol"] == [parse_packed(buf[j], *args)["scalars"]["aux_loss"]
                                          for j in range(2)]


def test_reconstructor_contract():
    task = _port_task()
    with pytest.raises(NotImplementedError):
        VolumeReconstructor(task, patched=True, device="cpu")
    recon = VolumeReconstructor(task, device="cpu", num_eval_slices=4)
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    vol = _subjects()[0]["vol"]
    reco = recon(vol, generator=g1)
    assert reco.shape == (32, 32, 4)  # centre crop of the depth
    assert torch.equal(reco, recon(vol, task.draw_seeds(g2, 1)))
    with pytest.raises(ValueError):
        recon(vol)
    x = torch.arange(5.0).reshape(5, 1)
    padded, n = pad_to_multiple(x, 4)
    assert n == 5 and padded[:, 0].tolist() == [0, 1, 2, 3, 4, 4, 4, 4]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            VolumeReconstructor(task)


def test_anomaly_scores_match_jax():
    jtask = jtasks.DDPMTask(jtasks.DDPMTaskConfig(**TINY))
    assert _port_task().anomaly_scores(0.375) == jtask.anomaly_scores(0.375)


def test_port_imports_no_jax_sklearn_matplotlib():
    """Importing every module of the port pulls in none of jax, flax, optax,
    sklearn, matplotlib or the JAX package (a fresh interpreter)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import conditioned_diffusion_models_uad_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = ('jax', 'jaxlib', 'flax', 'optax', 'sklearn', 'matplotlib',\n"
        "       'conditioned_diffusion_models_uad_tpu')\n"
        "print(sorted(k for k in sys.modules if k.split('.')[0] in bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip() == "[]", out.stdout
