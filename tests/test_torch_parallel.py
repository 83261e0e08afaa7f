"""Data parallelism over torch.distributed (``parallel/mesh.py``) on the CPU:
ranks are processes spawned with the gloo backend, each on the CPU.

* ``pad_to_multiple``, ``shard`` and ``shard_draws``;
* the synced ``MaskedBatchNorm`` of 2 ranks (masked and unmasked) against
  one process over the concatenated batch: output, input and parameter
  gradients and running statistics within 1e-6 (the ranks sum Σx and Σx²,
  one process takes a two-pass variance);
* a 2-rank ``Trainer.fit`` against the port's 1-process fit on the same
  batches and draws (losses within 1e-5, the net change of parameters and
  running statistics within tests/test_torch_fit.py's TOL_GAP), against the JAX
  ``Trainer(mesh=local_mesh(2))`` fit at tests/test_torch_fit.py's
  tolerances, the two ranks' parameters and statistics bit-equal, and the
  checkpoints written by rank 0 alone;
* a 2-rank ``batch_call_scored`` (volume-parallel) against the JAX
  reconstructor on a 2-device mesh, at tests/test_torch_eval_reconstruct.py's
  tolerances, and slice-parallel ``__call__``/``batch_call`` against one
  process at 2e-5 (the UNet's batch differs);
* a group that does not divide by the ranks takes the separate-dispatch path
  in ``run_stage`` and records the same rows as one process (2e-5).

Rank workers are the ``_..._rank`` functions of this module (the spawn start
method imports them); they import no JAX.
"""
import json
import os

import numpy as np
import pytest
import torch

from conditioned_diffusion_models_uad_torch.data.datamodules import DataConfig, TrainSliceSource
from conditioned_diffusion_models_uad_torch.models.resnet import MaskedBatchNorm
from conditioned_diffusion_models_uad_torch.models.tasks import DDPMTask, DDPMTaskConfig
from conditioned_diffusion_models_uad_torch.parallel import mesh
from conditioned_diffusion_models_uad_torch.train import loop
from conditioned_diffusion_models_uad_torch.utils.random_init import randomize_

torch.set_num_threads(2)

TOL_BN = 1e-6
TOL_FIT_LOSS = 1e-5  # measured 1.6e-6 (half-batch convolutions, summed moments)
# the fit's net change, relative: tests/test_torch_fit.py's TOL_GAP, for the
# same reason (Adam moves an entry whose gradient is within rounding of 0 by
# about lr either way); measured 0.0126 (params)
TOL_FIT_GAP = {"params": 0.05, "batch_stats": 5e-5}
TOL_RECO = 2e-5


def _cpus(n=2):
    return ["cpu"] * n


# --------------------------------------------------------------------------- #
# padding and sharding
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("n,multiple,target", [(5, 4, 8), (8, 4, 8), (1, 3, 3)])
def test_pad_to_multiple(n, multiple, target):
    x = torch.arange(n * 2).reshape(n, 2)
    padded, orig = mesh.pad_to_multiple(x, multiple)
    assert orig == n and padded.shape == (target, 2)
    assert torch.equal(padded[:n], x) and (padded[n:] == x[-1]).all()
    from conditioned_diffusion_models_uad_torch.eval.reconstruct import pad_to_multiple
    assert pad_to_multiple is mesh.pad_to_multiple


def test_shard_and_shard_draws():
    x = np.arange(12)
    assert [mesh.shard(x, r, 3).tolist() for r in range(3)] == [[0, 1, 2, 3], [4, 5, 6, 7],
                                                                [8, 9, 10, 11]]
    with pytest.raises(ValueError):
        mesh.shard(x, 0, 5)
    task = DDPMTask(DDPMTaskConfig(image_hw=(16, 16), cond_dim=8, encoder_backbone="resnet18",
                                   timesteps=20, unet_dim=32, num_res_blocks=1,
                                   channel_mult=(1, 2), attention_resolutions=(),
                                   step_ensemble=(5, 10), test_timesteps=10,
                                   dtype="float32", patched=True, patch_hw=(8, 8)),
                    device="cpu")
    draws = task.draw_train(torch.Generator().manual_seed(0), 4, augment="full")
    parts = [mesh.shard_draws(draws, r, 2, 4) for r in range(2)]
    for r, part in enumerate(parts):
        assert torch.equal(part.seed, draws.seed)  # the step's one noise field
        assert torch.equal(part.t, draws.t[2 * r:2 * r + 2])
        assert torch.equal(part.box, draws.box[2 * r:2 * r + 2])
        assert torch.equal(part.aug.noise, draws.aug.noise[2 * r:2 * r + 2])
        assert torch.equal(part.aug.intensity.log_gamma,
                           draws.aug.intensity.log_gamma[2 * r:2 * r + 2])
    assert mesh.shard_draws(draws, 0, 1, 4) is draws
    assert mesh.world() == (0, 1)


def test_white_noise_shard_is_a_slice_of_the_whole_draw():
    """Under ``sharded`` a task's white noise is its rank's rows of the
    noise drawn for the whole block (a simplex field is the same over it)."""
    cfg = dict(image_hw=(16, 16), cond_dim=8, encoder_backbone="resnet18", timesteps=20,
               unet_dim=32, num_res_blocks=1, channel_mult=(1, 2), attention_resolutions=(),
               step_ensemble=(5, 10), test_timesteps=10, dtype="float32")
    for noisetype in ("gaussian", "simplex"):
        task = DDPMTask(DDPMTaskConfig(noisetype=noisetype, **cfg), device="cpu")
        seeds = torch.tensor([3, 9], dtype=torch.int32)
        whole = task._noise(seeds, (6, 16, 16, 1)).reshape(2, 6, 16, 16, 1)
        for r in range(3):
            with mesh.sharded(task, r, 3):
                part = task._noise(seeds, (2, 16, 16, 1)).reshape(2, 2, 16, 16, 1)
            assert torch.equal(part, whole[:, 2 * r:2 * r + 2])
        assert task.shard == (0, 1)


# --------------------------------------------------------------------------- #
# synced BatchNorm
# --------------------------------------------------------------------------- #
def _bn_inputs():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(1.5, 2.0, (8, 6, 5, 5)).astype(np.float32))
    mask = torch.from_numpy((rng.uniform(size=(8, 1, 5, 5)) < 0.4).astype(np.float32))
    gout = torch.from_numpy(rng.normal(size=(8, 6, 5, 5)).astype(np.float32))
    weight = torch.from_numpy(rng.uniform(0.5, 1.5, 6).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=6).astype(np.float32))
    return x, mask, gout, weight, bias


def _bn_run(x, mask, gout, weight, bias):
    """One training forward/backward of MaskedBatchNorm on this process's
    rows: output, input gradient, (rank-summed) parameter gradients and the
    running statistics."""
    bn = MaskedBatchNorm(x.shape[1])
    with torch.no_grad():
        bn.weight.copy_(weight)
        bn.bias.copy_(bias)
    bn.train()
    x = x.clone().requires_grad_(True)
    y = bn(x, mask)
    (y * gout).sum().backward()
    grads = torch.cat([bn.weight.grad, bn.bias.grad])
    if mesh.world()[1] > 1:
        torch.distributed.all_reduce(grads)
    return {"y": y.detach(), "dx": x.grad, "dparams": grads,
            "running_mean": bn.running_mean.clone(), "running_var": bn.running_var.clone()}


def _bn_rank(rank):
    x, mask, gout, weight, bias = _bn_inputs()
    out = {}
    for masked in (False, True):
        m = mesh.shard(mask, rank, 2) if masked else None
        out[masked] = _bn_run(mesh.shard(x, rank, 2), m, mesh.shard(gout, rank, 2), weight,
                              bias)
    return out


@pytest.fixture(scope="module")
def bn_ranks():
    return mesh.spawn(_bn_rank, 2, "gloo", _cpus())


@pytest.mark.parametrize("masked", [False, True])
def test_synced_batchnorm_equals_whole_batch(bn_ranks, masked):
    x, mask, gout, weight, bias = _bn_inputs()
    want = _bn_run(x, mask if masked else None, gout, weight, bias)
    got = [r[masked] for r in bn_ranks]
    for key in ("y", "dx"):
        torch.testing.assert_close(torch.cat([g[key] for g in got]), want[key], atol=TOL_BN,
                                   rtol=TOL_BN)
    for key in ("dparams", "running_mean", "running_var"):
        assert torch.equal(got[0][key], got[1][key])  # the same on every rank
        torch.testing.assert_close(got[0][key], want[key], atol=TOL_BN, rtol=TOL_BN)


# --------------------------------------------------------------------------- #
# Trainer.fit
# --------------------------------------------------------------------------- #
FIT_TINY = dict(image_hw=(16, 16), cond_dim=8, encoder_backbone="resnet18", timesteps=20,
                unet_dim=32, num_res_blocks=1, channel_mult=(1, 2), attention_resolutions=(),
                test_timesteps=10, step_ensemble=(5, 10), dtype="float32", lr=1e-6)
B, SEED, FOLD, STEPS_PER_EPOCH = 4, 13, 1, 2


class Recorder:
    def __init__(self):
        self.rows = []

    def log_metrics(self, metrics, step=0):
        self.rows += [(k, float(v), int(step)) for k, v in metrics.items()]


def _volumes():
    rng = np.random.default_rng(2)
    train = rng.uniform(0, 1, (8, 16, 16, 5)).astype(np.float32)
    val = rng.uniform(0, 1, (4, 16, 16, 5)).astype(np.float32)
    return train, val


def _port_fit(state, draws, ckpt_dir):
    """The port's fit of tests/test_torch_fit.py from ``state`` with the
    given train and val draws (global batches); (rows, final state,
    meta.json or None)."""
    task = DDPMTask(DDPMTaskConfig(**FIT_TINY), device="cpu")
    task.load_state_dict(state)
    it = {True: iter(draws["train"]), False: iter(draws["val"])}
    task.draw_train = lambda generator, b, *, augment=True: next(it[bool(augment)])
    rec = Recorder()
    cfg = loop.TrainerConfig(max_epochs=2, check_val_every_n_epoch=1, log_every_n_steps=1,
                             seed=SEED, ckpt_dir=ckpt_dir)
    trainer = loop.Trainer(task, cfg, logger=rec)
    train, val = _volumes()
    dcfg = DataConfig(batch_size=B)
    final = trainer.fit(
        TrainSliceSource(torch.from_numpy(train), torch.from_numpy(train > 0.5).float(), dcfg),
        val_source=TrainSliceSource(torch.from_numpy(val), torch.from_numpy(val > 0.5).float(),
                                    dcfg),
        fold=FOLD)
    meta_path = os.path.join(ckpt_dir, f"fold-{FOLD}", "meta.json")
    meta = json.load(open(meta_path)) if os.path.exists(meta_path) else None
    return rec.rows, final["model"], meta


def _fit_rank(rank, state, draws, ckpt_dir):
    rows, final, meta = _port_fit(state, draws, ckpt_dir)
    files = sorted(os.listdir(os.path.join(ckpt_dir, f"fold-{FOLD}")))
    return {"rows": rows, "final": final, "meta": meta, "files": files}


@pytest.fixture(scope="module")
def fit_runs(tmp_path_factory):
    """The JAX mesh fit, the port's 2-rank fit and its 1-process fit."""
    import jax

    from conditioned_diffusion_models_uad_tpu.parallel.mesh import local_mesh
    from test_torch_fit import _cfg, _converted, loss_draws, step_draws
    from conditioned_diffusion_models_uad_tpu.data import datamodules as jdm
    from conditioned_diffusion_models_uad_tpu.models import tasks as jtasks
    from conditioned_diffusion_models_uad_tpu.ops.simplex import make_noise_fn
    from conditioned_diffusion_models_uad_tpu.train import loop as jloop

    tmp = tmp_path_factory.mktemp("fit")
    task = randomize_(DDPMTask(DDPMTaskConfig(**FIT_TINY), device="cpu"), 7)
    state = {k: v.clone() for k, v in task.state_dict().items()}

    jtask = jtasks.DDPMTask(jtasks.DDPMTaskConfig(**FIT_TINY))
    jtask.noise_fn = make_noise_fn("simplex", impl="pallas")
    init = _converted(state, jtask)
    rec = Recorder()
    trainer = jloop.Trainer(jtask, _cfg(jloop.TrainerConfig, tmp / "jax", epoch_scan=False),
                            mesh=local_mesh(2), logger=rec)
    train, val = _volumes()
    dcfg = jdm.DataConfig(batch_size=B)
    jfinal = trainer.fit(jdm.TrainSliceSource(train, train > 0.5, dcfg),
                         val_source=jdm.TrainSliceSource(val, val > 0.5, dcfg), fold=FOLD,
                         init_variables=init)
    jmeta = json.load(open(tmp / "jax" / f"fold-{FOLD}" / "meta.json"))

    key = jax.random.PRNGKey(SEED + FOLD)
    _, k_train, k_val = jax.random.split(key, 3)
    timesteps = FIT_TINY["timesteps"]
    draws = {"train": [step_draws(jax.random.fold_in(k_train, s // STEPS_PER_EPOCH), s, B,
                                  timesteps) for s in range(4)],
             "val": [loss_draws(jax.random.fold_in(k_val, 0), B, timesteps) for _ in range(2)]}
    ranks = mesh.spawn(_fit_rank, 2, "gloo", _cpus(), state, draws, str(tmp / "ranks"))
    single = _port_fit(state, draws, str(tmp / "single"))
    return {"jax": (rec.rows, jfinal, jmeta, init, jtask), "ranks": ranks, "single": single}


def test_two_rank_fit_matches_one_process_fit(fit_runs):
    ranks, (rows, final, meta) = fit_runs["ranks"], fit_runs["single"]
    r0, r1 = ranks
    for k, v in r0["final"].items():  # replicas stay bit-equal
        assert torch.equal(v, r1["final"][k]), k
    assert r1["rows"] == [] and r1["meta"] is not None  # rank 0 alone logs
    assert r0["files"] == ["best", "last", "meta.json"]
    assert r0["meta"] == r1["meta"]
    assert {k: v["step"] for k, v in r0["meta"].items()} == {k: v["step"] for k, v in
                                                            meta.items()}
    assert [(k, s) for k, _, s in r0["rows"]] == [(k, s) for k, _, s in rows]
    for (k, g, _), (_, w, _) in zip(r0["rows"], rows):
        if k in ("train/loss", "val/loss_comb"):
            assert abs(g - w) <= TOL_FIT_LOSS, (k, g, w)
    init = randomize_(DDPMTask(DDPMTaskConfig(**FIT_TINY), device="cpu"), 7).state_dict()
    for group, running in (("params", False), ("batch_stats", True)):
        names = [k for k in final if final[k].dtype.is_floating_point
                 and ("running" in k) == running]
        got = torch.cat([(r0["final"][k] - init[k]).reshape(-1) for k in names]).double()
        want = torch.cat([(final[k] - init[k]).reshape(-1) for k in names]).double()
        assert (got - want).norm() / want.norm() <= TOL_FIT_GAP[group], group


def test_two_rank_fit_matches_jax_mesh_fit(fit_runs):
    import jax

    from test_torch_fit import TOL_GAP, TOL_LOSS, _converted, _leaves

    want_rows, want_final, jmeta, init, jtask = fit_runs["jax"]
    r0 = fit_runs["ranks"][0]
    got_keys = [(k, s) for k, _, s in r0["rows"] if k != "train/steps_per_sec"]
    assert got_keys == [(k, s) for k, _, s in want_rows if k != "train/steps_per_sec"]
    errs = [abs(g - w) for (k, g, _), (_, w, _) in zip(r0["rows"], want_rows)
            if k in ("train/loss", "val/loss_comb")]
    assert len(errs) == 6 and max(errs) <= TOL_LOSS, errs
    assert {k: v["step"] for k, v in r0["meta"].items()} == {k: v["step"] for k, v in
                                                            jmeta.items()}
    got = _converted(r0["final"], jtask)
    for group in ("params", "batch_stats"):
        g, w, i = (_leaves(v, group) for v in (got, jax.device_get(want_final), init))
        got_d = np.concatenate([(a - c).ravel() for a, c in zip(g, i)])
        want_d = np.concatenate([(b - c).ravel() for b, c in zip(w, i)])
        gap = np.linalg.norm(got_d - want_d) / np.linalg.norm(want_d)
        assert gap <= TOL_GAP[group], (group, gap)


# --------------------------------------------------------------------------- #
# eval: slice-parallel and volume-parallel reconstruction, the fallback
# --------------------------------------------------------------------------- #
# the task, subjects and eval preset of tests/test_torch_eval_reconstruct.py
EVAL_TINY = dict(image_hw=(32, 32), cond_dim=16, encoder_backbone="resnet18", timesteps=20,
                 unet_dim=64, num_res_blocks=1, channel_mult=(1, 2), attention_resolutions=(),
                 test_timesteps=10, step_ensemble=(5, 10), dtype="float32")
EVAL_SHAPE = (32, 32, 6)
EVAL_CFG = dict(cc_backend="device", hausdorff_backend="device")
STAGE_KEY = np.asarray([0, 1007], np.uint32)


def _eval_task():
    return randomize_(DDPMTask(DDPMTaskConfig(**EVAL_TINY), device="cpu"), 21)


def _eval_subjects():
    rng = np.random.default_rng(11)
    subs = []
    for _ in range(2):
        vol = rng.uniform(0, 1, EVAL_SHAPE).astype(np.float32)
        seg = np.zeros(EVAL_SHAPE, np.float32)
        seg[8:20, 10:22, 1:5] = 1.0
        mask = np.zeros(EVAL_SHAPE, np.float32)
        mask[2:30, 2:30] = 1.0
        subs.append({"vol": vol, "vol_orig": vol, "mask_orig": mask, "seg_orig": seg})
    return subs


def _group3():
    subs = _eval_subjects()
    extra = {k: v[::-1].copy() for k, v in subs[0].items()}
    return [dict(s, ID=f"s{i}", label=1) for i, s in enumerate(subs + [extra])]


def _session():
    from conditioned_diffusion_models_uad_torch.eval.harness import EvalConfig, EvalSession

    return EvalSession(EvalConfig(**EVAL_CFG), "Brats21", "val", device="cpu")


def _recon_rank(rank, seeds, flags):
    from conditioned_diffusion_models_uad_torch.eval.reconstruct import VolumeReconstructor
    from conditioned_diffusion_models_uad_torch.orchestrate import run_stage

    recon = VolumeReconstructor(_eval_task(), device="cpu")
    subs = _eval_subjects()
    diff, packed = recon.batch_call_scored(subs, flags, seeds)
    alone = recon(subs[0]["vol"], seeds[:1], return_aux=True)
    batch = recon.batch_call([s["vol"] for s in subs], seeds)
    session = _session()
    run_stage(session, recon, _group3(), STAGE_KEY, volumes_per_call=3, fused_dispatch=False)
    rows = session.test_end() if rank == 0 else None
    return {"diff": diff, "packed": packed, "alone": alone, "batch": batch, "rows": rows,
            "depth_multiple": recon.depth_multiple}


@pytest.fixture(scope="module")
def recon_runs():
    from test_torch_eval_reconstruct import _jax_run

    _, _, _, flags, seeds, llen = _jax_run()
    pflags = _session()._fused_flags(EVAL_SHAPE, seg_is_host=True)
    assert pflags["statics"] == flags["statics"]
    ranks = mesh.spawn(_recon_rank, 2, "gloo", _cpus(), seeds, pflags)
    return {"ranks": ranks, "flags": flags, "llen": llen, "seeds": seeds}


def test_volume_parallel_scoring_matches_jax_mesh(recon_runs):
    """Each rank scores one volume of the group; the gathered buffers equal
    the JAX reconstructor's on a 2-device mesh (the JAX package's own
    test_reconstruct.py holds its mesh path to its one-device path)."""
    import jax

    from conditioned_diffusion_models_uad_torch.eval.fused import parse_packed
    from conditioned_diffusion_models_uad_tpu.eval import fused as JF
    from conditioned_diffusion_models_uad_tpu.eval.reconstruct import (
        VolumeReconstructor as JVolumeReconstructor,
    )
    from conditioned_diffusion_models_uad_tpu.models import tasks as jtasks
    from conditioned_diffusion_models_uad_tpu.ops.simplex import make_noise_fn
    from conditioned_diffusion_models_uad_tpu.parallel.mesh import local_mesh
    from conditioned_diffusion_models_uad_tpu.utils.convert_torch import (
        convert_reference_ddpm_checkpoint,
    )

    flags, llen = recon_runs["flags"], recon_runs["llen"]
    jtask = jtasks.DDPMTask(jtasks.DDPMTaskConfig(**EVAL_TINY))
    jtask.noise_fn = make_noise_fn("simplex", impl="pallas")
    sd = {("diffusion.model." + k[5:]) if k.startswith("unet.") else k: v.numpy()
          for k, v in _eval_task().state_dict().items()}
    variables = convert_reference_ddpm_checkpoint(sd, jtask)
    keys = jax.random.split(jax.random.PRNGKey(5), 2)  # the seeds' keys
    w_diff, w_packed = JVolumeReconstructor(jtask, mesh=local_mesh(2)).batch_call_scored(
        variables, _eval_subjects(), keys, flags)
    w_diff, w_packed = np.asarray(w_diff), np.asarray(w_packed)
    r0, r1 = recon_runs["ranks"]
    assert torch.equal(r0["packed"], r1["packed"]) and torch.equal(r0["diff"], r1["diff"])
    np.testing.assert_allclose(r0["diff"].numpy(), w_diff, atol=TOL_RECO, rtol=0)
    args = (EVAL_SHAPE, llen, flags["statics"]["pack_seg"], flags["statics"]["pack_maps"])
    for j in range(2):
        g = parse_packed(r0["packed"][j].numpy(), *args)["scalars"]
        w = JF.parse_packed(w_packed[j], *args)["scalars"]
        for k in ("l1recoErrorAll", "vol_score", "aux_loss"):
            np.testing.assert_allclose(g[k], w[k], atol=TOL_RECO, err_msg=k)
        for k in ("auroc", "auprc", "best_dice"):
            np.testing.assert_allclose(g[k], w[k], atol=1e-3, err_msg=k)
        assert g["lesion_size"] == w["lesion_size"]


def test_volume_parallel_buffers_bit_equal_one_process(recon_runs):
    """A group of 2 on 2 ranks is volume-parallel in batch_call_scored and
    batch_call: each rank runs its volume at the shapes one process runs it
    at, so the gathered buffers equal one process's bit for bit (the JAX
    package's dispatch-invariance contract across rank counts)."""
    from conditioned_diffusion_models_uad_torch.eval.reconstruct import VolumeReconstructor

    seeds = recon_runs["seeds"]
    recon = VolumeReconstructor(_eval_task(), device="cpu")
    subs = _eval_subjects()
    flags = _session()._fused_flags(EVAL_SHAPE, seg_is_host=True)
    diff, packed = recon.batch_call_scored(subs, flags, seeds)
    batch = recon.batch_call([s["vol"] for s in subs], seeds)
    for r in recon_runs["ranks"]:
        assert torch.equal(r["packed"], packed) and torch.equal(r["diff"], diff)
        for (g, g_aux), (w, w_aux) in zip(r["batch"], batch):
            assert torch.equal(g, w)
            assert torch.equal(g_aux["loss"], w_aux["loss"])
            assert torch.equal(g_aux["latent"], w_aux["latent"])


def test_slice_parallel_reconstruction_matches_one_process(recon_runs):
    from conditioned_diffusion_models_uad_torch.eval.reconstruct import VolumeReconstructor

    seeds = recon_runs["seeds"]
    recon = VolumeReconstructor(_eval_task(), device="cpu")
    subs = _eval_subjects()
    r0, r1 = recon_runs["ranks"]
    assert r0["depth_multiple"] == 8
    reco, aux = recon(subs[0]["vol"], seeds[:1], return_aux=True)
    for r in (r0, r1):
        torch.testing.assert_close(r["alone"][0], reco, atol=TOL_RECO, rtol=0)
        torch.testing.assert_close(r["alone"][1]["loss"], aux["loss"], atol=TOL_RECO, rtol=0)
    for (g, g_aux), (w, w_aux) in zip(r0["batch"], recon.batch_call([s["vol"] for s in subs],
                                                                    seeds)):
        torch.testing.assert_close(g, w, atol=TOL_RECO, rtol=0)
        torch.testing.assert_close(g_aux["latent"], w_aux["latent"], atol=1e-4, rtol=1e-4)


def test_group_that_does_not_divide_falls_back_with_the_same_rows(recon_runs):
    """A group of 3 volumes on 2 ranks: the separate-dispatch path, each
    volume's depth split over the ranks; rank 0's rows equal one process's."""
    from conditioned_diffusion_models_uad_torch.eval.reconstruct import VolumeReconstructor
    from conditioned_diffusion_models_uad_torch.orchestrate import run_stage

    session = _session()
    run_stage(session, VolumeReconstructor(_eval_task(), device="cpu"), _group3(), STAGE_KEY,
              volumes_per_call=3, fused_dispatch=False)
    want = session.test_end()
    got = recon_runs["ranks"][0]["rows"]
    assert recon_runs["ranks"][1]["rows"] is None
    assert got.keys() == want.keys() and got["IDs"] == want["IDs"] == ["s0", "s1", "s2"]
    for k, w in want.items():
        g = got[k]
        if isinstance(w, (list, tuple)) and w and isinstance(w[0], str):
            assert g == w, k
            continue
        try:
            a = np.asarray(g, dtype=np.float64)
            b = np.asarray(w, dtype=np.float64)
        except (TypeError, ValueError):
            assert g == w, k
            continue
        np.testing.assert_allclose(a, b, atol=TOL_RECO, rtol=0, err_msg=k)
