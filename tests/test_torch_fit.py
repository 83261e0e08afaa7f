"""Trainer.fit against the JAX package's Trainer.fit on the CPU: 2 epochs of
2 steps, a validation after each (check_val_every_n_epoch=1), from the same
seeded weights, volumes and random draws, in float32. The JAX trainer runs
step by step (epoch_scan=False; it never changes the JAX results); the
port's ``task.draw_train`` is replaced by the draws the JAX keys make
(tests/test_torch_train.py::step_draws for training, loss_draws of
fold_in(k_val, i) for validation batch i).

Required: identical index arrays, the same meta.json steps and best/last
choice, the same logged (key, step) rows, every train and val loss within
1e-5, the one-step loss tolerance of tests/test_torch_train.py (measured at
most 2.1e-6), and the fit's net change of the parameters and of the batch
statistics within TOL_GAP of the JAX run's. Adam moves an entry whose
gradient lies within rounding of 0 by about lr in either run, so the two
runs drift apart by about lr a step: at the flagship lr 1e-4 the fourth
step's loss differs by 6e-3 (measured). The test runs at lr 1e-6, where that
drift stays below the tolerances; the learning rate is not what it tests.

Faults of the loop that this test catches (measured on planted copies): a
skipped ``opt.step`` moves the losses by up to 7.7e-4 and leaves the
parameters' change at 0 (gap 1); an optimizer rebuilt at each epoch moves
the fourth loss by 1.2e-4 and gives a parameter gap of 0.52. Resume is held
to an unbroken fit in tests/test_torch_checkpoint_log.py."""
import json
import os

import jax
import numpy as np
import torch

from conditioned_diffusion_models_uad_torch.data.datamodules import DataConfig, TrainSliceSource
from conditioned_diffusion_models_uad_torch.models.tasks import DDPMTask, DDPMTaskConfig
from conditioned_diffusion_models_uad_torch.train import loop
from conditioned_diffusion_models_uad_torch.utils.random_init import randomize_
from conditioned_diffusion_models_uad_tpu.data import datamodules as jdm
from conditioned_diffusion_models_uad_tpu.models import tasks as jtasks
from conditioned_diffusion_models_uad_tpu.ops.simplex import make_noise_fn
from conditioned_diffusion_models_uad_tpu.train import loop as jloop
from conditioned_diffusion_models_uad_tpu.utils.convert_torch import (
    convert_reference_ddpm_checkpoint,
)
from test_torch_train import loss_draws, step_draws

torch.set_num_threads(2)

TINY = dict(image_hw=(16, 16), cond_dim=8, encoder_backbone="resnet18", timesteps=20,
            unet_dim=32, num_res_blocks=1, channel_mult=(1, 2), attention_resolutions=(),
            test_timesteps=10, step_ensemble=(5, 10), dtype="float32", lr=1e-6)
B, SEED, FOLD = 4, 13, 1
STEPS_PER_EPOCH = 2
TOL_LOSS = 1e-5
# relative gap ||port change - JAX change|| / ||JAX change|| of the fit's net
# change, measured 0.0134 (params, the lr drift) and 5.0e-6 (batch stats)
TOL_GAP = {"params": 0.05, "batch_stats": 5e-5}


class Recorder:
    def __init__(self):
        self.rows = []

    def log_metrics(self, metrics, step=0):
        self.rows += [(k, float(v), int(step)) for k, v in metrics.items()]

    def log_hyperparams(self, h):
        pass


def _volumes():
    rng = np.random.default_rng(2)
    train = rng.uniform(0, 1, (8, 16, 16, 5)).astype(np.float32)
    val = rng.uniform(0, 1, (4, 16, 16, 5)).astype(np.float32)
    return train, val


def _cfg(cls, tmp, **kw):
    return cls(max_epochs=2, check_val_every_n_epoch=1, log_every_n_steps=1, seed=SEED,
               ckpt_dir=str(tmp), **kw)


def _jax_fit(task, tmp):
    jtask = jtasks.DDPMTask(jtasks.DDPMTaskConfig(**TINY))
    jtask.noise_fn = make_noise_fn("simplex", impl="pallas")
    init = _converted(task.state_dict(), jtask)
    rec = Recorder()
    trainer = jloop.Trainer(jtask, _cfg(jloop.TrainerConfig, tmp, epoch_scan=False), logger=rec)
    idx = []
    step_fn = trainer._train_step

    def recording(state, data, vi, si, key):
        idx.append((np.asarray(vi).copy(), np.asarray(si).copy()))
        return step_fn(state, data, vi, si, key)

    trainer._train_step = recording
    train, val = _volumes()
    dcfg = jdm.DataConfig(batch_size=B)
    state = trainer.fit(jdm.TrainSliceSource(train, train > 0.5, dcfg),
                        val_source=jdm.TrainSliceSource(val, val > 0.5, dcfg), fold=FOLD,
                        init_variables=init)
    return rec.rows, idx, init, state, jtask


def _leaves(variables, group):
    """The leaves of one group ('params', 'batch_stats') of a JAX variables
    tree, as float64 arrays in tree order."""
    return [np.asarray(x, np.float64) for x in jax.tree_util.tree_leaves(variables[group])]


def _converted(state_dict, jtask):
    """A port state_dict converted into the JAX task's variables tree."""
    sd = {("diffusion.model." + k[5:]) if k.startswith("unet.") else k: v.numpy().copy()
          for k, v in state_dict.items()}
    return convert_reference_ddpm_checkpoint(sd, jtask)


def test_fit_matches_jax_fit(tmp_path, monkeypatch):
    task = randomize_(DDPMTask(DDPMTaskConfig(**TINY), device="cpu"), 7)
    want_rows, want_idx, init, want_final, jtask = _jax_fit(task, tmp_path / "jax")

    key = jax.random.PRNGKey(SEED + FOLD)
    _, k_train, k_val = jax.random.split(key, 3)
    calls = {"train": 0, "val": 0}

    def draws(generator, b, *, augment=True):
        if augment:
            s = calls["train"]
            calls["train"] += 1
            return step_draws(jax.random.fold_in(k_train, s // STEPS_PER_EPOCH), s, b,
                              task.cfg.timesteps)
        i = calls["val"] % 1  # one val batch a validation
        calls["val"] += 1
        return loss_draws(jax.random.fold_in(k_val, i), b, task.cfg.timesteps)

    task.draw_train = draws
    idx = []
    step_fn = loop.train_step

    def recording(task_, opt, data, vi, si, dr):
        idx.append((np.asarray(vi).copy(), np.asarray(si).copy()))
        return step_fn(task_, opt, data, vi, si, dr)

    monkeypatch.setattr(loop, "train_step", recording)
    rec = Recorder()
    trainer = loop.Trainer(task, _cfg(loop.TrainerConfig, tmp_path / "port"), logger=rec)
    train, val = _volumes()
    dcfg = DataConfig(batch_size=B)
    state = trainer.fit(
        TrainSliceSource(torch.from_numpy(train), torch.from_numpy(train > 0.5).float(), dcfg),
        val_source=TrainSliceSource(torch.from_numpy(val), torch.from_numpy(val > 0.5).float(),
                                    dcfg),
        fold=FOLD)
    assert calls == {"train": 4, "val": 2} and state["step"] == 4

    assert len(idx) == len(want_idx) == 4
    for (a, b), (c, d) in zip(idx, want_idx):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    got_keys = [(k, s) for k, _, s in rec.rows if k != "train/steps_per_sec"]
    want_keys = [(k, s) for k, _, s in want_rows if k != "train/steps_per_sec"]
    assert got_keys == want_keys
    assert [k for k, _, _ in rec.rows][-1] == [k for k, _, _ in want_rows][-1] == \
        "train/steps_per_sec"
    errs = {}
    for (k, g, s), (_, w, _) in zip(rec.rows, want_rows):
        if k in ("train/loss", "val/loss_comb"):
            errs[(k, s)] = abs(g - w)
        elif k == "epoch":
            assert g == w
    assert len(errs) == 6 and max(errs.values()) <= TOL_LOSS, errs
    metas = [json.load(open(os.path.join(str(tmp_path / d), f"fold-{FOLD}", "meta.json")))
             for d in ("port", "jax")]
    assert {k: v["step"] for k, v in metas[0].items()} == {k: v["step"] for k, v in
                                                          metas[1].items()}
    np.testing.assert_allclose(metas[0]["last"]["val_loss"], metas[1]["last"]["val_loss"],
                               atol=TOL_LOSS, rtol=0)

    # the fit's net change of every parameter (what Adam moved, at about lr
    # a step) and of every batch statistic, against the JAX run's
    got = _converted(state["model"], jtask)
    for group in ("params", "batch_stats"):
        g, w, i = (_leaves(v, group) for v in (got, want_final, init))
        assert len(g) == len(w) == len(i) > 0
        got_d = np.concatenate([(a - c).ravel() for a, c in zip(g, i)])
        want_d = np.concatenate([(b - c).ravel() for b, c in zip(w, i)])
        gap = np.linalg.norm(got_d - want_d) / np.linalg.norm(want_d)
        assert gap <= TOL_GAP[group], (group, gap)
