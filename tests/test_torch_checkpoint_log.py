"""train/checkpoint.py and log/loggers.py: the best/last rules against the
JAX package's FoldCheckpointer on the same val-loss sequence (meta.json
equal), what each checkpoint holds, NaN never best, best falling back to
last, find_run_checkpoint, resume continuing an unbroken fit, and the CSV
rows, summaries and hyperparameters against the JAX loggers. Exact: no
tolerance."""
import csv
import importlib.util
import json
import math
import os

import numpy as np
import pytest
import torch

from conditioned_diffusion_models_uad_torch.log import loggers as L
from conditioned_diffusion_models_uad_torch.models.tasks import DDPMTask, DDPMTaskConfig
from conditioned_diffusion_models_uad_torch.data.datamodules import DataConfig, TrainSliceSource
from conditioned_diffusion_models_uad_torch.train import checkpoint as C
from conditioned_diffusion_models_uad_torch.train.loop import Trainer, TrainerConfig
from conditioned_diffusion_models_uad_torch.utils.random_init import randomize_
from conditioned_diffusion_models_uad_tpu.log import loggers as JL
from conditioned_diffusion_models_uad_tpu.train import checkpoint as JC

torch.set_num_threads(2)

TINY = dict(image_hw=(16, 16), cond_dim=8, encoder_backbone="resnet18", timesteps=20,
            unet_dim=32, num_res_blocks=1, channel_mult=(1, 2), attention_resolutions=(),
            test_timesteps=10, step_ensemble=(5, 10), dtype="float32")


def _state(v):
    return {"model": {"w": torch.full((3,), float(v))},
            "optimizer": {"state": {0: {"exp_avg": torch.ones(3) * v}}, "param_groups": []},
            "step": int(v)}


def test_best_last_rules_and_meta_match_jax(tmp_path):
    losses = [0.5, float("nan"), 0.7, 0.3, float("inf"), 0.3, 0.2]
    port = C.FoldCheckpointer(str(tmp_path / "p"), fold=1)
    jax_ck = JC.FoldCheckpointer(str(tmp_path / "j"), fold=1)
    with pytest.raises(FileNotFoundError):
        port.restore("best")
    for i, v in enumerate(losses):
        assert port.is_best(v) == jax_ck.is_best(v)
        assert port.maybe_save_best(_state(i), i + 1, v) == jax_ck.maybe_save_best(
            {"params": {"w": np.full((3,), float(i))}, "step": np.int32(i)}, i + 1, v)
        port.save_last(_state(i), i + 1, v)
        jax_ck.save_last({"params": {"w": np.full((3,), float(i))}, "step": np.int32(i)},
                         i + 1, v)
    meta_p = json.load(open(os.path.join(port.dir, "meta.json")))
    meta_j = json.load(open(os.path.join(jax_ck.dir, "meta.json")))
    assert json.dumps(meta_p, sort_keys=True) == json.dumps(meta_j, sort_keys=True)
    assert meta_p["best"] == {"step": 7, "val_loss": 0.2}
    best, meta = port.restore("best")
    assert set(best) == {"model", "step"} and meta["step"] == 7  # no optimizer state
    last, _ = port.restore("last")
    assert set(last) == {"model", "optimizer", "step"} and last["step"] == 6
    assert torch.equal(last["optimizer"]["state"][0]["exp_avg"], torch.full((3,), 6.0))
    # the files load with weights_only
    path = os.path.join(port.dir, "last", C.STATE_FILE)
    torch.load(path, weights_only=True)
    # reopened, the meta carries over
    assert C.FoldCheckpointer(str(tmp_path / "p"), fold=1).meta == meta_p


def test_nan_never_best_and_best_falls_back_to_last(tmp_path):
    ck = C.FoldCheckpointer(str(tmp_path), fold=0)
    assert not ck.maybe_save_best(_state(1), 1, float("nan"))
    assert not ck.exists("best") and not ck.is_best(None)
    ck.save_last(_state(2), 2)
    state, meta = ck.restore("best")  # falls back to 'last'
    assert state["step"] == 2 and meta == {"step": 2, "val_loss": None}
    run = tmp_path.parent
    os.makedirs(os.path.join(str(tmp_path), "x"), exist_ok=True)
    assert C.find_run_checkpoint(str(tmp_path), "last", 0) == os.path.join(
        str(tmp_path), "fold-0", "last")
    with pytest.raises(FileNotFoundError):
        C.find_run_checkpoint(str(run), "best", 0)
    assert C.variables_only(_state(3)).keys() == {"model", "step"}


def _source(seed=0, n=4):
    rng = np.random.default_rng(seed)
    vols = torch.from_numpy(rng.uniform(0, 1, (n, 16, 16, 5)).astype(np.float32))
    return TrainSliceSource(vols, (vols > 0.5).float(), DataConfig(batch_size=2))


def _trainer(tmp, **kw):
    task = randomize_(DDPMTask(DDPMTaskConfig(**TINY), device="cpu"), 3)
    cfg = TrainerConfig(ckpt_dir=str(tmp), check_val_every_n_epoch=1, log_every_n_steps=1,
                        seed=5, **kw)
    return Trainer(task, cfg)


def test_resume_continues_an_unbroken_fit(tmp_path):
    src, val = _source(0), _source(1, 2)
    whole = _trainer(tmp_path / "a", max_epochs=3)
    whole.fit(src, val)
    first = _trainer(tmp_path / "b", max_epochs=2)
    first.fit(src, val)
    again = _trainer(tmp_path / "b", max_epochs=3, resume=True)
    again.fit(src, val)
    assert len(again.timings["epoch_s"]) == 1  # epochs 0 and 1 were done
    for (k, a), b in zip(whole.task.state_dict().items(), again.task.state_dict().values()):
        assert torch.equal(a, b), k
    meta_a = json.load(open(tmp_path / "a" / "fold-0" / "meta.json"))
    meta_b = json.load(open(tmp_path / "b" / "fold-0" / "meta.json"))
    assert meta_a == meta_b and meta_a["last"]["step"] == 3
    assert whole.state()["step"] == again.state()["step"] == 6


def test_fast_dev_run_and_no_val_source(tmp_path):
    t = _trainer(tmp_path / "f", max_epochs=5, fast_dev_run=True)
    t.fit(_source(0), _source(1, 2))
    assert t.timings["steps"] == 1 and not t.timings["val_s"]
    assert not C.FoldCheckpointer(str(tmp_path / "f")).exists("last")
    t = _trainer(tmp_path / "n", max_epochs=2)
    t.fit(_source(0))
    ck = C.FoldCheckpointer(str(tmp_path / "n"))
    assert ck.exists("last") and not ck.exists("best") and ck.meta["last"]["step"] == 2
    # trainer.aug_full runs (it raised before the full set was ported)
    t = _trainer(tmp_path / "full", max_epochs=1, fast_dev_run=True, aug_full=True)
    t.fit(_source(0))
    assert t.timings["steps"] == 1


def _rows(path):
    with open(path, newline="") as f:
        return [r[:3] for r in csv.reader(f)]


def test_csv_rows_summaries_and_hparams_match_jax(tmp_path):
    from conditioned_diffusion_models_uad_tpu.config import RunConfig as JRunConfig

    metrics = [({"train/loss": np.float32(0.25), "epoch": 0}, 1),
               ({"val/loss_comb": float("nan"), "epoch": 0}, 1),
               ({"x": "text", "y": torch.tensor(2.5)}, 3)]
    for mod, sub in ((L, "p"), (JL, "j")):
        lg = mod.MultiLogger(mod.CSVLogger(str(tmp_path / sub), name="csv_fold0"), None)
        for m, step in metrics:
            lg.log_metrics({k: (float(v) if torch.is_tensor(v) else v) for k, v in m.items()},
                           step=step)
        lg.finish()
    got = _rows(tmp_path / "p" / "csv_fold0" / "metrics.csv")
    assert got == _rows(tmp_path / "j" / "csv_fold0" / "metrics.csv")
    assert got[0] == ["key", "value", "step"] and got[3][:2] == ["val/loss_comb", "nan"]
    d = {"DicePerVolMean": 0.5, "IDs": ["a"], "x": {"y": 1}, "t_1p": 0.1}
    assert L.summarize(d, "val/Brats21/fold-0") == JL.summarize(d, "val/Brats21/fold-0")
    if importlib.util.find_spec("wandb") is None:
        assert L.WandbLogger(str(tmp_path)).run is None  # no wandb: a no-op

    class Shim:  # an injected wandb records the calls
        def __init__(self):
            self.calls = []

        def init(self, **kw):
            self.calls.append(("init", kw))
            return type("Run", (), {"id": "r1", "log": lambda s, m, step=0: self.calls.append(
                ("log", m, step)), "finish": lambda s: None})()

    shim = Shim()
    wl = L.WandbLogger(str(tmp_path / "w"), project="p", module=shim)
    wl.log_metrics({"a": 1.0}, step=4)
    assert shim.calls[-1] == ("log", {"a": 1.0}, 4)
    assert json.load(open(tmp_path / "w" / "wandb_id.json")) == {"id": "r1"}

    import yaml

    from conditioned_diffusion_models_uad_torch.config import RunConfig

    task = DDPMTask(DDPMTaskConfig(**TINY), device="cpu")
    lg = L.CSVLogger(str(tmp_path / "h"))
    L.log_hyperparameters(lg, RunConfig(model=DDPMTaskConfig(**TINY)), task)
    h = yaml.safe_load(open(tmp_path / "h" / "csv" / "hparams.yaml"))
    assert h["model/params_total"] == sum(p.numel() for p in task.parameters()) > 0
    jl = JL.CSVLogger(str(tmp_path / "hj"))
    from conditioned_diffusion_models_uad_tpu.models.tasks import DDPMTaskConfig as JCfg

    JL.log_hyperparameters(jl, JRunConfig(model=JCfg(**TINY)))
    hj = yaml.safe_load(open(tmp_path / "hj" / "csv" / "hparams.yaml"))
    assert {k: v for k, v in h.items() if k not in ("device", "model/params_total")} == hj
    assert math.isfinite(h["seed"])
