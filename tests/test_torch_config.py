"""config.py against the JAX package's: compose + materialize of every
configs/experiment/cDDPM/*.yaml that the port supports give the same dict
and the same typed configs (every field the two packages share), with group
re-selection, dotted overrides and ${env:...} interpolation, SparK
pretraining and the encoder import included; the pDDPM experiment and the
use_checkpoint / sampling_steps / reco_mode overrides, which the port once
refused, materialize as in the JAX package too. The port's RunConfig adds
one field, device. Exact."""
import dataclasses
import os

import pytest

from conditioned_diffusion_models_uad_torch import config as P
from conditioned_diffusion_models_uad_tpu import config as J

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")
SUPPORTED = ["cDDPM/DDPM_cond_spark_2D", "cDDPM/DDPM", "cDDPM/test"]
OVERRIDES = [
    [],
    ["trainer.max_epochs=3", "datamodule.batch_size=4", "model.unet_dim=64",
     "model.step_ensemble=[5,10]", "model.lr=1e-4", "eval=device_fast",
     "logger=csv", "mode=reference", "seed=7", "datamodule.preprocess_backend=device",
     "datamodule.shape_bucket=16", "model.num_eval_slices=40"],
    ["debug=true", "only_eval=true", "load_checkpoint=/x/y", "checkpoint=last",
     "trainer.epoch_scan=false", "callbacks.checkpoint.save_last=false"],
]


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _same_typed(got, want) -> None:
    g, w = _fields(got), _fields(want)
    assert set(g) - {"device"} == set(w), set(g) ^ set(w)
    for k, v in w.items():
        if dataclasses.is_dataclass(v):
            assert type(g[k]).__name__ == type(v).__name__, k
            _same_typed(g[k], v)
        else:
            assert g[k] == v, (k, g[k], v)


@pytest.mark.parametrize("experiment", SUPPORTED)
@pytest.mark.parametrize("overrides", OVERRIDES, ids=["plain", "groups", "debug"])
def test_compose_and_materialize_match_jax(experiment, overrides, monkeypatch):
    monkeypatch.setenv("DATA_DIR", "/data/here")
    monkeypatch.delenv("LOG_DIR", raising=False)
    tree = P.compose(CONFIGS, experiment, overrides)
    assert tree == J.compose(CONFIGS, experiment, overrides)
    assert tree["datamodule"]["data_dir"] == "/data/here"
    got, want = P.materialize(tree), J.materialize(tree)
    _same_typed(got, want)
    assert got.run_dir.split("_20")[0] == want.run_dir.split("_20")[0]
    assert got.device == "cuda"
    assert P.materialize(P.compose(CONFIGS, experiment, overrides + ["device=cpu"])).device == "cpu"


@pytest.mark.parametrize("experiment,overrides,what", [
    ("cDDPM/DDPM_patched", [], "patched"),
    ("cDDPM/DDPM_cond_spark_2D", ["model.use_checkpoint=true"], "use_checkpoint"),
    ("cDDPM/DDPM_cond_spark_2D", ["model.sampling_steps=20"], "sampling_steps"),
    ("cDDPM/DDPM_cond_spark_2D", ["model.reco_mode=ddim", "model.sampling_steps=20"],
     "reco_mode"),
    ("cDDPM/DDPM_cond_spark_2D", ["model.reco_mode=ancestral"], "reco_mode"),
    ("cDDPM/DDPM", ["model.reco_mode=ddim"], "reco_mode"),
])
def test_unsupported_experiments_raise(experiment, overrides, what, monkeypatch):
    """The experiments and overrides the port refused before it ported the
    pDDPM, ResBlock recompute and the samplers: each now materializes equal
    to the JAX package's, the named field included."""
    monkeypatch.setenv("DATA_DIR", "/data/here")
    tree = P.compose(CONFIGS, experiment, overrides)
    assert tree == J.compose(CONFIGS, experiment, overrides)
    got, want = P.materialize(tree), J.materialize(tree)
    _same_typed(got, want)
    assert getattr(got.model, what) == getattr(want.model, what)


@pytest.mark.parametrize("experiment,overrides", [
    ("cDDPM/Spark_2D_pretrain", []),
    ("cDDPM/Spark_2D_pretrain", ["model.backbone=resnet18", "model.dec_dim=64",
                                 "model.mask_ratio_hi=0.75", "model.loss_on_mask=false",
                                 "model.delta_mask=0.5", "trainer.max_epochs=3", "seed=7",
                                 "eval=device_fast", "logger=csv"]),
    ("cDDPM/DDPM_cond_spark_2D", ["pretrained_encoder=/runs/spark", "checkpoint=last"]),
])
def test_spark_and_pretrained_encoder_match_jax(experiment, overrides, monkeypatch):
    """SparK pretraining and the encoder import compose and materialize as in
    the JAX package (task Spark_2D -> SparkTaskConfig)."""
    monkeypatch.setenv("DATA_DIR", "/data/here")
    tree = P.compose(CONFIGS, experiment, overrides)
    assert tree == J.compose(CONFIGS, experiment, overrides)
    got, want = P.materialize(tree), J.materialize(tree)
    _same_typed(got, want)
    assert type(got.model).__name__ == type(want.model).__name__
    assert (got.task == "Spark_2D") == (type(got.model).__name__ == "SparkTaskConfig")


def test_override_errors_and_env_file(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="unknown option"):
        P.compose(CONFIGS, "cDDPM/DDPM_cond_spark_2D", ["logger=nope"])
    with pytest.raises(KeyError):
        P.materialize(P.compose(CONFIGS, None, ["trainer.nope=1"]))
    assert P.parse_overrides(["a.b=1e-4", "c=[1,2]", "d="]) == J.parse_overrides(
        ["a.b=1e-4", "c=[1,2]", "d="])
    env = tmp_path / "environment.env"
    env.write_text("# c\nUAD_TEST_X='v1'\nUAD_TEST_Y=2\n")
    monkeypatch.delenv("UAD_TEST_X", raising=False)
    monkeypatch.delenv("UAD_TEST_Y", raising=False)
    P.load_env_file(str(env))
    assert os.environ["UAD_TEST_X"] == "v1" and os.environ["UAD_TEST_Y"] == "2"


def test_print_and_save_config(tmp_path, capsys):
    tree = P.compose(CONFIGS, "cDDPM/DDPM_cond_spark_2D", [])
    P.print_config(tree, run_dir=str(tmp_path))
    P.save_config(tree, str(tmp_path / "final_config.yaml"))
    J.save_config(tree, str(tmp_path / "jax.yaml"))
    assert (tmp_path / "final_config.yaml").read_text() == (tmp_path / "jax.yaml").read_text()
    assert "model" in capsys.readouterr().out
