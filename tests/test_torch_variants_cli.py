"""The new model and training flags through the port's CLI on the CPU:
``model.spatial_transformer``, ``model.film_fold``, ``model.dropout_unet``
and ``trainer.aug_full`` compose and materialize as in the JAX package's
config.py, and a tiny run with all of them (``device=cpu``) fits, writes
its checkpoints and evaluates. Exact (config); finite metrics (run)."""
import os
import pickle

import numpy as np
import pytest
import torch

from conditioned_diffusion_models_uad_torch import config as P
from conditioned_diffusion_models_uad_torch.__main__ import USAGE, main as cli
from conditioned_diffusion_models_uad_torch.data.synthetic import build_synthetic_root
from conditioned_diffusion_models_uad_tpu import config as J
from test_torch_config import _same_typed

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")
FLAGS = ["model.spatial_transformer=true", "model.film_fold=true",
         "model.dropout_unet=0.1", "trainer.aug_full=true"]
TINY = ["model.unet_dim=32", "model.num_res_blocks=1", "model.channel_mult=[1,2]",
        "model.attention_resolutions=[]", "model.cond_dim=16",
        "model.encoder_backbone=resnet18", "model.timesteps=20",
        "model.step_ensemble=[5,10]", "model.test_timesteps=10", "model.dtype=float32",
        "datamodule.image_dim=[32,32,16]", "datamodule.rescale_factor=1.0",
        "datamodule.batch_size=2", "datamodule.testsets=[Brats21]", "logger=csv",
        "eval=device_fast"]


@pytest.mark.parametrize("flags", [FLAGS, FLAGS[:1], FLAGS[1:2], FLAGS[2:3], FLAGS[3:],
                                   ["trainer.aug_full=true", "trainer.aug_intensity=false"]],
                         ids=["all", "spatial_transformer", "film_fold", "dropout_unet",
                              "aug_full", "aug_full_only"])
def test_new_flags_materialize_as_in_jax(flags, monkeypatch):
    monkeypatch.setenv("DATA_DIR", "/data/here")
    for exp in ("cDDPM/DDPM_cond_spark_2D", "cDDPM/DDPM_patched"):
        tree = P.compose(CONFIGS, exp, flags)
        assert tree == J.compose(CONFIGS, exp, flags)
        got, want = P.materialize(tree), J.materialize(tree)
        _same_typed(got, want)
        for f in flags:
            group, key = f.split("=")[0].split(".")
            obj = got.model if group == "model" else got.trainer
            jobj = want.model if group == "model" else want.trainer
            assert getattr(obj, key) == getattr(jobj, key)
    unet = P.materialize(P.compose(CONFIGS, "cDDPM/DDPM_cond_spark_2D", FLAGS)).model.unet_config
    assert unet.spatial_transformer and unet.film_fold and unet.dropout == 0.1


def test_usage_lists_the_new_flags():
    assert "not ported" not in USAGE
    for flag in ("cDDPM/DDPM_patched", "model.spatial_transformer", "model.film_fold",
                 "model.dropout_unet", "trainer.aug_full", "prepare_cli"):
        assert flag in USAGE, flag


def test_cli_runs_with_every_new_flag(tmp_path):
    root = build_synthetic_root(str(tmp_path / "data"), shape=(34, 36, 18), n_train=2,
                                n_val=1, n_test=1, n_eval=1, eval_sets=("Brats21",), seed=6)
    cli(["experiment=cDDPM/DDPM_cond_spark_2D", f"datamodule.data_dir={root}", *TINY,
         *FLAGS, "model.norm_precision=compute", "device=cpu", f"log_dir={tmp_path}",
         "name=variants", "trainer.max_epochs=2", "trainer.check_val_every_n_epoch=1"])
    run = tmp_path / "variants"
    for rel in ("final_config.yaml", "csv_fold0/metrics.csv", "checkpoints/fold-0/meta.json",
                "checkpoints/fold-0/last/state.pt", "0_preds_dict.pkl"):
        assert (run / rel).is_file(), rel
    text = (run / "csv_fold0" / "metrics.csv").read_text()
    assert text.count("train/loss,") == 2 and text.count("val/loss_comb,") == 2
    state = torch.load(run / "checkpoints/fold-0/last/state.pt", weights_only=False)
    assert any(".transformer_blocks.0.attn2.to_k.weight" in k for k in state["model"])
    preds = pickle.loads((run / "0_preds_dict.pkl").read_bytes())
    for stage in ("val", "test"):
        ev = preds[stage]["Brats21"]
        assert np.isfinite(ev["DicePerVolMean"]) and np.isfinite(ev["AUPRCPerVolMean"])
