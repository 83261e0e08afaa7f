"""The slice through the port's own entry points on the CPU: the iterative
reconstruction (``model.reco_mode=ddim|ancestral``) composed from the CLI
overrides and run through ``orchestrate.evaluate`` in both dispatch modes
(the port's counterpart of tests/test_e2e_iterative.py, with its
assertions), and a tiny ``experiment=cDDPM/DDPM_patched`` run through the
port's CLI (``device=cpu``: fit, checkpoints, eval), whose eval rows from the
'last' checkpoint are held against the JAX package's ``evaluate`` on the same
weights, both on table simplex noise.

Tolerances: the iterative modes' two dispatch paths row for row at 1e-4
relative and 1e-6 absolute, as the JAX test holds its own. Against the JAX
package: IDs, labels, lesion sizes and confusion counts equal; thresholds and
float rows within 2e-5; AUROC/AUPRC, dice and the rates derived from counts
within 1e-3 (tests/test_torch_orchestrate.py's classes)."""
import dataclasses as dc
import os
import pickle

import numpy as np
import pytest
import torch

from conditioned_diffusion_models_uad_torch import config as P
from conditioned_diffusion_models_uad_torch import orchestrate as PO
from conditioned_diffusion_models_uad_torch.__main__ import main as cli
from conditioned_diffusion_models_uad_torch.data.synthetic import build_synthetic_root
from conditioned_diffusion_models_uad_torch.models.tasks import DDPMTask
from conditioned_diffusion_models_uad_tpu import config as J
from conditioned_diffusion_models_uad_tpu import orchestrate as JO
from conditioned_diffusion_models_uad_tpu.utils.convert_torch import (
    convert_reference_ddpm_checkpoint,
)
from test_e2e_iterative import TINY_OVERRIDES
from test_torch_orchestrate import _compare

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")
PATCHED_TINY = ["model.unet_dim=32", "model.num_res_blocks=1", "model.channel_mult=[1,2]",
                "model.attention_resolutions=[]", "model.timesteps=20",
                "model.step_ensemble=[5,10]", "model.test_timesteps=10",
                "model.patch_hw=[16,16]", "model.dtype=float32",
                "datamodule.image_dim=[32,32,16]", "datamodule.rescale_factor=1.0",
                "datamodule.batch_size=2",
                "datamodule.testsets=[Brats21]", "logger=csv"]


class _Null:
    def log_metrics(self, *a, **k):
        pass

    def log_image(self, *a, **k):
        pass


@pytest.mark.parametrize("mode", ["ddim", "ancestral"])
def test_port_iterative_reco_both_dispatch_modes(tmp_path, mode):
    root = build_synthetic_root(str(tmp_path / "data"), shape=(64, 64, 40), n_train=1,
                                n_val=1, n_test=1, n_eval=2, eval_sets=("Brats21",))
    tree = P.compose(CONFIGS, "cDDPM/DDPM_cond_spark_2D",
                     TINY_OVERRIDES + [f"model.reco_mode={mode}", f"name=iter_{mode}",
                                       f"datamodule.data_dir={root}",
                                       f"log_dir={tmp_path / 'logs'}", "device=cpu"])
    base = P.materialize(tree)
    assert base.model.reco_mode == mode  # the CLI override reached the task
    task = DDPMTask(base.model, device="cpu")
    assert task.draws_keys

    results = {}
    for fused in (True, False):
        cfg = dc.replace(base, eval=dc.replace(base.eval, fused_dispatch=fused))
        cfg.eval.out_dir = cfg.run_dir
        results[fused] = PO.evaluate(cfg, task, 0, _Null())

    for stage in ("val", "test"):
        ev_f = results[True][stage]["Brats21"]
        ev_s = results[False][stage]["Brats21"]
        assert ev_f["IDs"] == ev_s["IDs"] and len(ev_f["IDs"]) == 2
        # the NaN loss sentinel reaches the loss-derived scores and is left
        # out of their means; the residual-based scores stay real
        for ev in (ev_f, ev_s):
            assert np.isnan(ev["AnomalyScoreRegPerVol"]).all()
            assert np.isfinite(ev["AnomalyScoreRecoPerVol"]).all()
            assert np.isfinite(ev["DicePerVolMean"])
            assert np.isfinite(ev["AUCPerVolMean"])
            assert len(ev["latentSpace"]) == 2
        for k in ("DiceScorePerVol", "BestDicePerVol", "AUCPerVol",
                  "AUPRCPerVol", "TPPerVol", "FPPerVol", "HausPerVol",
                  "AnomalyScoreRecoPerVol", "l1recoErrorAll",
                  "lesionSizePerVol"):
            np.testing.assert_allclose(
                np.asarray(ev_f[k], np.float64), np.asarray(ev_s[k], np.float64),
                rtol=1e-4, atol=1e-6, err_msg=f"{stage}/{k}")
    np.testing.assert_allclose(
        results[True]["test"]["Brats21"]["BestThresholdPerVol"],
        results[False]["test"]["Brats21"]["BestThresholdPerVol"], rtol=1e-4)


def test_patched_cli_fit_eval_and_jax_rows(tmp_path):
    root = build_synthetic_root(str(tmp_path / "data"), shape=(34, 36, 18), n_train=2,
                                n_val=1, n_test=2, n_eval=2, seed=4)
    common = [f"datamodule.data_dir={root}", *PATCHED_TINY]
    cli(["experiment=cDDPM/DDPM_patched", *common, "device=cpu", f"log_dir={tmp_path}",
         "name=pddpm", "trainer.max_epochs=2", "trainer.check_val_every_n_epoch=1"])
    run = tmp_path / "pddpm"
    for rel in ("final_config.yaml", "csv_fold0/metrics.csv", "checkpoints/fold-0/meta.json",
                "checkpoints/fold-0/last/state.pt", "0_preds_dict.pkl"):
        assert (run / rel).is_file(), rel
    text = (run / "csv_fold0" / "metrics.csv").read_text()
    assert text.count("train/loss,") == 2 and text.count("val/loss_comb,") == 2
    preds = pickle.loads((run / "0_preds_dict.pkl").read_bytes())
    for stage in ("val", "test"):
        ev = preds[stage]["Brats21"]
        assert np.isfinite(ev["DicePerVolMean"]) and np.isfinite(ev["AUPRCPerVolMean"])
        assert len(ev["latentSpace"]) == 2  # pDDPM's zeros latent
        assert np.isfinite(ev["AnomalyScoreRegPerVol"]).all()  # the last box's loss

    # the trained weights through both packages' evaluate, table noise
    exp = "cDDPM/DDPM_patched"
    cfg = P.materialize(P.compose(CONFIGS, exp, common + [f"log_dir={tmp_path / 'p'}",
                                                           "device=cpu"]))
    jcfg = J.materialize(J.compose(CONFIGS, exp, common + [f"log_dir={tmp_path / 'j'}"]))
    assert cfg.model.patched and cfg.model.use_checkpoint and cfg.model.inpaint
    task = DDPMTask(cfg.model, device="cpu", noise_impl="table")
    task.load_state_dict(PO._run_state(str(run), "last", 0, "cpu"))
    jtask = JO.build_task(jcfg)
    sd = {("diffusion.model." + k[5:]) if k.startswith("unet.") else k: v.numpy().copy()
          for k, v in task.state_dict().items()}
    got = PO.evaluate(cfg, task, 0, _Null())
    want = JO.evaluate(jcfg, jtask, convert_reference_ddpm_checkpoint(sd, jtask), 0, _Null())
    print("worst", _compare(got, want))
