"""The slice as a whole: the port's CLI (``python -m
conditioned_diffusion_models_uad_torch ... device=cpu``) trains and
evaluates on a tiny synthetic root and reproduces its eval from the 'last'
checkpoint; then the port's ``evaluate`` against the JAX package's from the
same files and converted weights, under the default eval settings (host
scoring, one volume a call) and under eval=device_fast with the fused-path
size gate lowered (two volumes a call, scored in the reconstruction call).

The JAX task's noise is pinned to the hash-simplex Pallas kernel (interpret
mode); the port draws each volume's seeds itself through utils/prng.py (no
seed in this file comes through JAX). Tolerances, those of
tests/test_torch_eval_reconstruct.py: the preds dicts have the same rows,
IDs, labels, lesion sizes and confusion counts; thresholds and float rows
within 2e-5 absolute (the reconstructions differ by convolution summation
order, and the inputs by the preprocessing tolerance of
tests/test_torch_datamodules.py); AUROC/AUPRC, dice and the rates derived
from counts 1e-3. Also: importing every port module loads no jax, pandas or
orbax."""
import math
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from conditioned_diffusion_models_uad_torch import config as P
from conditioned_diffusion_models_uad_torch import orchestrate as PO
from conditioned_diffusion_models_uad_torch.data.synthetic import build_synthetic_root
from conditioned_diffusion_models_uad_torch.eval import harness as PH
from conditioned_diffusion_models_uad_torch.models.tasks import DDPMTask
from conditioned_diffusion_models_uad_torch.utils.random_init import randomize_
from conditioned_diffusion_models_uad_tpu import config as J
from conditioned_diffusion_models_uad_tpu import orchestrate as JO
from conditioned_diffusion_models_uad_tpu.eval import harness as JH
from conditioned_diffusion_models_uad_tpu.ops.simplex import make_noise_fn
from conditioned_diffusion_models_uad_tpu.utils.convert_torch import (
    convert_reference_ddpm_checkpoint,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")
EXPERIMENT = "experiment=cDDPM/DDPM_cond_spark_2D"
TINY = ["model.unet_dim=32", "model.num_res_blocks=1", "model.channel_mult=[1,2]",
        "model.attention_resolutions=[]", "model.cond_dim=16", "model.encoder_backbone=resnet18",
        "model.timesteps=20", "model.step_ensemble=[5,10]", "model.test_timesteps=10",
        "model.dtype=float32", "datamodule.image_dim=[32,32,16]", "datamodule.batch_size=2",
        "datamodule.testsets=[Brats21,IXI]", "logger=csv"]
TOL = 2e-5
TOL_RANK = 1e-3
EXACT = ("IDs", "labelPerVol", "lesionSizePerVol", "labelPerSlice", "lesionSizePerSlice",
         "TPPerVol", "FPPerVol", "TNPerVol", "FNPerVol")
RANK = ("AUC", "AUPRC", "Dice", "BestDice", "Precision", "Recall", "TPR", "FPR", "Accuracy",
        "Specificity", "Haus")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return build_synthetic_root(str(tmp_path_factory.mktemp("orch")), shape=(34, 36, 18),
                                n_train=2, n_val=2, n_test=2, n_eval=2, seed=3)


def _rows(preds):
    return {(st, name, k): v for st, sets in preds.items() for name, d in sets.items()
            for k, v in d.items()}


def _compare(got, want):
    """Worst absolute difference of the float rows, by tolerance class."""
    rg, rw = _rows(got), _rows(want)
    assert rg.keys() == rw.keys()
    worst = {"tol": 0.0, "rank": 0.0}
    for key, w in rw.items():
        g = rg[key]
        if key[2] in EXACT:
            assert g == w, key
            continue
        try:
            a = np.asarray(g, dtype=np.float64).ravel()
            b = np.asarray(w, dtype=np.float64).ravel()
        except (TypeError, ValueError):
            assert g == w, key
            continue
        assert a.shape == b.shape, key
        assert np.array_equal(np.isnan(a), np.isnan(b)), key
        ok = ~np.isnan(a)
        err = float(np.max(np.abs(a[ok] - b[ok]), initial=0.0))
        cls = "rank" if key[2].startswith(RANK) else "tol"
        worst[cls] = max(worst[cls], err)
    assert worst["tol"] <= TOL and worst["rank"] <= TOL_RANK, worst
    return worst


def _cli(args, cwd=REPO):
    return subprocess.run([sys.executable, "-m", "conditioned_diffusion_models_uad_torch", *args],
                          cwd=cwd, capture_output=True, text=True, timeout=600)


def test_cli_trains_evaluates_and_reloads_on_the_cpu(root, tmp_path):
    common = [EXPERIMENT, "device=cpu", f"datamodule.data_dir={root}", f"log_dir={tmp_path}",
              "eval=device_fast", *TINY]
    out = _cli(common + ["name=run", "trainer.max_epochs=2", "trainer.check_val_every_n_epoch=1"])
    assert out.returncode == 0, out.stderr[-3000:]
    run = tmp_path / "run"
    for rel in ("final_config.yaml", "config_tree.txt", "csv_fold0/metrics.csv",
                "checkpoints/fold-0/meta.json", "checkpoints/fold-0/best/state.pt",
                "checkpoints/fold-0/last/state.pt", "0_preds_dict.pkl", "0_timings.json"):
        assert (run / rel).is_file(), rel
    text = (run / "csv_fold0" / "metrics.csv").read_text()
    assert text.count("train/loss,") == 2 and text.count("val/loss_comb,") == 2
    preds = pickle.loads((run / "0_preds_dict.pkl").read_bytes())
    assert set(preds["val"]) == set(preds["test"]) == {"Brats21", "IXI"}
    for stage in ("val", "test"):
        assert math.isfinite(preds[stage]["Brats21"]["DicePerVolMean"])
        assert math.isfinite(preds[stage]["Brats21"]["AUPRCPerVolMean"])
    # the test stage applies the val stage's threshold
    assert preds["test"]["Brats21"]["BestThresholdPerVol"] == \
        [preds["test"]["Brats21"]["BestThresholdPerVol"][0]] * 2
    from conditioned_diffusion_models_uad_torch.__main__ import main

    main(common + ["name=reload", "only_eval=true", f"load_checkpoint={run}",
                   "checkpoint=last"])
    again = pickle.loads((tmp_path / "reload" / "0_preds_dict.pkl").read_bytes())
    assert _compare(again, preds) == {"tol": 0.0, "rank": 0.0}


def test_cli_needs_cuda_or_device_cpu(root, tmp_path, capsys):
    from conditioned_diffusion_models_uad_torch.__main__ import main

    assert main(["--help"]) is None and "device=cpu" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            main([EXPERIMENT, f"datamodule.data_dir={root}", f"log_dir={tmp_path}", *TINY])
        assert not (tmp_path / "DDPM_cond_2D_spark").exists()


class _Null:
    def log_metrics(self, *a, **k):
        pass

    def log_image(self, *a, **k):
        pass


@pytest.mark.parametrize("preset", ["default", "device_fast"])
def test_evaluate_matches_jax(root, tmp_path, preset, monkeypatch):
    overrides = [f"datamodule.data_dir={root}", *TINY]
    if preset == "device_fast":
        # every volume through the fused reconstruct + score call
        overrides.append("eval=device_fast")
        for mod in (PH, PO, JH):
            monkeypatch.setattr(mod, "FUSED_MIN_VOXELS", 1000)
    tree = P.compose(CONFIGS, "cDDPM/DDPM_cond_spark_2D",
                     overrides + [f"log_dir={tmp_path / 'p'}", "device=cpu"])
    cfg = P.materialize(tree)
    jcfg = J.materialize(J.compose(CONFIGS, "cDDPM/DDPM_cond_spark_2D",
                                   overrides + [f"log_dir={tmp_path / 'j'}"]))
    task = randomize_(DDPMTask(cfg.model, device="cpu"), 21)
    jtask = JO.build_task(jcfg)
    jtask.noise_fn = make_noise_fn("simplex", impl="pallas")
    sd = {("diffusion.model." + k[5:]) if k.startswith("unet.") else k: v.numpy().copy()
          for k, v in task.state_dict().items()}
    variables = convert_reference_ddpm_checkpoint(sd, jtask)
    # a reference Lightning .ckpt file loads into the port natively
    ckpt = tmp_path / "reference.ckpt"
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, ckpt)
    task2 = PO.build_task(cfg)
    PO.load_weights(task2, P.materialize(P.compose(
        CONFIGS, "cDDPM/DDPM_cond_spark_2D",
        overrides + ["device=cpu", "only_eval=true", f"load_checkpoint={ckpt}"])), 0)
    assert all(torch.equal(a, b) for a, b in zip(task.state_dict().values(),
                                                 task2.state_dict().values()))

    timings = {}
    got = PO.evaluate(cfg, task, 0, _Null(), timings)
    want = JO.evaluate(jcfg, jtask, variables, 0, _Null())
    worst = _compare(got, want)
    print(preset, "worst", worst)
    assert set(timings) == {f"{s}/{st}" for s in ("Brats21", "IXI")
                            for st in ("val", "test")}
    assert os.path.isfile(os.path.join(cfg.run_dir, "0_preds_dict.pkl"))
    # the healthy set hands its 1% quantile to the test stage
    assert math.isfinite(got["val"]["IXI"]["t_1p"])


def test_port_imports_no_jax_pandas_orbax():
    """Importing every module of the port (CLI included) pulls in none of
    jax, pandas, orbax or the JAX package (a fresh interpreter)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import conditioned_diffusion_models_uad_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = ('jax', 'jaxlib', 'flax', 'optax', 'pandas', 'orbax',\n"
        "       'conditioned_diffusion_models_uad_tpu')\n"
        "print(sorted(k for k in sys.modules if k.split('.')[0] in bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True, cwd=REPO)
    assert out.stdout.strip() == "[]", out.stdout
