"""The paper's two-stage pipeline through the port's CLI on the CPU: SparK
pretraining (experiment=cDDPM/Spark_2D_pretrain), then the cDDPM
(experiment=cDDPM/DDPM_cond_spark_2D) with ``pretrained_encoder=<that run>``,
at the tiny SparK overrides of the JAX package's tests/test_e2e_smoke.py
(resnet18, 64x64, dec_dim 64, float32) on a tiny synthetic root; the cDDPM's
encoder backbone at the start of its fit is the SparK checkpoint's, bit for
bit. Then the SparK eval protocol of the port's ``evaluate`` against the JAX
package's on the same files and converted weights, under the default eval
settings and under eval=device_fast with the fused-path size gate lowered;
each volume's mask comes from the key fold_in(PRNGKey(seed + 1000 + fold), i)
in both. Tolerances, those of tests/test_torch_orchestrate.py: the same rows,
IDs, labels, lesion sizes and confusion counts; thresholds and float rows
within 2e-5 absolute; AUROC/AUPRC, dice and the rates derived from counts
1e-3. Also: the new modules import no jax."""
import math
import os
import pickle
import subprocess
import sys

import pytest
import torch

from conditioned_diffusion_models_uad_torch import config as P
from conditioned_diffusion_models_uad_torch import orchestrate as PO
from conditioned_diffusion_models_uad_torch.__main__ import main
from conditioned_diffusion_models_uad_torch.data.synthetic import build_synthetic_root
from conditioned_diffusion_models_uad_torch.eval import harness as PH
from conditioned_diffusion_models_uad_torch.models.tasks import SparkTask
from conditioned_diffusion_models_uad_torch.train import checkpoint as PC
from conditioned_diffusion_models_uad_torch.train import loop as PL
from conditioned_diffusion_models_uad_torch.utils.convert_jax import convert_jax_spark_variables
from conditioned_diffusion_models_uad_tpu import config as J
from conditioned_diffusion_models_uad_tpu import orchestrate as JO
from conditioned_diffusion_models_uad_tpu.eval import harness as JH
from test_torch_orchestrate import _compare, _Null
from test_torch_spark import _perturb

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")
DATA = ["datamodule.image_dim=[64,64,16]", "datamodule.rescale_factor=1.0",
        "datamodule.batch_size=2", "datamodule.testsets=[Brats21]", "logger=csv"]
SPARK_TINY = ["model.backbone=resnet18", "model.dec_dim=64", "model.dtype=float32", *DATA]
DDPM_TINY = ["model.unet_dim=32", "model.num_res_blocks=1", "model.channel_mult=[1,2]",
             "model.attention_resolutions=[]", "model.cond_dim=16",
             "model.encoder_backbone=resnet18", "model.timesteps=20",
             "model.step_ensemble=[5,10]", "model.test_timesteps=10", "model.dtype=float32",
             *DATA]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return build_synthetic_root(str(tmp_path_factory.mktemp("spark")), shape=(66, 68, 18),
                                n_train=2, n_val=2, n_test=2, n_eval=2, seed=5)


def test_two_stage_cli_on_the_cpu(root, tmp_path, monkeypatch):
    common = ["device=cpu", f"datamodule.data_dir={root}", f"log_dir={tmp_path}"]
    main(["experiment=cDDPM/Spark_2D_pretrain", *common, *SPARK_TINY, "name=spark",
          "trainer.max_epochs=2", "trainer.check_val_every_n_epoch=1"])
    run = tmp_path / "spark"
    for rel in ("final_config.yaml", "csv_fold0/metrics.csv", "checkpoints/fold-0/meta.json",
                "checkpoints/fold-0/best/state.pt", "checkpoints/fold-0/last/state.pt",
                "0_preds_dict.pkl", "0_timings.json"):
        assert (run / rel).is_file(), rel
    text = (run / "csv_fold0" / "metrics.csv").read_text()
    assert text.count("train/loss,") == 2 and text.count("val/loss_comb,") == 2
    preds = pickle.loads((run / "0_preds_dict.pkl").read_bytes())
    for stage in ("val", "test"):
        d = preds[stage]["Brats21"]
        assert len(d["IDs"]) == 2 and math.isfinite(d["DicePerVolMean"])
        assert all(math.isfinite(v) and v > 0 for v in d["AnomalyScoreRecoPerVol"])
        assert d["AnomalyScoreRegPerVol"] == [0.0, 0.0]
    spark_state = PC.load_state(str(run / "checkpoints/fold-0/last"))["model"]

    seen = {}
    orig_fit = PL.Trainer.fit

    def fit(self, *a, **kw):
        seen.update({k: v.detach().clone() for k, v in self.task.state_dict().items()})
        return orig_fit(self, *a, **kw)

    monkeypatch.setattr(PL.Trainer, "fit", fit)
    main(["experiment=cDDPM/DDPM_cond_spark_2D", *common, *DDPM_TINY, "name=cddpm",
          f"pretrained_encoder={run}", "checkpoint=last", "trainer.max_epochs=1"])
    backbone = [k for k in seen if k.startswith("encoder.") and not k.startswith("encoder.fc.")]
    assert len(backbone) == sum(k.startswith("model.encoder.") for k in spark_state) > 0
    for k in backbone:
        assert torch.equal(seen[k], spark_state["model." + k]), k
    cddpm = pickle.loads((tmp_path / "cddpm" / "0_preds_dict.pkl").read_bytes())
    assert math.isfinite(cddpm["test"]["Brats21"]["DicePerVolMean"])


@pytest.mark.parametrize("preset", ["default", "device_fast"])
def test_spark_evaluate_matches_jax(root, tmp_path, preset, monkeypatch):
    overrides = [f"datamodule.data_dir={root}", *SPARK_TINY]
    if preset == "device_fast":
        # every volume through the fused reconstruct + score call
        overrides.append("eval=device_fast")
        for mod in (PH, PO, JH):
            monkeypatch.setattr(mod, "FUSED_MIN_VOXELS", 1000)
    cfg = P.materialize(P.compose(CONFIGS, "cDDPM/Spark_2D_pretrain",
                                  overrides + [f"log_dir={tmp_path / 'p'}", "device=cpu"]))
    jcfg = J.materialize(J.compose(CONFIGS, "cDDPM/Spark_2D_pretrain",
                                   overrides + [f"log_dir={tmp_path / 'j'}"]))
    jtask = JO.build_task(jcfg)
    import jax

    variables = _perturb(jtask.init(jax.random.PRNGKey(2)), 9)
    task = PO.build_task(cfg)
    assert isinstance(task, SparkTask)
    sd = convert_jax_spark_variables(variables["params"], variables["batch_stats"], task.scfg)
    task.load_state_dict({f"model.{k}": t for k, t in sd.items()})

    got = PO.evaluate(cfg, task, 0, _Null())
    want = JO.evaluate(jcfg, jtask, variables, 0, _Null())
    worst = _compare(got, want)
    print(preset, "worst", worst)
    reco = got["test"]["Brats21"]["AnomalyScoreRecoPerVol"]
    assert len(reco) == 2 and all(v > 0 for v in reco)


def test_spark_modules_import_no_jax():
    """The new modules are among those the package walk finds, and importing
    them with the CLI loads none of jax, flax, optax or the JAX package (a
    fresh interpreter)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import conditioned_diffusion_models_uad_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "new = ['models.spark', 'models.losses', 'models.tasks', 'utils.prng',\n"
        "       'utils.convert_jax', 'utils.decisions', 'orchestrate', '__main__']\n"
        "assert all(p.__name__ + '.' + n in names for n in new), names\n"
        "for n in new:\n"
        "    importlib.import_module(p.__name__ + '.' + n)\n"
        "bad = ('jax', 'jaxlib', 'flax', 'optax', 'conditioned_diffusion_models_uad_tpu')\n"
        "print(sorted(k for k in sys.modules if k.split('.')[0] in bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True, cwd=REPO)
    assert out.stdout.strip() == "[]", out.stdout


def test_torch_ckpt_refused_by_spark_only_eval(root, tmp_path):
    """A torch .ckpt file is a cDDPM checkpoint: SparK's only_eval refuses it,
    as the JAX package does."""
    path = tmp_path / "x.ckpt"
    torch.save({"state_dict": {"w": torch.zeros(1)}}, path)
    cfg = P.materialize(P.compose(CONFIGS, "cDDPM/Spark_2D_pretrain", [
        f"datamodule.data_dir={root}", *SPARK_TINY, "device=cpu", "only_eval=true",
        f"load_checkpoint={path}"]))
    with pytest.raises(ValueError, match="cDDPM"):
        PO.load_weights(PO.build_task(cfg), cfg, 0)
