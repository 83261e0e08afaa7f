"""The port keeps the JAX package's dispatch-invariance contract
(tests/test_dispatch_invariance.py), on the CPU in float32, at that test's
TINY config and shapes.

Every volume of a group draws its noise (or SparK mask) from its own row of
draws, and ``VolumeReconstructor`` runs each volume's slices through the
encoder and UNet in a call of its own, so a volume's rows see the same
shapes whatever the group: the grouped reconstruction equals the volume
alone bit for bit in every reco mode, and ``evaluate``'s identity and count
rows are exactly equal across ``volumes_per_call`` 1/2/4 x
``fused_dispatch``. The float rows are held at the JAX test's 1e-5
relative (the scoring of a fused group and of a volume through
``test_step`` are different programs). The 2-rank form of the contract
(volume-parallel buffers bit-equal to one process's) is in
tests/test_torch_parallel.py."""
import dataclasses as dc
import os

import numpy as np
import pytest
import torch

from conditioned_diffusion_models_uad_torch import config as P
from conditioned_diffusion_models_uad_torch import orchestrate as PO
from conditioned_diffusion_models_uad_torch.data.synthetic import build_synthetic_root
from conditioned_diffusion_models_uad_torch.eval import harness as PH
from conditioned_diffusion_models_uad_torch.eval.reconstruct import VolumeReconstructor
from conditioned_diffusion_models_uad_torch.models.tasks import (
    DDPMTask,
    DDPMTaskConfig,
    SparkTask,
    SparkTaskConfig,
)
from conditioned_diffusion_models_uad_torch.utils.random_init import randomize_

torch.set_num_threads(2)

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")

# tests/test_dispatch_invariance.py's TINY
TINY = dict(
    image_hw=(32, 32), cond_dim=16, encoder_backbone="resnet18",
    timesteps=20, unet_dim=32, num_res_blocks=1, channel_mult=(1, 2),
    attention_resolutions=(), test_timesteps=10, step_ensemble=(5, 10),
    dtype="float32",
)
TINY_OVERRIDES = [
    "model.unet_dim=32", "model.num_res_blocks=1", "model.channel_mult=[1,2]",
    "model.attention_resolutions=[]", "model.cond_dim=16", "model.encoder_backbone=resnet18",
    "model.timesteps=20", "model.step_ensemble=[5,10]", "model.test_timesteps=10",
    "model.dtype=float32", "datamodule.image_dim=[64,64,40]", "datamodule.rescale_factor=2.0",
    "datamodule.testsets=[Brats21]", "eval.save_output_images=false", "logger=csv",
]
INT_KEYS = (
    "TPPerVol", "FPPerVol", "TNPerVol", "FNPerVol", "lesionSizePerVol",
    "labelPerSlice", "labelPerVol",
)
FLOAT_KEYS = (
    "DiceScorePerVol", "BestDicePerVol", "BestThresholdPerVol", "AUCPerVol",
    "AUPRCPerVol", "HausPerVol", "l1recoErrorAll", "l2recoErrorAll",
    "AnomalyScoreRegPerVol", "AnomalyScoreRecoPerVol",
    "AnomalyScoreRecoPerSlice",
)


def _mode_task(mode):
    """(task, patched) of one reco mode, from seeded weights."""
    if mode == "spark":
        cfg = SparkTaskConfig(image_hw=(32, 32), backbone="resnet18", dec_dim=32,
                              dtype="float32")
        return randomize_(SparkTask(cfg, device="cpu"), 2), False
    if mode == "patched":
        cfg = DDPMTaskConfig(**{**TINY, "patched": True, "patch_hw": (16, 16)})
        return randomize_(DDPMTask(cfg, device="cpu"), 1), True
    kw = {} if mode == "single_shot" else {"reco_mode": mode, "sampling_steps": 4}
    return randomize_(DDPMTask(DDPMTaskConfig(**TINY, **kw), device="cpu"), 0), False


@pytest.mark.parametrize("mode", ["single_shot", "ancestral", "ddim", "patched", "spark"])
def test_grouped_reconstruction_bitwise(mode):
    """batch_call on 2 volumes equals each volume alone bit for bit:
    reconstruction and loss."""
    rng = np.random.default_rng(0)
    vols = [rng.random((32, 32, 12), dtype=np.float32) for _ in range(2)]
    task, patched = _mode_task(mode)
    recon = VolumeReconstructor(task, patched=patched, device="cpu")
    draws = PO.volume_draws(task, PO.eval_key(7, 0), [0, 1])
    grouped = recon.batch_call(vols, draws)
    for i, (vol, (r_g, a_g)) in enumerate(zip(vols, grouped)):
        r_s, a_s = recon(vol, draws[i:i + 1], return_aux=True)
        assert r_s.shape == (32, 32, 12) and r_s.std() > 1e-3
        np.testing.assert_array_equal(r_s.numpy(), r_g.numpy())
        np.testing.assert_array_equal(a_s["loss"].numpy(), a_g["loss"].numpy())


class _Null:
    def log_metrics(self, *a, **k):
        pass


def _eval_dicts_equal(ref, other, context):
    for stage in ("val", "test"):
        ev_r, ev_o = ref[stage]["Brats21"], other[stage]["Brats21"]
        assert ev_r["IDs"] == ev_o["IDs"], context
        for k in INT_KEYS:
            np.testing.assert_array_equal(
                np.asarray(ev_r[k], dtype=np.float64), np.asarray(ev_o[k], dtype=np.float64),
                err_msg=f"{context}: {stage}/{k}")
        for k in FLOAT_KEYS:
            np.testing.assert_allclose(
                np.asarray(ev_r[k], dtype=np.float64), np.asarray(ev_o[k], dtype=np.float64),
                rtol=1e-5, atol=1e-8, err_msg=f"{context}: {stage}/{k}")
        assert len(ev_r["latentSpace"]) == len(ev_o["latentSpace"]), context
        for a, b in zip(ev_r["latentSpace"], ev_o["latentSpace"]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-8, err_msg=context)


def test_eval_dict_invariant_to_dispatch_layout(tmp_path, monkeypatch):
    """volumes_per_call 1/2/4 x fused on/off give the same eval dict: IDs
    and counts exactly, float rows and latents at 1e-5 relative (4 eval
    volumes: layouts with and without a padded tail)."""
    for mod in (PH, PO):
        monkeypatch.setattr(mod, "FUSED_MIN_VOXELS", 1000)
    root = build_synthetic_root(str(tmp_path / "data"), shape=(64, 64, 40), n_train=1,
                                n_val=1, n_test=1, n_eval=4, eval_sets=("Brats21",))
    base = P.materialize(P.compose(
        CONFIGS, "cDDPM/DDPM_cond_spark_2D",
        [f"datamodule.data_dir={root}", *TINY_OVERRIDES, f"log_dir={tmp_path / 'logs'}",
         "device=cpu"]))
    task = randomize_(DDPMTask(base.model, device="cpu"), 0)
    layouts = [(1, False), (1, True), (2, False), (2, True), (4, True)]
    results = {}
    for vpc, fused in layouts:
        cfg = dc.replace(base, eval=dc.replace(base.eval, volumes_per_call=vpc,
                                               fused_dispatch=fused))
        results[(vpc, fused)] = PO.evaluate(cfg, task, 0, _Null())
    ref = results[layouts[0]]
    assert len(ref["test"]["Brats21"]["IDs"]) >= 3
    for layout in layouts[1:]:
        _eval_dicts_equal(ref, results[layout], f"layout {layout}")

