"""The plain reference against the system's CPU path at a tiny size, in
float32: the noise seeds and fields, the networks, one volume's
reconstruction and scoring, and the train step's loss and gradients."""
import math

import numpy as np
import pytest
import torch

from conditioned_diffusion_models_uad_torch.eval.fused import _volume_eval_core
from conditioned_diffusion_models_uad_torch.models.tasks import DDPMTask
from conditioned_diffusion_models_uad_torch.ops.simplex_hash import fractal_noise_2d_hash
from conditioned_diffusion_models_uad_torch.orchestrate import eval_key, volume_seeds
from uadbench.drivers.eval_protocol import make_subjects
from uadbench.harness.checks import parse_scores, reference_model, score_gap
from uadbench.harness.weights import make_weights
from uadbench.reference import noise
from uadbench.reference.diffusion import alpha_bars, reconstruct_volume
from uadbench.reference.scoring import score_volume

from conftest import tiny_cell

SEED = 2**31 + 12345  # past 32 signed bits, as the check's seeds are


def test_volume_seeds_and_fields():
    key = noise.prng_key(987654 + 1000)
    port = volume_seeds(eval_key(987654, 0), range(5), 3).numpy()
    ours = np.array([noise.volume_seeds(key, i, 3) for i in range(5)])
    assert (port == ours).all()
    seeds = torch.tensor(ours[0], dtype=torch.int32)
    a = fractal_noise_2d_hash(seeds, (40, 36))
    b = noise.fractal_noise(ours[0].tolist(), (40, 36))
    assert torch.allclose(a, b, atol=2e-6, rtol=0)


@pytest.fixture(scope="module")
def eval_cell(bench):
    return tiny_cell(bench, "eval")


def test_networks_and_reconstruction(eval_cell):
    cell = eval_cell
    task = DDPMTask(cell.task_config(), device="cpu")
    task.load_state_dict(make_weights(task.state_dict(), cell.weight_seed(SEED), "cpu"))
    ref = reference_model(cell, SEED, "cpu")
    assert set(ref.state_dict()) == set(task.state_dict())
    sub = make_subjects(1, (48, 48, 48), 5, [0.01, 0.15], [1, 2], "cpu")[0]
    vol = torch.as_tensor(sub["vol"])
    seeds = [11, 22, 33]
    slices = vol.movedim(-1, 0)[..., None]
    reco_port = task.reconstruct_with_aux(slices, torch.tensor([seeds], dtype=torch.int32))[0]
    reco_port = reco_port[..., 0].movedim(0, -1)
    reco_ref = reconstruct_volume(ref, vol, seeds, cell.config["model"], alpha_bars(), 20)
    err = (reco_port - reco_ref).pow(2).mean().sqrt() / reco_ref.pow(2).mean().sqrt()
    assert float(err) < 1e-5


@pytest.mark.parametrize("th_record", [float("nan"), 0.05])
def test_scoring(th_record):
    sub = make_subjects(1, (48, 48, 48), 9, [0.01, 0.15], [1, 2], "cpu")[0]
    d = {k: torch.as_tensor(v) for k, v in sub["_dev"].items()}
    g = torch.Generator().manual_seed(3)
    reco = (d["vol"] + 0.1 * torch.randn(d["vol"].shape, generator=g)).clamp(0, 1)
    statics = dict(residualmode="l1", erode_iterations=1, median_kernel=5, eval_seg=True,
                   cc_min_size=8, pack_seg=False, with_hausdorff=True, pack_maps=False)
    diff, packed = _volume_eval_core(d["vol"], reco, d["mask_orig"], d["seg_orig"],
                                     torch.tensor(th_record), torch.tensor(float("nan")),
                                     torch.tensor(0.0), torch.zeros(16), **statics)
    produced = parse_scores(packed.numpy(), 48)
    ref = score_volume(d["vol"], reco, d["mask_orig"], d["seg_orig"], th_record,
                       erode_iterations=1)
    assert score_gap(produced, ref, diff) < 1e-5
    assert produced["scalars"]["tp"] == ref["scalars"]["tp"] > 0
    assert math.isfinite(ref["scalars"]["haus_pt"])
