"""The port against the JAX package's committed golden eval metrics
(``GOLDEN`` and ``GOLDEN_ROWS`` of tests/test_golden_metrics.py, imported,
not copied): the same synthetic root (seed 0), the JAX ``DDPMTask(TINY)``'s
seed-0 variables converted with utils/convert_jax.py, the port's table
simplex noise (``noise_impl='table'``, the path the JAX package takes on the
CPU, where the golden numbers were made), the production eval preset
(``volumes_per_call=2``, ``fused_dispatch``) with the fused-path size gate
lowered as the JAX test lowers it, through the port's ``evaluate``.

Tolerance: counts (TP, FP, lesion sizes) equal; every float metric within
1e-6 absolute. The noise fields and eval keys are bit-equal to the JAX
package's; the UNet and encoder run in oneDNN's summation order, not
XLA:CPU's, which moves the reconstructions by about 1e-6 (measured: counts
equal, worst float metric 4.2e-7 from the golden value)."""
import numpy as np
import torch

from conditioned_diffusion_models_uad_torch import orchestrate as PO
from conditioned_diffusion_models_uad_torch.config import RunConfig
from conditioned_diffusion_models_uad_torch.data.datamodules import DataConfig
from conditioned_diffusion_models_uad_torch.eval import harness as PH
from conditioned_diffusion_models_uad_torch.eval.harness import EvalConfig
from conditioned_diffusion_models_uad_torch.models.tasks import DDPMTask, DDPMTaskConfig
from conditioned_diffusion_models_uad_torch.utils.convert_jax import convert_jax_ddpm_variables
from conditioned_diffusion_models_uad_tpu.data.synthetic import build_synthetic_root
from conditioned_diffusion_models_uad_tpu.models import tasks as jtasks
from test_golden_metrics import _ROWS, _SCALARS, GOLDEN, GOLDEN_ROWS, TINY

torch.set_num_threads(2)

TOL = 1e-6
COUNTS = ("TPPerVol", "FPPerVol", "lesionSizePerVol")


class _Null:
    def log_metrics(self, *a, **k):
        pass


def test_port_reproduces_golden_eval_metrics(tmp_path, monkeypatch):
    import jax

    root = build_synthetic_root(
        str(tmp_path / "data"), shape=(64, 64, 40), n_train=1, n_val=1,
        n_test=1, n_eval=3, eval_sets=("Brats21",), seed=0,
    )
    cfg = RunConfig(
        name="golden", seed=0, log_dir=str(tmp_path / "logs"), device="cpu",
        model=DDPMTaskConfig(**TINY),
        data=DataConfig(data_dir=root, image_dim=(64, 64, 40),
                        rescale_factor=2.0, testsets=("Brats21",)),
        eval=EvalConfig(save_output_images=False, volumes_per_call=2,
                        fused_dispatch=True),
    )
    cfg.eval.out_dir = cfg.run_dir
    variables = jax.device_get(jtasks.DDPMTask(jtasks.DDPMTaskConfig(**TINY)).init(
        jax.random.PRNGKey(cfg.seed)))
    task = DDPMTask(cfg.model, device="cpu", noise_impl="table")
    task.load_state_dict(convert_jax_ddpm_variables(variables, cfg.model))
    for mod in (PH, PO):
        monkeypatch.setattr(mod, "FUSED_MIN_VOXELS", 1000)
    preds = PO.evaluate(cfg, task, 0, _Null())

    worst = 0.0
    for stage in ("val", "test"):
        ev = preds[stage]["Brats21"]
        assert set(GOLDEN[stage]) == set(_SCALARS)
        for k, want in GOLDEN[stage].items():
            worst = max(worst, abs(float(ev[k]) - want))
            np.testing.assert_allclose(float(ev[k]), want, rtol=0, atol=TOL,
                                       err_msg=f"{stage}/{k}")
        for k in _ROWS:
            got = [float(v) for v in ev[k]]
            if k in COUNTS:
                assert got == GOLDEN_ROWS[stage][k], (stage, k)
                continue
            worst = max(worst, float(np.max(np.abs(np.subtract(got, GOLDEN_ROWS[stage][k])))))
            np.testing.assert_allclose(got, GOLDEN_ROWS[stage][k], rtol=0, atol=TOL,
                                       err_msg=f"{stage}/{k}")
    print("worst float gap", worst)
