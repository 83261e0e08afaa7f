"""The port's ResNet conditioning encoder (conditioned_diffusion_models_uad_
torch/models/resnet.py) against the JAX ResNetEncoder in eval mode, on the
CPU, from the same seeded weights and running statistics (the port's
state_dict through the JAX package's convert_reference_resnet_state_dict).

Tolerance: float32 on both sides; XLA:CPU and oneDNN sum the convolutions in
different orders, which moves the [B, cond_dim] outputs (magnitude ~1) by a
few 1e-6 through 17-50 layers."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conditioned_diffusion_models_uad_torch.models.resnet import (
    MaskedBatchNorm,
    ResNetConfig,
    ResNetEncoder,
)
from conditioned_diffusion_models_uad_torch.utils.random_init import randomize_
from conditioned_diffusion_models_uad_tpu.models import resnet as jresnet
from conditioned_diffusion_models_uad_tpu.utils.convert_torch import (
    convert_reference_resnet_state_dict,
)

torch.set_num_threads(2)

COND_DIM = 16
TOL = 1e-4


@pytest.mark.parametrize("norm_precision", ["float32", "compute"])
@pytest.mark.parametrize("variant", ["resnet18", "resnet50"])
def test_encoder_matches_jax(variant, norm_precision):
    enc = ResNetEncoder(ResNetConfig(variant=variant, norm_precision=norm_precision),
                        cond_dim=COND_DIM)
    randomize_(enc, 11)
    enc.to(memory_format=torch.channels_last).eval()
    sd = {k: v.numpy() for k, v in enc.state_dict().items()}
    variables = convert_reference_resnet_state_dict(sd, variant, cond_dim=COND_DIM)
    x = np.random.default_rng(0).uniform(0, 1, size=(2, 32, 32, 1)).astype(np.float32)
    jmodel = jresnet.ResNetEncoder(
        jresnet.ResNetConfig(variant=variant, norm_precision=norm_precision),
        cond_dim=COND_DIM,
    )
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        variables, jnp.asarray(x)))
    with torch.no_grad():
        got = enc(torch.from_numpy(x)).numpy()
    assert got.shape == (2, COND_DIM) and got.dtype == np.float32
    assert want.std() > 0.05
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("fold_apply", [False, True])
def test_masked_batchnorm_eval_matches_flax(fold_apply):
    rng = np.random.default_rng(5)
    c = 8
    x = rng.normal(size=(2, 4, 4, c)).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
         "bias": rng.normal(0, 0.1, c).astype(np.float32)}
    s = {"mean": rng.normal(0, 0.2, c).astype(np.float32),
         "var": rng.uniform(1e-6, 1e-4, c).astype(np.float32)}  # eps 1e-5 matters
    want = np.asarray(jresnet.MaskedBatchNorm(fold_apply=fold_apply).apply(
        {"params": p, "batch_stats": s}, jnp.asarray(x)))
    bn = MaskedBatchNorm(c, fold_apply=fold_apply).eval()
    with torch.no_grad():
        for name, v in (("weight", p["scale"]), ("bias", p["bias"]),
                        ("running_mean", s["mean"]), ("running_var", s["var"])):
            getattr(bn, name).copy_(torch.from_numpy(v))
        got = bn(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)
    with pytest.raises(NotImplementedError):
        bn.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
