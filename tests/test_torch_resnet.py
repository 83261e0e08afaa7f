"""The port's ResNet conditioning encoder (conditioned_diffusion_models_uad_
torch/models/resnet.py) against the JAX ResNetEncoder in eval and training
mode, on the CPU, from the same seeded weights and running statistics (the
port's state_dict through the JAX package's convert_reference_resnet_state_dict).

Tolerance: float32 on both sides; XLA:CPU and oneDNN sum the convolutions in
different orders, which moves the [B, cond_dim] outputs (magnitude ~1) by a
few 1e-6 through 17-50 layers. In training mode each layer is normalised by
its batch statistics, over as few as B = 4 values at the last stage, which
amplifies those differences (measured 8e-5 at resnet18): 2e-4."""
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
TOL_TRAIN = 2e-4


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
    # eval mode leaves the running statistics alone
    np.testing.assert_array_equal(bn.running_mean.numpy(), s["mean"])
    np.testing.assert_array_equal(bn.running_var.numpy(), s["var"])


def _bn_inputs(seed, c=8, shape=(3, 5, 4)):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.4, 2.0, size=(*shape, c)).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
         "bias": rng.normal(0, 0.1, c).astype(np.float32)}
    s = {"mean": rng.normal(0, 0.2, c).astype(np.float32),
         "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
    return x, p, s


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fold_apply", [False, True])
def test_masked_batchnorm_train_matches_flax(fold_apply, dtype):
    """Batch mean and biased variance, flax's 0.9 momentum update, applied in
    f32 or folded; bf16 tolerance is one bf16 ulp of outputs ~4."""
    x, p, s = _bn_inputs(6)
    c = x.shape[-1]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want, mut = jresnet.MaskedBatchNorm(fold_apply=fold_apply, dtype=jdt).apply(
        {"params": p, "batch_stats": s}, jnp.asarray(x, jdt),
        use_running_average=False, mutable=["batch_stats"])
    bn = MaskedBatchNorm(c, fold_apply=fold_apply, dtype=tdt).train()
    with torch.no_grad():
        for name, v in (("weight", p["scale"]), ("bias", p["bias"]),
                        ("running_mean", s["mean"]), ("running_var", s["var"])):
            getattr(bn, name).copy_(torch.from_numpy(v))
        got = bn(torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(mut["batch_stats"]["mean"]),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(mut["batch_stats"]["var"]),
                               atol=1e-6, rtol=1e-6)


def test_masked_batchnorm_train_gradient_matches_flax():
    """Gradients flow through the batch statistics, as under jax.grad."""
    x, p, s = _bn_inputs(7)
    c = x.shape[-1]
    cot = np.random.default_rng(8).normal(size=x.shape).astype(np.float32)

    def f(p, x):
        y, _ = jresnet.MaskedBatchNorm().apply(
            {"params": p, "batch_stats": s}, x, use_running_average=False,
            mutable=["batch_stats"])
        return jnp.sum(y * cot)

    gp, gx = jax.grad(f, argnums=(0, 1))(p, jnp.asarray(x))
    bn = MaskedBatchNorm(c).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(p["scale"]))
        bn.bias.copy_(torch.from_numpy(p["bias"]))
    xt = torch.from_numpy(x).requires_grad_(True)
    (bn(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1) * torch.from_numpy(cot)).sum().backward()
    for got, want in ((xt.grad, gx), (bn.weight.grad, gp["scale"]), (bn.bias.grad, gp["bias"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("norm_precision", ["float32", "compute"])
def test_encoder_train_mode_matches_jax(norm_precision):
    """resnet18 in training mode: outputs and every updated running stat."""
    variant = "resnet18"
    enc = ResNetEncoder(ResNetConfig(variant=variant, norm_precision=norm_precision),
                        cond_dim=COND_DIM)
    randomize_(enc, 12)
    enc.to(memory_format=torch.channels_last)
    # copies: the forward below updates the running statistics in place
    sd = {k: v.numpy().copy() for k, v in enc.state_dict().items()}
    variables = convert_reference_resnet_state_dict(sd, variant, cond_dim=COND_DIM)
    x = np.random.default_rng(1).uniform(0, 1, size=(4, 32, 32, 1)).astype(np.float32)
    jmodel = jresnet.ResNetEncoder(
        jresnet.ResNetConfig(variant=variant, norm_precision=norm_precision),
        cond_dim=COND_DIM,
    )
    want, mut = jax.jit(lambda v, x: jmodel.apply(v, x, train=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = enc.train()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL_TRAIN, rtol=TOL_TRAIN)
    sd_after = {k: v.numpy() for k, v in enc.state_dict().items()}
    want_vars = convert_reference_resnet_state_dict(sd_after, variant, cond_dim=COND_DIM)
    flat_want = jax.tree_util.tree_leaves_with_path(mut["batch_stats"])
    flat_got = dict(jax.tree_util.tree_leaves_with_path(want_vars["batch_stats"]))
    assert len(flat_want) == len(flat_got) > 0
    for path, v in flat_want:
        np.testing.assert_allclose(flat_got[path], np.asarray(v), atol=1e-5, rtol=1e-5)
