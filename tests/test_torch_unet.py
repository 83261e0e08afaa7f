"""The port's UNet (conditioned_diffusion_models_uad_torch/models/unet.py)
against the JAX UNetModel on the same weights, on the CPU.

The port's modules get seeded random weights (every parameter, so no
zero-initialised head hides a layer), their state_dict goes through the JAX
package's convert_reference_unet_state_dict, and both packages run the same
numpy inputs. Small config: 64 channels, mult (1, 2), one res block, 32x32,
so the 16x16 middle attention has 2 heads of 64.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conditioned_diffusion_models_uad_torch.models.unet import (
    GroupNorm32,
    UNetConfig,
    UNetModel,
    timestep_embedding,
)
from conditioned_diffusion_models_uad_torch.utils.random_init import randomize_
from conditioned_diffusion_models_uad_tpu.models import unet as junet
from conditioned_diffusion_models_uad_tpu.utils.convert_torch import (
    convert_reference_unet_state_dict,
)

torch.set_num_threads(2)

SMALL = dict(model_channels=64, channel_mult=(1, 2), num_res_blocks=1,
             attention_resolutions=(), cond_dim=16)
# fp32: both sides compute the same ops in float32; XLA:CPU and oneDNN sum
# the convolutions and reductions in different orders, which moves outputs
# of magnitude ~1 (std ~0.5) by up to ~5e-6 in all.
TOL_FP32 = 3e-5
# bf16: every layer rounds its activations to bf16 (8 bits of mantissa, an
# ulp of 0.0078 at 1); the frameworks round at different places (a bias added
# before or after the rounding, fused elementwise chains), which leaves a
# mean difference of ~1 ulp and a worst pixel of ~8 ulps over the network.
TOL_BF16_MAX = 0.1
TOL_BF16_MEAN = 0.02


def _inputs(seed=0, b=2, hw=32):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, size=(b, hw, hw, 1)).astype(np.float32)
    t = np.array([3, 17][:b], np.int32)
    c = rng.normal(size=(b, SMALL["cond_dim"])).astype(np.float32)
    return x, t, c


@functools.lru_cache(maxsize=None)
def _jax_out(norm_precision, dtype):
    """JAX output (numpy) and the seeded port state_dict it was made from."""
    model = UNetModel(UNetConfig(**SMALL, norm_precision=norm_precision, dtype=dtype))
    randomize_(model, 7)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    jcfg = junet.UNetConfig(**SMALL, norm_precision=norm_precision, dtype=dtype)
    variables = convert_reference_unet_state_dict(sd, jcfg)
    x, t, c = _inputs()
    out = jax.jit(junet.UNetModel(jcfg).apply)(
        variables, jnp.asarray(x), jnp.asarray(t), jnp.asarray(c))
    return np.asarray(out), model.state_dict()


def _port_out(norm_precision, dtype, fused):
    _, sd = _jax_out(norm_precision, dtype)
    model = UNetModel(UNetConfig(**SMALL, norm_precision=norm_precision, dtype=dtype,
                                 fused_attention=fused))
    model.load_state_dict(sd)
    model.to(memory_format=torch.channels_last).eval()
    x, t, c = _inputs()
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t).long(), torch.from_numpy(c))
    return out.numpy()


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("norm_precision", ["float32", "compute"])
def test_unet_fp32_matches_jax(norm_precision, fused):
    want, _ = _jax_out(norm_precision, "float32")
    got = _port_out(norm_precision, "float32", fused)
    assert got.shape == want.shape == (2, 32, 32, 1)
    assert want.std() > 0.05  # not a constant image
    np.testing.assert_allclose(got, want, atol=TOL_FP32, rtol=0)


@pytest.mark.parametrize("norm_precision", ["float32", "compute"])
def test_unet_bf16_einsum_matches_jax(norm_precision):
    """bf16 with the einsum attention on both sides: CPU JAX always runs the
    einsum path (bf16 logits), which the fused kernel does not reproduce."""
    want, _ = _jax_out(norm_precision, "bfloat16")
    got = _port_out(norm_precision, "bfloat16", fused=False)
    diff = np.abs(got - want)
    assert diff.max() <= TOL_BF16_MAX, diff.max()
    assert diff.mean() <= TOL_BF16_MEAN, diff.mean()


def test_timestep_embedding_matches_jax():
    t = np.array([0, 1, 250, 999], np.int32)
    want = np.asarray(junet.timestep_embedding(jnp.asarray(t), 64))
    got = timestep_embedding(torch.from_numpy(t), 64).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("f32_apply", [True, False])
def test_groupnorm32_matches_jax(f32_apply):
    """Both GroupNorm modes, with their own eps (1e-6 flax, 1e-5 folded):
    the input's variance (~1e-5) is small enough for a wrong eps to show."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(2, 8, 8, 64)) * 3e-3).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    beta = rng.normal(0, 0.1, 64).astype(np.float32)
    mod = junet.GroupNorm32(f32_apply=f32_apply)
    v = {"params": {"GroupNorm_0": {"scale": gamma, "bias": beta}}}
    want = np.asarray(mod.apply(v, jnp.asarray(x)))
    gn = GroupNorm32(64, f32_apply=f32_apply)
    with torch.no_grad():
        gn.weight.copy_(torch.from_numpy(gamma))
        gn.bias.copy_(torch.from_numpy(beta))
        got = gn(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_unet_unported_options_raise():
    """The options that raised before they were ported now build and run
    (tests/test_torch_unet_variants.py holds them against the JAX UNet)."""
    x, t, c = _inputs()
    for kw in (dict(film_fold=True, norm_precision="compute"), dict(spatial_transformer=True),
               dict(resblock_updown=False), dict(use_scale_shift_norm=False)):
        model = UNetModel(UNetConfig(**SMALL, **kw)).eval()
        with torch.no_grad():
            out = model(torch.from_numpy(x), torch.from_numpy(t).long(), torch.from_numpy(c))
        assert out.shape == x.shape and torch.isfinite(out).all()
