"""The full-resolution cDDPM (``datamodule.rescale_factor=1``: IXI's 192x192
slices without the downsample) on the CPU: the port's config and the JAX
package's give the same model image size and the same middle-block sequence
length (48x48 = 2304 tokens, beyond what K2's S <= 576 tensor-core kernel
holds, so the card's bf16 attention takes ``attention_fwd_mma_long``); and a
tiny UNet whose middle block attends over more than 576 tokens (104x104
input, 26x26 = 676 at the middle) against the JAX UNet on the same weights,
the JAX side through its fused attention (the Pallas kernel in interpret
mode, as tests/test_attention_pallas.py runs it on the CPU; the JAX UNet
takes that path only on a TPU, so the test names the backend for its
module) and the port through ``fused_attention`` (the plain version on a
CPU tensor).

Weights: the JAX model's init with every leaf then drawn from a seeded numpy
generator, carried over by ``convert_jax_unet_params`` into a strict
``load_state_dict``; the JAX model runs jitted. Tolerances are the UNet
tests': float32 5e-6 of the output's largest magnitude (XLA:CPU and oneDNN
sum the convolutions in different orders); bfloat16 0.1 max / 0.02 mean
absolute (the frameworks round activations to bf16 at different places:
on this input 0.073 max and 0.0125 mean, outputs of std 0.54; the einsum
attention on both sides gives 0.083 and 0.0124)."""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conditioned_diffusion_models_uad_torch import config as P
from conditioned_diffusion_models_uad_torch.models.unet import UNetConfig, UNetModel
from conditioned_diffusion_models_uad_torch.ops.attention import MMA_MAX_SEQ, kernel_for
from conditioned_diffusion_models_uad_torch.utils.convert_jax import convert_jax_unet_params
from conditioned_diffusion_models_uad_tpu import config as J
from conditioned_diffusion_models_uad_tpu.models import unet as junet
from conditioned_diffusion_models_uad_tpu.ops import attention_pallas

torch.set_num_threads(2)

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")
FULLRES = ["datamodule.rescale_factor=1"]
TINY = dict(model_channels=32, channel_mult=(1, 2, 2), num_res_blocks=1,
            attention_resolutions=(), cond_dim=8, num_head_channels=64)
HW = 104  # the middle block at 26x26: S = 676
TOL_FP32_REL = 5e-6
TOL_BF16_MAX = 0.1
TOL_BF16_MEAN = 0.02


def middle_seq(cfg) -> int:
    """Tokens the middle block's attention takes: the image over the
    downsamples of a UNet with len(channel_mult) levels."""
    down = 2 ** (len(cfg.unet_config.channel_mult) - 1)
    h, w = cfg.image_hw
    return (h // down) * (w // down)


def test_fullres_config_matches_jax(monkeypatch):
    monkeypatch.setenv("DATA_DIR", "/data/here")
    tree = P.compose(CONFIGS, "cDDPM/DDPM_cond_spark_2D", FULLRES)
    assert tree == J.compose(CONFIGS, "cDDPM/DDPM_cond_spark_2D", FULLRES)
    got, want = P.materialize(tree).model, J.materialize(tree).model
    assert tuple(got.image_hw) == tuple(want.image_hw) == (192, 192)
    assert middle_seq(got) == middle_seq(want) == 2304
    assert got.dtype == want.dtype == "bfloat16"
    assert got.fused_attention and want.fused_attention
    # the flagship at rescale 2 stays at 96x96 and S = 576, K2's S <= 576 kernel
    flagship = P.materialize(P.compose(CONFIGS, "cDDPM/DDPM_cond_spark_2D", [])).model
    assert middle_seq(flagship) == MMA_MAX_SEQ
    head_dim = got.unet_config.num_head_channels
    assert kernel_for(torch.bfloat16, middle_seq(got), head_dim) == "mma_long"
    assert kernel_for(torch.bfloat16, middle_seq(flagship), head_dim) == "mma"


def randomize_jax_params(params, seed):
    """Every leaf from a seeded generator: kernels ~ N(0, 1/fan_in), norm
    scales ~ 1 + N(0, 0.2²), biases ~ N(0, 0.2²)."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name, shape = path[-1].key, np.shape(a)
        if name == "kernel":
            return (rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        if name == "scale":
            return (1 + 0.2 * rng.normal(size=shape)).astype(np.float32)
        return (0.2 * rng.normal(size=shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, params)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, size=(1, HW, HW, 1)).astype(np.float32)
    t = np.array([250], np.int32)
    c = rng.normal(size=(1, TINY["cond_dim"])).astype(np.float32)
    return x, t, c


class _OnTpu:
    """The jax module as ``models/unet.py`` sees it, with the backend named
    "tpu", so its AttentionBlock takes the fused Pallas path."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def default_backend():
        return "tpu"


@functools.lru_cache(maxsize=None)
def _params():
    """Seeded JAX params of the tiny UNet (numpy leaves; float32 in either
    compute dtype). Their shapes do not depend on the image size, so the
    init runs at 16x16."""
    jcfg = junet.UNetConfig(**TINY)
    x = jnp.zeros((1, 16, 16, 1), jnp.float32)
    t = jnp.zeros((1,), jnp.int32)
    c = jnp.zeros((1, TINY["cond_dim"]), jnp.float32)
    v = jax.jit(junet.UNetModel(jcfg).init)(jax.random.PRNGKey(0), x, t, c)
    return jax.tree_util.tree_map(np.asarray, randomize_jax_params(v["params"], 1))


@functools.lru_cache(maxsize=None)
def _jax_out(dtype):
    """The JAX UNet's output through its fused attention (interpret mode),
    and the params it ran with."""
    jcfg = junet.UNetConfig(**TINY, fused_attention=True, dtype=dtype)
    x, t, c = (jnp.asarray(a) for a in _inputs())
    params = _params()
    mp = pytest.MonkeyPatch()
    calls = []
    fused = attention_pallas.fused_attention

    def interpret(qkv):
        calls.append(qkv.shape)
        return fused(qkv, True)

    try:
        mp.setattr(junet, "jax", _OnTpu())
        mp.setattr(attention_pallas, "fused_attention", interpret)
        out = jax.jit(junet.UNetModel(jcfg).apply)({"params": params}, x, t, c)
    finally:
        mp.undo()
    assert calls == [(1, (HW // 4) ** 2, 3, 1, 64)], calls  # the middle block's, S = 676
    return np.asarray(out, np.float32), params


def _port_out(dtype):
    want, params = _jax_out(dtype)
    pcfg = UNetConfig(**TINY, fused_attention=True, dtype=dtype)
    model = UNetModel(pcfg)
    model.load_state_dict(convert_jax_unet_params(params, pcfg), strict=True)
    model.to(memory_format=torch.channels_last).eval()
    x, t, c = _inputs()
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t).long(), torch.from_numpy(c))
    return got.float().numpy(), want


def test_tiny_unet_beyond_576_tokens_fp32_matches_jax_fused():
    got, want = _port_out("float32")
    assert got.shape == want.shape == (1, HW, HW, 1)
    assert (HW // 4) ** 2 > MMA_MAX_SEQ
    scale = np.abs(want).max()
    assert want.std() > 0.05
    np.testing.assert_allclose(got, want, atol=TOL_FP32_REL * scale, rtol=0)


def test_tiny_unet_beyond_576_tokens_bf16_matches_jax_fused():
    got, want = _port_out("bfloat16")
    assert kernel_for(torch.bfloat16, (HW // 4) ** 2, 64) == "mma_long"
    diff = np.abs(got - want)
    assert diff.max() <= TOL_BF16_MAX, diff.max()
    assert diff.mean() <= TOL_BF16_MEAN, diff.mean()
