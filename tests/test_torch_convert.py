"""utils/convert_jax.py of the port: JAX-package variables -> the port's
state_dict. It is the exact inverse of the JAX package's
convert_reference_unet_state_dict / convert_reference_resnet_state_dict, so a
round trip JAX -> port -> JAX must give the original variables bitwise.
All leaves are perturbed from a numpy seed first, so no zero-initialised or
unit-initialised leaf can hide a swapped mapping."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conditioned_diffusion_models_uad_torch.models.tasks import DDPMTask, DDPMTaskConfig
from conditioned_diffusion_models_uad_torch.models.unet import UNetConfig, UNetModel
from conditioned_diffusion_models_uad_torch.utils.convert_jax import (
    convert_jax_ddpm_variables,
    convert_jax_resnet_variables,
    convert_jax_unet_params,
)
from conditioned_diffusion_models_uad_tpu.models import resnet as jresnet
from conditioned_diffusion_models_uad_tpu.models import tasks as jtasks
from conditioned_diffusion_models_uad_tpu.models import unet as junet
from conditioned_diffusion_models_uad_tpu.utils.convert_torch import (
    convert_reference_ddpm_checkpoint,
    convert_reference_resnet_state_dict,
    convert_reference_unet_state_dict,
)

torch.set_num_threads(2)

UNET = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
            attention_resolutions=(2,), cond_dim=16, num_head_channels=16)


def _perturb(tree, seed):
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    new = [np.asarray(x, np.float32) + rng.normal(0, 0.1, np.shape(x)).astype(np.float32)
           for x in leaves]
    return jax.tree_util.tree_unflatten(treedef, new)


def _assert_trees_equal(a, b):
    fa = jax.tree_util.tree_flatten_with_path(a)[0]
    fb = dict(jax.tree_util.tree_flatten_with_path(b)[0])
    assert len(fa) == len(fb)
    for path, x in fa:
        np.testing.assert_array_equal(np.asarray(fb[path]), np.asarray(x),
                                      err_msg=jax.tree_util.keystr(path))


def _unet_params(seed=0):
    jcfg = junet.UNetConfig(**UNET)
    x = jnp.zeros((1, 16, 16, 1))
    v = jax.jit(junet.UNetModel(jcfg).init)(
        jax.random.PRNGKey(seed), x, jnp.zeros((1,), jnp.int32), jnp.zeros((1, 16)))
    return jcfg, _perturb(v["params"], seed)


def test_unet_round_trip_bitwise():
    jcfg, params = _unet_params()
    sd = convert_jax_unet_params(params, UNetConfig(**UNET))
    model = UNetModel(UNetConfig(**UNET))
    model.load_state_dict(sd)  # strict: every port key is produced
    back = convert_reference_unet_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()}, jcfg)
    _assert_trees_equal(back["params"], params)


def test_unet_converted_forward_matches_jax():
    """Converted weights drive the same function (encoder/decoder attention
    sites included), in float32."""
    jcfg, params = _unet_params(seed=1)
    model = UNetModel(UNetConfig(**UNET))
    model.load_state_dict(convert_jax_unet_params(params, UNetConfig(**UNET)))
    model.to(memory_format=torch.channels_last).eval()
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (2, 16, 16, 1)).astype(np.float32)
    t = np.array([1, 9], np.int32)
    c = rng.normal(size=(2, 16)).astype(np.float32)
    want = np.asarray(junet.UNetModel(jcfg).apply({"params": params}, x, t, c))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(c))
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5, rtol=0)


@pytest.mark.parametrize("variant", ["resnet18", "resnet50"])
def test_resnet_round_trip_bitwise(variant):
    model = jresnet.ResNetEncoder(jresnet.ResNetConfig(variant=variant), cond_dim=16)
    v = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)))
    v = _perturb(jax.tree_util.tree_map(np.asarray, dict(v)), 3)
    sd = convert_jax_resnet_variables(v["params"], v["batch_stats"], variant)
    back = convert_reference_resnet_state_dict(
        {k: t.numpy() for k, t in sd.items()}, variant, cond_dim=16)
    _assert_trees_equal(back, v)


def test_ddpm_round_trip_through_port_task():
    cfg = dict(image_hw=(32, 32), cond_dim=16, encoder_backbone="resnet18",
               timesteps=20, unet_dim=32, num_res_blocks=1, channel_mult=(1, 2),
               attention_resolutions=(), test_timesteps=10, step_ensemble=(5, 10),
               dtype="float32")
    jtask = jtasks.DDPMTask(jtasks.DDPMTaskConfig(**cfg))
    variables = _perturb(jax.tree_util.tree_map(np.asarray, jtask.init(
        jax.random.PRNGKey(0))), 4)
    task = DDPMTask(DDPMTaskConfig(**cfg), device="cpu")
    task.load_state_dict(convert_jax_ddpm_variables(variables, task.cfg))
    sd = {}
    for k, v in task.state_dict().items():
        key = "diffusion.model." + k[5:] if k.startswith("unet.") else k
        sd[key] = v.numpy()
    _assert_trees_equal(convert_reference_ddpm_checkpoint(sd, jtask), variables)
