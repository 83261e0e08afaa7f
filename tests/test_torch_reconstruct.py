"""The slice as a whole: the port's DDPMTask.reconstruct_with_aux against the
JAX DDPMTask on the CPU, from the same seeded weights and noise seeds.

The JAX task runs a tiny config (tests/test_golden_metrics.py TINY with a
64-channel UNet, so the middle attention has 2 heads of 64) with its noise_fn
pinned to the hash-simplex Pallas path in interpret mode: the auto mode takes
the permutation-table path on the CPU, which the port does not implement.
The JAX task draws each field's seed as randint(key, (), 0, int32max) from
split(key, E)[m] (or split_keys(vol_keys, E)[m, v] for G grouped volumes);
the port takes those seeds explicitly.

Tolerance: float32 on both sides; convolution summation order (XLA:CPU vs
oneDNN) moves reconstructions in [0, 1] by ~1e-6 and the per-slice L1 loss by
less; 2e-5 leaves a margin."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conditioned_diffusion_models_uad_torch.models.tasks import DDPMTask, DDPMTaskConfig
from conditioned_diffusion_models_uad_torch.utils.random_init import randomize_
from conditioned_diffusion_models_uad_tpu.diffusion.gaussian import split_keys
from conditioned_diffusion_models_uad_tpu.models import tasks as jtasks
from conditioned_diffusion_models_uad_tpu.ops.simplex import make_noise_fn
from conditioned_diffusion_models_uad_tpu.utils.convert_torch import (
    convert_reference_ddpm_checkpoint,
)

torch.set_num_threads(2)

TINY = dict(
    image_hw=(32, 32), cond_dim=16, encoder_backbone="resnet18",
    timesteps=20, unet_dim=64, num_res_blocks=1, channel_mult=(1, 2),
    attention_resolutions=(), test_timesteps=10, step_ensemble=(5, 10),
    dtype="float32",
)
TOL = 2e-5
DEPTH = 4
INT32_MAX = int(jnp.iinfo(jnp.int32).max)


def _seed(key) -> int:
    return int(jax.random.randint(key, (), 0, INT32_MAX, jnp.int32))


def _port_task(**kw):
    task = DDPMTask(DDPMTaskConfig(**TINY, **kw), device="cpu")
    randomize_(task, 21)
    return task


def _jax_variables(task, jtask):
    """The port's weights as a reference-layout checkpoint -> JAX variables."""
    sd = {}
    for k, v in task.state_dict().items():
        if k.startswith("unet."):
            sd["diffusion.model." + k[len("unet."):]] = v.numpy()
        else:
            sd[k] = v.numpy()  # 'encoder.*'
    return convert_reference_ddpm_checkpoint(sd, jtask)


@functools.lru_cache(maxsize=None)
def _jax_reco(noise_ensemble: bool, groups: int):
    jtask = jtasks.DDPMTask(jtasks.DDPMTaskConfig(**TINY, noise_ensemble=noise_ensemble))
    jtask.noise_fn = make_noise_fn("simplex", impl="pallas")
    task = _port_task(noise_ensemble=noise_ensemble)
    variables = _jax_variables(task, jtask)
    slices = _slices()
    key = jax.random.PRNGKey(5)
    if groups > 1:
        key = jax.random.split(key, groups)
    reco, aux = jax.jit(jtask.reconstruct_with_aux)(variables, jnp.asarray(slices), key)
    return np.asarray(reco), {k: np.asarray(v) for k, v in aux.items()}, key


def _slices():
    rng = np.random.default_rng(9)
    return rng.uniform(0, 1, size=(DEPTH, 32, 32, 1)).astype(np.float32)


def _port_seeds(key, groups, e):
    """[G, E] seeds the JAX task draws from ``key``."""
    if groups == 1:
        if e == 1:
            return [[_seed(key)]]
        return [[_seed(k) for k in jax.random.split(key, e)]]
    if e == 1:
        return [[_seed(key[v])] for v in range(groups)]
    member = split_keys(key, e)  # [E, G, 2]
    return [[_seed(member[m, v]) for m in range(e)] for v in range(groups)]


def _compare(got, want):
    reco, aux = got
    want_reco, want_aux = want
    assert reco.shape == want_reco.shape == (DEPTH, 32, 32, 1)
    assert want_reco.std() > 0.05
    np.testing.assert_allclose(reco.numpy(), want_reco, atol=TOL, rtol=0)
    np.testing.assert_allclose(aux["loss_per_slice"].numpy(),
                               want_aux["loss_per_slice"], atol=TOL, rtol=TOL)
    np.testing.assert_allclose(aux["latent_per_slice"].numpy(),
                               want_aux["latent_per_slice"], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("noise_ensemble,groups", [(True, 1), (True, 2), (False, 2)])
def test_reconstruct_with_aux_matches_jax(noise_ensemble, groups):
    want_reco, want_aux, key = _jax_reco(noise_ensemble, groups)
    task = _port_task(noise_ensemble=noise_ensemble)
    e = task.cfg.ensemble_size
    seeds = torch.tensor(_port_seeds(key, groups, e), dtype=torch.int32)
    got = task.reconstruct_with_aux(torch.from_numpy(_slices()), seeds)
    _compare(got, (want_reco, want_aux))


def test_grouped_equals_per_volume_calls():
    """G = 2 grouped reconstruction equals two G = 1 calls, bitwise."""
    task = _port_task()
    slices = torch.from_numpy(_slices())
    seeds = torch.tensor([[101, 202], [303, 404]], dtype=torch.int32)
    reco, aux = task.reconstruct_with_aux(slices, seeds)
    half = DEPTH // 2
    for v in range(2):
        r, a = task.reconstruct_with_aux(slices[v * half:(v + 1) * half], seeds[v:v + 1])
        sl = slice(v * half, (v + 1) * half)
        assert torch.equal(reco[sl], r)
        for k in a:
            assert torch.equal(aux[k][sl], a[k])


def test_generator_seeds_and_entry_point_contract():
    task = _port_task()
    slices = torch.from_numpy(_slices())
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    r1 = task.reconstruct(slices, generator=g1, groups=2)
    seeds = task.draw_seeds(g2, groups=2)
    assert seeds.shape == (2, 2) and seeds.dtype == torch.int32
    assert torch.equal(r1, task.reconstruct(slices, seeds))
    with pytest.raises(ValueError):
        task.reconstruct(slices)
    with pytest.raises(ValueError):
        task.reconstruct(slices, torch.zeros((1, 3), dtype=torch.int32))


def test_default_device_is_cuda_and_never_silently_cpu():
    """With no device argument the task asks for CUDA; without a card that
    raises rather than running on the CPU."""
    if torch.cuda.is_available():
        assert DDPMTask(DDPMTaskConfig(**TINY)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            DDPMTask(DDPMTaskConfig(**TINY))
