"""The samplers of diffusion/gaussian.py and the iterative reconstruction of
models/tasks.py against the JAX package on the CPU, in float32, with the
same keys, the same table simplex noise (bit-equal, test_torch_simplex_table
.py) and the same random weights (the port's, carried into JAX through
utils/convert_torch.py): q_posterior, noise_for, p_sample_loop full and
truncated, ddim_sample full and truncated, interpolate, DDPMTask.sample and
reconstruct_with_aux with reco_mode 'ddim' / 'ancestral' on two grouped
volumes.

Tolerances: q_posterior within 1e-6 and the grouped noise bit-equal. One
UNet call differs by oneDNN's against XLA:CPU's summation order (4.4e-6 on
outputs of std 0.58 with these weights), and each step feeds the next
through coefficients that grow near t = 0, so a chain of up to 8 steps is
held at 5e-4 absolute on [0, 1] images and 1e-3 on the [-1, 1] interpolation
(measured worst 9.0e-5 and 9.3e-5); a volume alone against the same volume
in a group of two at 2e-5; the NaN loss sentinel exactly; the latent at
1e-5."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conditioned_diffusion_models_uad_torch.diffusion import gaussian as PG
from conditioned_diffusion_models_uad_torch.models.tasks import DDPMTask, DDPMTaskConfig
from conditioned_diffusion_models_uad_torch.utils.random_init import randomize_
from conditioned_diffusion_models_uad_tpu.diffusion import gaussian as JG
from conditioned_diffusion_models_uad_tpu.models import tasks as jtasks
from conditioned_diffusion_models_uad_tpu.utils.convert_torch import (
    convert_reference_ddpm_checkpoint,
)

torch.set_num_threads(2)

TINY = dict(
    image_hw=(32, 32), cond_dim=16, encoder_backbone="resnet18",
    timesteps=8, unet_dim=32, num_res_blocks=1, channel_mult=(1, 2),
    attention_resolutions=(2,), test_timesteps=5, step_ensemble=(2, 4),
    sampling_steps=3, dtype="float32",
)
TOL = 5e-4
B = 4


@functools.lru_cache(maxsize=None)
def _tasks(reco_mode="single_shot"):
    cfg = DDPMTaskConfig(**TINY, reco_mode=reco_mode)
    task = randomize_(DDPMTask(cfg, device="cpu", noise_impl="table"), 5)
    jtask = jtasks.DDPMTask(jtasks.DDPMTaskConfig(**TINY, reco_mode=reco_mode))
    sd = {("diffusion.model." + k[5:]) if k.startswith("unet.") else k: v.numpy().copy()
          for k, v in task.state_dict().items()}
    return task, jtask, convert_reference_ddpm_checkpoint(sd, jtask)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x01 = rng.uniform(0, 1, (B, 32, 32, 1)).astype(np.float32)
    cond = rng.normal(0, 1, (B, 16)).astype(np.float32)
    keys = rng.integers(0, 2**32, (2, 2), dtype=np.uint64).astype(np.uint32)
    return x01, cond, keys


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    assert err <= tol, err
    return err


def test_q_posterior_matches():
    task, jtask, _ = _tasks()
    rng = np.random.default_rng(1)
    x0 = rng.normal(0, 1, (6, 32, 32, 1)).astype(np.float32)
    xt = rng.normal(0, 1, (6, 32, 32, 1)).astype(np.float32)
    t = np.array([0, 1, 3, 5, 7, 2])
    got = PG.q_posterior(task.sched, torch.from_numpy(x0), torch.from_numpy(xt),
                         torch.from_numpy(t))
    want = jax.jit(lambda a, b, c: JG.q_posterior(jtask.sched, a, b, c))(
        jnp.asarray(x0), jnp.asarray(xt), jnp.asarray(t, jnp.int32))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)


def test_noise_for_grouped_equals_alone():
    """A grouped [G, 2] draw is each volume's [2] draw, block by block, and
    the JAX package's."""
    task, jtask, _ = _tasks()
    _, _, keys = _inputs()
    shape = (6, 32, 32, 1)
    got = PG.noise_for(task.key_noise, keys, shape)
    want = JG.noise_for(jtask.noise_fn, jnp.asarray(keys), shape)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for v in range(2):
        alone = PG.noise_for(task.key_noise, keys[v], (3, 32, 32, 1))
        assert torch.equal(got[3 * v:3 * v + 3], alone)


@pytest.mark.parametrize("sampler,start_t", [("ancestral", 0), ("ancestral", 5),
                                             ("ddim", 0), ("ddim", 6)])
def test_samplers_match_jax(sampler, start_t):
    task, jtask, variables = _tasks()
    x01, cond, keys = _inputs(start_t)
    x_start = x01 * 2 - 1
    shape = x01.shape
    common = dict(cond=torch.from_numpy(cond), start_t=start_t,
                  x_start=torch.from_numpy(x_start) if start_t else None)
    jcommon = dict(cond=jnp.asarray(cond), start_t=start_t,
                   x_start=jnp.asarray(x_start) if start_t else None,
                   noise_fn=jtask.noise_fn)
    model_fn = jtask._model_fn(variables)
    if sampler == "ddim":
        got = PG.ddim_sample(task.sched, task.gd_cfg, task.unet, shape, key=keys,
                             noise_fn=task.key_noise, sampling_timesteps=4, **common)
        want = JG.ddim_sample(jtask.sched, jtask.gd_cfg, model_fn, shape,
                              key=jnp.asarray(keys), sampling_timesteps=4, **jcommon)
    else:
        got = PG.p_sample_loop(task.sched, task.gd_cfg, task.unet, shape, key=keys,
                               noise_fn=task.key_noise, **common)
        want = JG.p_sample_loop(jtask.sched, jtask.gd_cfg, model_fn, shape,
                                key=jnp.asarray(keys), **jcommon)
    assert got.std() > 1e-3
    print(sampler, start_t, _close(got.numpy(), want))


def test_interpolate_and_task_sample_match_jax():
    task, jtask, variables = _tasks()
    x01, cond, keys = _inputs(7)
    x1, x2 = x01 * 2 - 1, x01[::-1].copy() * 2 - 1
    got = PG.interpolate(task.sched, task.gd_cfg, task.unet, torch.from_numpy(x1),
                         torch.from_numpy(x2), key=keys[0], noise_fn=task.key_noise, t=5,
                         lam=0.3, cond=torch.from_numpy(cond))
    want = JG.interpolate(jtask.sched, jtask.gd_cfg, jtask._model_fn(variables),
                          jnp.asarray(x1), jnp.asarray(x2), key=jnp.asarray(keys[0]), t=5,
                          lam=0.3, cond=jnp.asarray(cond), noise_fn=jtask.noise_fn)
    print("interpolate", _close(got.numpy(), want, 2 * TOL))  # [-1, 1] images
    got = task.sample(x01.shape, keys, cond=torch.from_numpy(cond),
                      x_start01=torch.from_numpy(x01), start_t=6, use_ddim=True,
                      sampling_timesteps=3)
    want = jtask.sample(variables, x01.shape, jnp.asarray(keys), cond=jnp.asarray(cond),
                        x_start01=jnp.asarray(x01), start_t=6, use_ddim=True,
                        sampling_timesteps=3)
    print("sample", _close(got.numpy(), want))


@pytest.mark.parametrize("mode", ["ddim", "ancestral"])
def test_iterative_reconstruction_matches_jax(mode):
    """Two volumes of 2 slices each under [2, 2] keys: the reconstruction,
    the NaN loss sentinel and the latent; and each volume alone with its own
    key reconstructs as it does in the group."""
    task, jtask, variables = _tasks(mode)
    x01, _, keys = _inputs(11)
    reco, aux = task.reconstruct_with_aux(torch.from_numpy(x01), torch.from_numpy(
        keys.astype(np.int64)))
    jreco, jaux = jtask.reconstruct_with_aux(variables, jnp.asarray(x01), jnp.asarray(keys))
    print(mode, _close(reco.numpy(), jreco))
    assert torch.isnan(aux["loss_per_slice"]).all() and np.isnan(jaux["loss_per_slice"]).all()
    _close(aux["latent_per_slice"].numpy(), jaux["latent_per_slice"], 1e-5)
    alone = task.reconstruct(torch.from_numpy(x01[2:]), torch.from_numpy(
        keys[1:].astype(np.int64)))
    _close(alone.numpy(), reco[2:].numpy(), 2e-5)
    assert task.cfg.reco_mode == mode and task.draws_keys
