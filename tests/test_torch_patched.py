"""The patched DDPM (pDDPM) and the unconditional UNet against the JAX
package on the CPU, float32, table simplex noise, the same keys and weights:
box_to_mask, the eval grids, paste_patches ('avg', 'cut'), the training box
draw, p_losses with a box, a brain mask and inpainting, the patched
``loss`` and its UNet gradients, ``reconstruct_patched_with_aux`` on two
grouped volumes, ``use_checkpoint`` (ResBlock recompute) and the
unconditional UNet converted from JAX variables by utils/convert_jax.py.

Tolerances: masks, grids and the 'cut' paste exact; the 'avg' paste
1e-6 (a sum over boxes in another order); p_losses with a fixed elementwise
model 1e-6 (FMA contraction in XLA:CPU); the UNet paths as
tests/test_torch_train.py and tests/test_torch_reconstruct.py hold them: loss
1e-5, reconstruction 1e-4, each gradient tensor 1e-3 of its largest entry,
or of 1e-4 of the network's largest gradient where that is more (a conv bias
in front of a GroupNorm of one channel a group has a gradient of 0 in exact
arithmetic: rounding noise of ~3e-9 here); the unconditional forward 1e-5;
use_checkpoint's loss and gradients bit-equal to the plain run."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conditioned_diffusion_models_uad_torch.diffusion import gaussian as PG
from conditioned_diffusion_models_uad_torch.models.tasks import (
    DDPMTask,
    DDPMTaskConfig,
    TrainDraws,
)
from conditioned_diffusion_models_uad_torch.ops import patch_sampling as PP
from conditioned_diffusion_models_uad_torch.utils import prng
from conditioned_diffusion_models_uad_torch.utils.convert_jax import convert_jax_ddpm_variables
from conditioned_diffusion_models_uad_torch.utils.random_init import randomize_
from conditioned_diffusion_models_uad_tpu.diffusion import gaussian as JG
from conditioned_diffusion_models_uad_tpu.models import tasks as jtasks
from conditioned_diffusion_models_uad_tpu.ops import patch_sampling as JP
from conditioned_diffusion_models_uad_tpu.utils.convert_torch import (
    convert_reference_ddpm_checkpoint,
)

torch.set_num_threads(2)

PTINY = dict(
    image_hw=(32, 32), condition=False, timesteps=20, unet_dim=32, num_res_blocks=1,
    channel_mult=(1, 2), attention_resolutions=(2,), test_timesteps=10,
    step_ensemble=(5, 10), noise_ensemble=False, dtype="float32", patched=True,
    patch_hw=(16, 16), inpaint=True, use_checkpoint=True,
)
B = 4


@functools.lru_cache(maxsize=None)
def _tasks(**kw):
    cfg = DDPMTaskConfig(**{**PTINY, **kw})
    task = randomize_(DDPMTask(cfg, device="cpu", noise_impl="table"), 8)
    # recompute changes no value: the JAX side runs without it
    jtask = jtasks.DDPMTask(jtasks.DDPMTaskConfig(**{**PTINY, **kw, "use_checkpoint": False}))
    sd = {("diffusion.model." + k[5:]) if k.startswith("unet.") else k: v.numpy().copy()
          for k, v in task.state_dict().items()}
    return task, jtask, convert_reference_ddpm_checkpoint(sd, jtask)


def test_box_to_mask_and_grids_equal():
    boxes = np.array([[0, 0, 16, 16], [5, 3, 21, 19], [20, 10, 32, 32], [31, 31, 32, 32]],
                     np.int32)
    got = PG.box_to_mask(torch.from_numpy(boxes), 32, 28)
    np.testing.assert_array_equal(got.numpy(), np.asarray(JG.box_to_mask(
        jnp.asarray(boxes), 32, 28)))
    for hw, p in (((96, 96), (48, 48)), ((96, 80), (48, 48)), ((50, 70), (16, 24)),
                  ((32, 32), (40, 40))):
        for eq in (True, False):
            np.testing.assert_array_equal(PP.grid_boxes(hw, p, eq), JP.grid_boxes(hw, p, eq))
        np.testing.assert_array_equal(PP.grid_boxes_cut(hw, p), JP.grid_boxes_cut(hw, p))
    assert PP.grid_boxes((96, 96), (48, 48)).shape == (4, 4)


@pytest.mark.parametrize("aggregate", ["avg", "cut"])
def test_paste_patches_matches_jax(aggregate):
    rng = np.random.default_rng(2)
    boxes = PP.grid_boxes((40, 40), (16, 16))  # overlapping 3x3 grid
    boxes = np.concatenate([boxes[:-1], [[2, 2, 3, 3]]]).astype(np.int32)  # a gap
    recos = rng.uniform(0, 1, (len(boxes), 3, 40, 40, 1)).astype(np.float32)
    orig = rng.uniform(0, 1, (3, 40, 40, 1)).astype(np.float32)
    got = PP.paste_patches(torch.from_numpy(recos), torch.from_numpy(orig), boxes, aggregate)
    want = np.asarray(JP.paste_patches(jnp.asarray(recos), jnp.asarray(orig),
                                       jnp.asarray(boxes), aggregate))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 if aggregate == "avg" else 0)


def test_sample_single_box_range():
    g = torch.Generator().manual_seed(0)
    boxes = PP.sample_single_box(g, 2000, (96, 80), (48, 32))
    assert boxes.dtype == torch.int32 and boxes.shape == (2000, 4)
    assert boxes[:, 0].min() == 0 and boxes[:, 0].max() == 80 - 32
    assert boxes[:, 1].min() == 0 and boxes[:, 1].max() == 96 - 48
    assert torch.equal(boxes[:, 2] - boxes[:, 0], torch.full((2000,), 32, dtype=torch.int32))
    assert torch.equal(boxes[:, 3] - boxes[:, 1], torch.full((2000,), 48, dtype=torch.int32))


@pytest.mark.parametrize("objective,inpaint,brain", [("pred_x0", True, False),
                                                     ("pred_x0", False, True),
                                                     ("pred_noise", True, False)])
def test_p_losses_box_brain_inpaint_match_jax(objective, inpaint, brain):
    task, jtask, _ = _tasks()
    rng = np.random.default_rng(3)
    x0 = rng.uniform(-1, 1, (B, 32, 32, 1)).astype(np.float32)
    noise = rng.normal(0, 1, (B, 32, 32, 1)).astype(np.float32)
    t = np.array([0, 4, 11, 19])
    box = PP.sample_single_box(torch.Generator().manual_seed(4), B, (32, 32), (16, 16))
    brain_mask = (rng.uniform(0, 1, (B, 32, 32, 1)) > 0.3).astype(np.float32)
    cfg = dict(objective=objective, loss_type="l1", inpaint=inpaint)

    def model(x, tt, cond):
        return x * (0.7 - 0.2 * x) + 0.01 * tt.reshape(-1, 1, 1, 1)

    got = PG.p_losses(task.sched, PG.GaussianDiffusionConfig(**cfg),
                      lambda x, tt, c: model(x, tt.float(), c),
                      torch.from_numpy(x0), torch.from_numpy(t), None, torch.from_numpy(noise),
                      box_mask=PG.box_to_mask(box, 32, 32),
                      brain_mask=torch.from_numpy(brain_mask) if brain else None, reduce=False)
    want = jax.jit(lambda a, n, m, bm: JG.p_losses(
        jtask.sched, JG.GaussianDiffusionConfig(**cfg),
        lambda x, tt, c: model(x, tt.astype(jnp.float32), c), a,
        jnp.asarray(t, jnp.int32), None, n, box_mask=m, brain_mask=bm, reduce=False))(
        jnp.asarray(x0), jnp.asarray(noise), JG.box_to_mask(jnp.asarray(box.numpy()), 32, 32),
        jnp.asarray(brain_mask) if brain else None)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)


def _jax_loss_draws(key, b, timesteps, image_hw, patch_hw):
    """What JAX ``DDPMTask.loss(variables, batch, key)`` draws: the noise key,
    t and the patch boxes (``sample_single_box``: x0 from the first half of
    ``split(k_box)``, y0 from the second)."""
    _k_enc, k_noise, k_diff, k_box, _k_drop = prng.split(np.asarray(key), 5)
    t = prng.randint(prng.split(k_diff)[0], (b,), 0, timesteps)
    kx, ky = prng.split(k_box)
    x0 = prng.randint(kx, (b,), 0, image_hw[1] - patch_hw[1] + 1)
    y0 = prng.randint(ky, (b,), 0, image_hw[0] - patch_hw[0] + 1)
    box = np.stack([x0, y0, x0 + patch_hw[1], y0 + patch_hw[0]], axis=1).astype(np.int32)
    return TrainDraws(torch.from_numpy(t.astype(np.int64)),
                      torch.from_numpy(k_noise.astype(np.int64))[None], None,
                      torch.from_numpy(box))


def test_patched_loss_and_gradients_match_jax():
    task, jtask, variables = _tasks()
    x01 = np.random.default_rng(5).uniform(0, 1, (B, 32, 32, 1)).astype(np.float32)
    key = jax.random.PRNGKey(13)

    def f(params):
        loss, (_, aux) = jtask.loss({"params": params, "batch_stats": {}},
                                    {"vol": jnp.asarray(x01)}, key, train=True)
        return loss, aux["reco"]

    (jloss, jreco), jgrads = jax.jit(jax.value_and_grad(f, has_aux=True))(variables["params"])
    draws = _jax_loss_draws(key, B, 20, (32, 32), (16, 16))
    task.zero_grad(set_to_none=True)
    loss, aux = task.loss({"vol": torch.from_numpy(x01)}, draws)
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= 1e-5
    np.testing.assert_allclose(aux["reco"].detach().numpy(), np.asarray(jreco), rtol=0,
                               atol=1e-4)
    want = convert_jax_ddpm_variables({"params": jax.device_get(jgrads), "batch_stats": {}},
                                      task.cfg)
    gmax = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for name, p in task.named_parameters():
        w = want[name].numpy()
        err = float(np.abs(p.grad.numpy() - w).max())
        assert err <= 1e-3 * max(float(np.abs(w).max()), 1e-4 * gmax), (name, err)


def test_use_checkpoint_leaves_loss_and_gradients_unchanged():
    task, _, _ = _tasks()
    plain = DDPMTask(dataclasses.replace(task.cfg, use_checkpoint=False), device="cpu",
                     noise_impl="table")
    plain.load_state_dict(task.state_dict())
    g = torch.Generator().manual_seed(6)
    draws = task.draw_train(g, B, augment=False)
    assert draws.box.shape == (B, 4) and draws.seed.shape == (1, 2)
    x01 = torch.rand((B, 32, 32, 1), generator=g)
    grads = []
    for t in (task, plain):
        t.zero_grad(set_to_none=True)
        loss, _ = t.loss({"vol": x01}, draws)
        loss.backward()
        grads.append((loss.detach(), [p.grad.clone() for p in t.parameters()]))
    assert torch.equal(grads[0][0], grads[1][0])
    assert all(torch.equal(a, b) for a, b in zip(grads[0][1], grads[1][1]))


def test_patched_reconstruction_matches_jax():
    """Two volumes of 3 slices under [2, 2] keys: 4 boxes of 16x16 at
    32x32, one chunk; the last box's loss, the zeros latent; and the second
    volume alone with its key reconstructs as in the group."""
    task, jtask, variables = _tasks()
    x01 = np.random.default_rng(7).uniform(0, 1, (6, 32, 32, 1)).astype(np.float32)
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(3), 2))
    reco, aux = task.reconstruct_patched_with_aux(torch.from_numpy(x01),
                                                  torch.from_numpy(keys.astype(np.int64)))
    jreco, jaux = jax.jit(jtask.reconstruct_patched_with_aux)(variables, jnp.asarray(x01),
                                                              jnp.asarray(keys))
    np.testing.assert_allclose(reco.numpy(), np.asarray(jreco), rtol=0, atol=1e-4)
    np.testing.assert_allclose(aux["loss_per_slice"].numpy(), np.asarray(jaux["loss_per_slice"]),
                               rtol=0, atol=1e-5)
    assert aux["latent_per_slice"].shape == (6, 1) and not aux["latent_per_slice"].any()
    alone = task.reconstruct_patched(torch.from_numpy(x01[3:]),
                                     torch.from_numpy(keys[1:].astype(np.int64)))
    np.testing.assert_allclose(alone.numpy(), reco[3:].numpy(), rtol=0, atol=2e-5)


def test_unconditional_unet_converts_and_matches_jax():
    """The DDPM baseline's UNet (condition=False: no encoder, no label
    embedding): JAX variables -> utils/convert_jax.py -> the port's state
    (the round trip from the port's weights is exact), and its forward."""
    task, jtask, variables = _tasks()
    assert "encoder" not in variables["params"] and variables["batch_stats"] == {}
    sd = convert_jax_ddpm_variables(jax.device_get(variables), task.cfg)
    assert sd.keys() == task.state_dict().keys()
    assert all(torch.equal(sd[k], v) for k, v in task.state_dict().items())
    assert task.encoder is None and not hasattr(task.unet, "label_emb")
    rng = np.random.default_rng(9)
    x = rng.uniform(-1, 1, (3, 32, 32, 1)).astype(np.float32)
    t = np.array([1, 7, 15])
    with torch.no_grad():
        got = task.unet(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    want = np.asarray(jax.jit(jtask._model_fn(variables))(jnp.asarray(x),
                                                         jnp.asarray(t, jnp.int32), None))
    assert want.std() > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
