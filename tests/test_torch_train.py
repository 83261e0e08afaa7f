"""The cDDPM train step: the port's DDPMTask.loss, its gradients and two
train_steps with Adam against the JAX package on the CPU, from the same
seeded weights, slices and random draws, in float32.

The JAX task runs the tiny config of tests/test_torch_reconstruct.py with its
noise_fn pinned to the hash-simplex Pallas path (interpret mode). Its draws
come from PRNG keys; the test reads the same draws out of those keys,
following the split structure of train/loop.py:153 (k_aug, k_loss),
models/tasks.py:270 (k_noise), diffusion/gaussian.py:244 (t) and
data/augment.py:205 (the augmentation), and hands them to the port as a
TrainDraws.

Tolerances (float32; XLA:CPU and oneDNN sum convolutions in other orders, and
training-mode BatchNorm divides by batch statistics of as few as 4 values,
which amplifies that): loss 1e-5 (measured 2.4e-7), reconstruction 1e-4
(2.5e-5), each gradient tensor 1e-3 of its largest entry (2.3e-4), running
statistics 1e-4 (1.8e-6). Adam moves a parameter by about lr*sign(gradient)
whatever the gradient's size, so an entry whose gradient is within rounding
of 0 can land up to 2*lr apart in the two runs (measured: 0.01% of entries
after one step). One step from a common state is held at 2*lr in the worst
entry, 1e-8 on average and 1e-4 of entries more than lr/10 apart (measured
2.0e-4, 2.9e-9, 2.7e-5). Two independent steps carry those entries into the
second forward, which moves its loss by 1.7e-5 and its update more widely:
4*lr, 2e-6, 2e-2 (measured 2.9e-4, 6.4e-7, 9.1e-3), loss and running
statistics 1e-4 and 5e-4 (1.7e-5, 8.0e-5)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conditioned_diffusion_models_uad_torch.models.tasks import (
    DDPMTask,
    DDPMTaskConfig,
    TrainDraws,
)
from conditioned_diffusion_models_uad_torch.train import loop
from conditioned_diffusion_models_uad_torch.utils.convert_jax import (
    convert_jax_adam_state,
    convert_jax_ddpm_params,
    convert_jax_ddpm_variables,
)
from conditioned_diffusion_models_uad_torch.utils.decisions import recorded_choices
from conditioned_diffusion_models_uad_torch.utils.random_init import randomize_
from conditioned_diffusion_models_uad_tpu.models import tasks as jtasks
from conditioned_diffusion_models_uad_tpu.ops.simplex import make_noise_fn
from conditioned_diffusion_models_uad_tpu.train import loop as jloop
from conditioned_diffusion_models_uad_tpu.utils.convert_torch import (
    convert_reference_ddpm_checkpoint,
)
from test_torch_augment import jax_draws

torch.set_num_threads(2)

TINY = dict(
    image_hw=(32, 32), cond_dim=16, encoder_backbone="resnet18",
    timesteps=20, unet_dim=64, num_res_blocks=1, channel_mult=(1, 2),
    attention_resolutions=(), test_timesteps=10, step_ensemble=(5, 10),
    dtype="float32",
)
B = 4
LR = 1e-4
TOL_LOSS = 1e-5
TOL_RECO = 1e-4
TOL_GRAD = 1e-3
# by steps since the two runs last shared their state:
# (loss, running stats, worst parameter, mean parameter, share beyond lr/10)
TOL_STEPS = {1: (TOL_LOSS, 1e-4, 2 * LR, 1e-8, 1e-4),
             2: (1e-4, 5e-4, 4 * LR, 2e-6, 2e-2)}
INT32_MAX = int(jnp.iinfo(jnp.int32).max)


def _port_task():
    return randomize_(DDPMTask(DDPMTaskConfig(**TINY), device="cpu"), 21)


def _jax_task():
    jtask = jtasks.DDPMTask(jtasks.DDPMTaskConfig(**TINY))
    jtask.noise_fn = make_noise_fn("simplex", impl="pallas")
    return jtask


def _jax_variables(task, jtask):
    """The port's weights as a reference-layout checkpoint -> JAX variables."""
    sd = {}
    for k, v in task.state_dict().items():
        name = "diffusion.model." + k[len("unet."):] if k.startswith("unet.") else k
        sd[name] = v.numpy().copy()
    return convert_reference_ddpm_checkpoint(sd, jtask)


def _slices(seed=9):
    return np.random.default_rng(seed).uniform(0, 1, size=(B, 32, 32, 1)).astype(np.float32)


def _data():
    """Volumes [V, H, W, D] and the [2, B] slice indices of two steps."""
    rng = np.random.default_rng(3)
    vols = rng.uniform(0, 1, size=(3, 32, 32, 6)).astype(np.float32)
    vi = np.array([[0, 1, 2, 1], [2, 0, 0, 1]], np.int32)
    si = np.array([[1, 4, 2, 5], [0, 3, 5, 2]], np.int32)
    return vols, vi, si


def loss_draws(k_loss, b, timesteps, aug_draws=None) -> TrainDraws:
    """The draws JAX ``DDPMTask.loss(variables, batch, k_loss)`` makes."""
    _k_enc, k_noise, k_diff, _k_box, _k_drop = jax.random.split(k_loss, 5)
    seed = int(jax.random.randint(k_noise, (), 0, INT32_MAX, jnp.int32))
    t_key, _ = jax.random.split(k_diff)
    t = np.asarray(jax.random.randint(t_key, (b,), 0, timesteps, dtype=jnp.int32))
    return TrainDraws(torch.from_numpy(t.astype(np.int64)),
                      torch.tensor([seed], dtype=torch.int32), aug_draws)


def step_draws(key, step, b, timesteps) -> TrainDraws:
    """The draws of JAX ``train_step(state, data, vi, si, key)`` at ``step``."""
    k_aug, k_loss = jax.random.split(jax.random.fold_in(key, step))
    return loss_draws(k_loss, b, timesteps, jax_draws(k_aug, b))


def _host(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), jax.device_get(tree))


# --------------------------------------------------------------------------- #
# the JAX side, computed once per module
# --------------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def _jax_loss_and_grad():
    jtask = _jax_task()
    v = _jax_variables(_port_task(), jtask)
    batch = {"vol": jnp.asarray(_slices())}
    key = jax.random.PRNGKey(11)

    def f(params):
        loss, (stats, aux) = jtask.loss({"params": params, "batch_stats": v["batch_stats"]},
                                        batch, key, train=True)
        return loss, (stats, aux["reco"])

    (loss, (stats, reco)), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(v["params"])
    val_loss, (_, val_aux) = jax.jit(lambda v: jtask.loss(v, batch, key, train=False))(v)
    return _host(dict(loss=loss, stats=stats, reco=reco, grads=grads, val_loss=val_loss,
                      val_reco=val_aux["reco"])), key


@functools.lru_cache(maxsize=None)
def _jax_two_steps():
    jtask = _jax_task()
    v = _jax_variables(_port_task(), jtask)
    trainer = jloop.Trainer(jtask, jloop.TrainerConfig())
    state = {"params": v["params"], "batch_stats": v["batch_stats"],
             "opt_state": trainer.tx.init(v["params"]), "step": jnp.zeros((), jnp.int32)}
    vols, vi, si = _data()
    data = (jnp.asarray(vols), jnp.asarray(vols > 0.5))
    key = jax.random.PRNGKey(17)
    states, losses = [], []
    for s in range(2):
        state, loss = trainer._train_step(state, data, jnp.asarray(vi[s]), jnp.asarray(si[s]),
                                          key)
        states.append(_host(state))
        losses.append(float(loss))
    return states, losses, key


# --------------------------------------------------------------------------- #
# tests
# --------------------------------------------------------------------------- #
def _port_loss(task, key, *, train=True):
    draws = loss_draws(key, B, task.cfg.timesteps)
    return task.loss({"vol": torch.from_numpy(_slices())}, draws, train=train)


def test_loss_matches_jax_train_mode():
    want, key = _jax_loss_and_grad()
    task = _port_task()
    loss, aux = _port_loss(task, key)
    assert loss.shape == () and aux["reco"].shape == (B, 32, 32, 1)
    np.testing.assert_allclose(loss.item(), want["loss"], atol=TOL_LOSS, rtol=TOL_LOSS)
    np.testing.assert_allclose(aux["reco"].detach().numpy(), want["reco"], atol=TOL_RECO,
                               rtol=0)
    # the encoder's running statistics moved as flax's batch_stats did
    sd = task.encoder.state_dict()
    got = {k: v for k, v in sd.items() if "running" in k}
    want_sd = convert_jax_ddpm_variables(
        {"params": _jax_variables(_port_task(), _jax_task())["params"],
         "batch_stats": {"encoder": want["stats"]["encoder"]}}, task.cfg)
    assert len(got) > 0
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), want_sd[f"encoder.{k}"].numpy(),
                                   atol=TOL_STEPS[1][1], rtol=TOL_STEPS[1][1])


def test_loss_matches_jax_validation_mode():
    want, key = _jax_loss_and_grad()
    task = _port_task()
    before = {k: v.clone() for k, v in task.encoder.state_dict().items()}
    with torch.no_grad():
        loss, aux = _port_loss(task, key, train=False)
    np.testing.assert_allclose(loss.item(), want["val_loss"], atol=TOL_LOSS, rtol=TOL_LOSS)
    np.testing.assert_allclose(aux["reco"].numpy(), want["val_reco"], atol=TOL_RECO, rtol=0)
    for k, v in task.encoder.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_gradients_match_jax_value_and_grad():
    want, key = _jax_loss_and_grad()
    task = _port_task()
    loss, _ = _port_loss(task, key)
    loss.backward()
    grads = convert_jax_ddpm_params(want["grads"], task.cfg)
    names = [n for n, _ in task.named_parameters()]
    assert sorted(names) == sorted(grads)
    for n, p in task.named_parameters():
        g = grads[n].numpy()
        scale = max(float(np.abs(g).max()), 1e-12)
        assert p.grad is not None, n
        err = float(np.abs(p.grad.numpy() - g).max())
        assert err <= TOL_GRAD * scale, (n, err, scale)


def _compare_state(task, jstate, steps_apart):
    _, tol_stats, tol_max, tol_mean, tol_share = TOL_STEPS[steps_apart]
    want = convert_jax_ddpm_variables(
        {"params": jstate["params"], "batch_stats": jstate["batch_stats"]}, task.cfg)
    got = task.state_dict()
    diffs = np.concatenate([np.abs(got[n].numpy() - want[n].numpy()).ravel()
                            for n, _ in task.named_parameters()])
    assert diffs.max() <= tol_max, diffs.max()
    assert diffs.mean() <= tol_mean, diffs.mean()
    assert (diffs > LR / 10).mean() <= tol_share, (diffs > LR / 10).mean()
    for k, v in got.items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=tol_stats,
                                       rtol=tol_stats)


def test_two_train_steps_match_jax_adam():
    jstates, jlosses, key = _jax_two_steps()
    task = _port_task()
    opt = loop.make_optimizer(task)
    vols, vi, si = _data()
    data = (torch.from_numpy(vols), torch.from_numpy(vols > 0.5))
    for s in range(2):
        draws = step_draws(key, s, B, task.cfg.timesteps)
        loss = loop.train_step(task, opt, data, vi[s], si[s], draws)
        tol_loss = TOL_STEPS[s + 1][0]
        np.testing.assert_allclose(loss.item(), jlosses[s], atol=tol_loss, rtol=tol_loss)
        _compare_state(task, jstates[s], s + 1)


def test_adam_state_conversion_continues_a_jax_run():
    """Step 2 of the port, started from JAX's state after step 1 (weights,
    batch statistics and Adam moments converted), matches JAX's step 2."""
    jstates, jlosses, key = _jax_two_steps()
    task = _port_task()
    s1 = jstates[0]
    task.load_state_dict(convert_jax_ddpm_variables(
        {"params": s1["params"], "batch_stats": s1["batch_stats"]}, task.cfg))
    opt = loop.make_optimizer(task)
    opt.load_state_dict(convert_jax_adam_state(s1["opt_state"], task, opt))
    assert float(opt.state_dict()["state"][0]["step"]) == 1.0
    vols, vi, si = _data()
    draws = step_draws(key, 1, B, task.cfg.timesteps)
    loss = loop.train_step(task, opt, (torch.from_numpy(vols), None), vi[1], si[1], draws)
    np.testing.assert_allclose(loss.item(), jlosses[1], atol=TOL_LOSS, rtol=TOL_LOSS)
    _compare_state(task, jstates[1], 1)


def test_val_step_and_gathered_batch():
    vols, vi, si = _data()
    data = (torch.from_numpy(vols), torch.from_numpy(vols > 0.5))
    batch = loop.gathered_batch(data, vi[0], si[0])
    want = np.stack([vols[v, :, :, s] for v, s in zip(vi[0], si[0])])[..., None]
    assert torch.equal(batch["vol"], torch.from_numpy(want))
    assert torch.equal(batch["mask"], torch.from_numpy(want > 0.5))
    task = _port_task()
    draws = task.draw_train(torch.Generator().manual_seed(0), B, augment=False)
    assert draws.aug is None and draws.seed.dtype == torch.int32
    assert 0 <= draws.t.min() and draws.t.max() < task.cfg.timesteps
    before = [p.clone() for p in task.parameters()]
    a = loop.val_step(task, data, vi[0], si[0], draws)
    b = task.loss(batch, draws, train=False)[0]
    assert torch.equal(a, b)
    assert all(torch.equal(p, q) for p, q in zip(task.parameters(), before))


def test_train_epoch_draws_per_step_and_reproduces():
    vols, vi, si = _data()
    data = (torch.from_numpy(vols), None)
    runs = []
    for _ in range(2):
        task = _port_task()
        opt = loop.make_optimizer(task)
        runs.append(loop.train_epoch(task, opt, data, vi, si,
                                     torch.Generator().manual_seed(5)))
    assert runs[0].shape == (2,) and bool(torch.isfinite(runs[0]).all())
    assert torch.equal(runs[0], runs[1])


def test_reconstruction_unchanged_by_training_mode_plumbing():
    """A loss in training mode puts the encoder back in the mode it found
    (eval, from ``__init__``), so the reconstruction after it uses the
    running statistics."""
    task = _port_task()
    slices = torch.from_numpy(_slices())
    seeds = torch.tensor([[7, 8]], dtype=torch.int32)
    reco0, _ = task.reconstruct_with_aux(slices, seeds)
    task.encoder.load_state_dict(_port_task().encoder.state_dict())
    with torch.no_grad():
        task.loss({"vol": slices}, task.draw_train(torch.Generator().manual_seed(1), B))
    assert not task.encoder.training
    task.encoder.load_state_dict(_port_task().encoder.state_dict())
    reco1, _ = task.reconstruct_with_aux(slices, seeds)
    assert not task.encoder.training
    assert torch.equal(reco0, reco1)


def test_diffusion_call_draws_t_from_a_generator():
    from conditioned_diffusion_models_uad_torch.diffusion import diffusion_call

    task = _port_task()
    x = torch.from_numpy(_slices())
    noise = torch.zeros_like(x)
    calls = []

    def model(xt, t, cond):
        calls.append(t.clone())
        return torch.zeros_like(xt)

    g1, g2 = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    diffusion_call(task.sched, task.gd_cfg, model, x, t=None, cond=None, noise=noise,
                   generator=g1)
    want = torch.randint(0, task.cfg.timesteps, (B,), generator=g2)
    assert torch.equal(calls[0], want)
    with pytest.raises(ValueError):
        diffusion_call(task.sched, task.gd_cfg, model, x, t=None, cond=None, noise=noise)


def test_dropout_in_training_is_not_ported():
    task = DDPMTask(DDPMTaskConfig(**{**TINY, "dropout_unet": 0.1}), device="cpu")
    draws = task.draw_train(torch.Generator().manual_seed(0), B)
    with pytest.raises(NotImplementedError):
        task.loss({"vol": torch.from_numpy(_slices())}, draws)


def _jax_encoder_choices(jtask, v, x):
    """The JAX encoder's ReLU masks and max-pool indices on ``x`` in training
    mode, in the port's call order (stem ReLU, max-pool, then each block's
    ReLUs) and layout (NCHW), read from its captured BatchNorm and block
    outputs (BasicBlock encoders)."""
    ev = {"params": v["params"]["encoder"], "batch_stats": v["batch_stats"]["encoder"]}
    _, mut = jtask.encoder.apply(ev, jnp.asarray(x), train=True, capture_intermediates=True,
                                 mutable=["batch_stats", "intermediates"])
    inter = mut["intermediates"]["backbone"]

    def out(mod):
        return torch.from_numpy(np.array(mod["__call__"][0])).permute(0, 3, 1, 2)

    stem = out(inter["stem_bn"])
    h, idx = torch.nn.functional.max_pool2d(torch.relu(stem), 3, 2, 1, return_indices=True)
    choices = [stem > 0, idx]
    for si in range(1, 5):
        for bi in range(2):
            blk = inter[f"stage{si}_block{bi}"]
            short = out(blk["down_bn"]) if "down_bn" in blk else h
            choices += [out(blk["bn1"]) > 0, out(blk["bn2"]) + short > 0]
            h = out(blk)
    return choices


@pytest.mark.slow
def test_full_width_loss_and_gradients_match_jax():
    """The flagship widths (96x96, UNet 128 channels, mult (1, 2, 2), cond
    128, the 4-head middle attention) with the depth cut to one res block and
    a resnet18 encoder, batch 2, float32: loss, reconstruction and every
    gradient as tight as the tiny config, with the port taking the JAX
    encoder's ReLU and max-pool choices. Left to choose, the port flips a few
    of the encoder's ~460k choices whose inputs lie within rounding of their
    threshold, and each flip moves whole encoder gradients by up to ~1e-2
    (utils/decisions.py); at most 1e-4 of them may differ."""
    cfg = dict(cond_dim=128, encoder_backbone="resnet18", num_res_blocks=1, dtype="float32")
    task = randomize_(DDPMTask(DDPMTaskConfig(**cfg), device="cpu"), 3)
    jtask = jtasks.DDPMTask(jtasks.DDPMTaskConfig(**cfg))
    jtask.noise_fn = make_noise_fn("simplex", impl="pallas")
    v = _jax_variables(task, jtask)
    x = np.random.default_rng(4).uniform(0, 1, size=(2, 96, 96, 1)).astype(np.float32)
    key = jax.random.PRNGKey(8)

    def f(params):
        loss, (_, aux) = jtask.loss({"params": params, "batch_stats": v["batch_stats"]},
                                    {"vol": jnp.asarray(x)}, key, train=True)
        return loss, aux["reco"]

    (want_loss, want_reco), want_grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        v["params"])
    with recorded_choices(_jax_encoder_choices(jtask, v, x), replay=True,
                          loss=False) as count:
        loss, aux = task.loss({"vol": torch.from_numpy(x)},
                              loss_draws(key, 2, task.cfg.timesteps))
        loss.backward()
    assert count["flipped"] <= 1e-4 * count["made"], count
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=TOL_LOSS, rtol=TOL_LOSS)
    np.testing.assert_allclose(aux["reco"].detach().numpy(), np.asarray(want_reco),
                               atol=TOL_RECO, rtol=0)
    grads = convert_jax_ddpm_params(_host(want_grads), task.cfg)
    rel = {}
    for n, p in task.named_parameters():
        g = torch.from_numpy(grads[n].numpy()).double()
        rel[n] = ((p.grad.double() - g).norm() / g.norm().clamp_min(1e-30)).item()
    worst = max((v, n) for n, v in rel.items())
    print(f"encoder choices {count}; worst gradient error {worst}")
    assert worst[0] <= TOL_GRAD, (worst, count)
