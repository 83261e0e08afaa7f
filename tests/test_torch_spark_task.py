"""The port's SparkTask (models/tasks.py), its AdamW step (train/loop.py),
its eval reconstruction and the encoder import against the JAX package on the
CPU, at the tiny SparK config of the JAX package's own tests (resnet18,
64x64, dec_dim 64, float32), from JAX-initialised weights carried over by
utils/convert_jax.py. The JAX task draws its mask from a key; the test
reads that mask out of the key (train/loop.py:153's split, then
models/tasks.py's) and hands it to the port in a SparkDraws, with the
intensity augmentation's draws read the same way.

The gradient is piecewise: the encoder's ReLUs and max-pool, the decoder's
ReLU6 and the full-image L1 each choose by the sign (or the largest) of an
input, and at this size a change of 1e-7 in the slices flips enough of them
to move gradient tensors by 2e-3 (masked loss) to 9e-3 (with the L1) at
batch 4, in the port alone. So the port replays the JAX run's choices
(utils/decisions.py), read from its captured BatchNorm outputs and its
reconstruction, and at most 1e-3 of them may differ from the port's own.

Tolerances (float32; XLA:CPU and oneDNN sum convolutions in other orders,
and training-mode BatchNorm over 4-16 active values amplifies that): loss
1e-5 relative (measured 1e-7), reconstruction 2e-4 of its largest value,
each gradient tensor 1e-3 norm-relative, running statistics 1e-4. One AdamW
step from a common state: AdamW moves an entry by about lr whatever its
gradient's size, so an entry whose gradient lies within rounding of 0 can
land up to 2 lr apart (masked convolutions leave many weight gradients near
0); held at 2 lr in the worst entry, 1e-3 of entries more than lr / 10 apart
and so lr * 1e-3 on average (measured 4.0e-4, 1.8e-4 and 4.4e-8). The AdamW
arithmetic alone, each of three steps from the same parameter and gradient:
2.4e-7 relative (two float32 roundings: torch scales the parameter by
1 - lr wd, optax adds lr wd p to the update). Eval reconstructions 1e-5 of the largest value, and
per-slice losses 1e-5 relative. The encoder import: exact. Batch 8: at batch
4 the level-0 BatchNorm normalises one active site a sample, 4 values, and a
change of 1e-7 in the slices moves the replayed gradients by up to 1e-3 in
the port alone."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from conditioned_diffusion_models_uad_torch import orchestrate as PO
from conditioned_diffusion_models_uad_torch.models.tasks import (
    DDPMTask,
    DDPMTaskConfig,
    SparkDraws,
    SparkTask,
    SparkTaskConfig,
    import_spark_encoder,
)
from conditioned_diffusion_models_uad_torch.models.resnet import upsample_mask
from conditioned_diffusion_models_uad_torch.train import loop
from conditioned_diffusion_models_uad_torch.utils.convert_jax import (
    convert_jax_ddpm_variables,
    convert_jax_spark_variables,
)
from conditioned_diffusion_models_uad_torch.utils.decisions import recorded_choices
from conditioned_diffusion_models_uad_torch.utils.random_init import randomize_
from conditioned_diffusion_models_uad_tpu.data.augment import aug_intensity_batch
from conditioned_diffusion_models_uad_tpu.models import spark as jspark
from conditioned_diffusion_models_uad_tpu.models import tasks as jtasks
from conditioned_diffusion_models_uad_tpu.train import loop as jloop
from conditioned_diffusion_models_uad_tpu.utils.convert_torch import (
    convert_reference_ddpm_checkpoint,
    import_reference_spark_encoder,
)
from test_torch_augment import jax_draws
from test_torch_spark import _perturb

torch.set_num_threads(2)

CFG = dict(image_hw=(64, 64), backbone="resnet18", dec_dim=64, dtype="float32")
DDPM_TINY = dict(image_hw=(64, 64), cond_dim=16, encoder_backbone="resnet18", timesteps=20,
                 unet_dim=32, num_res_blocks=1, channel_mult=(1, 2),
                 attention_resolutions=(), test_timesteps=10, step_ensemble=(5, 10),
                 dtype="float32")
B = 8
LR = SparkTaskConfig().lr
TOL_LOSS = 1e-5
TOL_RECO = 2e-4
TOL_GRAD = 1e-3
TOL_STATS = 1e-4
TOL_FLIPPED = 1e-3


def _host(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), jax.device_get(tree))


@functools.lru_cache(maxsize=None)
def _jax_variables():
    jtask = jtasks.SparkTask(jtasks.SparkTaskConfig(**CFG))
    return _host(_perturb(jtask.init(jax.random.PRNGKey(0), batch_size=B), 7))


def _port_task(**kw):
    task = SparkTask(SparkTaskConfig(**{**CFG, **kw}), device="cpu")
    v = _jax_variables()
    sd = convert_jax_spark_variables(v["params"], v["batch_stats"], task.scfg)
    task.load_state_dict({f"model.{k}": t for k, t in sd.items()})
    return task


def _port_state(task):
    """The port task's state as the JAX tree's state_dict (for comparing)."""
    return {k[len("model."):]: t for k, t in task.state_dict().items()}


def _data():
    rng = np.random.default_rng(3)
    vols = rng.uniform(0, 1, size=(3, 64, 64, 6)).astype(np.float32)
    vi = np.array([0, 1, 2, 1, 0, 2, 2, 1], np.int32)
    si = np.array([1, 4, 2, 5, 0, 3, 5, 2], np.int32)
    return vols, vi, si


def _jax_choices(jtask, v, x, active):
    """The JAX SparK model's piecewise choices on ``x`` in training mode, in
    the port's call order and NCHW layout: the stem's ReLU and max-pool, each
    BasicBlock's two ReLUs, each decoder stage's ReLU6 (at 0), then, when the
    loss has the full-image L1, its error signs."""
    _, mut = jtask.model.apply(v, jnp.asarray(x), jnp.asarray(active), train=True,
                               capture_intermediates=True,
                               mutable=["batch_stats", "intermediates"])
    inter = mut["intermediates"]

    def out(mod):
        return torch.from_numpy(np.array(mod["__call__"][0])).permute(0, 3, 1, 2)

    enc = inter["encoder"]
    stem = out(enc["stem_bn"])
    h, idx = torch.nn.functional.max_pool2d(torch.relu(stem), 3, 2, 1, return_indices=True)
    h = h * upsample_mask(torch.from_numpy(np.asarray(active)), h.shape[2], h.shape[3])
    choices = [stem > 0, idx]
    for si in range(1, 5):
        for bi in range(2):
            blk = enc[f"stage{si}_block{bi}"]
            short = out(blk["down_bn"]) if "down_bn" in blk else h
            choices += [out(blk["bn1"]) > 0, out(blk["bn2"]) + short > 0]
            h = out(blk)
    choices += [out(inter["decoder"][f"stage{i}"]["block"]["bn1"]) > 0 for i in range(5)]
    if not jtask.cfg.loss_on_mask:
        reco = np.asarray(inter["__call__"][0])
        choices.append(torch.from_numpy(np.sign(reco - x)).to(torch.int8))
    return choices


def _mask_of(k_loss, scfg):
    """The active grid JAX ``SparkTask.loss(variables, batch, k_loss)`` draws."""
    k_mask, _ = jax.random.split(k_loss)
    return np.asarray(jspark.random_mask(k_mask, B, scfg.fmap_size, scfg.len_keep))


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grad(loss_on_mask=True):
    jtask = jtasks.SparkTask(jtasks.SparkTaskConfig(**CFG, loss_on_mask=loss_on_mask))
    v = _jax_variables()
    x = np.random.default_rng(9).uniform(0, 1, (B, 64, 64, 1)).astype(np.float32)
    key = jax.random.PRNGKey(11)

    def f(params):
        loss, (stats, aux) = jtask.loss({"params": params, "batch_stats": v["batch_stats"]},
                                        {"vol": jnp.asarray(x)}, key, train=True)
        return loss, (stats, aux["reco"], aux["active"])

    (loss, (stats, reco, active)), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        v["params"])
    val_loss, (_, val_aux) = jax.jit(lambda v: jtask.loss(
        v, {"vol": jnp.asarray(x)}, key, train=False))(v)
    out = _host(dict(loss=loss, stats=stats, reco=reco, active=active, grads=grads,
                     val_loss=val_loss, val_reco=val_aux["reco"]))
    out["choices"] = _jax_choices(jtask, v, x, out["active"])
    return out, x


@functools.lru_cache(maxsize=None)
def _jax_one_step():
    jtask = jtasks.SparkTask(jtasks.SparkTaskConfig(**CFG))
    v = _jax_variables()
    trainer = jloop.Trainer(jtask, jloop.TrainerConfig())
    state = {"params": v["params"], "batch_stats": v["batch_stats"],
             "opt_state": trainer.tx.init(v["params"]), "step": jnp.zeros((), jnp.int32)}
    vols, vi, si = _data()
    key = jax.random.PRNGKey(17)
    state, loss = trainer._train_step(state, (jnp.asarray(vols), jnp.asarray(vols > 0.5)),
                                      jnp.asarray(vi), jnp.asarray(si), key)
    k_aug, k_loss = jax.random.split(jax.random.fold_in(key, 0))
    active = _mask_of(k_loss, jtask.cfg.spark_config)
    x = np.asarray(aug_intensity_batch(k_aug, jnp.asarray(vols[vi, :, :, si][..., None])))
    return (_host(state), float(loss), SparkDraws(torch.from_numpy(active), jax_draws(k_aug, B)),
            _jax_choices(jtask, v, x, active))


@pytest.mark.parametrize("loss_on_mask", [True, False])
def test_loss_reco_stats_and_gradients_match_jax(loss_on_mask):
    want, x = _jax_loss_and_grad(loss_on_mask)
    task = _port_task(loss_on_mask=loss_on_mask)
    draws = SparkDraws(torch.from_numpy(want["active"]))
    with recorded_choices(list(want["choices"]), replay=True) as count:
        loss, aux = task.loss({"vol": torch.from_numpy(x)}, draws)
        loss.backward()
    assert count["flipped"] <= TOL_FLIPPED * count["made"], count
    np.testing.assert_allclose(loss.item(), want["loss"], rtol=TOL_LOSS, atol=0)
    reco = aux["reco"].detach().numpy()
    np.testing.assert_allclose(reco, want["reco"], atol=TOL_RECO * np.abs(want["reco"]).max(),
                               rtol=0)
    v = _jax_variables()
    want_sd = convert_jax_spark_variables(v["params"], want["stats"], task.scfg)
    for k, t in _port_state(task).items():
        if "running" in k:
            np.testing.assert_allclose(t.numpy(), want_sd[k].numpy(), atol=TOL_STATS,
                                       rtol=TOL_STATS)
    grads = convert_jax_spark_variables(want["grads"], None, task.scfg)
    names = [n for n, _ in task.named_parameters()]
    assert sorted(n[len("model."):] for n in names) == sorted(grads)
    worst = 0.0
    for n, p in task.named_parameters():
        g = grads[n[len("model."):]].double()
        rel = ((p.grad.double() - g).norm() / g.norm().clamp_min(1e-30)).item()
        assert rel <= TOL_GRAD, (n, rel)
        worst = max(worst, rel)
    print("worst gradient", worst, count)


def test_validation_loss_matches_jax_and_leaves_stats():
    want, x = _jax_loss_and_grad(True)
    task = _port_task()
    before = {k: t.clone() for k, t in task.state_dict().items()}
    with torch.no_grad():
        loss, aux = task.loss({"vol": torch.from_numpy(x)},
                              SparkDraws(torch.from_numpy(want["active"])), train=False)
    np.testing.assert_allclose(loss.item(), want["val_loss"], rtol=TOL_LOSS, atol=0)
    np.testing.assert_allclose(aux["reco"].numpy(), want["val_reco"],
                               atol=1e-5 * np.abs(want["val_reco"]).max(), rtol=0)
    assert all(torch.equal(t, before[k]) for k, t in task.state_dict().items())
    assert not task.training and not task.model.training


def test_one_train_step_matches_jax_adamw():
    jstate, jloss, draws, choices = _jax_one_step()
    task = _port_task()
    opt = loop.make_optimizer(task)
    assert isinstance(opt, torch.optim.AdamW)
    assert opt.defaults["betas"] == (0.9, 0.95) and opt.defaults["weight_decay"] == 0.05
    vols, vi, si = _data()
    with recorded_choices(list(choices), replay=True) as count:
        loss = loop.train_step(task, opt, (torch.from_numpy(vols),
                                           torch.from_numpy(vols > 0.5)), vi, si, draws)
    assert count["flipped"] <= TOL_FLIPPED * count["made"], count
    np.testing.assert_allclose(loss.item(), jloss, rtol=TOL_LOSS, atol=0)
    want = convert_jax_spark_variables(jstate["params"], jstate["batch_stats"], task.scfg)
    got = _port_state(task)
    diffs = np.concatenate([np.abs(got[n[len("model."):]].numpy()
                                   - want[n[len("model."):]].numpy()).ravel()
                            for n, _ in task.named_parameters()])
    assert diffs.max() <= 2 * LR, diffs.max()
    assert diffs.mean() <= LR * 1e-3, diffs.mean()
    assert (diffs > LR / 10).mean() <= 1e-3, (diffs > LR / 10).mean()
    for k, t in got.items():
        if "running" in k:
            np.testing.assert_allclose(t.numpy(), want[k].numpy(), atol=TOL_STATS,
                                       rtol=TOL_STATS)


def test_adamw_arithmetic_matches_optax():
    """Three steps of the port's AdamW and optax.adamw on the same
    parameters and gradients: the update rule, decay on the pre-step
    parameter included."""
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(50,)).astype(np.float32)
    grads = [rng.normal(scale=s, size=(50,)).astype(np.float32) for s in (1.0, 1e-3, 10.0)]
    tx = optax.adamw(2e-4, b1=0.9, b2=0.95, weight_decay=0.05)
    jp, st = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    task = torch.nn.Module()
    task.w = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    task.cfg = SparkTaskConfig()
    opt = loop.make_optimizer(task)
    for g in grads:
        with torch.no_grad():  # each step from the same parameter
            task.w.copy_(torch.from_numpy(np.asarray(jp)))
        upd, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, upd)
        task.w.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(task.w.detach().numpy(), np.asarray(jp), atol=1e-9,
                                   rtol=2.4e-7)


@pytest.mark.parametrize("loss_on_mask", [True, False])
def test_reconstruct_with_aux_matches_jax(loss_on_mask):
    """Two volumes of 5 slices stacked, each masked from its own key
    fold_in(key, i): reconstruction and per-slice loss (masked; or L1_AE sum
    + delta_mask times masked), and the empty latent column."""
    kw = dict(loss_on_mask=loss_on_mask, delta_mask=0.5)
    jtask = jtasks.SparkTask(jtasks.SparkTaskConfig(**CFG, **kw))
    v = _jax_variables()
    x = np.random.default_rng(5).uniform(0, 1, (10, 64, 64, 1)).astype(np.float32)
    key = jax.random.PRNGKey(4141)
    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(3, 5))
    reco_w, aux_w = jax.jit(jtask.reconstruct_with_aux)(v, jnp.asarray(x), keys)
    task = _port_task(**kw)
    keys_p = PO.volume_draws(task, np.asarray(key), [3, 4])
    assert keys_p.dtype == torch.int64
    np.testing.assert_array_equal(keys_p.numpy(), np.asarray(keys))
    reco, aux = task.reconstruct_with_aux(torch.from_numpy(x), keys_p)
    reco_w = np.asarray(reco_w)
    np.testing.assert_allclose(reco.numpy(), reco_w, atol=1e-5 * np.abs(reco_w).max(), rtol=0)
    np.testing.assert_allclose(aux["loss_per_slice"].numpy(), np.asarray(aux_w["loss_per_slice"]),
                               rtol=1e-5, atol=0)
    assert aux["latent_per_slice"].shape == (10, 0) == aux_w["latent_per_slice"].shape
    assert task.latent_len == 0
    assert task.anomaly_scores(0.25) == jtask.anomaly_scores(0.25)


def test_draws_and_generator_reconstruction():
    task = _port_task()
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    d1, d2 = task.draw_train(g1, B), task.draw_train(g2, B)
    assert torch.equal(d1.active, d2.active) and d1.aug is not None
    assert d1.active.shape == (B, 2, 2) and (d1.active.reshape(B, -1).sum(1) == 1).all()
    assert task.draw_train(g1, B, augment=False).aug is None
    x = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (4, 64, 64, 1)).astype(
        np.float32))
    a = task.reconstruct(x, generator=torch.Generator().manual_seed(8), groups=2)
    keys = task.draw_seeds(torch.Generator().manual_seed(8), 2)
    assert keys.shape == (2, 2) and keys.dtype == torch.int64
    assert torch.equal(a, task.reconstruct(x, keys))
    with pytest.raises(ValueError):
        task.reconstruct(x)


def _ddpm_pair():
    """A JAX DDPMTask's variables and the port's state_dict of them."""
    jd = jtasks.DDPMTask(jtasks.DDPMTaskConfig(**DDPM_TINY))
    port = randomize_(DDPMTask(DDPMTaskConfig(**DDPM_TINY), device="cpu"), 21)
    sd = {("diffusion.model." + k[5:]) if k.startswith("unet.") else k: t.numpy().copy()
          for k, t in port.state_dict().items()}
    return jd, convert_reference_ddpm_checkpoint(sd, jd), port


def test_import_spark_encoder_matches_jax():
    jd, dv, port = _ddpm_pair()
    sv = _jax_variables()
    merged = convert_jax_ddpm_variables(_host(jtasks.import_spark_encoder(dv, sv)), jd.cfg)
    spark_sd = {f"model.{k}": t for k, t in convert_jax_spark_variables(
        sv["params"], sv["batch_stats"], _port_task().scfg).items()}
    got = import_spark_encoder(port.state_dict(), spark_sd)
    assert set(got) == set(merged)
    for k, t in got.items():
        assert torch.equal(t, merged[k]), k
    assert torch.equal(got["encoder.fc.weight"], port.state_dict()["encoder.fc.weight"])
    assert not torch.equal(got["encoder.conv1.weight"], port.state_dict()["encoder.conv1.weight"])
    with pytest.raises(KeyError):
        import_spark_encoder(port.state_dict(), {"model.encoder.conv1.weight": None})


def test_reference_spark_ckpt_remap_matches_jax(tmp_path):
    """A reference torch SparK .ckpt (``sparse_encoder.sp_cnn.*`` with an fc
    head and num_batches_tracked, decoder keys beside it) through the
    orchestrator's ``pretrained_encoder`` file path, against the JAX
    package's import_reference_spark_encoder."""
    jd, dv, port = _ddpm_pair()
    donor = randomize_(SparkTask(SparkTaskConfig(**CFG), device="cpu"), 4)
    ref = {}
    for k, t in donor.state_dict().items():
        if k.startswith("model.encoder."):
            ref["sparse_encoder.sp_cnn." + k[len("model.encoder."):]] = t
        else:
            ref["dense_decoder." + k] = t
    ref["sparse_encoder.sp_cnn.fc.weight"] = torch.ones(1000, 512)
    ref["sparse_encoder.sp_cnn.fc.bias"] = torch.ones(1000)
    ref["sparse_encoder.sp_cnn.bn1.num_batches_tracked"] = torch.tensor(3)
    path = tmp_path / "spark.ckpt"
    torch.save({"state_dict": ref}, path)

    want = convert_jax_ddpm_variables(_host(import_reference_spark_encoder(
        dv, {k: t.numpy() for k, t in ref.items()}, "resnet18")), jd.cfg)

    class Cfg:
        pretrained_encoder = str(path)
        checkpoint = "best"

    PO.load_pretrained_encoder(port, Cfg, 0)
    got = port.state_dict()
    for k, t in want.items():
        assert torch.equal(got[k], t), k
    for k, t in donor.state_dict().items():
        if k.startswith("model.encoder."):
            assert torch.equal(got["encoder." + k[len("model.encoder."):]], t), k
