"""The UNet variants of the port (conditioned_diffusion_models_uad_torch/
models/unet.py) against the JAX UNetModel on the CPU: the spatial transformer
(at depth 1 and 2, conditional and not), conv up/down with and without
convolutions (``resblock_updown=False``, ``conv_resample``), the additive
embedding (``use_scale_shift_norm=False``), the FiLM fold, each alone and
combined, and ResBlock dropout from replayed masks.

Weights: the JAX model's init with every leaf then drawn from a seeded numpy
generator (so no zero-initialised head hides a layer), carried over by
``convert_jax_unet_params`` into a strict ``load_state_dict``. Inputs are
numpy-seeded. Tiny config: 32 channels, mult (1, 2), one res block, 16x16,
attention at ds 2 (the 8x8 level, 2 heads of 16) and in the middle.

Tolerances. float32: 5e-6 of the output's largest magnitude (~2); XLA:CPU
and oneDNN sum the convolutions in different orders (measured 3.2e-6 of it
at most, the tanh-GELU of the spatial transformer adding nothing visible).
bfloat16: the existing UNet tests' 0.1 max / 0.02 mean absolute. The
dropout step: loss 1e-5; each gradient tensor 1e-4 of its largest entry,
or 1e-3 of the model's largest gradient where that is more (a tensor whose
gradient is 0 up to rounding)."""
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conditioned_diffusion_models_uad_torch.models.unet import (
    Downsample,
    UNetConfig,
    UNetModel,
    count_params,
)
from conditioned_diffusion_models_uad_torch.utils.convert_jax import convert_jax_unet_params
from conditioned_diffusion_models_uad_tpu.models import unet as junet

torch.set_num_threads(2)

SMALL = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
             attention_resolutions=(2,), cond_dim=8, num_head_channels=16)
B, HW = 2, 16
TOL_FP32_REL = 5e-6
TOL_BF16_MAX = 0.1
TOL_BF16_MEAN = 0.02

VARIANTS = {
    "spatial_transformer": dict(spatial_transformer=True),
    "spatial_transformer_depth2": dict(spatial_transformer=True, transformer_depth=2),
    "spatial_transformer_uncond": dict(spatial_transformer=True, cond_dim=None),
    "conv_updown": dict(resblock_updown=False),
    "pool_updown": dict(resblock_updown=False, conv_resample=False),
    "additive_emb": dict(use_scale_shift_norm=False),
    "film_fold": dict(film_fold=True, norm_precision="compute"),
    "film_fold_f32_norm": dict(film_fold=True),
    "combined": dict(spatial_transformer=True, resblock_updown=False,
                     use_scale_shift_norm=False, norm_precision="compute"),
    "combined_film": dict(spatial_transformer=True, resblock_updown=False, film_fold=True,
                          norm_precision="compute", transformer_depth=2),
}


def _inputs(cond_dim, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, size=(B, HW, HW, 1)).astype(np.float32)
    t = np.array([3, 17], np.int32)
    c = None if cond_dim is None else rng.normal(size=(B, cond_dim)).astype(np.float32)
    return x, t, c


def _j(a):
    return None if a is None else jnp.asarray(a)


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


def _cfgs(kw, dtype="float32", **extra):
    cfg = {**SMALL, **kw, **extra}
    return junet.UNetConfig(**cfg, dtype=dtype), UNetConfig(**cfg, dtype=dtype)


@functools.lru_cache(maxsize=None)
def _params(name, dtype="float32", use_checkpoint=False):
    """Seeded JAX params of a variant (numpy leaves)."""
    jcfg, _ = _cfgs(VARIANTS[name], dtype, use_checkpoint=use_checkpoint)
    x, t, c = _inputs(jcfg.cond_dim)
    v = junet.UNetModel(jcfg).init(jax.random.PRNGKey(0), _j(x), _j(t), _j(c))
    return jax.tree_util.tree_map(np.asarray, randomize_jax_params(v["params"], 1))


def _port(name, dtype="float32", **extra):
    jcfg, pcfg = _cfgs(VARIANTS[name], dtype, **extra)
    model = UNetModel(pcfg)
    model.load_state_dict(convert_jax_unet_params(_params(name, dtype), pcfg), strict=True)
    return model.to(memory_format=torch.channels_last).eval(), jcfg


def _torch(x, t, c):
    return (torch.from_numpy(x), torch.from_numpy(t).long(),
            None if c is None else torch.from_numpy(c))


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_fp32_matches_jax(name):
    model, jcfg = _port(name)
    x, t, c = _inputs(jcfg.cond_dim)
    want = np.asarray(jax.jit(junet.UNetModel(jcfg).apply)(
        {"params": _params(name)}, _j(x), _j(t), _j(c)))
    with torch.no_grad():
        got = model(*_torch(x, t, c)).numpy()
    assert got.shape == want.shape == (B, HW, HW, 1)
    assert np.abs(got - want).max() <= TOL_FP32_REL * np.abs(want).max()


@pytest.mark.parametrize("name", ["combined", "combined_film", "spatial_transformer"])
def test_variant_bf16_matches_jax(name):
    model, jcfg = _port(name, "bfloat16")
    x, t, c = _inputs(jcfg.cond_dim)
    want = np.asarray(jax.jit(junet.UNetModel(jcfg).apply)(
        {"params": _params(name, "bfloat16")}, _j(x), _j(t), _j(c)))
    with torch.no_grad():
        got = model(*_torch(x, t, c)).numpy()
    d = np.abs(got - want)
    assert d.max() <= TOL_BF16_MAX and d.mean() <= TOL_BF16_MEAN


def test_film_fold_needs_the_folded_norm():
    """film_fold under norm_precision='float32' is the unfused path, as in
    the JAX package: the same outputs as without the flag."""
    a, _ = _port("film_fold_f32_norm")
    assert not any(m.film_fold for m in a.modules() if hasattr(m, "film_fold"))
    b, _ = _port("film_fold")
    assert all(m.film_fold for m in b.modules() if hasattr(m, "film_fold"))


def test_downsample_pads_like_flax_same():
    """A 3x3 stride-2 'SAME' conv pads an even side on the high end only
    (torch's padding=1 would shift the grid by a pixel) and an odd side on
    both."""
    for n in (8, 9):
        d = Downsample(32)
        x = torch.randn(1, 32, n, n)
        kernel = d.op.weight.detach().numpy().transpose(2, 3, 1, 0)
        want = jax.lax.conv_general_dilated(
            jnp.asarray(x.permute(0, 2, 3, 1).numpy()), jnp.asarray(kernel), (2, 2), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC")) + d.op.bias.detach().numpy()
        got = d(x).permute(0, 2, 3, 1).detach().numpy()
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)
        assert d.out_hw(n, n) == (got.shape[1], got.shape[2])


# --------------------------------------------------------------------------- #
# dropout: the JAX run's masks, replayed
# --------------------------------------------------------------------------- #
def jax_apply_with_masks(module, variables, x, t, c, key):
    """``module.apply`` in training mode with ``key`` as the dropout rng,
    and the keep mask each ``nn.Dropout`` drew (in call order, [B, H, W, C]
    numpy bool). The interceptor draws the rng as ``nn.Dropout`` does and
    hands it in, so the output is the uninstrumented one."""
    masks = []

    def intercept(next_fun, args, kwargs, context):
        mod = context.module
        if isinstance(mod, fnn.Dropout) and context.method_name == "__call__":
            rng = mod.make_rng("dropout")
            masks.append(np.asarray(jax.random.bernoulli(rng, 1.0 - mod.rate,
                                                         args[0].shape)))
            return next_fun(*args, **kwargs, rng=rng)
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(intercept):
        out = module.apply(variables, x, t, c, deterministic=False, rngs={"dropout": key})
    return out, masks


def _torch_masks(masks):
    return [torch.from_numpy(np.array(m)).permute(0, 3, 1, 2) for m in masks]


@pytest.mark.parametrize("name", ["spatial_transformer", "additive_emb", "film_fold"])
def test_dropout_forward_replays_jax_masks(name):
    model, jcfg = _port(name, dropout=0.3)
    jcfg = junet.UNetConfig(**{**jcfg.__dict__, "dropout": 0.3})
    x, t, c = _inputs(jcfg.cond_dim)
    key = jax.random.PRNGKey(5)
    jm = junet.UNetModel(jcfg)
    v = {"params": _params(name)}
    want, masks = jax_apply_with_masks(jm, v, _j(x), _j(t), _j(c), key)
    plain = jm.apply(v, _j(x), _j(t), _j(c), deterministic=False, rngs={"dropout": key})
    assert np.array_equal(np.asarray(want), np.asarray(plain))
    shapes = model.dropout_shapes(B, HW, HW)
    assert [tuple(m.shape) for m in _torch_masks(masks)] == shapes
    assert 0.6 < np.mean([m.mean() for m in masks]) < 0.8
    with torch.no_grad():
        got = model(*_torch(x, t, c), dropout=_torch_masks(masks)).numpy()
        off = model(*_torch(x, t, c)).numpy()
    want = np.asarray(want)
    assert np.abs(got - want).max() <= TOL_FP32_REL * np.abs(want).max()
    assert np.abs(off - want).max() > 100 * TOL_FP32_REL * np.abs(want).max()
    with pytest.raises(ValueError):
        model(*_torch(x, t, c), dropout=_torch_masks(masks)[:-1])


@pytest.mark.parametrize("name", ["spatial_transformer", "conv_updown"])
def test_dropout_step_with_checkpointing_matches_jax(name):
    """One step's loss mean|UNet(x, t, c) - y| and every parameter's
    gradient with dropout (p = 0.2) and per-ResBlock recomputation on both
    sides: the JAX gradients under nn.remat against the port's under
    torch.utils.checkpoint, the masks replayed. The rematerialised JAX run
    draws the same masks as the plain one (same loss), and the port's
    recomputed forward applies the masks it was given."""
    model, jcfg = _port(name, dropout=0.2, use_checkpoint=True)
    kw = {**jcfg.__dict__, "dropout": 0.2}
    x, t, c = _inputs(jcfg.cond_dim)
    y = np.random.default_rng(8).uniform(-1, 1, size=(B, HW, HW, 1)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    params = _params(name)
    plain_m = junet.UNetModel(junet.UNetConfig(**{**kw, "use_checkpoint": False}))
    _, masks = jax_apply_with_masks(plain_m, {"params": params}, _j(x), _j(t), _j(c), key)
    remat_m = junet.UNetModel(junet.UNetConfig(**{**kw, "use_checkpoint": True}))

    def loss_fn(m):
        def f(p):
            out = m.apply({"params": p}, _j(x), _j(t), _j(c), deterministic=False,
                          rngs={"dropout": key})
            return jnp.mean(jnp.abs(out - y))
        return f

    want_loss, grads = jax.value_and_grad(loss_fn(remat_m))(params)
    assert abs(float(want_loss) - float(loss_fn(plain_m)(params))) < 1e-7

    calls = []
    hook = [blk.register_forward_pre_hook(lambda *a: calls.append(1))
            for blk in model.modules() if type(blk).__name__ == "ResBlock"]
    out = model(*_torch(x, t, c), dropout=_torch_masks(masks))
    loss = (out - torch.from_numpy(y)).abs().mean()
    loss.backward()
    for h in hook:
        h.remove()
    n_res = len(model.dropout_shapes(B, HW, HW))
    assert len(calls) == 2 * n_res  # each ResBlock ran again in the backward pass
    assert abs(loss.item() - float(want_loss)) <= 1e-5
    want_g = convert_jax_unet_params(jax.tree_util.tree_map(np.asarray, grads), model.cfg)
    got_g = dict(model.named_parameters())
    assert set(want_g) == set(got_g)
    # a conv bias right before a GroupNorm has a gradient that is 0 up to
    # rounding (~1e-8 against a largest gradient of ~3e-5): it is held at
    # 1e-3 of the model's largest gradient, as tests/test_torch_train.py
    # holds every gradient
    floor = 1e-3 * max(np.abs(g.numpy()).max() for g in want_g.values())
    for k, g in want_g.items():
        d = np.abs(got_g[k].grad.numpy() - g.numpy()).max()
        assert d <= max(1e-4 * np.abs(g.numpy()).max(), floor), (k, d)


def test_count_params_and_flops_match_jax():
    for name in ("spatial_transformer", "conv_updown", "additive_emb"):
        model, jcfg = _port(name)
        want = junet.count_params(_params(name))
        assert count_params(model.parameters()) == want
        assert count_params(model.state_dict().values()) == want


def test_task_training_loss_with_dropout_matches_jax():
    """``DDPMTask.loss`` in training with ``dropout_unet`` on the unconditional
    spatial-transformer task: the JAX task's draws (t and the noise seed, as
    tests/test_torch_train.py reads them) and the masks its dropout key
    drew, handed to the port in a ``TrainDraws``; the loss and the
    reconstruction at float32."""
    from conditioned_diffusion_models_uad_torch.models.tasks import DDPMTask, DDPMTaskConfig
    from conditioned_diffusion_models_uad_torch.utils.convert_jax import (
        convert_jax_ddpm_params,
    )
    from conditioned_diffusion_models_uad_tpu.models import tasks as jtasks
    from conditioned_diffusion_models_uad_tpu.ops.simplex import make_noise_fn
    from test_torch_train import loss_draws

    kw = dict(image_hw=(16, 16), condition=False, timesteps=20, unet_dim=32,
              num_res_blocks=1, channel_mult=(1, 2), attention_resolutions=(2,),
              test_timesteps=10, step_ensemble=(5, 10), dtype="float32",
              spatial_transformer=True, dropout_unet=0.2)
    jtask = jtasks.DDPMTask(jtasks.DDPMTaskConfig(**kw))
    jtask.noise_fn = make_noise_fn("simplex", impl="pallas")
    params = randomize_jax_params(jtask.init(jax.random.PRNGKey(0))["params"], 4)
    params = jax.tree_util.tree_map(np.asarray, params)
    x = np.random.default_rng(2).uniform(0, 1, (3, 16, 16, 1)).astype(np.float32)
    key = jax.random.PRNGKey(13)
    masks = []

    def intercept(next_fun, args, kwargs, context):
        mod = context.module
        if isinstance(mod, fnn.Dropout) and context.method_name == "__call__":
            rng = mod.make_rng("dropout")
            masks.append(np.array(jax.random.bernoulli(rng, 1.0 - mod.rate, args[0].shape)))
            return next_fun(*args, **kwargs, rng=rng)
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(intercept):
        want, (_, aux) = jtask.loss({"params": params, "batch_stats": {}},
                                    {"vol": jnp.asarray(x)}, key, train=True)
    task = DDPMTask(DDPMTaskConfig(**kw), device="cpu")
    task.load_state_dict(convert_jax_ddpm_params(params, task.cfg), strict=True)
    draws = loss_draws(key, 3, kw["timesteps"])
    draws = type(draws)(draws.t, draws.seed, dropout=_torch_masks(masks))
    got, got_aux = task.loss({"vol": torch.from_numpy(x)}, draws, train=True)
    assert abs(got.item() - float(want)) <= 1e-5
    np.testing.assert_allclose(got_aux["reco"].detach().numpy(), np.asarray(aux["reco"]),
                               atol=1e-4, rtol=0)
