"""The port's SparK modules (models/spark.py, the masked path of
models/resnet.py, models/losses.py, utils/prng.py::uniform) against the JAX
package's on the CPU, at the tiny SparK config of the JAX package's own tests
(resnet18, 64x64 so f = 2, dec_dim 64), from the same numpy-seeded inputs and
JAX-initialised weights (BatchNorm statistics and affines, mask tokens
perturbed from a seed) carried over by utils/convert_jax.py.

Tolerances:
* prng.uniform and the eval masks: bit-equal.
* MaskedBatchNorm with a mask: outputs 1e-5 (f32) and 2e-2 (bf16, one bf16
  ulp of outputs ~4), batch and running statistics 1e-6.
* masked pyramid (all four levels), f32: eval mode 1e-5 of the level's
  largest value; training mode 2e-4 (each BatchNorm divides by statistics of
  as few as 4 active values at the last stage, which amplifies the ~1e-7
  convolution summation-order differences; measured 5.5e-5).
* SparKModel, f32: eval 1e-5 (measured 6e-7 on outputs of std 0.1); training
  mode max 5e-4 and mean 5e-5 (measured 2.1e-4 and 2.3e-5 on outputs of std
  0.87; the level-0 densify BatchNorm sees one active site a sample). bf16: eval max 2e-2 and mean
  2e-3 (measured 7.8e-3, 8.9e-4); training max 1.0 and mean 0.1 (measured
  0.59, 0.058 on outputs of std 0.88: that BatchNorm normalises by the
  statistics of 4 bf16 values). In both modes the port's bf16 output is also
  held to be no farther from the float32 model's than the JAX package's bf16
  output is, within 25% (max and mean; measured in training 0.81 and 0.069
  for the port, 1.04 and 0.088 for JAX).
* spark_spatial_loss and l1_ae_loss: 1e-6 relative.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conditioned_diffusion_models_uad_torch.models import losses as plosses
from conditioned_diffusion_models_uad_torch.models import resnet as presnet
from conditioned_diffusion_models_uad_torch.models import spark as pspark
from conditioned_diffusion_models_uad_torch.models.tasks import SparkTask, SparkTaskConfig
from conditioned_diffusion_models_uad_torch.utils import prng
from conditioned_diffusion_models_uad_torch.utils.convert_jax import (
    convert_jax_resnet_variables,
    convert_jax_spark_variables,
)
from conditioned_diffusion_models_uad_tpu.models import losses as jlosses
from conditioned_diffusion_models_uad_tpu.models import resnet as jresnet
from conditioned_diffusion_models_uad_tpu.models import spark as jspark

torch.set_num_threads(2)

HW = 64
B = 4
TINY = dict(backbone="resnet18", input_size=HW, dec_dim=64)


def _slices(seed=0, b=B):
    return np.random.default_rng(seed).uniform(0, 1, (b, HW, HW, 1)).astype(np.float32)


def _perturb(variables, seed):
    """JAX variables with BatchNorm statistics and affines and the mask
    tokens drawn from ``seed`` (flax initialises them to constants)."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = jax.tree_util.keystr(path)
        a = np.asarray(a)
        if "'mean'" in name or "'bias'" in name:
            return rng.normal(0, 0.1, a.shape).astype(np.float32)
        if "'var'" in name:
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if "'scale'" in name:
            return rng.uniform(0.6, 1.4, a.shape).astype(np.float32)
        if "mask_token" in name:
            return rng.normal(0, 1, a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(leaf, variables)


def _jcfg(**kw):
    return jspark.SparKConfig(**{**TINY, **kw})


def _pcfg(**kw):
    return pspark.SparKConfig(**{**TINY, **kw})


@functools.lru_cache(maxsize=None)
def _jax_model(dtype="float32", norm_precision="float32", use_pos_emb=False):
    cfg = _jcfg(dtype=dtype, norm_precision=norm_precision, use_pos_emb=use_pos_emb)
    model = jspark.SparKModel(cfg)
    active = jspark.random_mask(jax.random.PRNGKey(3), B, cfg.fmap_size, cfg.len_keep)
    v = model.init(jax.random.PRNGKey(1), jnp.zeros((B, HW, HW, 1)), active)
    return model, _perturb(v, 5), np.asarray(active)


def _port_model(variables, **kw):
    cfg = _pcfg(**kw)
    m = pspark.SparKModel(cfg).to(memory_format=torch.channels_last)
    m.load_state_dict(convert_jax_spark_variables(variables["params"],
                                                  variables["batch_stats"], cfg))
    return m


# --------------------------------------------------------------------------- #
# randomness
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("shape,lo,hi", [((), 0.0, 1.0), ((7,), 0.0, 1.0),
                                         ((5, 9), 0.0, 1.0), ((3, 4, 4), 0.0, 1.0),
                                         ((6,), 0.55, 0.75), ((2, 8), -3.0, 7.25)])
def test_uniform_bit_equal(shape, lo, hi):
    seeds = np.random.default_rng(2).integers(0, 2**31 - 1, 200)
    keys = jnp.stack([jax.random.PRNGKey(int(s)) for s in seeds])
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, shape, jnp.float32, lo, hi))(
        keys))
    got = np.stack([prng.uniform(prng.PRNGKey(int(s)), shape, lo, hi) for s in seeds])
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_uniform_padded_depth_prefix():
    """Bits are drawn by flat position: the first rows of a deeper draw are
    the shallower draw, so a volume padded to a bucketed depth keeps its
    rows."""
    key = prng.fold_in(prng.PRNGKey(3141 + 1000), 5)
    deep = prng.uniform(key, (56, 9))
    for d in (1, 17, 50):
        np.testing.assert_array_equal(deep[:d], prng.uniform(key, (d, 9)))


@pytest.mark.parametrize("batch,fmap,len_keep", [(4, 2, 1), (50, 3, 3), (8, 4, 6)])
def test_eval_mask_bit_equal(batch, fmap, len_keep):
    for s in range(20):
        key = prng.fold_in(prng.PRNGKey(s), 7)
        want = np.asarray(jspark.random_mask(jnp.asarray(key), batch, fmap, len_keep))
        got = pspark.random_mask_from_key(key, batch, fmap, len_keep)
        assert got.dtype == torch.bool and got.shape == (batch, fmap, fmap)
        np.testing.assert_array_equal(got.numpy(), want)
        assert (got.reshape(batch, -1).sum(1) == len_keep).all()


def test_grouped_eval_mask_is_each_volumes_own():
    """SparkTask.eval_mask of G stacked volumes: volume v's rows are JAX's
    random_mask(keys[v], depth / G) (its grouped reconstruct_with_aux), and
    the same rows as the volume alone."""
    task = SparkTask(SparkTaskConfig(image_hw=(96, 96), backbone="resnet18", dec_dim=16,
                                     dtype="float32"), device="cpu")
    key = prng.PRNGKey(4141)
    keys = prng.fold_in(key, np.array([3, 8, 9]))
    got = task.eval_mask(torch.from_numpy(keys.astype(np.int64)), 3 * 56)
    for v in range(3):
        want = np.asarray(jspark.random_mask(jnp.asarray(keys[v]), 56, 3, 3))
        np.testing.assert_array_equal(got[56 * v:56 * (v + 1)].numpy(), want)
        np.testing.assert_array_equal(task.eval_mask(keys[v:v + 1], 56).numpy(), want)


def test_training_masks():
    g = torch.Generator().manual_seed(0)
    a = pspark.random_mask(g, 16, 3, 3)
    assert a.shape == (16, 3, 3) and (a.reshape(16, -1).sum(1) == 3).all()
    assert not torch.equal(a[0], a[1]) or not torch.equal(a[1], a[2])
    r = pspark.random_mask_uniform_ratio(g, 16, 3, 0.5, 0.8)
    kept = r.reshape(16, -1).sum(1)
    assert (kept == kept[0]).all() and 2 <= int(kept[0]) <= 5  # round(9 (1 - r))
    m = pspark.random_mask_multi_ratio(g, 30, 4)
    assert m.shape == (30, 4, 4) and (m.reshape(30, -1).sum(1) >= 1).all()
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    assert torch.equal(pspark.random_mask(g1, 8, 3, 3), pspark.random_mask(g2, 8, 3, 3))


# --------------------------------------------------------------------------- #
# layers
# --------------------------------------------------------------------------- #
def test_sincos_patchify_upsample_match_jax():
    for dim, grid in ((64, 2), (512, 3), (16, 12)):
        np.testing.assert_array_equal(pspark.get_2d_sincos_pos_embed(dim, grid),
                                      jspark.get_2d_sincos_pos_embed(dim, grid))
    x = np.random.default_rng(1).normal(size=(2, 96, 96, 1)).astype(np.float32)
    p = pspark.patchify(torch.from_numpy(x), 32)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jspark.patchify(jnp.asarray(x), 32)))
    np.testing.assert_array_equal(pspark.unpatchify(p, 32, 3).numpy(), x)
    active = np.random.default_rng(2).uniform(size=(2, 3, 3)) > 0.5
    np.testing.assert_array_equal(
        presnet.upsample_mask(torch.from_numpy(active), 24, 24).permute(0, 2, 3, 1).numpy(),
        np.asarray(jresnet.upsample_mask(jnp.asarray(active), 24, 24)))


def _bn_case(seed, c=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.4, 2.0, size=(3, 6, 4, c)).astype(np.float32)
    mask = (rng.uniform(size=(3, 6, 4, 1)) > 0.6).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
         "bias": rng.normal(0, 0.1, c).astype(np.float32)}
    s = {"mean": rng.normal(0, 0.2, c).astype(np.float32),
         "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
    return x, mask, p, s


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fold_apply", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_masked_batchnorm_with_mask_matches_flax(train, fold_apply, dtype):
    x, mask, p, s = _bn_case(11)
    c = x.shape[-1]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want, mut = jresnet.MaskedBatchNorm(fold_apply=fold_apply, dtype=jdt).apply(
        {"params": p, "batch_stats": s}, jnp.asarray(x, jdt), jnp.asarray(mask),
        use_running_average=not train, mutable=["batch_stats"])
    bn = presnet.MaskedBatchNorm(c, fold_apply=fold_apply, dtype=tdt).train(train)
    with torch.no_grad():
        for name, v in (("weight", p["scale"]), ("bias", p["bias"]),
                        ("running_mean", s["mean"]), ("running_var", s["var"])):
            getattr(bn, name).copy_(torch.from_numpy(v))
        got = bn(torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2),
                 torch.from_numpy(mask).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)
    assert (got.float().numpy()[np.broadcast_to(mask, x.shape) == 0] == 0).all()
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(bn, name).numpy(),
                                   np.asarray(mut["batch_stats"][key]), atol=1e-6, rtol=1e-6)


def test_masked_batchnorm_gradient_matches_flax():
    x, mask, p, s = _bn_case(12)
    cot = np.random.default_rng(13).normal(size=x.shape).astype(np.float32)

    def f(p, x):
        y, _ = jresnet.MaskedBatchNorm().apply(
            {"params": p, "batch_stats": s}, x, jnp.asarray(mask),
            use_running_average=False, mutable=["batch_stats"])
        return jnp.sum(y * cot)

    gp, gx = jax.grad(f, argnums=(0, 1))(p, jnp.asarray(x))
    bn = presnet.MaskedBatchNorm(x.shape[-1]).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(p["scale"]))
        bn.bias.copy_(torch.from_numpy(p["bias"]))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = bn(xt.permute(0, 3, 1, 2), torch.from_numpy(mask).permute(0, 3, 1, 2))
    (y.permute(0, 2, 3, 1) * torch.from_numpy(cot)).sum().backward()
    for got, want in ((xt.grad, gx), (bn.weight.grad, gp["scale"]), (bn.bias.grad, gp["bias"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("train", [False, True])
def test_masked_pyramid_matches_jax(train):
    """All four levels of ResNetBackbone(x, active) (flax) against the port's
    ``pyramid(x, active)``, float32, and the running statistics after a
    training-mode pass."""
    cfg = jresnet.ResNetConfig(variant="resnet18")
    backbone = jresnet.ResNetBackbone(cfg)
    x = _slices(1)
    active = np.asarray(jspark.random_mask(jax.random.PRNGKey(8), B, 2, 1))
    v = _perturb(backbone.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(active)), 6)
    fn = jax.jit(lambda v, x, a: backbone.apply(v, x, a, train=train, mutable=["batch_stats"]))
    want, mut = fn(v, jnp.asarray(x), jnp.asarray(active))
    port = presnet.ResNetBackbone(presnet.ResNetConfig(variant="resnet18"))
    port.to(memory_format=torch.channels_last).train(train)
    port.load_state_dict(convert_jax_resnet_variables(
        {"backbone": v["params"]}, {"backbone": v["batch_stats"]}, "resnet18"))
    with torch.no_grad():
        got = port.pyramid(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(active))
    assert len(got) == len(want) == 4
    tol = 2e-4 if train else 1e-5
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == (w.shape[0], w.shape[3], w.shape[1], w.shape[2])
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w, atol=tol * scale, rtol=0)
        # inactive sites are zero at every level
        m = presnet.upsample_mask(torch.from_numpy(active), g.shape[2], g.shape[3])
        assert (g * (1 - m) == 0).all()
    if train:
        stats = convert_jax_resnet_variables({"backbone": v["params"]},
                                             {"backbone": mut["batch_stats"]}, "resnet18")
        for k, t in port.state_dict().items():
            if "running" in k:
                np.testing.assert_allclose(t.numpy(), stats[k].numpy(), atol=1e-5, rtol=1e-5)


# (dtype, norm_precision, use_pos_emb, train) -> (max, mean) absolute limits
MODEL_TOL = {
    ("float32", False): (1e-5, 1e-6), ("float32", True): (5e-4, 5e-5),
    ("bfloat16", False): (2e-2, 2e-3), ("bfloat16", True): (1.0, 0.1),
}


@pytest.mark.parametrize("case", [
    ("float32", "float32", False), ("float32", "compute", False), ("float32", "float32", True),
    ("bfloat16", "float32", False), ("bfloat16", "compute", False),
])
@pytest.mark.parametrize("train", [False, True])
def test_spark_model_matches_jax(case, train):
    dtype, norm_precision, use_pos_emb = case
    jmodel, v, active = _jax_model(dtype, norm_precision, use_pos_emb)
    x = _slices(2)
    fn = jax.jit(lambda v, x, a: jmodel.apply(v, x, a, train=train, mutable=["batch_stats"]))
    want, mut = fn(v, jnp.asarray(x), jnp.asarray(active))
    want = np.asarray(want)
    model = _port_model(v, dtype=dtype, norm_precision=norm_precision,
                        use_pos_emb=use_pos_emb).train(train)
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(active))
    assert got.shape == (B, HW, HW, 1) and got.dtype == torch.float32
    err = np.abs(got.numpy() - want)
    tol_max, tol_mean = MODEL_TOL[(dtype, train)]
    assert want.std() > 0.05
    assert err.max() <= tol_max and err.mean() <= tol_mean, (err.max(), err.mean())
    if dtype == "bfloat16":
        jref, v_ref, _ = _jax_model("float32", norm_precision, use_pos_emb)
        ref = np.asarray(jax.jit(lambda v, x, a: jref.apply(
            v, x, a, train=train, mutable=["batch_stats"])[0])(v_ref, jnp.asarray(x),
                                                                jnp.asarray(active)))
        ours, theirs = np.abs(got.numpy() - ref), np.abs(want - ref)
        assert ours.max() <= 1.25 * theirs.max(), (ours.max(), theirs.max())
        assert ours.mean() <= 1.25 * theirs.mean(), (ours.mean(), theirs.mean())
    if train and dtype == "float32":
        want_sd = convert_jax_spark_variables(v["params"], mut["batch_stats"], _pcfg())
        for k, t in model.state_dict().items():
            if "running" in k:
                np.testing.assert_allclose(t.numpy(), want_sd[k].numpy(), atol=1e-4, rtol=1e-4)


# --------------------------------------------------------------------------- #
# losses
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("pix_norm", [0, 1, 2])
@pytest.mark.parametrize("loss_l2", [True, False])
@pytest.mark.parametrize("dense_loss", [False, True])
@pytest.mark.parametrize("per_sample", [False, True])
def test_spark_spatial_loss_matches_jax(pix_norm, loss_l2, dense_loss, per_sample):
    rng = np.random.default_rng(pix_norm * 8 + loss_l2 * 4 + dense_loss * 2 + per_sample)
    inp = rng.uniform(0, 1, (3, 96, 96, 1)).astype(np.float32)
    rec = rng.normal(0.5, 0.3, (3, 96, 96, 1)).astype(np.float32)
    active = rng.uniform(size=(3, 3, 3)) > 0.6
    kw = dict(input_size=96, pix_norm=pix_norm, loss_l2=loss_l2, dense_loss=dense_loss)
    want = np.asarray(jspark.spark_spatial_loss(jspark.SparKConfig(**kw), jnp.asarray(inp),
                                                jnp.asarray(rec), jnp.asarray(active),
                                                per_sample=per_sample))
    got = pspark.spark_spatial_loss(pspark.SparKConfig(**kw), torch.from_numpy(inp),
                                    torch.from_numpy(rec), torch.from_numpy(active),
                                    per_sample=per_sample)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("strategy", ["sum", "mean"])
@pytest.mark.parametrize("per_sample", [False, True])
def test_l1_ae_loss_matches_jax(strategy, per_sample):
    rng = np.random.default_rng(4)
    reco = rng.uniform(0, 1, (5, 12, 12, 1)).astype(np.float32)
    target = rng.uniform(0, 1, (5, 12, 12, 1)).astype(np.float32)
    want = jlosses.l1_ae_loss(jnp.asarray(reco), jnp.asarray(target), strategy, per_sample)
    got = plosses.l1_ae_loss(torch.from_numpy(reco), torch.from_numpy(target), strategy,
                             per_sample)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=0)
