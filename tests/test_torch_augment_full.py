"""The port's full augmentation set (conditioned_diffusion_models_uad_torch/
data/augment.py: flip, affine, elastic, noise, motion, ``full_augment_apply``)
and its resampling (ops/interp.py) against the JAX package's, on the CPU.
The JAX functions draw from a PRNG key; the test reads the same draws out of
that key (the split structure of data/augment.py:100-235) and hands them to
the port.

Tolerances: images 1e-5 absolute (float32 cos/sin/exp and FFTs round by a
few ulps between XLA and PyTorch; measured below 2e-6). The warped mask is
an order-0 sample and is held bit for bit. The cubic resize agrees with
``jax.image.resize`` to 1e-5 on displacements of up to 7.5 pixels
(float32; measured 1e-6), the linear resize to 1e-6 on values in [0, 1]."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conditioned_diffusion_models_uad_torch.data import augment as aug
from conditioned_diffusion_models_uad_torch.ops import interp
from conditioned_diffusion_models_uad_torch.train.loop import gathered_batch
from conditioned_diffusion_models_uad_tpu.data import augment as jaug
from test_torch_augment import jax_draws

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=0)
B, H, W = 6, 32, 24
# keys 200 + seed; 8 and 9 switch motion (p = 0.1) on for some sample
FULL_SEEDS = [0, 1, 2, 3, 8, 9]


def _x(seed=0):
    return np.random.default_rng(seed).uniform(0, 1, size=(B, H, W, 1)).astype(np.float32)


def _mask(seed=0):
    rng = np.random.default_rng(100 + seed)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    m = ((yy - H / 2) ** 2 / 100 + (xx - W / 2) ** 2 / 60 < rng.uniform(0.8, 1.2, (B, 1, 1)))
    return m[..., None].astype(np.float32)


def _t(a, dtype=None):
    return torch.from_numpy(np.array(a, dtype))


def jax_full_draws(key, b, h, w) -> aug.FullAugDraws:
    """The draws ``full_augment_batch(key, vol, mask)`` makes."""
    k_sp, k_int, k_n, k_gn, k_m, k_gm = jax.random.split(key, 6)
    keys = jax.random.split(k_sp, 6)

    def gate(k, p, shape=(b,)):
        return _t(jax.random.bernoulli(k, p, shape)).reshape(b)

    aff = [jax.random.split(ck, 3) for ck in jax.random.split(keys[2], b)]
    deg = _t([jax.random.uniform(k[0], (), minval=-10.0, maxval=10.0) for k in aff])
    sc = _t([jax.random.uniform(k[1], (), minval=-0.1, maxval=0.1) for k in aff])
    tr = _t(np.stack([jax.random.uniform(k[2], (2,), minval=-5.0, maxval=5.0) for k in aff]))
    disp = _t(np.stack([jax.random.uniform(ck, (2, 4, 4), minval=-7.5, maxval=7.5)
                        for ck in jax.random.split(keys[4], b)]))
    k_std, k_nn = jax.random.split(k_n)
    k_sh, k_wt = jax.random.split(k_m)
    return aug.FullAugDraws(
        flip_gate=gate(keys[0], 0.5, (b, 1, 1, 1)),
        affine_gate=gate(keys[1], 0.25), affine_deg=deg, affine_scale=sc, affine_shift=tr,
        elastic_gate=gate(keys[3], 0.25), elastic_disp=disp,
        intensity=jax_draws(k_int, b),
        noise_gate=gate(k_gn, 0.5, (b, 1, 1, 1)),
        noise_std=_t(jax.random.uniform(k_std, (b, 1, 1, 1), maxval=0.1)).reshape(b),
        noise=_t(jax.random.normal(k_nn, (b, h, w, 1))),
        motion_gate=gate(k_gm, 0.1, (b, 1, 1, 1)),
        motion_shifts=_t(jax.random.uniform(k_sh, (b, 3, 2), minval=-4.0, maxval=4.0)),
        motion_weights=_t(jax.random.dirichlet(k_wt, jnp.ones((4,)), (b,))),
    )


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **tol)


@pytest.mark.parametrize("seed", [0, 1])
def test_noise_matches_jax(seed):
    key = jax.random.PRNGKey(50 + seed)
    x = _x(seed)
    k_std, k_n = jax.random.split(key)
    std = _t(jax.random.uniform(k_std, (B, 1, 1, 1), maxval=0.1)).reshape(B)
    noise = _t(jax.random.normal(k_n, (B, H, W, 1)))
    _close(aug.apply_noise(torch.from_numpy(x), std, noise), jaug._rand_noise(key, jnp.asarray(x)))


@pytest.mark.parametrize("seed", [0, 1])
def test_motion_matches_jax(seed):
    key = jax.random.PRNGKey(60 + seed)
    x = _x(seed)
    k_sh, k_wt = jax.random.split(key)
    shifts = _t(jax.random.uniform(k_sh, (B, 3, 2), minval=-4.0, maxval=4.0))
    weights = _t(jax.random.dirichlet(k_wt, jnp.ones((4,)), (B,)))
    _close(aug.apply_motion(torch.from_numpy(x), shifts, weights),
           jaug._rand_motion(key, jnp.asarray(x)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_affine_coords_match_jax(seed):
    key = jax.random.PRNGKey(70 + seed)
    k_r, k_s, k_t = jax.random.split(key, 3)
    deg = _t([jax.random.uniform(k_r, (), minval=-10.0, maxval=10.0)])
    sc = _t([jax.random.uniform(k_s, (), minval=-0.1, maxval=0.1)])
    tr = _t(jax.random.uniform(k_t, (2,), minval=-5.0, maxval=5.0))[None]
    got = aug.affine_coords(deg, sc, tr, H, W)[0]
    _close(got, jaug._affine_coords(key, H, W), dict(atol=2e-5, rtol=0))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_elastic_coords_match_jax(seed):
    key = jax.random.PRNGKey(80 + seed)
    disp = _t(jax.random.uniform(key, (2, 4, 4), minval=-7.5, maxval=7.5))[None]
    _close(aug.elastic_coords(disp, H, W)[0], jaug._elastic_coords(key, H, W))


@pytest.mark.parametrize("order", [0, 1])
def test_warp_matches_map_coordinates(order):
    rng = np.random.default_rng(order)
    img = rng.uniform(0, 1, (H, W)).astype(np.float32)
    coords = rng.uniform(-3, max(H, W) + 3, (2, H, W)).astype(np.float32)
    got = interp.map_coordinates(torch.from_numpy(img)[None], torch.from_numpy(coords)[None],
                                 order)[0]
    want = np.asarray(jaug._warp(jnp.asarray(img), jnp.asarray(coords), order))
    if order == 0:
        assert np.array_equal(got.numpy(), want)
    else:
        _close(got, want, dict(atol=1e-6, rtol=0))


def test_order0_ties_round_half_away_from_zero():
    """Coordinates on .5 (and just below it) pick the voxel JAX picks:
    2.5 -> 3 and -0.5 -> -1 (clamped to 0), where torch.round gives 2 and
    -0; 0.5 - 2**-25 -> 0."""
    img = torch.arange(6 * 5, dtype=torch.float32).reshape(1, 6, 5)
    vals = [-0.5, 0.5, 1.5, 2.5, 3.5, 4.5, 0.5 - 2 ** -25, 1.4999999]
    cy = np.array(vals, np.float32)
    cx = np.array(vals[::-1], np.float32)
    coords = np.stack([cy, cx])[:, :, None]  # [2, 8, 1]
    got = interp.map_coordinates(img, torch.from_numpy(coords)[None], 0)[0]
    want = jax.scipy.ndimage.map_coordinates(jnp.asarray(img[0]), list(jnp.asarray(coords)),
                                             order=0, mode="nearest")
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(interp.round_half_away(torch.tensor([2.5, -2.5, 0.5 - 2 ** -25])),
                       torch.tensor([3.0, -3.0, 0.0]))


@pytest.mark.parametrize("shape,out", [((2, 4, 4), (2, 32, 24)), ((2, 5, 3), (2, 9, 17))])
def test_cubic_resize_matches_jax_image_resize(shape, out):
    x = np.random.default_rng(3).uniform(-7.5, 7.5, shape).astype(np.float32)
    got = interp.resize(torch.from_numpy(x), out, "cubic")
    _close(got, jax.image.resize(jnp.asarray(x), out, "cubic"))


@pytest.mark.parametrize("shape,out", [((20, 17, 11), (19, 17, 14)), ((9, 30, 7), (13, 12, 7))])
@pytest.mark.parametrize("method", ["trilinear", "nearest"])
def test_resize_matches_jax_image_resize(shape, out, method):
    """Linear with antialiasing where an axis shrinks, and nearest."""
    x = np.random.default_rng(4).uniform(0, 1, shape).astype(np.float32)
    got = interp.resize(torch.from_numpy(x), out, "linear" if method == "trilinear" else method)
    want = jax.image.resize(jnp.asarray(x), out, method)
    if method == "nearest":
        assert np.array_equal(got.numpy(), np.asarray(want))
    else:
        _close(got, want, dict(atol=1e-6, rtol=0))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_spatial_augment_matches_jax(seed):
    key = jax.random.PRNGKey(90 + seed)
    x, m = _x(seed), _mask(seed)
    # spatial_augment_batch(k_sp) is the first split of full_augment_batch's key
    k_sp = jax.random.split(key, 6)[0]
    draws = jax_full_draws(key, B, H, W)
    got_v, got_m = aug.spatial_augment_apply(torch.from_numpy(x), torch.from_numpy(m), draws)
    want_v, want_m = jaug.spatial_augment_batch(k_sp, jnp.asarray(x), jnp.asarray(m))
    _close(got_v, want_v)
    assert np.array_equal(got_m.numpy(), np.asarray(want_m))


@pytest.mark.parametrize("seed", FULL_SEEDS)
def test_full_augment_batch_matches_jax(seed):
    """The whole set, from one key: spatial on image and mask, then the
    intensity policy, noise and motion."""
    key = jax.random.PRNGKey(200 + seed)
    x, m = _x(seed), _mask(seed)
    draws = jax_full_draws(key, B, H, W)
    got_v, got_m = aug.full_augment_apply(torch.from_numpy(x), torch.from_numpy(m), draws)
    want_v, want_m = jaug.full_augment_batch(key, jnp.asarray(x), jnp.asarray(m))
    _close(got_v, want_v)
    assert np.array_equal(got_m.numpy(), np.asarray(want_m))


def test_every_family_gated_on_somewhere():
    """The seeds of the whole-set comparison switch each family on for some
    sample, so it covers every family."""
    on = {f: False for f in ("flip", "affine", "elastic", "noise", "motion")}
    for seed in FULL_SEEDS:
        d = jax_full_draws(jax.random.PRNGKey(200 + seed), B, H, W)
        for f in on:
            on[f] |= bool(getattr(d, f"{f}_gate").any())
    assert all(on.values()), on


def test_draw_aug_full_shapes_ranges_and_dirichlet():
    g = torch.Generator().manual_seed(0)
    d = aug.draw_aug_full(g, 400, H, W)
    assert d.noise.shape == (400, H, W, 1) and d.elastic_disp.shape == (400, 2, 4, 4)
    assert d.motion_shifts.shape == (400, 3, 2) and d.motion_weights.shape == (400, 4)
    assert d.affine_deg.abs().max() <= 10 and d.affine_scale.abs().max() <= 0.1
    assert d.affine_shift.abs().max() <= 5 and d.elastic_disp.abs().max() <= 7.5
    assert 0 <= d.noise_std.min() and d.noise_std.max() <= 0.1
    assert torch.allclose(d.motion_weights.sum(1), torch.ones(400))
    assert (d.motion_weights >= 0).all()
    # Dirichlet(1,1,1,1): each weight has mean 1/4 and variance 3/80
    assert abs(d.motion_weights.mean().item() - 0.25) < 0.01
    assert abs(d.motion_weights[:, 0].var().item() - 3 / 80) < 0.01
    for gate, p in ((d.flip_gate, 0.5), (d.affine_gate, 0.25), (d.elastic_gate, 0.25),
                    (d.noise_gate, 0.5), (d.motion_gate, 0.1)):
        assert abs(gate.float().mean().item() - p) < 0.08
    again = aug.draw_aug_full(torch.Generator().manual_seed(0), 400, H, W)
    assert torch.equal(again.noise, d.noise)
    assert d.to("cpu").intensity.ghost_num.device.type == "cpu"
    assert aug.draw_aug(g, 3, (H, W), False) is None
    assert isinstance(aug.draw_aug(g, 3, (H, W), True), aug.AugDraws)
    with pytest.raises(ValueError):
        aug.draw_aug(g, 3, (H, W), "spatial")


def test_gathered_batch_warps_vol_and_mask_together():
    """With full draws, gathered_batch augments the slices and their masks
    with one transform; intensity draws leave the mask alone."""
    rng = np.random.default_rng(5)
    vols = torch.from_numpy(rng.uniform(0, 1, (2, H, W, 4)).astype(np.float32))
    masks = torch.from_numpy((rng.uniform(0, 1, (2, H, W, 4)) > 0.5).astype(np.float32))
    vi, si = [0, 1, 1, 0, 1, 0], [0, 1, 2, 3, 0, 1]
    draws = jax_full_draws(jax.random.PRNGKey(7), B, H, W)
    batch = gathered_batch((vols, masks), vi, si, draws)
    plain = gathered_batch((vols, masks), vi, si)
    want_v, want_m = aug.full_augment_apply(plain["vol"], plain["mask"], draws)
    assert torch.equal(batch["vol"], want_v) and torch.equal(batch["mask"], want_m)
    intensity = gathered_batch((vols, masks), vi, si, draws.intensity)
    assert torch.equal(intensity["mask"], plain["mask"])
