"""The port's fused GroupNorm+FiLM+SiLU (conditioned_diffusion_models_uad_torch/
ops/fused_norm.py) against the JAX package's plain twin and its Pallas kernel
in interpret mode, on the CPU, from the same numpy inputs.

On the CPU the port's wrapper is its plain version (float32 math, one cast at
the end), so it is held at the tolerances tests/test_fused_norm.py holds the
TPU kernel to against the twin: 2e-5 in float32 (the same float32 operations
summed in another order) and rtol = atol = 2e-2 in bfloat16 (the kernel folds
the affine into bf16 coefficients; one or two bf16 ulps at |y| ~ 1-4)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from conditioned_diffusion_models_uad_torch.ops.fused_norm import (
    fused_groupnorm_silu,
    groupnorm_silu_reference,
)
from conditioned_diffusion_models_uad_tpu.ops import fused_norm as jnorm

torch.set_num_threads(2)

TOL = {"float32": dict(atol=2e-5, rtol=0.0), "bfloat16": dict(atol=2e-2, rtol=2e-2)}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
SHAPE = (3, 8, 8, 256)  # tests/test_fused_norm.py's shape: 8 channels a group


def _inputs(film_rows, seed=0, shape=SHAPE):
    rng = np.random.default_rng(seed)
    b, c = shape[0], shape[-1]
    x = rng.normal(0.3, 1.5, size=shape).astype(np.float32)
    gamma = (rng.normal(size=c) * 0.1 + 1.0).astype(np.float32)
    beta = (rng.normal(size=c) * 0.1).astype(np.float32)
    film = None
    if film_rows is not None:
        rows = b if film_rows == "B" else 1
        film = tuple((rng.normal(size=(rows, c)) * 0.2).astype(np.float32) for _ in range(2))
    return x, gamma, beta, film


def _torch_args(x, gamma, beta, film, tdt):
    tf = None if film is None else tuple(torch.from_numpy(f) for f in film)
    return torch.from_numpy(x).to(tdt), torch.from_numpy(gamma), torch.from_numpy(beta), tf


def _jax_args(x, gamma, beta, film, jdt):
    jf = None if film is None else tuple(jnp.asarray(f) for f in film)
    return jnp.asarray(x, jdt), jnp.asarray(gamma), jnp.asarray(beta), jf


def _compare(got, want, dtype):
    assert got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **TOL[dtype])


CASES = [(film, silu) for film in (None, "B", "1") for silu in (True, False)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("film,silu", CASES)
def test_reference_matches_jax_reference(dtype, film, silu):
    tdt, jdt = DTYPES[dtype]
    x, gamma, beta, f = _inputs(film)
    b, h, w, c = x.shape
    got = groupnorm_silu_reference(*_torch_args(x.reshape(b, h * w, c), gamma, beta, f, tdt),
                                   apply_silu=silu)
    want = jnorm.groupnorm_silu_reference(
        *_jax_args(x.reshape(b, h * w, c), gamma, beta, f, jdt), apply_silu=silu)
    assert got.dtype == tdt
    _compare(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("film,silu", CASES)
def test_fused_matches_pallas_interpret(dtype, film, silu):
    tdt, jdt = DTYPES[dtype]
    x, gamma, beta, f = _inputs(film, seed=1)
    got = fused_groupnorm_silu(*_torch_args(x, gamma, beta, f, tdt), apply_silu=silu)
    want = jnorm.fused_groupnorm_silu(*_jax_args(x, gamma, beta, f, jdt), apply_silu=silu,
                                      use_pallas=True, interpret=True)
    _compare(got, want, dtype)


def test_three_dim_input_eps_and_groups():
    """[B, N, C] input, a non-default eps and group count, at a variance
    where eps matters."""
    x, gamma, beta, f = _inputs("B", seed=2, shape=(2, 24, 64))
    x = x * 1e-3
    got = fused_groupnorm_silu(*_torch_args(x, gamma, beta, f, torch.float32),
                               groups=16, eps=1e-5)
    want = jnorm.fused_groupnorm_silu(*_jax_args(x, gamma, beta, f, jnp.float32),
                                      groups=16, eps=1e-5, use_pallas=True, interpret=True)
    _compare(got, want, "float32")


def test_cpu_is_the_plain_version_and_not_counted():
    x, gamma, beta, f = _torch_args(*_inputs("1", seed=3), torch.float32)
    before = fused_groupnorm_silu.launches
    got = fused_groupnorm_silu(x, gamma, beta, f)
    b, h, w, c = x.shape
    want = groupnorm_silu_reference(x.reshape(b, h * w, c), gamma, beta, f).reshape(x.shape)
    assert torch.equal(got, want)
    assert fused_groupnorm_silu.launches == before
    with pytest.raises(ValueError):
        fused_groupnorm_silu(x[0, 0], gamma, beta)


# --------------------------------------------------------------------------- #
# K3's three variants: the plan, and the cluster and one-read kernels'
# arithmetic
# --------------------------------------------------------------------------- #
from conditioned_diffusion_models_uad_torch.ops import fused_norm as F3  # noqa: E402

# chip_smoke.py's TOL_K3: allclose (atol, rtol) against the plain version
TOL_K3 = {"bfloat16": dict(atol=2e-2, rtol=2e-2), "float32": dict(atol=2e-5, rtol=0.0)}


@pytest.mark.parametrize("n,c,k", [(9216, 128, 16), (2304, 256, 8), (576, 256, 2)])
def test_kernel_for_takes_the_unet_sites_in_one_cluster_pass(n, c, k):
    plan = F3.kernel_for(torch.bfloat16, n, c, 32)
    assert plan.variant == "cluster" and plan.k == k
    assert plan.rows_per_rank * c * 2 == 147_456  # each rank's share of a sample
    assert plan.smem_bytes == F3.cluster_smem(plan.rows_per_rank, c, 32, 2, k)
    assert plan.smem_bytes <= F3.MAX_SMEM
    # the least power of two: half as many CTAs would not hold a sample
    assert F3.cluster_smem(2 * plan.rows_per_rank, c, 32, 2, k // 2) > F3.MAX_SMEM


@pytest.mark.parametrize("dtype,n,c,groups,aligned", [
    (torch.float32, 16 * 9216, 128, 32, True),  # a 75 MB sample: beyond the grid
    (torch.bfloat16, 100, 36, 12, True),    # C*2 % 16 != 0
    (torch.bfloat16, 9216, 128, 32, False),  # x not 16-byte aligned
    (torch.bfloat16, 64, 4096, 32, True),   # 512 slices a row: beyond a one-read block
    (torch.bfloat16, 32 * 9216, 128, 32, True),  # a 75 MB bf16 sample
    (torch.bfloat16, 4 * 9216, 128, 32, True),   # 9.4 MB bf16: beyond 16 CTAs
    (torch.bfloat16, 64, 1024, 32, True),        # bf16 C > 512: no cluster kernel
])
def test_kernel_for_gives_the_rest_to_the_two_pass_kernel(dtype, n, c, groups, aligned):
    """In bfloat16 every sample beyond the cluster kernel takes the two-pass
    kernels, which beat the one-read kernel at the UNet's sites."""
    assert F3.kernel_for(dtype, n, c, groups, aligned=aligned) == F3.K3Plan("two_pass")


@pytest.mark.parametrize("dtype,n,c,rows,tiles,resident", [
    (torch.float32, 9216, 128, 96, 96, 396),     # a 4.7 MB float32 flagship sample
    (torch.float32, 2 * 9216, 128, 96, 192, 396),  # 9.4 MB: beyond 16 CTAs
    (torch.float32, 64, 1024, 11, 6, 264),       # C > 512: no cluster kernel
    (torch.float32, 9215, 128, 96, 96, 396),     # the last tile one row short
])
def test_kernel_for_gives_resident_samples_to_the_one_read_kernel(dtype, n, c, rows, tiles,
                                                                    resident):
    itemsize = torch.empty((), dtype=dtype).element_size()
    plan = F3.kernel_for(dtype, n, c, 32)
    assert plan == F3.K3Plan("coop", 0, rows, F3.coop_smem(rows, c, 32, itemsize), tiles,
                             resident)
    assert plan.smem_bytes <= F3.MAX_SMEM and tiles <= resident
    assert (rows * c * itemsize <= F3.COOP_TILE_BYTES
            and F3.coop_threads(c, itemsize) <= F3.COOP_THREADS)
    # one block fewer than the sample's tiles at once: the two-launch kernels
    fewer = F3.kernel_for(dtype, n, c, 32, resident=lambda p, threads: p.tiles - 1)
    assert fewer == F3.K3Plan("two_pass")
    exact = F3.kernel_for(dtype, n, c, 32, resident=lambda p, threads: p.tiles)
    assert exact == plan._replace(resident=tiles)


@pytest.mark.parametrize("n,row_bytes", [(9216, 512), (9215, 512), (36864, 256), (1, 512),
                                         (100, 4096), (64, 2048), (7, 98_304)])
def test_coop_tiles_cover_a_sample_evenly(n, row_bytes):
    rows, tiles = F3.coop_tiles(n, row_bytes)
    assert rows * row_bytes <= max(F3.COOP_TILE_BYTES, row_bytes)
    assert rows * (tiles - 1) < n <= rows * tiles  # no empty tile
    assert rows - (n - rows * (tiles - 1)) < tiles  # the last tile short by < tiles rows


@pytest.mark.parametrize("b,tiles,resident", [(8, 96, 396), (1, 96, 396), (3, 192, 396),
                                              (5, 3, 264), (40, 7, 50), (2, 50, 50)])
def test_coop_schedule_opens_every_sample_barrier(b, tiles, resident):
    """The one-read launch's schedule, simulated: block j takes tiles j,
    j + grid, ... in order, and a block moves past a tile only once every
    tile of that sample has arrived. Every block must finish (no barrier
    waits on a tile that a waiting block holds), each round of tiles holds
    whole samples, and the grid is within what the card holds at once."""
    plan = F3.K3Plan("coop", 0, 1, 1, tiles, resident)
    grid = F3.coop_grid(b, plan)
    assert 0 < grid <= resident and grid % tiles == 0 and grid <= b * tiles
    queues = [list(range(j, b * tiles, grid)) for j in range(grid)]
    assert sorted(t for q in queues for t in q) == list(range(b * tiles))
    arrived = [0] * b
    at = [0] * grid  # the index of the tile each block is at
    waiting = [False] * grid
    moved = True
    while moved:
        moved = False
        for j, q in enumerate(queues):
            if at[j] == len(q):
                continue
            s = q[at[j]] // tiles
            if not waiting[j]:
                arrived[s] += 1
                waiting[j] = moved = True
            if arrived[s] == tiles:
                at[j] += 1
                waiting[j] = False
                moved = True
    assert all(at[j] == len(q) for j, q in enumerate(queues))


@pytest.mark.parametrize("dtype,n,c,groups,aligned", [
    (torch.float16, 576, 256, 32, True),
    (torch.bfloat16, 576, 100, 32, True),   # 100 channels, 32 groups
    (torch.bfloat16, 0, 128, 32, True),
    (torch.bfloat16, 64, 2048, 32, False),  # 2048 one-element threads
])
def test_kernel_for_raises_on_what_neither_variant_takes(dtype, n, c, groups, aligned):
    with pytest.raises(ValueError):
        F3.kernel_for(dtype, n, c, groups, aligned=aligned)


@pytest.mark.parametrize("wrapper", [F3.fused_groupnorm_silu_cluster,
                                     F3.fused_groupnorm_silu_coop,
                                     F3.fused_groupnorm_silu_two_pass])
def test_variant_on_cpu_is_the_plain_version_and_not_counted(wrapper):
    x, gamma, beta, f = _torch_args(*_inputs("B", seed=4), torch.bfloat16)
    before = (wrapper.launches, fused_groupnorm_silu.launches)
    b, h, w, c = x.shape
    want = groupnorm_silu_reference(x.reshape(b, h * w, c), gamma, beta, f)
    assert torch.equal(wrapper(x, gamma, beta, f), want.reshape(x.shape))
    assert (wrapper.launches, fused_groupnorm_silu.launches) == before


def _round(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return v.to(dtype).float()


def cluster_kernel_emulation(x, gamma, beta, film, *, k, groups=32, eps=1e-6,
                             apply_silu=True):
    """csrc/fused_norm.cu::gn_cluster_kernel's arithmetic in float32 on the
    CPU, for x [B, N, C]: rank r of a sample's k-CTA cluster holds rows
    [r*R, min(N, (r+1)*R)), R = ceil(N/k) (the last rank ragged, or empty);
    each rank's float32 sums of x and of round(x*x) per group; the k
    partials folded in rank order; mean, var = E[x^2] - mean^2, inv =
    rsqrt(var + eps); a = inv*gamma, b = beta - mean*a, FiLM a*(1+s),
    b*(1+s)+t, a and b rounded to x's dtype; y = round(round(x*a) + b); SiLU
    y / round(1 + round(exp(-y))), rounded."""
    dt = x.dtype
    b, n, c = x.shape
    cg = c // groups
    xf = x.float()
    rows = -(-n // k)
    s1 = torch.zeros(b, groups)
    s2 = torch.zeros(b, groups)
    for r in range(k):  # rank order
        part = xf[:, r * rows:min(n, (r + 1) * rows)].reshape(b, -1, groups, cg)
        s1 = s1 + part.sum(dim=(1, 3))
        s2 = s2 + _round(part * part, dt).sum(dim=(1, 3))
    cnt = float(n * cg)
    mean = s1 / cnt
    inv = torch.rsqrt(s2 / cnt - mean * mean + eps)
    mean_c = mean.repeat_interleave(cg, dim=1)  # [B, C]
    a = inv.repeat_interleave(cg, dim=1) * gamma.float()
    bb = beta.float() - mean_c * a
    if film is not None:
        fs = 1.0 + film[0].float()
        a = a * fs
        bb = bb * fs + film[1].float()
    a, bb = _round(a, dt)[:, None, :], _round(bb, dt)[:, None, :]
    y = _round(_round(xf * a, dt) + bb, dt)
    if apply_silu:
        y = _round(y / _round(1.0 + _round(torch.exp(-y), dt), dt), dt)
    return y.to(dt)


def test_emulated_ranks_cover_every_row_once():
    for n, k in ((9215, 16), (99, 4), (9, 8), (5, 16)):
        rows = -(-n // k)
        seen = [i for r in range(k) for i in range(r * rows, min(n, (r + 1) * rows))]
        assert seen == list(range(n))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape,k,film,silu", [
    ((2, 99, 64), 4, "B", True),     # ragged last rank (24 of 25 rows)
    ((3, 36, 128), 16, "1", True),   # 3 rows a rank, the last three ranks empty
    ((2, 64, 256), 2, None, False),
])
def test_cluster_emulation_matches_pallas_interpret(dtype, shape, k, film, silu):
    tdt, jdt = DTYPES[dtype]
    x, gamma, beta, f = _inputs(film, seed=7, shape=shape)
    got = cluster_kernel_emulation(*_torch_args(x, gamma, beta, f, tdt), k=k,
                                   apply_silu=silu)
    jx, jg, jb, jf = _jax_args(x, gamma, beta, f, jdt)
    fs, fsh = jf if jf is not None else (None, None)
    want = jnorm._fused_pallas(jx, jg, jb, fs, fsh, groups=32, eps=1e-6,
                               apply_silu=silu, interpret=True)
    assert got.shape == shape and got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **TOL_K3[dtype])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_coop_emulation_matches_pallas_interpret(dtype, monkeypatch):
    """The one-read kernel folds per-tile partials in tile order, over the
    tiles ``coop_tiles`` cuts (rows = ceil(n / tiles)): the cluster
    emulation's arithmetic with a rank a tile. Tiles of 1 KB here, so that
    a 99-row sample of 64 channels spreads over several, the last short."""
    monkeypatch.setattr(F3, "COOP_TILE_BYTES", 1024)
    shape = (2, 99, 64)
    tdt, jdt = DTYPES[dtype]
    rows, tiles = F3.coop_tiles(shape[1], shape[2] * torch.empty((), dtype=tdt).element_size())
    assert tiles > 1 and rows == -(-shape[1] // tiles)
    x, gamma, beta, f = _inputs("B", seed=9, shape=shape)
    got = cluster_kernel_emulation(*_torch_args(x, gamma, beta, f, tdt), k=tiles)
    jx, jg, jb, jf = _jax_args(x, gamma, beta, f, jdt)
    want = jnorm._fused_pallas(jx, jg, jb, *jf, groups=32, eps=1e-6, apply_silu=True,
                               interpret=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **TOL_K3[dtype])


def test_bf16_slice_check_takes_only_a_card_tensor():
    x = torch.zeros((4, 8), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        F3.bf16_slice_check(x, x.float(), x.float(), True)


# --------------------------------------------------------------------------- #
# the fold numerics (``fused_groupnorm_fold``): GroupNorm32's own roundings
# --------------------------------------------------------------------------- #
from conditioned_diffusion_models_uad_torch.models.unet import GroupNorm32  # noqa: E402
from conditioned_diffusion_models_uad_torch.utils.random_init import randomize_  # noqa: E402


def fold_kernel_emulation(x, gamma, beta, film, *, film_after, k, groups=32, eps=1e-5,
                          apply_silu=True, moments=None):
    """csrc/fused_norm.cu's fold numerics (kFold, kFoldFilmAfter) in float32 on
    the CPU, for x [B, N, C] and film = (scale, shift) [B, C] of x's dtype:
    rank r of k holds rows [r*R, min(N, (r+1)*R)), R = ceil(N/k), and adds
    its float32 sums of x and of x*x (the square not rounded); the k partials
    folded in rank order; ``moments`` = (E[x], E[x^2]) [B, G] in their place
    where given. var = max(0, E[x^2] - mean^2), inv = rsqrt(var + eps); a =
    gamma*inv, b = beta - mean*a, the FiLM composed into them in float32
    unless ``film_after``; a and b rounded to x's dtype; y = round(round(x*a)
    + b); with ``film_after`` y = round(round(y*round(1 + scale)) + shift);
    SiLU y / (1 + exp(-y)) in float32 from y's value, rounded once."""
    dt = x.dtype
    b, n, c = x.shape
    cg = c // groups
    xf = x.float()
    if moments is None:
        rows = -(-n // k)
        s1 = torch.zeros(b, groups)
        s2 = torch.zeros(b, groups)
        for r in range(k):  # rank order
            part = xf[:, r * rows:min(n, (r + 1) * rows)].reshape(b, -1, groups, cg)
            s1 = s1 + part.sum(dim=(1, 3))
            s2 = s2 + (part * part).sum(dim=(1, 3))
        moments = (s1 / float(n * cg), s2 / float(n * cg))
    mean, meansq = moments
    inv = torch.rsqrt(torch.clamp_min(meansq - mean * mean, 0.0) + eps)
    mean_c = mean.repeat_interleave(cg, dim=1)  # [B, C]
    a = gamma.float() * inv.repeat_interleave(cg, dim=1)
    bb = beta.float() - mean_c * a
    if film is not None and not film_after:
        fs = 1.0 + film[0].float()
        a = a * fs
        bb = bb * fs + film[1].float()
    a, bb = _round(a, dt)[:, None, :], _round(bb, dt)[:, None, :]
    y = _round(_round(xf * a, dt) + bb, dt)
    if film is not None and film_after:
        y = _round(_round(y * _round(1.0 + film[0].float(), dt)[:, None, :], dt)
                   + film[1].float()[:, None, :], dt)
    if apply_silu:
        y = F.silu(y)
    return y.to(dt)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("film", [None, "fold", "after"])
@pytest.mark.parametrize("silu", [True, False])
def test_fold_emulation_is_the_eager_fold_given_its_statistics(dtype, film, silu):
    """Fed the eager chain's moments (per-channel means over H*W, then over
    the group's channels), the fold emulation equals ``GroupNorm32.eager``
    bit for bit: every rounding after the statistics is the chain's. With
    its own rank-ordered statistics it differs only by their float32
    summation order."""
    tdt = DTYPES[dtype][0]
    gen = torch.Generator().manual_seed(11)
    b, c, h = 3, 128, 16  # 3 * 128 * 256 elements: the SiLU's vector loop has no tail
    norm = randomize_(GroupNorm32(c, f32_apply=False), 4)
    x = (torch.randn((b, c, h, h), generator=gen) * 1.7 + 0.4).to(tdt).to(
        memory_format=torch.channels_last)
    scale, shift = ((0.3 * torch.randn((b, c, 1, 1), generator=gen)).to(tdt) for _ in range(2))
    kw = dict(film_fold=film == "fold", silu=silu)
    with torch.no_grad():
        want = (norm.eager(x, **kw) if film is None
                else norm.eager(x, scale, shift, **kw))
        xf = x.float()
        g = norm.num_groups
        moments = tuple(v.mean(dim=(2, 3)).reshape(b, g, c // g).mean(dim=2)
                        for v in (xf, xf * xf))
        x3 = x.permute(0, 2, 3, 1).reshape(b, h * h, c)
        f = None if film is None else (scale.reshape(b, c), shift.reshape(b, c))
        args = (x3, norm.weight, norm.bias, f)
        emul = dict(film_after=film == "after", apply_silu=silu)
        got = fold_kernel_emulation(*args, k=4, moments=moments, **emul)
        own = fold_kernel_emulation(*args, k=4, **emul)
    want3 = want.permute(0, 2, 3, 1).reshape(b, h * h, c)
    assert got.dtype == tdt and torch.equal(got, want3)
    np.testing.assert_allclose(own.float().numpy(), want3.float().numpy(), **TOL_K3[dtype])


def test_fold_wrapper_runs_on_the_card_only():
    x, gamma, beta, f = _torch_args(*_inputs("B", seed=12), torch.bfloat16)
    before = fused_groupnorm_silu.launches
    with pytest.raises(ValueError):
        F3.fused_groupnorm_fold(x, gamma, beta, f, film_after=True)
    assert fused_groupnorm_silu.launches == before
