"""Fused GroupNorm(32) + FiLM scale-shift + SiLU (counterpart of
``conditioned_diffusion_models_uad_tpu/ops/fused_norm.py``).

``groupnorm_silu_reference`` is the plain PyTorch version of the JAX twin:
flax ``nn.GroupNorm`` math (mean and mean of squares over the group),
float32 throughout, one cast to x's dtype at the end. ``fused_groupnorm_silu``
is the wrapper: for a CUDA tensor it launches the variant of kernel K3
(``csrc/fused_norm.cu``) that ``kernel_for`` picks, and it takes the plain
version only for a CPU tensor, as the JAX function's default takes its twin
off the TPU. The variants:

- ``fused_groupnorm_silu_cluster``: one launch of as many thread-block
  clusters of k CTAs as the card holds at once, each holding one sample at
  a time in its shared memory, so x is read once;
- ``fused_groupnorm_silu_coop``: one cooperative launch of resident blocks,
  each holding one tile of a sample in its shared memory across a
  per-sample barrier, so x is read once; for the float32 samples the
  cluster kernel does not hold whose tiles fit in the blocks the card holds
  at once;
- ``fused_groupnorm_silu_two_pass``: a statistics launch, a launch that
  sums each sample's partials once, and an apply launch over pixel tiles (x
  read twice), for the rest: a sample too large for the resident grid, rows
  not a multiple of 16 bytes, x not 16-byte aligned.

Each variant runs in one of two numerics, a template parameter of the
kernels. ``fused_groupnorm_silu`` takes the TPU kernel's own, not the twin's:
the square is taken in x's dtype, the folded per-channel ``a``, ``b`` are
rounded to x's dtype before ``x*a + b``, and the SiLU runs in y's dtype. In
float32 it matches the plain version to ~1e-6; in bfloat16 to one or two bf16
ulps. No model of either package calls it, as in the JAX package.

``fused_groupnorm_fold`` takes the UNet's own: ``models/unet.py::GroupNorm32``
on the fold (``f32_apply=False``, eps 1e-5) with the ResBlock's FiLM and
SiLU, rounded step for step as the eager chain rounds them (the square in
float32, var clamped at 0, the FiLM composed into ``a``, ``b`` or applied
after the norm in x's dtype, torch's SiLU); only the float32 summation
order of the statistics differs. ``GroupNorm32`` calls it on the card
wherever autograd records nothing (``models/unet.py::takes_k3``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# the cluster kernel's limits (csrc/fused_norm.cu)
CLUSTER_THREADS = 512     # threads a CTA at most
CLUSTER_MAX = 16          # CTAs a cluster at most (non-portable size)
MAX_SMEM = 232_448        # dynamic shared memory a CTA may use on the H100
CHUNKS = 4                # bulk-copy pieces of a rank's rows
SLOTS = CHUNKS + 1        # piece-sized slots of shared memory
_BAR_BYTES = 64           # the CTA's mbarriers
TWO_PASS_MAX_THREADS = 1024

# the one-read (cooperative) kernel's limits (csrc/fused_norm.cu)
COOP_THREADS = 256        # threads a block at most; C*itemsize/16 <= this
COOP_TILE_BYTES = 48 * 1024  # target bytes of x a block holds
COOP_FOLD = 1024          # float2 partials staged at once in the fold
H100_SMS = 132
SM_SMEM = 233_472         # shared memory an SM gives its blocks
BLOCK_SMEM_RESERVED = 1024  # shared memory the card keeps per block

Film = Optional[Tuple[torch.Tensor, torch.Tensor]]

# the kernels' numerics (csrc/fused_norm.cu::Numerics)
TPU, FOLD, FOLD_FILM_AFTER = 0, 1, 2

_C = ctypes.c_int
_P = ctypes.c_void_p
_ARGTYPES = {
    "fused_groupnorm_tiles": [_C, _C, _C],
    "fused_groupnorm_silu_two_pass": [_P] * 6 + [_C, _P] + [_C] * 6
    + [ctypes.c_float, _C, _C, _P],
    "fused_groupnorm_silu_cluster": [_P] * 5 + [_C, _P] + [_C] * 8
    + [ctypes.c_float, _C, _C, _P],
    "fused_groupnorm_cluster_smem": [_C] * 5,
    "fused_groupnorm_cluster_occupancy": [_C] * 5,
    "fused_groupnorm_slice_check": [_P] * 9 + [_C] * 3 + [_P],
    "fused_groupnorm_silu_coop": [_P] * 5 + [_C] + [_P] * 3 + [_C] * 8
    + [ctypes.c_float, _C, _C, _P],
    "fused_groupnorm_coop_smem": [_C] * 4,
    "fused_groupnorm_coop_resident": [_C] * 4,
}


@functools.lru_cache(maxsize=None)
def _fns():
    return _build.bind("fused_norm", _ARGTYPES)


def groupnorm_silu_reference(x: torch.Tensor, gamma: torch.Tensor,
                             beta: torch.Tensor, film: Film = None, *,
                             groups: int = 32, eps: float = 1e-6,
                             apply_silu: bool = True) -> torch.Tensor:
    """Plain version, x [B, N, C] -> [B, N, C] in x's dtype."""
    b, n, c = x.shape
    xf = x.float().reshape(b, n, groups, c // groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    mean2 = (xf * xf).mean(dim=(1, 3), keepdim=True)
    var = mean2 - mean * mean
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, n, c)
    y = y * gamma.float() + beta.float()
    if film is not None:
        fs, fsh = film
        y = y * (1.0 + fs.float()[:, None, :]) + fsh.float()[:, None, :]
    if apply_silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


class K3Plan(NamedTuple):
    """What ``kernel_for`` picks: the variant ("cluster", "coop" or
    "two_pass"); for the cluster kernel, the CTAs per cluster (one cluster
    per sample), the rows each rank holds and the dynamic shared memory per
    CTA; for the one-read kernel, the rows a tile holds, the shared memory
    per block, the tiles a sample and the blocks the card holds at once (all
    0 for the two-pass kernel)."""
    variant: str
    k: int = 0
    rows_per_rank: int = 0
    smem_bytes: int = 0
    tiles: int = 0
    resident: int = 0


def cluster_smem(rows: int, c: int, groups: int, itemsize: int, k: int) -> int:
    """Dynamic shared memory of a CTA of a k-CTA cluster whose ranks hold
    ``rows`` rows: SLOTS slots of ceil(rows / CHUNKS) rows (a sample's
    pieces and one more, so that the next sample's pieces load while this
    one's are written), the mbarriers, the per-thread-row sums [2][R][C] (R
    = CLUSTER_THREADS // (C*itemsize/16) rows per step), per-channel sums
    [2][C], this rank's per-group partials [2][G], every rank's [k][2][G],
    and per-channel a and b [2][C], all f32. ``csrc/fused_norm.cu::
    cluster_smem`` computes the same."""
    r = CLUSTER_THREADS // (c * itemsize // 16)
    slot_rows = -(-rows // CHUNKS)
    return (SLOTS * slot_rows * c * itemsize + _BAR_BYTES
            + 4 * (2 * r * c + 4 * c + 2 * groups + 2 * k * groups))


def coop_threads(c: int, itemsize: int) -> int:
    """Threads of a one-read block: a whole number of rows of 16-byte
    slices, at most COOP_THREADS (``csrc/fused_norm.cu::coop_threads``)."""
    tpr = c * itemsize // 16
    return tpr * (COOP_THREADS // tpr)


def coop_tiles(n: int, row_bytes: int) -> Tuple[int, int]:
    """(rows a tile, tiles a sample) of the one-read kernel for a sample of
    ``n`` rows of ``row_bytes``: about COOP_TILE_BYTES a tile, the rows
    spread evenly so that only the last tile is short."""
    rows = max(1, COOP_TILE_BYTES // row_bytes)
    tiles = -(-n // rows)
    rows = -(-n // tiles)
    return rows, -(-n // rows)


def coop_smem(rows: int, c: int, groups: int, itemsize: int) -> int:
    """Dynamic shared memory of a one-read block whose tile holds ``rows``
    rows: the tile, the mbarriers, the per-thread-row sums [2][R][C], the
    per-channel sums, a and b [4][C], the per-group sums, mean and inv
    [4][G] (f32) and COOP_FOLD staged float2 partials.
    ``csrc/fused_norm.cu::coop_smem`` computes the same."""
    r = coop_threads(c, itemsize) // (c * itemsize // 16)
    return (rows * c * itemsize + _BAR_BYTES + 4 * (2 * r * c + 4 * c + 4 * groups)
            + 8 * COOP_FOLD)


def nominal_resident(plan: "K3Plan", threads: int) -> int:
    """Blocks of the one-read kernel an H100 holds at once, counting shared
    memory and threads only (the card's own count, from the occupancy
    calculator, also counts registers: ``coop_resident``)."""
    per_sm = min(SM_SMEM // (plan.smem_bytes + BLOCK_SMEM_RESERVED), 2048 // threads, 32)
    return H100_SMS * per_sm


def coop_grid(b: int, plan: "K3Plan") -> int:
    """Blocks of a one-read launch over b samples: whole samples, as many
    as the resident blocks hold at once (so a round of tiles holds its
    samples' barriers whole), and no more than the tiles."""
    return min(b, plan.resident // plan.tiles) * plan.tiles


def _two_pass_vec(c: int, itemsize: int, aligned: bool) -> int:
    """Elements a two-pass thread moves at once: 16 bytes where C and the
    pointer allow, else 1."""
    v = 16 // itemsize
    return v if c % v == 0 and aligned else 1


def kernel_for(dtype: torch.dtype, n: int, c: int, groups: int, *,
               aligned: bool = True,
               resident: Optional[Callable[["K3Plan", int], int]] = None) -> K3Plan:
    """The K3 variant that takes x [B, n, c] of this dtype with ``groups``
    groups on the card. "cluster" when C <= CLUSTER_THREADS (a thread a
    channel), C*itemsize is a multiple of 16, x is 16-byte aligned and a
    sample fits in k <= 16 CTAs (k the least power of two) of at most
    MAX_SMEM bytes each, scratch included; else, for float32, "coop" when
    C*itemsize is a multiple of 16 of at most COOP_THREADS slices, x is
    aligned and a sample's tiles (``coop_tiles``) are no more than the
    blocks the card holds at once: ``resident(plan, threads)``, by default
    an H100's count by shared memory and threads (``nominal_resident``);
    else "two_pass". In bfloat16 the two-pass kernels beat the one-read
    kernel at every UNet site beyond the cluster (1.4-2.7x at a volume's
    rows), whose rounds hold one or two samples across a barrier; in
    float32 the two are even at 32 samples and the one-read kernel leads
    below. Raises on what no variant takes."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"fused_groupnorm_silu takes float32 or bfloat16, got {dtype}")
    if n < 1 or c < 1 or groups < 1:
        raise ValueError(f"fused_groupnorm_silu needs n, c, groups >= 1, got {n}, {c}, {groups}")
    if c % groups:
        raise ValueError(f"channels {c} do not split into {groups} groups")
    itemsize = torch.empty((), dtype=dtype).element_size()
    row_bytes = c * itemsize
    if aligned and row_bytes % 16 == 0 and c <= CLUSTER_THREADS:
        k = 1
        while k <= CLUSTER_MAX:
            rows = -(-n // k)
            smem = cluster_smem(rows, c, groups, itemsize, k)
            if smem <= MAX_SMEM:
                return K3Plan("cluster", k, rows, smem)
            k *= 2
    if dtype == torch.float32 and aligned and row_bytes % 16 == 0 \
            and row_bytes // 16 <= COOP_THREADS:
        rows, tiles = coop_tiles(n, row_bytes)
        smem = coop_smem(rows, c, groups, itemsize)
        if smem <= MAX_SMEM:
            plan = K3Plan("coop", 0, rows, smem, tiles)
            held = (resident or nominal_resident)(plan, coop_threads(c, itemsize))
            if tiles <= held:
                return plan._replace(resident=held)
    if c // _two_pass_vec(c, itemsize, aligned) > TWO_PASS_MAX_THREADS:
        raise ValueError(f"fused_groupnorm_silu does not take {c} channels of {dtype} "
                         "at this alignment")
    return K3Plan("two_pass")


def _as_bnc(x: torch.Tensor) -> torch.Tensor:
    if x.dim() == 4:
        return x.reshape(x.shape[0], x.shape[1] * x.shape[2], x.shape[3])
    if x.dim() != 3:
        raise ValueError(f"x must be [B, H, W, C] or [B, N, C], got {tuple(x.shape)}")
    return x


def _card_plan(x: torch.Tensor, groups: int) -> K3Plan:
    """Check a CUDA x [B, N, C] and return the plan ``kernel_for`` picks for
    it (raising on what neither variant takes)."""
    b, n, c = x.shape
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("fused_groupnorm_silu needs a contiguous x")
    if b > 65535:
        raise ValueError(f"fused_groupnorm_silu takes at most 65535 samples, got {b}")
    device = x.device.index if x.device.index is not None else torch.cuda.current_device()
    return _plan_on_card(x.dtype, n, c, groups, x.data_ptr() % 16 == 0, device)


@functools.lru_cache(maxsize=None)
def _plan_on_card(dtype: torch.dtype, n: int, c: int, groups: int, aligned: bool,
                  device: int) -> K3Plan:
    """``kernel_for`` with card ``device``'s own count of resident one-read
    blocks, kept per shape (the wrapper's host time is of the order of the
    small kernels' device time)."""
    return kernel_for(dtype, n, c, groups, aligned=aligned,
                      resident=lambda plan, threads: coop_resident(
                          plan.rows_per_rank, c=c, groups=groups, dtype=dtype, device=device))


def _card_params(x, gamma, beta, film):
    """gamma, beta and FiLM as contiguous float32 tensors on x's device, and
    the FiLM row count (0 without FiLM)."""
    b, _, c = x.shape
    dev = x.device
    gamma = gamma.to(device=dev, dtype=torch.float32).contiguous()
    beta = beta.to(device=dev, dtype=torch.float32).contiguous()
    if gamma.shape != (c,) or beta.shape != (c,):
        raise ValueError(f"gamma and beta must be [{c}]")
    fs = fsh = None
    film_rows = 0
    if film is not None:
        fs, fsh = (f.to(device=dev, dtype=torch.float32).contiguous() for f in film)
        film_rows = fs.shape[0]
        if fs.shape != (film_rows, c) or fsh.shape != fs.shape or film_rows not in (1, b):
            raise ValueError(f"film must be two [1 or {b}, {c}] tensors")
    return gamma, beta, fs, fsh, film_rows


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch_cluster(x, plan, gamma, beta, film, groups, eps, apply_silu, numerics=TPU):
    """One launch of the cluster kernel on a checked x [B, N, C] with its
    ``plan``, in ``numerics``; counted in both wrappers' ``launches``."""
    gamma, beta, fs, fsh, film_rows = _card_params(x, gamma, beta, film)
    b, n, c = x.shape
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    clusters = resident_clusters(plan, c, groups, x.dtype, torch.cuda.current_device())
    _build.check(_fns()["fused_groupnorm_silu_cluster"](
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), _ptr(fs), _ptr(fsh), film_rows,
        out.data_ptr(), b, n, c, groups, _DTYPE_CODES[x.dtype], plan.k,
        plan.rows_per_rank, clusters, eps, int(apply_silu), numerics, stream),
        "fused_groupnorm_silu_cluster launch")
    fused_groupnorm_silu_cluster.launches += 1
    fused_groupnorm_silu.launches += 1
    return out


def _launch_two_pass(x, plan, gamma, beta, film, groups, eps, apply_silu, numerics=TPU):
    """One call of the two-pass kernels (statistics, their fold, then apply)
    on a checked x [B, N, C]; counted once in both wrappers' ``launches``."""
    gamma, beta, fs, fsh, film_rows = _card_params(x, gamma, beta, film)
    b, n, c = x.shape
    vec = _two_pass_vec(c, x.element_size(), x.data_ptr() % 16 == 0)
    fns = _fns()
    tiles = fns["fused_groupnorm_tiles"](n, c, vec)
    # the tiles' partials [B, tiles, G, 2], then their sums [B, G, 2]
    partial = torch.empty(b * (tiles + 1) * groups * 2, dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(fns["fused_groupnorm_silu_two_pass"](
        x.data_ptr(), partial.data_ptr(), gamma.data_ptr(), beta.data_ptr(), _ptr(fs),
        _ptr(fsh), film_rows, out.data_ptr(), b, n, c, groups, _DTYPE_CODES[x.dtype],
        vec, eps, int(apply_silu), numerics, stream),
        "fused_groupnorm_silu_two_pass launch")
    fused_groupnorm_silu_two_pass.launches += 1
    fused_groupnorm_silu.launches += 1
    return out


# (device, stream) -> uint32 counters the one-read kernel leaves at zero
_coop_counters = {}


def _counters(device: torch.device, b: int) -> torch.Tensor:
    """At least 2*b zero uint32 counters for the one-read kernel on
    ``device``'s current stream: zeroed once, and set back to zero by every
    launch that uses them, so launches on one stream share them."""
    stream = torch.cuda.current_stream(device)
    key = (device.index, stream.cuda_stream)
    buf = _coop_counters.get(key)
    if buf is None or buf.numel() < 2 * b:
        buf = torch.zeros(2 * b, dtype=torch.int32, device=device)
        _coop_counters[key] = buf
    return buf


def _launch_coop(x, plan, gamma, beta, film, groups, eps, apply_silu, numerics=TPU):
    """One cooperative launch of the one-read kernel on a checked x
    [B, N, C] with its ``plan``; counted in both wrappers' ``launches``."""
    gamma, beta, fs, fsh, film_rows = _card_params(x, gamma, beta, film)
    b, n, c = x.shape
    partial = torch.empty((b, plan.tiles, groups, 2), dtype=torch.float32, device=x.device)
    counters = _counters(x.device, b)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(_fns()["fused_groupnorm_silu_coop"](
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), _ptr(fs), _ptr(fsh), film_rows,
        out.data_ptr(), partial.data_ptr(), counters.data_ptr(), b, n, c, groups,
        _DTYPE_CODES[x.dtype], plan.rows_per_rank, plan.tiles, coop_grid(b, plan), eps,
        int(apply_silu), numerics, stream),
        "fused_groupnorm_silu_coop launch")
    fused_groupnorm_silu_coop.launches += 1
    fused_groupnorm_silu.launches += 1
    return out


_LAUNCH = {"cluster": _launch_cluster, "coop": _launch_coop, "two_pass": _launch_two_pass}


def fused_groupnorm_silu_cluster(x: torch.Tensor, gamma: torch.Tensor,
                                 beta: torch.Tensor, film: Film = None, *,
                                 groups: int = 32, eps: float = 1e-6,
                                 apply_silu: bool = True) -> torch.Tensor:
    """K3's one-pass variant: one launch of as many thread-block clusters as
    the card holds at once, each holding one sample at a time.
    Raises for a shape ``kernel_for`` gives to the two-pass kernel. A CPU
    tensor takes the plain version. Counts its launches in
    ``fused_groupnorm_silu_cluster.launches`` and
    ``fused_groupnorm_silu.launches``."""
    shape = x.shape
    x = _as_bnc(x)
    if x.device.type == "cpu":
        return groupnorm_silu_reference(x, gamma, beta, film, groups=groups, eps=eps,
                                        apply_silu=apply_silu).reshape(shape)
    plan = _card_plan(x, groups)
    if plan.variant != "cluster":
        raise ValueError(f"the cluster kernel does not take {x.dtype} x {tuple(x.shape)} "
                         f"(data_ptr % 16 = {x.data_ptr() % 16})")
    return _launch_cluster(x, plan, gamma, beta, film, groups, eps,
                           apply_silu).reshape(shape)


def fused_groupnorm_silu_coop(x: torch.Tensor, gamma: torch.Tensor,
                              beta: torch.Tensor, film: Film = None, *,
                              groups: int = 32, eps: float = 1e-6,
                              apply_silu: bool = True) -> torch.Tensor:
    """K3's one-read variant, float32 only: one cooperative launch of
    resident blocks, a tile of a sample in each block's shared memory across
    a per-sample barrier. Raises for a shape ``kernel_for`` gives to another variant. A
    CPU tensor takes the plain version. Counts its launches in
    ``fused_groupnorm_silu_coop.launches`` and
    ``fused_groupnorm_silu.launches``."""
    shape = x.shape
    x = _as_bnc(x)
    if x.device.type == "cpu":
        return groupnorm_silu_reference(x, gamma, beta, film, groups=groups, eps=eps,
                                        apply_silu=apply_silu).reshape(shape)
    plan = _card_plan(x, groups)
    if plan.variant != "coop":
        raise ValueError(f"the one-read kernel does not take {x.dtype} x {tuple(x.shape)} "
                         f"(kernel_for picked {plan.variant})")
    return _launch_coop(x, plan, gamma, beta, film, groups, eps, apply_silu).reshape(shape)


def fused_groupnorm_silu_two_pass(x: torch.Tensor, gamma: torch.Tensor,
                                  beta: torch.Tensor, film: Film = None, *,
                                  groups: int = 32, eps: float = 1e-6,
                                  apply_silu: bool = True) -> torch.Tensor:
    """K3's two-pass variant (statistics, their sums a sample, then apply,
    over pixel tiles); it takes every shape ``kernel_for`` takes. A CPU
    tensor takes the plain version. Counts its launches (one per call, of
    its three kernels) in
    ``fused_groupnorm_silu_two_pass.launches`` and
    ``fused_groupnorm_silu.launches``."""
    shape = x.shape
    x = _as_bnc(x)
    if x.device.type == "cpu":
        return groupnorm_silu_reference(x, gamma, beta, film, groups=groups, eps=eps,
                                        apply_silu=apply_silu).reshape(shape)
    plan = _card_plan(x, groups)
    return _launch_two_pass(x, plan, gamma, beta, film, groups, eps,
                            apply_silu).reshape(shape)


# variant name (``K3Plan.variant``) -> its wrapper
VARIANTS = {"cluster": fused_groupnorm_silu_cluster,
            "coop": fused_groupnorm_silu_coop,
            "two_pass": fused_groupnorm_silu_two_pass}


@functools.lru_cache(maxsize=None)
def resident_clusters(plan: K3Plan, c: int, groups: int, dtype: torch.dtype,
                      device: int) -> int:
    """How many clusters of ``plan`` card ``device`` holds at once
    (``cudaOccupancyMaxActiveClusters``): the cluster kernel launches that
    many persistent clusters, each walking its share of the samples."""
    n = _fns()["fused_groupnorm_cluster_occupancy"](plan.k, plan.rows_per_rank, c, groups,
                                                    _DTYPE_CODES[dtype])
    if n < 1:
        raise RuntimeError(f"the card holds no cluster of {plan} "
                           f"(cudaOccupancyMaxActiveClusters: {n})")
    return n


@functools.lru_cache(maxsize=None)
def coop_resident(rows_per_tile: int, *, c: int, groups: int, dtype: torch.dtype,
                  device: int) -> int:
    """How many one-read blocks with tiles of ``rows_per_tile`` rows card
    ``device`` holds at once (the occupancy calculator's blocks an SM, times
    the SMs): the most its cooperative launch may take."""
    with torch.cuda.device(device):
        n = _fns()["fused_groupnorm_coop_resident"](rows_per_tile, c, groups,
                                                    _DTYPE_CODES[dtype])
    if n < 1:
        raise RuntimeError(f"the card holds no one-read block of {rows_per_tile} rows "
                           f"x {c} {dtype} (occupancy: {n})")
    return n


def coop_smem_on_card(plan: K3Plan, c: int, groups: int, dtype: torch.dtype) -> int:
    """The one-read kernel's own count of its shared memory for ``plan``."""
    return _fns()["fused_groupnorm_coop_smem"](plan.rows_per_rank, c, groups,
                                               _DTYPE_CODES[dtype])


def cluster_smem_on_card(plan: K3Plan, c: int, groups: int, dtype: torch.dtype) -> int:
    """The cluster kernel's own count of its shared memory for ``plan``."""
    return _fns()["fused_groupnorm_cluster_smem"](plan.rows_per_rank, c, groups,
                                                  _DTYPE_CODES[dtype], plan.k)


def bf16_slice_check(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                     apply_silu: bool, numerics: int = TPU, film: Film = None):
    """The kernels' bf16x2 arithmetic against their generic per-element
    rounding, on the card, in ``numerics``: x bf16 [M, 8] with its own
    bf16-valued a, b (float32 [M, 8]), and for ``FOLD_FILM_AFTER`` its own
    bf16-valued FiLM (scale, shift), through both. Returns (y packed, y
    generic, square packed, square generic); each pair must be equal bit for
    bit."""
    if x.device.type != "cuda" or x.dtype != torch.bfloat16 or x.dim() != 2 \
            or x.shape[1] != 8 or not x.is_contiguous():
        raise ValueError("bf16_slice_check takes a contiguous CUDA bf16 x [M, 8]")
    if (film is not None) != (numerics == FOLD_FILM_AFTER):
        raise ValueError("bf16_slice_check takes a FiLM with FOLD_FILM_AFTER only")
    coefs = [t.to(device=x.device, dtype=torch.float32).contiguous()
             for t in (a, b, *(film or ()))]
    if any(t.shape != x.shape for t in coefs):
        raise ValueError("a, b and the FiLM must have x's shape")
    fs, fsh = coefs[2:] if film is not None else (None, None)
    y_packed, y_generic = torch.empty_like(x), torch.empty_like(x)
    sq_packed, sq_generic = (torch.empty(x.shape, dtype=torch.float32, device=x.device)
                             for _ in range(2))
    _build.check(_fns()["fused_groupnorm_slice_check"](
        x.data_ptr(), coefs[0].data_ptr(), coefs[1].data_ptr(), _ptr(fs), _ptr(fsh),
        y_packed.data_ptr(), y_generic.data_ptr(), sq_packed.data_ptr(),
        sq_generic.data_ptr(), x.shape[0], int(apply_silu), numerics,
        torch.cuda.current_stream(x.device).cuda_stream),
        "fused_groupnorm_slice_check launch")
    return y_packed, y_generic, sq_packed, sq_generic


def fused_groupnorm_silu(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                         film: Film = None, *, groups: int = 32, eps: float = 1e-6,
                         apply_silu: bool = True) -> torch.Tensor:
    """GroupNorm + optional FiLM ``y*(1+scale)+shift`` + optional SiLU.

    x: [B, H, W, C] or [B, N, C], float32 or bfloat16; gamma, beta [C];
    film = (scale, shift), each [B or 1, C] of any float dtype. Returns x's
    shape and dtype. For a CUDA tensor it launches the K3 variant that
    ``kernel_for`` picks, with no fallback; the plain version serves a CPU
    tensor only. ``fused_groupnorm_silu.launches`` counts the launches of
    every variant."""
    x3 = _as_bnc(x)
    if x3.device.type == "cpu":
        out = groupnorm_silu_reference(x3, gamma, beta, film, groups=groups, eps=eps,
                                       apply_silu=apply_silu)
        return out.reshape(x.shape)
    plan = _card_plan(x3, groups)
    return _LAUNCH[plan.variant](x3, plan, gamma, beta, film, groups, eps,
                                 apply_silu).reshape(x.shape)


def fused_groupnorm_fold(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                         film: Film = None, *, film_after: bool = False, groups: int = 32,
                         eps: float = 1e-5, apply_silu: bool = False) -> torch.Tensor:
    """K3 in the UNet's fold numerics, on the card: ``GroupNorm32``'s fold
    (``f32_apply=False``) of x [B, H, W, C] or [B, N, C] (float32 or
    bfloat16, contiguous), then the ResBlock's FiLM, film = (scale, shift)
    [B or 1, C] of x's dtype's values, composed into the coefficients in
    float32 (as ``film_fold``) or, with ``film_after``, applied after the
    norm in x's dtype, ``y*(1+scale)+shift``; then SiLU as torch computes it.
    One call of the variant ``kernel_for`` picks (one kernel, or the
    two-pass variant's three), counted once in its own and in
    ``fused_groupnorm_silu.launches``. The eager chain
    (``GroupNorm32.eager``) is its plain version; a CPU tensor raises."""
    x3 = _as_bnc(x)
    if x3.device.type != "cuda":
        raise ValueError(f"fused_groupnorm_fold runs on the card, got {x3.device}")
    if film_after and film is None:
        raise ValueError("film_after needs a FiLM")
    plan = _card_plan(x3, groups)
    numerics = FOLD_FILM_AFTER if film_after else FOLD
    return _LAUNCH[plan.variant](x3, plan, gamma, beta, film, groups, eps, apply_silu,
                                 numerics).reshape(x.shape)


fused_groupnorm_silu.launches = 0
fused_groupnorm_silu_cluster.launches = 0
fused_groupnorm_silu_coop.launches = 0
fused_groupnorm_silu_two_pass.launches = 0
