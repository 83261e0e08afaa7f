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
- ``fused_groupnorm_silu_two_pass``: a statistics launch and an apply launch
  over pixel tiles, for the shapes the cluster kernel does not take.

Both mirror the TPU kernel's own numerics, not the twin's: the square is
taken in x's dtype, the folded per-channel ``a``, ``b`` are rounded to x's
dtype before ``x*a + b``, and the SiLU runs in y's dtype. In float32 they
match the plain version to ~1e-6; in bfloat16 to one or two bf16 ulps.

No model of either package calls this op: the UNets keep their unfused
GroupNorm, whose eps and rounding differ (``models/unet.py::GroupNorm32``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

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

Film = Optional[Tuple[torch.Tensor, torch.Tensor]]

_C = ctypes.c_int
_P = ctypes.c_void_p
_ARGTYPES = {
    "fused_groupnorm_tiles": [_C, _C, _C],
    "fused_groupnorm_silu_two_pass": [_P] * 6 + [_C, _P] + [_C] * 6
    + [ctypes.c_float, _C, _P],
    "fused_groupnorm_silu_cluster": [_P] * 5 + [_C, _P] + [_C] * 8
    + [ctypes.c_float, _C, _P],
    "fused_groupnorm_cluster_smem": [_C] * 5,
    "fused_groupnorm_cluster_occupancy": [_C] * 5,
    "fused_groupnorm_slice_check": [_P] * 7 + [_C, _C, _P],
}


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
    """What ``kernel_for`` picks: the variant ("cluster" or "two_pass"); for
    the cluster kernel, the CTAs per cluster (one cluster per sample), the
    rows each rank holds and the dynamic shared memory per CTA (all 0 for
    the two-pass kernel)."""
    variant: str
    k: int = 0
    rows_per_rank: int = 0
    smem_bytes: int = 0


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


def _two_pass_vec(c: int, itemsize: int, aligned: bool) -> int:
    """Elements a two-pass thread moves at once: 16 bytes where C and the
    pointer allow, else 1."""
    v = 16 // itemsize
    return v if c % v == 0 and aligned else 1


def kernel_for(dtype: torch.dtype, n: int, c: int, groups: int, *,
               aligned: bool = True) -> K3Plan:
    """The K3 variant that takes x [B, n, c] of this dtype with ``groups``
    groups on the card. "cluster" when C <= CLUSTER_THREADS (a thread a
    channel), C*itemsize is a multiple of 16, x is 16-byte aligned and a
    sample fits in k <= 16 CTAs (k the least power of two) of at most
    MAX_SMEM bytes each, scratch included; else "two_pass". Raises on what
    neither variant takes."""
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
    return kernel_for(x.dtype, n, c, groups, aligned=x.data_ptr() % 16 == 0)


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


def _launch_cluster(x, plan, gamma, beta, film, groups, eps, apply_silu):
    """One launch of the cluster kernel on a checked x [B, N, C] with its
    ``plan``; counted in both wrappers' ``launches``."""
    gamma, beta, fs, fsh, film_rows = _card_params(x, gamma, beta, film)
    b, n, c = x.shape
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    clusters = resident_clusters(plan, c, groups, x.dtype, torch.cuda.current_device())
    _build.check(_fns()["fused_groupnorm_silu_cluster"](
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), _ptr(fs), _ptr(fsh), film_rows,
        out.data_ptr(), b, n, c, groups, _DTYPE_CODES[x.dtype], plan.k,
        plan.rows_per_rank, clusters, eps, int(apply_silu), stream),
        "fused_groupnorm_silu_cluster launch")
    fused_groupnorm_silu_cluster.launches += 1
    fused_groupnorm_silu.launches += 1
    return out


def _launch_two_pass(x, plan, gamma, beta, film, groups, eps, apply_silu):
    """One call of the two-pass kernels (statistics, then apply) on a
    checked x [B, N, C]; counted once in both wrappers' ``launches``."""
    gamma, beta, fs, fsh, film_rows = _card_params(x, gamma, beta, film)
    b, n, c = x.shape
    vec = _two_pass_vec(c, x.element_size(), x.data_ptr() % 16 == 0)
    fns = _fns()
    tiles = fns["fused_groupnorm_tiles"](n, c, vec)
    partial = torch.empty((b, tiles, groups, 2), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(fns["fused_groupnorm_silu_two_pass"](
        x.data_ptr(), partial.data_ptr(), gamma.data_ptr(), beta.data_ptr(), _ptr(fs),
        _ptr(fsh), film_rows, out.data_ptr(), b, n, c, groups, _DTYPE_CODES[x.dtype],
        vec, eps, int(apply_silu), stream),
        "fused_groupnorm_silu_two_pass launch")
    fused_groupnorm_silu_two_pass.launches += 1
    fused_groupnorm_silu.launches += 1
    return out


_LAUNCH = {"cluster": _launch_cluster, "two_pass": _launch_two_pass}


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


def fused_groupnorm_silu_two_pass(x: torch.Tensor, gamma: torch.Tensor,
                                  beta: torch.Tensor, film: Film = None, *,
                                  groups: int = 32, eps: float = 1e-6,
                                  apply_silu: bool = True) -> torch.Tensor:
    """K3's two-launch variant (statistics, then apply, over pixel tiles); it
    takes every shape ``kernel_for`` takes. A CPU tensor takes the plain
    version. Counts its launches (one per call, of its two kernels) in
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


def cluster_smem_on_card(plan: K3Plan, c: int, groups: int, dtype: torch.dtype) -> int:
    """The cluster kernel's own count of its shared memory for ``plan``."""
    return _fns()["fused_groupnorm_cluster_smem"](plan.rows_per_rank, c, groups,
                                                  _DTYPE_CODES[dtype], plan.k)


def bf16_slice_check(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                     apply_silu: bool):
    """The kernels' bf16x2 arithmetic against their generic per-element
    rounding, on the card: x bf16 [M, 8] with its own bf16-valued a, b
    (float32 [M, 8]) through both. Returns (y packed, y generic, square
    packed, square generic); each pair must be equal bit for bit."""
    if x.device.type != "cuda" or x.dtype != torch.bfloat16 or x.dim() != 2 \
            or x.shape[1] != 8 or not x.is_contiguous():
        raise ValueError("bf16_slice_check takes a contiguous CUDA bf16 x [M, 8]")
    a, b = (t.to(device=x.device, dtype=torch.float32).contiguous() for t in (a, b))
    if a.shape != x.shape or b.shape != x.shape:
        raise ValueError("a and b must have x's shape")
    y_packed, y_generic = torch.empty_like(x), torch.empty_like(x)
    sq_packed, sq_generic = (torch.empty(x.shape, dtype=torch.float32, device=x.device)
                             for _ in range(2))
    _build.check(_fns()["fused_groupnorm_slice_check"](
        x.data_ptr(), a.data_ptr(), b.data_ptr(), y_packed.data_ptr(),
        y_generic.data_ptr(), sq_packed.data_ptr(), sq_generic.data_ptr(), x.shape[0],
        int(apply_silu), torch.cuda.current_stream(x.device).cuda_stream),
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
    both variants."""
    x3 = _as_bnc(x)
    if x3.device.type == "cpu":
        out = groupnorm_silu_reference(x3, gamma, beta, film, groups=groups, eps=eps,
                                       apply_silu=apply_silu)
        return out.reshape(x.shape)
    plan = _card_plan(x3, groups)
    return _LAUNCH[plan.variant](x3, plan, gamma, beta, film, groups, eps,
                                 apply_silu).reshape(x.shape)


fused_groupnorm_silu.launches = 0
fused_groupnorm_silu_cluster.launches = 0
fused_groupnorm_silu_two_pass.launches = 0
