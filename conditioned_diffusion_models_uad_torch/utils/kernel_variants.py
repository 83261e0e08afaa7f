"""Times variants of the hand-written kernels against the shipped ones, in
turns, on one card.

    python -m conditioned_diffusion_models_uad_torch.utils.kernel_variants \
        [k1] [k2] [k2long] [k3] [residual]

A variant is a library's source, ``csrc/<library>.cu``, with a few textual
changes (``VARIANTS[library][name]``), built with the library's nvcc flags
into ``_build/``, all nvcc runs in parallel. A variant whose changes no
longer apply to the source is skipped, and the output names it. Each
kernel's variants are timed in the order shipped, variants, variants
reversed, shipped, and each shape prints one JSON line with the readings,
each kernel's largest difference from the plain version and the card's name
and power limit:

- K1 (``simplex_noise``): device µs a launch (torch.profiler) at
  [N, 96, 96] for N = 1 (the train step's field), 2, 4 and 6 (the
  reconstruction's fields) and at [3, 37, 130], and whether each layout's
  field equals the shipped kernel's bit for bit;
- K2 (``attention_mma``): ms (CUDA events) at qkv [576, 576, 3, 4, 64] bf16
  (eval) and [32, 576, 3, 4, 64] (train);
- K2 beyond S = 576 (``attention_mma_long``, ``k2long``): ms (CUDA events)
  at qkv [312, 2304, 3, 4, 64] bf16 (a full-resolution eval volume),
  [32, 2304, 3, 4, 64] (its train step) and [576, 576, 3, 4, 64];
- K3 (``fused_norm``): ms (CUDA events) of the cluster kernel, the two-pass
  kernel and the variants at the UNet's three norm-site shapes (bf16, FiLM
  [288, C], SiLU on), whether each output equals the shipped cluster
  kernel's bit for bit, and, from the ``phases`` variant's ``%globaltimer``
  stamps at the phase boundaries of every CTA, each phase's mean length and
  the CTAs' mean time a sample beside the kernel's span;
- the ResBlock output sum (``residual``): device ms a launch (torch.profiler)
  at [312, 128, 192, 192] bf16 with and without a skip bias and at
  [104, 256, 256, 256], the rate in TB/s of two reads and a write, and
  whether each output equals the plain version bit for bit.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys
from typing import Optional

import torch

from ..ops import _build
from ..ops import attention as A
from ..ops import fused_norm as F3
from ..ops import residual as R
from ..ops import simplex_hash as K1
from .timing import cuda_ms, profiled_kernel_ms

# name -> list of (text in the shipped source, replacement)
K2_VARIANTS = {
    # FA3-style turns: the two query groups take the tensor cores in turn
    # (named barriers 3 and 4), so that one group's exps run under the
    # other's products; only when both groups take the same number of slices
    "turns": [
        ("""__device__ __forceinline__ void ldsm_x4(""",
         """__device__ __forceinline__ void turn_wait(int grp) {
  asm volatile("bar.sync %0, %1;\\n" :: "r"(3 + grp), "n"(kThreads) : "memory");
}
__device__ __forceinline__ void turn_pass(int grp) {
  asm volatile("bar.arrive %0, %1;\\n" :: "r"(3 + (1 - grp)), "n"(kThreads) : "memory");
}
__device__ __forceinline__ void ldsm_x4("""),
        ("""  uint4 qnext = load_q(grp);
""", """  uint4 qnext = load_q(grp);
  const bool turns = n_slices % kGroups == 0;
  if (turns && grp == 1) turn_pass(grp);
"""),
        ("""    uint32_t qa[KD][4];
""", """    const bool last = sl + kGroups >= n_slices;
    if (turns) turn_wait(grp);
    uint32_t qa[KD][4];
"""),
        ("""        mma16816(sc[2 * j + 1], qa[kk], kf[2], kf[3]);
      }
    }
""", """        mma16816(sc[2 * j + 1], qa[kk], kf[2], kf[3]);
      }
    }
    if (turns) turn_pass(grp);
"""),
        ("""    float o[DT][4];
""", """    if (turns) turn_wait(grp);
    float o[DT][4];
"""),
        ("""        mma16816(o[2 * dp + 1], pa[j], vf[2], vf[3]);
      }
    }
""", """        mma16816(o[2 * dp + 1], pa[j], vf[2], vf[3]);
      }
    }
    if (turns && !(grp == 1 && last)) turn_pass(grp);
"""),
    ],
    # the mma asm not volatile, so the compiler may move it freely
    "mma_not_volatile": [
        ("""  asm volatile(
      "mma.sync""", """  asm(
      "mma.sync"""),
    ],
    # V awaited only before the first P.V, so its copy overlaps the first Q.K
    "v_late": [
        ("""  cp_wait<0>();
  __syncthreads();

  const int n_slices = (S + 15) / 16;""", """  const int n_slices = (S + 15) / 16;
  const bool v_late = n_slices >= kGroups;
  if (!v_late) cp_wait<0>();
  __syncthreads();"""),
        ("""    float o[DT][4];
""", """    if (v_late && sl == grp) {
      cp_wait<0>();
      asm volatile("bar.sync 5, %0;\\n" :: "n"(kThreads) : "memory");
    }
    float o[DT][4];
"""),
    ],
    # the exp argument as one FFMA, s * log2e - m * log2e
    "ffma_exp": [
        ("""    float l0 = 0.0f, l1 = 0.0f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      sc[n][0] = ex2((sc[n][0] - m0) * kLog2e);
      sc[n][1] = ex2((sc[n][1] - m0) * kLog2e);
      sc[n][2] = ex2((sc[n][2] - m1) * kLog2e);
      sc[n][3] = ex2((sc[n][3] - m1) * kLog2e);""",
         """    float l0 = 0.0f, l1 = 0.0f;
    const float mb0 = -m0 * kLog2e, mb1 = -m1 * kLog2e;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      sc[n][0] = ex2(fmaf(sc[n][0], kLog2e, mb0));
      sc[n][1] = ex2(fmaf(sc[n][1], kLog2e, mb0));
      sc[n][2] = ex2(fmaf(sc[n][2], kLog2e, mb1));
      sc[n][3] = ex2(fmaf(sc[n][3], kLog2e, mb1));"""),
    ],
}


# phase boundaries stamped by the K3 ``phases`` variant, in order, for each
# sample a CTA takes
PHASES = ["start", "stats", "cta_sum", "cluster_sync1", "dsmem_read", "coef",
          "applied", "next_loads"]
_STAMP = """
__device__ unsigned long long* k3_stamps;  // [ctas][8], set by k3_set_stamps
__device__ long long k3_stamp_ctas;
// phase boundary i of this CTA's work on sample s
__device__ __forceinline__ void stamp(long long s, int i) {
  const long long cta = s * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0 && cta < k3_stamp_ctas) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    k3_stamps[cta * 8 + i] = t;
  }
}
"""

K3_VARIANTS = {
    # globaltimer stamps at the phase boundaries (PHASES), read back by
    # k3_read_stamps
    "phases": [
        ("""template <typename T, bool SILU, int MODE>
__global__ void __launch_bounds__(kClusterThreads, 1)""",
         _STAMP + """template <typename T, bool SILU, int MODE>
__global__ void __launch_bounds__(kClusterThreads, 1)"""),
        ("""    float gam = 0.0f, bet = 0.0f, fsc = 0.0f, fsh = 0.0f;
""", """    stamp(s, 0);
    float gam = 0.0f, bet = 0.0f, fsc = 0.0f, fsh = 0.0f;
"""),
        ("""            *reinterpret_cast<const V*>(piece + (size_t)n * C + lane * VEC), s1, s2);
    }
#pragma unroll""",
         """            *reinterpret_cast<const V*>(piece + (size_t)n * C + lane * VEC), s1, s2);
    }
    stamp(s, 1);
#pragma unroll"""),
        ("""    // every rank's partials, read through distributed shared memory
    cluster.sync();
""", """    stamp(s, 2);
    // every rank's partials, read through distributed shared memory
    cluster.sync();
    stamp(s, 3);
"""),
        ("""    cluster_arrive();
""", """    cluster_arrive();
    stamp(s, 4);
"""),
        ("""    Slice<T, VEC> sl;
    sl.coef(a_c + lane * VEC, b_c + lane * VEC);
    if (MODE == kFoldFilmAfter) {
""", """    stamp(s, 5);
    Slice<T, VEC> sl;
    sl.coef(a_c + lane * VEC, b_c + lane * VEC);
    if (MODE == kFoldFilmAfter) {
"""),
        ("""    if (tid == 0 && pieces > 0) {
      asm volatile("cp.async.bulk.wait_group.read 0;\\n" ::: "memory");
      load_piece(P0 + pieces - 1 + kSlots);
    }
""", """    stamp(s, 6);
    if (tid == 0 && pieces > 0) {
      asm volatile("cp.async.bulk.wait_group.read 0;\\n" ::: "memory");
      load_piece(P0 + pieces - 1 + kSlots);
    }
    stamp(s, 7);
"""),
        ("""extern "C" int fused_groupnorm_cluster_smem(""",
         """extern "C" int k3_set_stamps(void* buf, long long ctas) {
  cudaError_t e = cudaMemcpyToSymbol(k3_stamps, &buf, sizeof(buf));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyToSymbol(k3_stamp_ctas, &ctas, sizeof(ctas));
}

extern "C" int fused_groupnorm_cluster_smem("""),
    ],
    # one cluster per sample (grid of B clusters), so no cluster loads the
    # next sample's pieces while it applies the current one
    "cluster_per_sample": [
        ("""  cudaError_t e = cluster_config<T, SILU, MODE>(k, rows_per_rank, c, g, &cfg, &attr,
                                               min(b, clusters));""",
         """  cudaError_t e = cluster_config<T, SILU, MODE>(k, rows_per_rank, c, g, &cfg, &attr, b);"""),
    ],
    # bf16 SiLU: every division through __fdiv_rn (div.rn.f32 with its range
    # check and slow-path branch) instead of silu_div
    "fdiv_rn_silu": [
        ("""      y2[p] = __floats2bfloat162_rn(silu_div(yf[p].x, d[p].x),
                                    silu_div(yf[p].y, d[p].y));""",
         """      y2[p] = __floats2bfloat162_rn(__fdiv_rn(yf[p].x, d[p].x),
                                    __fdiv_rn(yf[p].y, d[p].y));"""),
    ],
    # bf16 SiLU: ex2.approx and rcp.approx (__expf, __fdividef), rounded as
    # they are: not the function (a bf16 result may differ by one ulp), a
    # bound on what the accurate exp and divide cost
    "fast_silu": [
        ("""one, __floats2bfloat162_rn(expf(-yf[p].x), expf(-yf[p].y))));""",
         """one, __floats2bfloat162_rn(__expf(-yf[p].x), __expf(-yf[p].y))));"""),
        ("""      y2[p] = __floats2bfloat162_rn(silu_div(yf[p].x, d[p].x),
                                    silu_div(yf[p].y, d[p].y));""",
         """      y2[p] = __floats2bfloat162_rn(__fdividef(yf[p].x, d[p].x),
                                    __fdividef(yf[p].y, d[p].y));"""),
        ("""    if (!(largest < kSiluFastMax)) {  // rare: |y| >= 87 in the slice
#pragma unroll
      for (int p = 0; p < 4; ++p)
        y2[p] = __floats2bfloat162_rn(__fdiv_rn(yf[p].x, d[p].x),
                                      __fdiv_rn(yf[p].y, d[p].y));
    }
""", ""),
    ],
    # the second cluster barrier whole (cluster.sync()) right after the
    # partials are read, so the apply starts only once every peer has read
    "full_second_barrier": [
        ("    if (s != blockIdx.y) cluster_wait();\n", ""),
        ("    cluster_arrive();\n", "    cluster.sync();\n"),
        ("  }\n  cluster_wait();\n}", "  }\n}"),
    ],
    # one slot a piece (no spare slot): the next sample's piece i loads only
    # once this sample's piece i has been stored
    "no_spare_slot": [
        ("constexpr int kSlots = kChunks + 1; ", "constexpr int kSlots = kChunks; "),
    ],
}


# the long-sequence K2 kernel's layout: query rows a warp, warps, key tile,
# ring depth, blocks an SM it is built for
K2_LONG_VARIANTS = {
    # 16 query rows a warp (a 64-row tile): half the registers, three blocks
    # an SM, but every K and V fragment feeds one MMA, not two
    "mt1": [("constexpr int kMT = 2;", "constexpr int kMT = 1;"),
            ("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 3)")],
    # 8 warps (a 256-row query tile, one block an SM): half the L2 reads
    "warps8": [("constexpr int kWarps = 4;", "constexpr int kWarps = 8;"),
               ("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 1)")],
    # tiles of 32 keys: half the logit registers, twice the barriers
    "bk32": [("constexpr int kBK = 64; ", "constexpr int kBK = 32; ")],
    # two and four ring stages
    "stages2": [("constexpr int kStages = 3;", "constexpr int kStages = 2;")],
    "stages4": [("constexpr int kStages = 3;", "constexpr int kStages = 4;")],
}

_K1_CHOICE = "  if ((long long)n * h * w >= kOneLanePixels)\n"
_K1_SPLIT = "  return (int)launch<8>(seeds, out, n, h, w, octaves, oc, st);"

K1_VARIANTS = {
    # one lane a pixel at every size (the serial walk over the octaves)
    "one_lane": [(_K1_CHOICE, "  if (true)\n")],
    # eight lanes a pixel at every size
    "eight_lanes": [(_K1_CHOICE, "  if (false)\n")],
    # two lanes a pixel at every size (three octaves a lane at 6)
    "two_lanes": [(_K1_CHOICE, "  if (false)\n"),
                  (_K1_SPLIT, _K1_SPLIT.replace("<8>", "<2>"))],
    # the shipped layouts with IEEE divides (div.rn with its range check and
    # the branch to its slow path) instead of div_rn's inline sequence
    "ieee_divides": [
        ("  if ((a == 0.0f || (a >= 0x1p-60f && a <= 0x1p60f)) && d >= 0x1p-60f &&\n"
         "      d <= 0x1p60f) {", "  if (false) {"),
    ],
}

# the ResBlock output sum (csrc/residual.cu): vectors in flight a thread,
# blocks an SM, threads a block, cache hints
# the ResBlock output sum (csrc/residual.cu): vectors a thread, threads a
# block, cache hints
RESIDUAL_VARIANTS = {
    "unroll4": [("constexpr int kUnroll = 8;", "constexpr int kUnroll = 4;")],
    "unroll2": [("constexpr int kUnroll = 8;", "constexpr int kUnroll = 2;")],
    "threads128": [("constexpr int kThreads = 256;", "constexpr int kThreads = 128;")],
    "streaming": [("      sv[u] = s[j];\n      hv[u] = h[j];",
                   "      sv[u] = __ldcs(s + j);\n      hv[u] = __ldcs(h + j);"),
                  ("      out[j] = sum_vec<T, kSkipBias>(",
                   "      __stcs(out + j, sum_vec<T, kSkipBias>("),
                  ("bs + chs[u] * V, bo + chs[u] * V);\n  }\n}",
                   "bs + chs[u] * V, bo + chs[u] * V));\n  }\n}")],
}

VARIANTS = {"simplex_noise": K1_VARIANTS, "attention_mma": K2_VARIANTS,
            "attention_mma_long": K2_LONG_VARIANTS, "fused_norm": K3_VARIANTS,
            "residual": RESIDUAL_VARIANTS}


def apply_changes(src: str, changes) -> Optional[str]:
    """``src`` with each (old, new) change made, or None when an old text
    does not occur exactly once."""
    for old, new in changes:
        if src.count(old) != 1:
            return None
        src = src.replace(old, new)
    return src


def variant_source(library: str, name: str) -> Optional[str]:
    """The shipped ``csrc/<library>.cu`` with variant ``name``'s changes
    made, or None when they no longer apply."""
    return apply_changes((_build.CSRC / f"{library}.cu").read_text(),
                         VARIANTS[library][name])


def build_variants(library: str):
    """Compile every variant of ``library`` that applies, all nvcc runs in
    parallel. Returns (name -> loaded library, names skipped)."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, skipped = {}, []
    for name in VARIANTS[library]:
        src = variant_source(library, name)
        if src is None:
            skipped.append(name)
            continue
        digest = hashlib.sha256(src.encode()).hexdigest()[:16]
        cu = _build.BUILD_DIR / f"{library}-{name}-{digest}.cu"
        lib = cu.with_suffix(".so")
        cu.write_text(src)
        procs[name] = (subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, *_build.SOURCES[library],
             "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {library}/{name}: nvcc exit {proc.returncode}\n{err}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs, skipped


def _fn(lib, name, argtypes):
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _in_turns(kernels: dict, time_one) -> dict:
    """Readings of each kernel in the order given, then reversed."""
    readings = {}
    for name in list(kernels) + list(reversed(kernels)):
        readings.setdefault(name, []).append(time_one(kernels[name]))
    return readings


# --------------------------------------------------------------------------- #
# K1
# --------------------------------------------------------------------------- #
def _k1_caller(lib):
    fn = _fn(lib, "simplex_fractal_noise", K1._ARGTYPES["simplex_fractal_noise"])

    def call(seeds, shape):
        h, w = shape
        out = torch.empty((seeds.shape[0], h, w), dtype=torch.float32, device=seeds.device)
        consts = K1.octave_constants()
        _build.check(fn(seeds.data_ptr(), out.data_ptr(), seeds.shape[0], h, w, 6,
                        consts.data_ptr(), torch.cuda.current_stream(seeds.device).cuda_stream),
                     "simplex_fractal_noise variant launch")
        return out
    return call


def k1_main(card) -> None:
    libs, skipped = build_variants("simplex_noise")
    layouts = {"shipped": K1.fractal_noise_2d}
    layouts.update({name: _k1_caller(lib) for name, lib in libs.items()})
    g = torch.Generator().manual_seed(0)
    for shape, n in (((96, 96), 1), ((37, 130), 3), ((96, 96), 2), ((96, 96), 4),
                     ((96, 96), 6)):
        seeds = torch.randint(0, 2**31 - 1, (n,), generator=g, dtype=torch.int32).cuda()
        want = K1.fractal_noise_2d_hash(seeds, shape)
        us = _in_turns(layouts, lambda fn: 1e3 * profiled_kernel_ms(
            lambda: fn(seeds, shape), ("fractal_noise_kernel",)))
        outs = {name: fn(seeds, shape) for name, fn in layouts.items()}
        print(json.dumps({
            "kernel": "K1", "shape": [n, *shape], "device_us": us,
            "max_abs_err": {k: (o - want).abs().max().item() for k, o in outs.items()},
            "equal_to_shipped": {k: torch.equal(o, outs["shipped"]) for k, o in outs.items()},
            "skipped": skipped, "nvidia_smi": card}), flush=True)


# --------------------------------------------------------------------------- #
# K2
# --------------------------------------------------------------------------- #
def _k2_caller(lib):
    fn = _fn(lib, "attention_mma_fwd",
             [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
              ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])

    def call(qkv):
        b, s, _, h, d = qkv.shape
        out = torch.empty((b, s, h, d), dtype=qkv.dtype, device=qkv.device)
        _build.check(fn(qkv.data_ptr(), out.data_ptr(), b, s, h, d,
                        A.qk_scale(d, qkv.dtype),
                        torch.cuda.current_stream(qkv.device).cuda_stream),
                     "attention_mma_fwd variant launch")
        return out
    return call


def k2_main(card) -> None:
    libs, skipped = build_variants("attention_mma")
    kernels = {"shipped": A.attention_fwd_mma}
    kernels.update({name: _k2_caller(lib) for name, lib in libs.items()})
    g = torch.Generator().manual_seed(1)
    for shape in ((576, 576, 3, 4, 64), (32, 576, 3, 4, 64)):
        qkv = torch.randn(shape, generator=g).to(torch.bfloat16).cuda()
        want = A.attention_reference(qkv).float()
        ms = _in_turns(kernels, lambda fn: cuda_ms(lambda: fn(qkv), reps=30, warmup=3))
        err = {name: (fn(qkv).float() - want).abs().max().item()
               for name, fn in kernels.items()}
        print(json.dumps({"kernel": "K2", "shape": list(shape), "ms": ms,
                          "max_abs_err": err, "skipped": skipped, "nvidia_smi": card}),
              flush=True)
        del qkv, want
        torch.cuda.empty_cache()


def _k2_long_caller(lib):
    fn = _fn(lib, "attention_mma_long_fwd",
             [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
              ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])

    def call(qkv):
        b, s, _, h, d = qkv.shape
        out = torch.empty((b, s, h, d), dtype=qkv.dtype, device=qkv.device)
        _build.check(fn(qkv.data_ptr(), out.data_ptr(), b, s, h, d,
                        A.qk_scale(d, qkv.dtype),
                        torch.cuda.current_stream(qkv.device).cuda_stream),
                     "attention_mma_long_fwd variant launch")
        return out
    return call


def k2long_main(card) -> None:
    libs, skipped = build_variants("attention_mma_long")
    kernels = {"shipped": A.attention_fwd_mma_long}
    kernels.update({name: _k2_long_caller(lib) for name, lib in libs.items()})
    g = torch.Generator().manual_seed(1)
    for shape in ((312, 2304, 3, 4, 64), (32, 2304, 3, 4, 64), (576, 576, 3, 4, 64)):
        qkv = torch.randn(shape, generator=g).to(torch.bfloat16).cuda()
        # the plain version in batch chunks of 32 ([32, 4, S, S] f32 logits)
        want = torch.cat([A.attention_reference(qkv[i:i + 32]).float()
                          for i in range(0, shape[0], 32)])
        ms = _in_turns(kernels, lambda fn: cuda_ms(lambda: fn(qkv), reps=10, warmup=2))
        err = {name: (fn(qkv).float() - want).abs().max().item()
               for name, fn in kernels.items()}
        print(json.dumps({"kernel": "K2 long", "shape": list(shape), "ms": ms,
                          "max_abs_err": err, "skipped": skipped, "nvidia_smi": card}),
              flush=True)
        del qkv, want
        torch.cuda.empty_cache()


# --------------------------------------------------------------------------- #
# K3
# --------------------------------------------------------------------------- #
def _k3_caller(lib):
    """The variant library's cluster kernel, called as the shipped wrapper
    calls it (plan from ``kernel_for``)."""
    fn = _fn(lib, "fused_groupnorm_silu_cluster", F3._ARGTYPES["fused_groupnorm_silu_cluster"])

    def call(x, gamma, beta, film, apply_silu=True):
        b, n, c = x.shape
        plan = F3.kernel_for(x.dtype, n, c, 32)
        clusters = F3.resident_clusters(plan, c, 32, x.dtype, torch.cuda.current_device())
        out = torch.empty_like(x)
        _build.check(fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                        film[0].data_ptr(), film[1].data_ptr(), film[0].shape[0],
                        out.data_ptr(), b, n, c, 32, F3._DTYPE_CODES[x.dtype], plan.k,
                        plan.rows_per_rank, clusters, 1e-6, int(apply_silu), F3.TPU,
                        torch.cuda.current_stream(x.device).cuda_stream),
                     "fused_groupnorm_silu_cluster variant launch")
        return out
    return call


def k3_phase_breakdown(lib, x, gamma, beta, film) -> dict:
    """One launch of the ``phases`` variant: mean microseconds of each phase
    over the (CTA, sample) pairs, the mean time a CTA spends on a sample and
    the kernel's span."""
    b, n, c = x.shape
    ctas = b * F3.kernel_for(x.dtype, n, c, 32).k
    stamps = torch.zeros((ctas, len(PHASES)), dtype=torch.int64, device=x.device)
    set_stamps = _fn(lib, "k3_set_stamps", [ctypes.c_void_p, ctypes.c_longlong])
    _build.check(set_stamps(stamps.data_ptr(), ctas), "k3_set_stamps")
    _k3_caller(lib)(x, gamma, beta, film)
    # the kernel stamps no more: ``stamps`` is freed when this returns
    _build.check(set_stamps(None, 0), "k3_set_stamps")
    st = stamps.cpu().double() / 1e3  # microseconds
    steps = st[:, 1:] - st[:, :-1]
    return {"phase_us": {f"{PHASES[i]}->{PHASES[i + 1]}": steps[:, i].mean().item()
                         for i in range(len(PHASES) - 1)},
            "us_per_sample": (st[:, -1] - st[:, 0]).mean().item(),
            "kernel_span_us": (st[:, -1].max() - st[:, 0].min()).item(), "ctas": ctas}


def k3_main(card) -> None:
    libs, skipped = build_variants("fused_norm")
    kernels = {"shipped": F3.fused_groupnorm_silu_cluster,
               "two_pass": F3.fused_groupnorm_silu_two_pass}
    kernels.update({name: _k3_caller(lib) for name, lib in libs.items()})
    g = torch.Generator(device="cuda").manual_seed(5)
    for shape in ((288, 9216, 128), (288, 2304, 256), (288, 576, 256)):
        c = shape[-1]
        x = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
        gamma = 1.0 + 0.1 * torch.randn(c, generator=g, device="cuda")
        beta = 0.1 * torch.randn(c, generator=g, device="cuda")
        film = tuple(0.1 * torch.randn((shape[0], c), generator=g, device="cuda")
                     for _ in range(2))
        want = F3.groupnorm_silu_reference(x, gamma, beta, film).float()
        ms = _in_turns(kernels, lambda fn: cuda_ms(lambda: fn(x, gamma, beta, film),
                                                   reps=20, warmup=3))
        outs = {name: fn(x, gamma, beta, film) for name, fn in kernels.items()}
        err = {name: (out.float() - want).abs().max().item() for name, out in outs.items()}
        same = {name: torch.equal(out, outs["shipped"]) for name, out in outs.items()}
        del outs
        line = {"kernel": "K3", "shape": list(shape), "ms": ms,
                "shipped_without_silu_ms": cuda_ms(
                    lambda: kernels["shipped"](x, gamma, beta, film, apply_silu=False),
                    reps=20, warmup=3),
                "max_abs_err": err, "equal_to_shipped": same, "skipped": skipped,
                "nvidia_smi": card}
        if "phases" in libs:
            line["phases"] = k3_phase_breakdown(libs["phases"], x, gamma, beta, film)
        print(json.dumps(line), flush=True)
        del x, want
        torch.cuda.empty_cache()


# --------------------------------------------------------------------------- #
# The ResBlock output sum
# --------------------------------------------------------------------------- #
def _residual_caller(lib):
    fn = _fn(lib, "residual_bias_sum", R._ARGTYPES["residual_bias_sum"])

    def call(s, h, b_skip, b_out, out):
        b, c, hh, ww = s.shape
        bs = None if b_skip is None else b_skip.data_ptr()
        _build.check(fn(s.data_ptr(), h.data_ptr(), bs, b_out.data_ptr(), out.data_ptr(),
                        b * hh * ww, c, 1, torch.cuda.current_stream(s.device).cuda_stream),
                     "residual_bias_sum variant launch")
        return out
    return call


def residual_main(card) -> None:
    libs, skipped = build_variants("residual")
    kernels = {"shipped": lambda s, h, bs, bo, out: R.residual_bias_sum(s, h, bs, bo,
                                                                          out=out)}
    kernels.update({name: _residual_caller(lib) for name, lib in libs.items()})
    g = torch.Generator(device="cuda").manual_seed(21)
    for shape, skip in (((312, 128, 192, 192), False), ((312, 128, 192, 192), True),
                        ((104, 256, 256, 256), False)):
        s, h = (torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
                .contiguous(memory_format=torch.channels_last) for _ in range(2))
        c = shape[1]
        b_skip = torch.randn(c, generator=g, device="cuda").to(torch.bfloat16) if skip else None
        b_out = torch.randn(c, generator=g, device="cuda").to(torch.bfloat16)
        out = torch.empty_like(h)
        want = R.residual_bias_sum_reference(s, h, b_skip, b_out)
        same = {name: torch.equal(fn(s, h, b_skip, b_out, out), want)
                for name, fn in kernels.items()}
        del want
        ms = _in_turns(kernels, lambda fn: profiled_kernel_ms(
            lambda: fn(s, h, b_skip, b_out, out), ("residual_kernel",), reps=20))
        nbytes = 3 * s.numel() * s.element_size()
        # the same bytes through ATen's vectorised add, beside the shipped
        # kernel, both by CUDA events (ATen splits an add beyond 2^31 bytes)
        events_ms = {"shipped": cuda_ms(lambda: kernels["shipped"](s, h, b_skip, b_out, out)),
                     "aten_add": cuda_ms(lambda: torch.add(s, h, out=out))}
        print(json.dumps({"kernel": "residual", "shape": list(shape), "skip_bias": skip,
                          "device_ms": ms, "events_ms": events_ms,
                          "tb_per_s": {k: [nbytes / m / 1e9 for m in v]
                                       for k, v in ms.items()},
                          "equal_to_plain": same, "skipped": skipped, "nvidia_smi": card}),
              flush=True)
        del s, h, out
        torch.cuda.empty_cache()


def main(argv=None) -> None:
    runs = {"k1": k1_main, "k2": k2_main, "k2long": k2long_main, "k3": k3_main,
            "residual": residual_main}
    picked = (sys.argv[1:] if argv is None else argv) or list(runs)
    if any(p not in runs for p in picked):
        raise SystemExit(f"kernel_variants: pick from {list(runs)}, got {picked}")
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    for p in picked:
        runs[p](card)


if __name__ == "__main__":
    main()
