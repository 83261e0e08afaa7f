"""Times variants of the tensor-core attention kernel against the shipped
one, in turns, on one card.

    python -m conditioned_diffusion_models_uad_torch.utils.k2_variants

Each variant is ``csrc/attention_mma.cu`` with one textual change
(``VARIANTS``), built with the same nvcc flags into ``_build/``. At the
flagship eval shape (qkv [576, 576, 3, 4, 64] bf16) and the train shape
([32, 576, 3, 4, 64]) it times the shipped kernel and every variant in the
order shipped, variants, variants reversed, shipped, and prints one JSON
line per shape: the readings in ms per kernel, each kernel's largest
difference from the plain version, and the card's name and power limit.
A change that no longer applies to the source raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess

import torch

from ..ops import _build
from ..ops import attention as A

# name -> list of (text in the shipped source, replacement)
VARIANTS = {
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


def variant_source(name: str) -> str:
    """The shipped source with variant ``name``'s changes applied."""
    src = (_build.CSRC / "attention_mma.cu").read_text()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name}: a change no longer applies")
        src = src.replace(old, new)
    return src


def build_variants() -> dict:
    """Compile every variant, all nvcc runs in parallel; name -> library path."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in VARIANTS:
        src = variant_source(name)
        digest = hashlib.sha256(src.encode()).hexdigest()[:16]
        cu = _build.BUILD_DIR / f"attention_mma-{name}-{digest}.cu"
        lib = cu.with_suffix(".so")
        cu.write_text(src)
        procs[name] = (subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name}: nvcc exit {proc.returncode}\n{err}")
        libs[name] = lib
    return libs


def _caller(lib):
    fn = ctypes.CDLL(str(lib)).attention_mma_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(qkv):
        b, s, _, h, d = qkv.shape
        out = torch.empty((b, s, h, d), dtype=qkv.dtype, device=qkv.device)
        _build.check(fn(qkv.data_ptr(), out.data_ptr(), b, s, h, d,
                        A.qk_scale(d, qkv.dtype),
                        torch.cuda.current_stream(qkv.device).cuda_stream),
                     "attention_mma_fwd variant launch")
        return out
    return call


def _cuda_ms(fn, reps=30, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k2_variants: no CUDA device")
    kernels = {"shipped": A.attention_fwd_mma}
    kernels.update({name: _caller(lib) for name, lib in build_variants().items()})
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    g = torch.Generator().manual_seed(1)
    order = list(kernels) + list(reversed(kernels))
    for shape in ((576, 576, 3, 4, 64), (32, 576, 3, 4, 64)):
        qkv = torch.randn(shape, generator=g).to(torch.bfloat16).cuda()
        want = A.attention_reference(qkv).float()
        ms = {}
        for name in order:
            ms.setdefault(name, []).append(_cuda_ms(lambda: kernels[name](qkv)))
        err = {name: (fn(qkv).float() - want).abs().max().item()
               for name, fn in kernels.items()}
        print(json.dumps({"shape": list(shape), "ms": ms, "max_abs_err": err,
                          "nvidia_smi": card}), flush=True)
        del qkv, want
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
