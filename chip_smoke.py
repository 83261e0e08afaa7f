#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the hand-written kernels from ``conditioned_diffusion_models_uad_torch/
csrc`` with nvcc, holds each against its plain PyTorch version on the card,
then drives the port's main path: the flagship cDDPM single-shot volume
reconstruction (``DDPMTask.reconstruct_with_aux``, experiment
cDDPM/DDPM_cond_spark_2D). Every phase prints one JSON line; any failed check
raises, so the process exits non-zero. The last line is the device line
``{"ok": true, "device": {...}}``.

Without CUDA, or run from a directory that holds no port package, it exits
non-zero before printing any result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "conditioned_diffusion_models_uad_torch"

# published dense peaks of one H100 SXM (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12  # CUDA cores, outside the tensor cores

# K1: float/int operations per pixel per octave, counted from
# csrc/simplex_noise.cu (4 vertex contributions of ~30 operations each,
# ~35 for the cell geometry and vertex selection, 3 for the accumulation)
K1_OPS_PER_PIXEL_OCTAVE = 158

TOL_K1 = 1e-5
TOL_K2 = {"bfloat16": 2e-2, "float32": 1e-5}
TOL_SLICE_FP32 = 2e-3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` calls, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------- #
# phases
# --------------------------------------------------------------------------- #
def phase_device():
    import torch

    from conditioned_diffusion_models_uad_torch.ops import _build

    nvcc = _build.nvcc_path()
    nvcc_version = subprocess.run(
        [nvcc, "--version"], capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[-1]
    build_s = _build.build_all()
    ptxas_dir = ROOT / "chiprun_out"
    ptxas_dir.mkdir(exist_ok=True)
    (ptxas_dir / "ptxas.txt").write_text(
        "\n".join(f"== {k}\n{v}" for k, v in _build.build_log.items())
    )
    emit({"phase": "device", "nvidia_smi": nvidia_smi(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc": nvcc_version, "kernel_build_s": build_s})


def k1_record(seeds, shape):
    import torch

    from conditioned_diffusion_models_uad_torch.ops.simplex_hash import (
        fractal_noise_2d,
        fractal_noise_2d_hash,
    )

    got = fractal_noise_2d(seeds, shape)
    want = fractal_noise_2d_hash(seeds, shape)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    n, (h, w) = seeds.shape[0], shape
    ops = K1_OPS_PER_PIXEL_OCTAVE * 6 * n * h * w
    nbytes = 4 * n + 4 * n * h * w
    t_ops = ops / FP32_FLOP_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {
        "name": "fractal_noise_2d", "route": "cuda",
        "source": f"{PKG}/csrc/simplex_noise.cu",
        "replaces": "conditioned_diffusion_models_uad_tpu/ops/simplex_pallas.py:149",
        "shape": [n, h, w], "launches": None,
        "max_abs_err": err, "tol": TOL_K1,
        "ms": cuda_ms(lambda: fractal_noise_2d(seeds, shape), reps=50),
        "plain_ms": cuda_ms(lambda: fractal_noise_2d_hash(seeds, shape), reps=10),
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }


def phase_k1():
    import torch

    g = torch.Generator().manual_seed(0)
    recs = []
    for shape, n in (((96, 96), 6), ((37, 130), 3)):
        seeds = torch.randint(0, 2**31 - 1, (n,), generator=g, dtype=torch.int32)
        seeds[0] = 2**31 - 2
        rec = k1_record(seeds.cuda(), shape)
        require(rec["max_abs_err"] <= TOL_K1, f"K1 {shape} err {rec['max_abs_err']}")
        recs.append(rec)
    emit({"phase": "k1", "results": recs})
    return recs[0]


def k2_record(qkv):
    import torch
    import torch.nn.functional as F

    from conditioned_diffusion_models_uad_torch.ops.attention import (
        attention_reference,
        fused_attention,
    )

    b, s, _, h, d = qkv.shape
    dtype = str(qkv.dtype).replace("torch.", "")
    got = fused_attention(qkv)
    want = attention_reference(qkv)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    del want
    q, k, v = (qkv[:, :, i].transpose(1, 2).contiguous() for i in range(3))
    flops = 4.0 * b * h * s * s * d
    peak = BF16_FLOP_PER_S if qkv.dtype == torch.bfloat16 else FP32_FLOP_PER_S
    nbytes = qkv.numel() * qkv.element_size() + got.numel() * got.element_size()
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    rec = {
        "name": "fused_attention", "route": "cuda",
        "source": f"{PKG}/csrc/attention.cu",
        "replaces": "conditioned_diffusion_models_uad_tpu/ops/attention_pallas.py:117",
        "shape": list(qkv.shape), "dtype": dtype, "launches": None,
        "max_abs_err": err, "tol": TOL_K2[dtype],
        "ms": cuda_ms(lambda: fused_attention(qkv), reps=5),
        "plain_ms": cuda_ms(lambda: attention_reference(qkv), reps=3, warmup=1),
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": cuda_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, scale=d ** -0.5), reps=5
        ),
    }
    return rec


def phase_k2():
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(1)
    recs = []
    for shape, dtype in (((576, 576, 3, 4, 64), torch.bfloat16),
                         ((3, 100, 3, 2, 64), torch.float32),
                         ((2, 64, 3, 2, 32), torch.float32)):
        qkv = torch.randn(shape, generator=g).to(dtype).cuda()
        rec = k2_record(qkv)
        require(rec["max_abs_err"] <= rec["tol"],
                f"K2 {shape} {dtype} err {rec['max_abs_err']}")
        recs.append(rec)
        del qkv
        torch.cuda.empty_cache()
    emit({"phase": "k2", "results": recs})
    return recs[0]


def kernel_kind(name: str) -> str:
    """Coarse class of a CUDA kernel, from its name."""
    low = name.lower()
    for kind, marks in (("K2 attention", ("attention_fwd_kernel",)),
                        ("K1 noise", ("fractal_noise_kernel",)),
                        ("upsample/pool", ("upsample", "pool")),
                        ("convolution", ("conv", "xmma", "implicit", "cudnn",
                                         "fprop")),
                        ("gemm", ("gemm", "cutlass", "matmul")),
                        ("reduction", ("reduce",)),
                        ("copy", ("copy",)),
                        ("elementwise", ("elementwise",))):
        if any(m in low for m in marks):
            return kind
    return "other"


def _flagship_task(device, **kw):
    from conditioned_diffusion_models_uad_torch.models.tasks import (
        DDPMTask,
        DDPMTaskConfig,
    )
    from conditioned_diffusion_models_uad_torch.utils.random_init import randomize_

    task = DDPMTask(DDPMTaskConfig(**kw), device=device)
    return randomize_(task, 0)


def phase_slice_correctness():
    """Flagship config in float32 at a small depth, on the card and on the
    CPU, same weights and seeds: holds the whole path, kernels included."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(2)
    slices = torch.rand((4, 96, 96, 1), generator=g)
    seeds = torch.randint(0, 2**31 - 1, (1, 3), generator=g, dtype=torch.int32)
    outs = {}
    for dev in ("cuda", "cpu"):
        task = _flagship_task(dev, dtype="float32")
        t0 = time.perf_counter()
        reco, aux = task.reconstruct_with_aux(slices, seeds)
        if dev == "cuda":
            torch.cuda.synchronize()
        outs[dev] = (reco.cpu(), {k: v.cpu() for k, v in aux.items()},
                     time.perf_counter() - t0)
        del task
    err = {
        "reco": (outs["cuda"][0] - outs["cpu"][0]).abs().max().item(),
        "loss_per_slice": (outs["cuda"][1]["loss_per_slice"]
                           - outs["cpu"][1]["loss_per_slice"]).abs().max().item(),
        "latent_per_slice": (outs["cuda"][1]["latent_per_slice"]
                             - outs["cpu"][1]["latent_per_slice"]).abs().max().item(),
    }
    reco = outs["cuda"][0]
    emit({"phase": "slice_correctness", "config": "DDPMTaskConfig(dtype='float32')",
          "slices": 4, "ensemble": 3, "max_abs_err_vs_cpu": err,
          "tol": TOL_SLICE_FP32, "reco_std": reco.std().item(),
          "cpu_s": outs["cpu"][2]})
    require(reco.shape == (4, 96, 96, 1), f"reco shape {tuple(reco.shape)}")
    require(bool(torch.isfinite(reco).all()), "fp32 reconstruction not finite")
    require(reco.std().item() > 1e-3, "fp32 reconstruction is constant")
    for k, v in err.items():
        require(v <= TOL_SLICE_FP32, f"card vs CPU {k} err {v}")


def phase_full_size():
    """The flagship reconstruction at full size: bf16, 2 volumes x 96 slices
    x 3 ensemble members, so the UNet runs at batch 576. The launch counters
    are zeroed just before the main-path call and read just after."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from conditioned_diffusion_models_uad_torch.ops.attention import fused_attention
    from conditioned_diffusion_models_uad_torch.ops.simplex_hash import fractal_noise_2d

    task = _flagship_task("cuda")  # DDPMTaskConfig() defaults: bf16, compute norms
    g = torch.Generator(device="cuda").manual_seed(3)
    depth, groups = 192, 2
    slices = torch.rand((depth, 96, 96, 1), generator=g, device="cuda")
    seed_gen = torch.Generator().manual_seed(4)

    fractal_noise_2d.launches = 0
    fused_attention.launches = 0
    reco, aux = task.reconstruct_with_aux(slices, generator=seed_gen, groups=groups)
    torch.cuda.synchronize()
    launches = {"fractal_noise_2d": fractal_noise_2d.launches,
                "fused_attention": fused_attention.launches}
    require(reco.shape == (depth, 96, 96, 1), f"reco shape {tuple(reco.shape)}")
    require(bool(torch.isfinite(reco).all()), "bf16 reconstruction not finite")
    require(reco.float().std().item() > 1e-3, "bf16 reconstruction is constant")
    require(aux["loss_per_slice"].shape == (depth,)
            and bool(torch.isfinite(aux["loss_per_slice"]).all()), "loss_per_slice")
    require(aux["latent_per_slice"].shape == (depth, 128), "latent_per_slice")
    for name, n in launches.items():
        require(n >= 1, f"{name} was not launched on the main path")

    e = task.cfg.ensemble_size
    reps = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        task.reconstruct_with_aux(slices, generator=seed_gen, groups=groups)
    torch.cuda.synchronize()
    call_s = (time.perf_counter() - t0) / reps

    with torch.no_grad():
        x = torch.rand((depth * e, 96, 96, 1), generator=g, device="cuda")
        t = torch.randint(0, 1000, (depth * e,), generator=g, device="cuda")
        cond = torch.randn((depth * e, 128), generator=g, device="cuda")
        layer_ms = {
            "encoder_192": cuda_ms(lambda: task.encode(slices), reps=3, warmup=1),
            "unet_576": cuda_ms(lambda: task.unet(x, t, cond), reps=3, warmup=1),
        }
        del x, t, cond

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        task.reconstruct_with_aux(slices, generator=seed_gen, groups=groups)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [ev for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and ev.self_device_time_total > 0]
    busy_ms = sum(ev.self_device_time_total for ev in kernels) / 1e3
    by_kind = {}
    for ev in kernels:
        kind = kernel_kind(ev.key)
        by_kind[kind] = by_kind.get(kind, 0.0) + ev.self_device_time_total / 1e3
    kernels.sort(key=lambda ev: ev.self_device_time_total, reverse=True)
    top = [{"name": ev.key[:90], "kind": kernel_kind(ev.key),
            "ms": ev.self_device_time_total / 1e3, "calls": ev.count}
           for ev in kernels[:12]]
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "profile_full_size.txt").write_text(
        prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=60))
    emit({"phase": "full_size", "nvidia_smi": nvidia_smi(),
          "config": "DDPMTaskConfig() (bf16, norm_precision=compute, fused_attention)",
          "volumes": groups, "slices": depth, "ensemble": e, "unet_batch": depth * e,
          "launches": launches, "reco_std": reco.float().std().item(),
          "s_per_call": call_s,
          "eval_slice_denoises_per_sec": depth * e / call_s,
          "layer_ms": layer_ms,
          "profiled_wall_ms": wall_ms, "profiled_kernel_ms": busy_ms,
          "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
          "kernel_ms_by_kind": by_kind, "top_kernels": top})
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / PKG / "csrc").is_dir():
        print(f"chip_smoke: {PKG}/ not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))

    phase_device()
    k1 = phase_k1()
    k2 = phase_k2()
    phase_slice_correctness()
    launches = phase_full_size()
    k1["launches"] = launches["fractal_noise_2d"]
    k2["launches"] = launches["fused_attention"]
    emit({"kernels": [k1, k2]})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
