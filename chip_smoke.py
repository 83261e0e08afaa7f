#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the hand-written kernels from ``conditioned_diffusion_models_uad_torch/
csrc`` with nvcc, holds each against its plain PyTorch version on the card,
then drives the port's paths (experiment cDDPM/DDPM_cond_spark_2D): the
flagship single-shot volume reconstruction (``DDPMTask.reconstruct_with_aux``),
the fused GroupNorm+FiLM+SiLU op at the UNet's norm-site shapes
(``fused_groupnorm_silu``), and the flagship train step
(``train/loop.py::train_step``). Each path is driven with the kernels' launch
counters set to 0 just before it and read just after. Every phase prints one
JSON line; any failed check raises, so the process exits non-zero. The last
line is the device line ``{"ok": true, "device": {...}}``.

Without CUDA, or run from a directory that holds no port package, it exits
non-zero before printing any result.
"""
from __future__ import annotations

import json
import math
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

# K3: float operations per element, counted from csrc/fused_norm.cu (stats:
# square, round, two adds; apply: multiply, add, two roundings; SiLU: exp,
# add, divide, two roundings)
K3_OPS_PER_ELEMENT = {True: 13, False: 8}

TOL_K1 = 1e-5
TOL_K2 = {"bfloat16": 2e-2, "float32": 1e-5}
# K3: tests/test_fused_norm.py's tolerances, as allclose (atol, rtol)
TOL_K3 = {"bfloat16": (2e-2, 2e-2), "float32": (2e-5, 0.0)}
TOL_SLICE_FP32 = 2e-3
# train_correctness, card vs CPU in float32 (TF32 off), batch 4: each of two
# steps from a common state (the CPU takes the card's weights, running
# statistics and Adam moments before the step) and with the CPU replaying
# the card's piecewise choices: the encoder's ReLU signs and max-pool
# argmaxes and the L1 loss's error signs (utils/decisions.py: a choice within
# rounding of its threshold that goes the other way moves whole gradient
# tensors by up to a few percent). Limits: loss and running
# statistics (norm-relative) at the one-step tolerances of
# tests/test_torch_train.py; 1e-3 norm-relative for each gradient tensor of
# either network; Adam's update scales with the gradient's relative error, so
# parameters at most lr * 1e-3 apart on average, and at most 1e-3 of them
# more than lr/10 apart (an entry whose gradient lies within its error of 0
# can land up to 2 * lr apart); at most 1e-4 of the choices that the CPU
# would have made otherwise.
TRAIN_TOL = {"loss": 1e-5, "grad_encoder": 1e-3, "grad_unet": 1e-3, "stats": 1e-4,
             "param_mean": 1e-7, "param_share": 1e-3, "flipped_share": 1e-4}

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


def k3_record(x, gamma, beta, film, apply_silu=True, groups=32):
    import torch
    import torch.nn.functional as F

    from conditioned_diffusion_models_uad_torch.ops.fused_norm import (
        fused_groupnorm_silu,
        groupnorm_silu_reference,
    )

    b, n, c = x.shape
    dtype = str(x.dtype).replace("torch.", "")
    got = fused_groupnorm_silu(x, gamma, beta, film, groups=groups, apply_silu=apply_silu)

    def plain():
        return groupnorm_silu_reference(x, gamma, beta, film, groups=groups,
                                        apply_silu=apply_silu)

    want = plain().float()
    torch.cuda.synchronize()
    atol, rtol = TOL_K3[dtype]
    diff = (got.float() - want).abs()
    err = diff.max().item()
    # allclose as a ratio: <= 1 passes
    ratio = (diff / (atol + rtol * want.abs())).max().item()
    del want, diff
    nbytes = 2 * x.numel() * x.element_size() + 4 * (2 * c + (0 if film is None
                                                              else 2 * film[0].numel()))
    ops = K3_OPS_PER_ELEMENT[apply_silu] * x.numel()
    t_ops = ops / FP32_FLOP_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    rec = {
        "name": "fused_groupnorm_silu", "route": "cuda",
        "source": f"{PKG}/csrc/fused_norm.cu",
        "replaces": "conditioned_diffusion_models_uad_tpu/ops/fused_norm.py:96",
        "shape": [b, n, c], "dtype": dtype, "groups": groups,
        "film_rows": None if film is None else film[0].shape[0], "silu": apply_silu,
        "launches": None, "max_abs_err": err, "tol_atol_rtol": [atol, rtol],
        "allclose_ratio": ratio,
        "ms": cuda_ms(lambda: fused_groupnorm_silu(x, gamma, beta, film, groups=groups,
                                                   apply_silu=apply_silu), reps=20),
        "plain_ms": cuda_ms(plain, reps=3, warmup=1),
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }
    side = int(round(n ** 0.5))
    if side * side == n:
        # F.group_norm on the channels_last NCHW view: GN and affine only, no
        # FiLM and no SiLU, so it computes less than the kernel
        xv = x.view(b, side, side, c).permute(0, 3, 1, 2)
        g, bt = gamma.to(x.dtype), beta.to(x.dtype)
        rec["library_ms"] = cuda_ms(lambda: F.group_norm(xv, groups, g, bt, 1e-6), reps=10)
        rec["library_call"] = "F.group_norm, channels_last (GN + affine only)"
    return rec


def phase_k3():
    """K3 on its own path, the op's entry point at the UNet's three norm-site
    shapes (tools/bench_fused_norm.py: batch 288, bf16, FiLM [288, C] f32,
    SiLU on), with the launch counter set to 0 just before and read just
    after each call; then each call's result against the plain version, and
    two small cases (f32 with FiLM [1, C]; bf16 without FiLM or SiLU at C = 36,
    which takes the kernel's scalar path)."""
    import torch

    from conditioned_diffusion_models_uad_torch.ops.fused_norm import fused_groupnorm_silu

    g = torch.Generator(device="cuda").manual_seed(5)

    def inputs(shape, dtype, film_rows):
        b, h, w, c = shape
        x = torch.randn(shape, generator=g, device="cuda").to(dtype)
        gamma = 1.0 + 0.1 * torch.randn(c, generator=g, device="cuda")
        beta = 0.1 * torch.randn(c, generator=g, device="cuda")
        film = None
        if film_rows:
            film = tuple(0.1 * torch.randn((film_rows, c), generator=g, device="cuda")
                         for _ in range(2))
        return x, gamma, beta, film

    tool_shapes = [(288, 96, 96, 128), (288, 48, 48, 256), (288, 24, 24, 256)]
    recs = []
    for shape in tool_shapes:
        x, gamma, beta, film = inputs(shape, torch.bfloat16, shape[0])
        fused_groupnorm_silu.launches = 0
        y = fused_groupnorm_silu(x, gamma, beta, film)
        torch.cuda.synchronize()
        launches = fused_groupnorm_silu.launches
        require(launches == 1, f"K3 {shape}: {launches} launches in one call")
        require(y.shape == x.shape and y.dtype == x.dtype, f"K3 {shape} output")
        require(bool(torch.isfinite(y).all()), f"K3 {shape} output not finite")
        del y
        b, h, w, c = shape
        rec = k3_record(x.view(b, h * w, c), gamma, beta, film)
        rec["launches"] = launches
        recs.append(rec)
        del x
        torch.cuda.empty_cache()
    for shape, dtype, film_rows, silu, groups in (
            ((4, 24, 24, 128), torch.float32, 1, True, 32),
            ((3, 10, 10, 36), torch.bfloat16, 0, False, 12)):
        x, gamma, beta, film = inputs(shape, dtype, film_rows)
        b, h, w, c = shape
        recs.append(k3_record(x.view(b, h * w, c), gamma, beta, film, apply_silu=silu,
                              groups=groups))
    for rec in recs:
        require(rec["allclose_ratio"] <= 1.0,
                f"K3 {rec['shape']} {rec['dtype']} err {rec['max_abs_err']} "
                f"(allclose ratio {rec['allclose_ratio']})")
    emit({"phase": "k3", "results": recs})
    return recs[0]


def kernel_kind(name: str) -> str:
    """Coarse class of a CUDA kernel, from its name."""
    low = name.lower()
    for kind, marks in (("K2 attention", ("attention_fwd_kernel",)),
                        ("K1 noise", ("fractal_noise_kernel",)),
                        ("K3 norm", ("gn_stats_kernel", "gn_apply_kernel")),
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


def _kernel_events(prof):
    """The profile's device kernels: CUDA events with device time, without
    user annotations (``Optimizer.step#Adam.step`` spans the kernels it
    launches and would count them twice)."""
    import torch

    return [ev for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and ev.self_device_time_total > 0
            and not getattr(ev, "is_user_annotation", False)]


def _launch_counters():
    from conditioned_diffusion_models_uad_torch.ops.attention import fused_attention
    from conditioned_diffusion_models_uad_torch.ops.fused_norm import fused_groupnorm_silu
    from conditioned_diffusion_models_uad_torch.ops.simplex_hash import fractal_noise_2d

    return {"fractal_noise_2d": fractal_noise_2d, "fused_attention": fused_attention,
            "fused_groupnorm_silu": fused_groupnorm_silu}


def _zero_launches():
    counters = _launch_counters()
    for fn in counters.values():
        fn.launches = 0
    return counters


def _read_launches(counters):
    return {name: fn.launches for name, fn in counters.items()}


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

    task = _flagship_task("cuda")  # DDPMTaskConfig() defaults: bf16, compute norms
    g = torch.Generator(device="cuda").manual_seed(3)
    depth, groups = 192, 2
    slices = torch.rand((depth, 96, 96, 1), generator=g, device="cuda")
    seed_gen = torch.Generator().manual_seed(4)

    counters = _zero_launches()
    reco, aux = task.reconstruct_with_aux(slices, generator=seed_gen, groups=groups)
    torch.cuda.synchronize()
    launches = _read_launches(counters)
    require(reco.shape == (depth, 96, 96, 1), f"reco shape {tuple(reco.shape)}")
    require(bool(torch.isfinite(reco).all()), "bf16 reconstruction not finite")
    require(reco.float().std().item() > 1e-3, "bf16 reconstruction is constant")
    require(aux["loss_per_slice"].shape == (depth,)
            and bool(torch.isfinite(aux["loss_per_slice"]).all()), "loss_per_slice")
    require(aux["latent_per_slice"].shape == (depth, 128), "latent_per_slice")
    for name in ("fractal_noise_2d", "fused_attention"):
        require(launches[name] >= 1, f"{name} was not launched on the main path")

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
    kernels = _kernel_events(prof)
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


def _train_setup(b, device, seed):
    """Random volumes [8, 96, 96, 40] on ``device``, one batch's slice
    indices, and the generator that made them."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    vols = torch.rand((8, 96, 96, 40), generator=g, device=device)
    vi = torch.randint(0, 8, (b,), generator=g, device=device)
    si = torch.randint(0, 40, (b,), generator=g, device=device)
    return (vols, None), vi, si, g


def _running_stats(task):
    return {k: v.detach().clone() for k, v in task.state_dict().items() if "running" in k}


def _train_one(task, opt, data, vi, si, draws, choices, replay):
    """One train step on the task's device, recording its piecewise choices
    into ``choices`` or replaying them: the loss, the gradients, parameters
    and running statistics after the step, and the count of replayed
    choices."""
    from conditioned_diffusion_models_uad_torch.train.loop import train_step
    from conditioned_diffusion_models_uad_torch.utils.decisions import recorded_choices

    dev = task.device
    with recorded_choices(choices, replay=replay) as count:
        loss = train_step(task, opt, (data[0].to(dev), None), vi.to(dev), si.to(dev), draws)
    return dict(loss=loss.item(), count=count,
                grads={n: p.grad.detach().double().cpu() for n, p in task.named_parameters()},
                params={n: p.detach().double().cpu() for n, p in task.named_parameters()},
                stats={k: v.double().cpu() for k, v in _running_stats(task).items()})


def _train_spread(a, b, lr):
    """How far step ``a`` is from step ``b``."""
    import torch

    def normrel(x, y):
        return ((x - y).norm() / y.norm().clamp_min(1e-30)).item()

    d = torch.cat([(a["params"][n] - v).abs().reshape(-1) for n, v in b["params"].items()])
    out = {"loss": abs(a["loss"] - b["loss"]),
           "stats": max(normrel(a["stats"][k], v) for k, v in b["stats"].items()),
           "param_mean": d.mean().item(), "param_share": (d > lr / 10).double().mean().item(),
           "flipped_share": b["count"]["flipped"] / b["count"]["made"]}
    for net in ("encoder", "unet"):
        worst = max((normrel(a["grads"][n], v), n) for n, v in b["grads"].items()
                    if n.startswith(net + "."))
        out[f"grad_{net}"], out[f"grad_{net}_worst"] = worst
    return out


def phase_train_correctness():
    """The flagship config in float32 (TF32 off) at batch 4, from the same
    seeded weights, slices and draws: two train steps on the card, each
    repeated on the CPU from the card's state before it (weights, running
    statistics, Adam moments) with the card's piecewise choices; losses,
    gradients, and parameters and running statistics after the Adam step."""
    import copy

    import torch

    from conditioned_diffusion_models_uad_torch.train.loop import make_optimizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    b = 4
    data, vi, si, g = _train_setup(b, "cpu", 6)
    cpu_task = _flagship_task("cpu", dtype="float32")
    draws = [cpu_task.draw_train(g, b) for _ in range(2)]
    card_task = _flagship_task("cuda", dtype="float32")
    card_opt, cpu_opt = make_optimizer(card_task), make_optimizer(cpu_task)
    steps, secs = [], {"cuda": 0.0, "cpu": 0.0}
    for dr in draws:
        state = {k: v.detach().cpu().clone() for k, v in card_task.state_dict().items()}
        opt_state = copy.deepcopy(card_opt.state_dict())
        choices = []
        t0 = time.perf_counter()
        card = _train_one(card_task, card_opt, data, vi, si, dr, choices, replay=False)
        t1 = time.perf_counter()
        cpu_task.load_state_dict(state)
        cpu_opt.load_state_dict(opt_state)
        cpu = _train_one(cpu_task, cpu_opt, data, vi, si, dr, choices, replay=True)
        secs["cuda"] += t1 - t0
        secs["cpu"] += time.perf_counter() - t1
        steps.append({"loss_cuda": card["loss"], "loss_cpu": cpu["loss"],
                      "choices": cpu["count"],
                      "card_vs_cpu": _train_spread(card, cpu, card_task.cfg.lr)})
    emit({"phase": "train_correctness",
          "config": "DDPMTaskConfig(dtype='float32'), TF32 off", "batch": b,
          "steps": steps, "limit": TRAIN_TOL, "cuda_s": secs["cuda"], "cpu_s": secs["cpu"]})
    for i, st in enumerate(steps):
        require(math.isfinite(st["loss_cuda"]), f"card train loss not finite at step {i}")
        for k, lim in TRAIN_TOL.items():
            v = st["card_vs_cpu"][k]
            require(v <= lim, f"card vs CPU at step {i}: {k} {v} > {lim}")


def phase_train_full_size():
    """The flagship train step at full size: DDPMTaskConfig() defaults (bf16,
    compute norms, fused attention), batch 32 (configs/datamodule/IXI.yaml),
    slices gathered from random volumes on the card, aug_intensity on."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from conditioned_diffusion_models_uad_torch.train.loop import (
        gathered_batch,
        make_optimizer,
        train_step,
    )

    b = 32
    task = _flagship_task("cuda")
    opt = make_optimizer(task)
    data, vi, si, g = _train_setup(b, "cuda", 7)

    def step():
        return train_step(task, opt, data, vi, si, task.draw_train(g, b))

    for _ in range(3):
        loss = step()
    require(math.isfinite(loss.item()), "train loss not finite")

    n_count = 5
    counters = _zero_launches()
    for _ in range(n_count):
        loss = step()
    torch.cuda.synchronize()
    launches = _read_launches(counters)
    per_step = {k: v / n_count for k, v in launches.items()}
    for name in ("fractal_noise_2d", "fused_attention"):
        require(per_step[name] >= 1, f"{name} was not launched on every train step")

    reps = 20
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        loss = step()
    torch.cuda.synchronize()
    s_per_step = (time.perf_counter() - t0) / reps
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # layer times: the train step's pieces between CUDA events
    parts = {"gather_augment": 0.0, "forward": 0.0, "backward": 0.0, "optimizer": 0.0}
    n_parts = 5
    for _ in range(n_parts):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        draws = task.draw_train(g, b)
        ev[0].record()
        batch = gathered_batch(data, vi, si, draws.aug)
        ev[1].record()
        opt.zero_grad(set_to_none=True)
        loss, _ = task.loss(batch, draws, train=True)
        ev[2].record()
        loss.backward()
        ev[3].record()
        opt.step()
        ev[4].record()
        torch.cuda.synchronize()
        for i, k in enumerate(parts):
            parts[k] += ev[i].elapsed_time(ev[i + 1]) / n_parts

    torch.cuda.synchronize()
    n_prof = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_prof):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = _kernel_events(prof)
    busy_ms = sum(ev.self_device_time_total for ev in kernels) / 1e3
    by_kind = {}
    for ev in kernels:
        kind = kernel_kind(ev.key)
        by_kind[kind] = by_kind.get(kind, 0.0) + ev.self_device_time_total / 1e3 / n_prof
    kernels.sort(key=lambda ev: ev.self_device_time_total, reverse=True)
    top = [{"name": ev.key[:90], "kind": kernel_kind(ev.key),
            "ms_per_step": ev.self_device_time_total / 1e3 / n_prof,
            "calls_per_step": ev.count / n_prof}
           for ev in kernels[:12]]
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "profile_train_step.txt").write_text(
        prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=60))

    # learning: one repeated batch; the loss at one fixed set of draws (train
    # mode, running statistics restored after each reading) must fall
    fixed = task.draw_train(g, b)

    def fixed_loss():
        stats = _running_stats(task)
        with torch.no_grad():
            value = task.loss(gathered_batch(data, vi, si, fixed.aug), fixed)[0].item()
        task.load_state_dict(stats, strict=False)
        return value

    n_learn = 50
    before = fixed_loss()
    learn_losses = [step().item() for _ in range(n_learn)]
    after = fixed_loss()
    emit({"phase": "train_full_size", "nvidia_smi": nvidia_smi(),
          "config": "DDPMTaskConfig() (bf16, norm_precision=compute, fused_attention), "
                    "Adam lr 1e-4, aug_intensity",
          "batch": b, "launches_per_step": per_step, "s_per_step": s_per_step,
          "train_slices_per_sec": b / s_per_step, "layer_ms": parts,
          "peak_memory_gb": peak_gb,
          "profiled_steps": n_prof, "profiled_wall_ms": wall_ms,
          "profiled_kernel_ms": busy_ms,
          "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
          # the profiler slows the host; against the unprofiled step time
          "device_idle_share_unprofiled": max(0.0, 1.0 - busy_ms / n_prof
                                              / (s_per_step * 1e3)),
          "kernel_ms_per_step_by_kind": by_kind, "top_kernels": top,
          "fixed_draw_loss_before": before, "fixed_draw_loss_after": after,
          "learn_steps": n_learn, "learn_loss_first_last": [learn_losses[0],
                                                             learn_losses[-1]]})
    require(all(math.isfinite(v) for v in learn_losses), "train loss not finite")
    require(after < before, f"fixed-draw loss did not fall: {before} -> {after}")
    return per_step


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
    k3 = phase_k3()
    phase_slice_correctness()
    launches = phase_full_size()
    phase_train_correctness()
    train_launches = phase_train_full_size()
    k1["launches"] = launches["fractal_noise_2d"]
    k2["launches"] = launches["fused_attention"]
    for rec, name in ((k1, "fractal_noise_2d"), (k2, "fused_attention"),
                      (k3, "fused_groupnorm_silu")):
        rec["launches_by_path"] = {"reconstruct_call": launches[name],
                                   "train_step": train_launches[name]}
    k3["launches_by_path"]["fused_groupnorm_silu_call"] = k3["launches"]
    emit({"kernels": [k1, k2, k3]})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
