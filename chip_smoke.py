#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the hand-written kernels from ``conditioned_diffusion_models_uad_torch/
csrc`` with nvcc, holds each against its plain PyTorch version on the card,
then drives the port's paths (experiment cDDPM/DDPM_cond_spark_2D): the
flagship single-shot volume reconstruction (``DDPMTask.reconstruct_with_aux``;
bf16 attention takes K2's tensor-core variant, float32 its scalar one),
the fused GroupNorm+FiLM+SiLU op at the UNet's norm-site shapes
(``fused_groupnorm_silu``), the anomaly-scoring eval chain (phases
``eval_correctness``: the scoring core card against CPU and scipy on one
reconstruction; ``eval_full_size``: the orchestrated val/test/healthy
protocol through ``eval/reconstruct.py::VolumeReconstructor.
batch_call_scored`` and ``eval/harness.py::EvalSession``), and the flagship
train step (``train/loop.py::train_step``). Each path is driven with the kernels' launch
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
# eval scoring, card against CPU on the same reconstruction: the residual,
# maps, counts, thresholds, best dice and squared Hausdorff distances bit for
# bit; float32 means and sums (reco errors, scores, AUROC/AUPRC) summed in
# another order, relative
TOL_EVAL_REL = 1e-5
# the flagship scoring grid: configs/datamodule/IXI.yaml image_dim
# [192, 192, 100] over rescale 2
EVAL_SHAPE = (96, 96, 50)
EXACT_EVAL_SCALARS = ("best_dice", "th_record", "th_apply", "lesion_size", "haus_pt",
                      "haus_tp", "tp", "fp", "tn", "fn")

sys.path.insert(0, str(ROOT))
try:
    from conditioned_diffusion_models_uad_torch.utils.timing import (
        cuda_ms,
        graph_ms,
        host_ms,
        kernel_events,
        profiled_kernel_ms,
    )
except ImportError as err:  # no port beside this script, or no torch
    _IMPORT_ERROR = err
else:
    _IMPORT_ERROR = None


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


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

    def call():
        return fractal_noise_2d(seeds, shape)

    return {
        "name": "fractal_noise_2d", "route": "cuda",
        "source": f"{PKG}/csrc/simplex_noise.cu",
        "replaces": "conditioned_diffusion_models_uad_tpu/ops/simplex_pallas.py:149",
        "shape": [n, h, w], "launches": None,
        "max_abs_err": err, "tol": TOL_K1,
        # device time per launch (profiler); beside it the same launches
        # replayed from a CUDA graph, and the host's time per call
        "ms": profiled_kernel_ms(call, ("fractal_noise_kernel",)),
        "graph_ms": graph_ms(call),
        "host_ms": host_ms(call),
        "plain_ms": cuda_ms(lambda: fractal_noise_2d_hash(seeds, shape), reps=10),
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }


def phase_k1():
    import torch

    g = torch.Generator().manual_seed(0)
    recs = []
    # the reconstruction's 6 fields, the train step's one, a ragged shape
    for shape, n in (((96, 96), 6), ((96, 96), 1), ((37, 130), 3)):
        seeds = torch.randint(0, 2**31 - 1, (n,), generator=g, dtype=torch.int32)
        seeds[0] = 2**31 - 2
        rec = k1_record(seeds.cuda(), shape)
        require(rec["max_abs_err"] <= TOL_K1, f"K1 {shape} err {rec['max_abs_err']}")
        recs.append(rec)
    emit({"phase": "k1", "results": recs})
    return recs[0]


K2_VARIANTS = {"mma": ("attention_fwd_mma", "csrc/attention_mma.cu"),
               "scalar": ("attention_fwd_scalar", "csrc/attention.cu")}


def k2_record(qkv, kernel):
    """K2 variant ``kernel`` ("mma" or "scalar") called directly on ``qkv``:
    its error against the plain version, its time, the plain version's and
    SDPA's, and its bound."""
    import torch
    import torch.nn.functional as F

    from conditioned_diffusion_models_uad_torch.ops import attention as A

    name, source = K2_VARIANTS[kernel]
    wrapper = getattr(A, name)
    b, s, _, h, d = qkv.shape
    dtype = str(qkv.dtype).replace("torch.", "")
    got = wrapper(qkv)
    want = A.attention_reference(qkv)
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
        "name": name, "route": "cuda", "source": f"{PKG}/{source}",
        "replaces": "conditioned_diffusion_models_uad_tpu/ops/attention_pallas.py:117",
        "shape": list(qkv.shape), "dtype": dtype, "launches": None,
        "max_abs_err": err, "tol": TOL_K2[dtype],
        "ms": cuda_ms(lambda: wrapper(qkv), reps=20),
        "plain_ms": cuda_ms(lambda: A.attention_reference(qkv), reps=3, warmup=1),
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": cuda_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, scale=d ** -0.5), reps=10
        ),
    }
    return rec


def phase_k2():
    """Each case through ``fused_attention`` (the launch counters show which
    variant its dispatch took, and it must be the one ``kernel_for`` names,
    with the variant's own output), then the variant alone against the plain
    version; and the scalar kernel at the flagship bf16 shape, called
    directly, to set beside the tensor-core kernel."""
    import torch

    from conditioned_diffusion_models_uad_torch.ops import attention as A

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(1)
    cases = [
        ("mma", (576, 576, 3, 4, 64), torch.bfloat16, True),     # eval, batch 576
        ("mma_train", (32, 576, 3, 4, 64), torch.bfloat16, True),  # train, batch 32
        (None, (3, 100, 3, 2, 64), torch.bfloat16, True),        # ragged S
        (None, (2, 64, 3, 2, 32), torch.bfloat16, True),         # D = 32
        (None, (2, 600, 3, 2, 64), torch.bfloat16, True),        # S beyond the mma limit
        ("scalar_bf16", (576, 576, 3, 4, 64), torch.bfloat16, False),
        ("scalar", (12, 576, 3, 4, 64), torch.float32, True),    # slice_correctness
        (None, (3, 100, 3, 2, 64), torch.float32, True),
        (None, (2, 64, 3, 2, 32), torch.float32, True),
    ]
    recs, named = [], {}
    for key, shape, dtype, dispatched in cases:
        qkv = torch.randn(shape, generator=g).to(dtype).cuda()
        kernel = A.kernel_for(dtype, shape[1], shape[-1]) if dispatched else "scalar"
        rec = k2_record(qkv, kernel)
        if dispatched:
            counters = _zero_launches()
            via = A.fused_attention(qkv)
            torch.cuda.synchronize()
            took = _read_launches(counters)
            require(took[rec["name"]] == 1 and took["fused_attention"] == 1,
                    f"K2 {shape} {dtype}: dispatch took {took}, wanted {rec['name']}")
            require(torch.equal(via, getattr(A, rec["name"])(qkv)),
                    f"K2 {shape} {dtype}: fused_attention differs from {rec['name']}")
            rec["dispatch"] = kernel
        require(rec["max_abs_err"] <= rec["tol"],
                f"K2 {rec['name']} {shape} {dtype} err {rec['max_abs_err']}")
        recs.append(rec)
        if key:
            named[key] = rec
        del qkv
        torch.cuda.empty_cache()
    emit({"phase": "k2", "results": recs})
    return named


def k3_record(x, gamma, beta, film, variant, apply_silu=True, groups=32):
    """K3 variant ``variant`` ("cluster" or "two_pass") called directly on x
    [B, N, C]: its error against the plain version as an allclose ratio, and
    its bound."""
    import torch

    from conditioned_diffusion_models_uad_torch.ops import fused_norm as F3

    b, n, c = x.shape
    dtype = str(x.dtype).replace("torch.", "")
    wrapper = F3.VARIANTS[variant]
    got = wrapper(x, gamma, beta, film, groups=groups, apply_silu=apply_silu)
    want = F3.groupnorm_silu_reference(x, gamma, beta, film, groups=groups,
                                       apply_silu=apply_silu).float()
    torch.cuda.synchronize()
    atol, rtol = TOL_K3[dtype]
    diff = (got.float() - want).abs()
    err = diff.max().item()
    # allclose as a ratio: <= 1 passes
    ratio = (diff / (atol + rtol * want.abs())).max().item()
    del got, want, diff
    nbytes = 2 * x.numel() * x.element_size() + 4 * (2 * c + (0 if film is None
                                                              else 2 * film[0].numel()))
    ops = K3_OPS_PER_ELEMENT[apply_silu] * x.numel()
    t_ops = ops / FP32_FLOP_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {
        "name": wrapper.__name__, "route": "cuda", "source": f"{PKG}/csrc/fused_norm.cu",
        "replaces": "conditioned_diffusion_models_uad_tpu/ops/fused_norm.py:96",
        "shape": [b, n, c], "dtype": dtype, "groups": groups,
        "film_rows": None if film is None else film[0].shape[0], "silu": apply_silu,
        "launches": None, "max_abs_err": err, "tol_atol_rtol": [atol, rtol],
        "allclose_ratio": ratio,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
    }


def _k3_library_ms(x, gamma, beta, groups=32):
    """F.group_norm on the channels_last NCHW view of a square x: GN and
    affine only, no FiLM and no SiLU, so it computes less than the kernel."""
    import torch.nn.functional as F

    b, n, c = x.shape
    side = int(round(n ** 0.5))
    if side * side != n:
        return None
    xv = x.view(b, side, side, c).permute(0, 3, 1, 2)
    g, bt = gamma.to(x.dtype), beta.to(x.dtype)
    return cuda_ms(lambda: F.group_norm(xv, groups, g, bt, 1e-6), reps=10)


def k3_bf16_rounding():
    """The K3 kernels' bf16 arithmetic rounds as the TPU kernel does,
    round(round(x*a) + b), in two checks. On the card, the bf16x2 form that
    both variants use against the generic per-element form on 2^20 slices of
    8 (x over 2^-8..2^8, |y| past SiLU's fast-divide limit included): equal
    bit for bit, with and without SiLU. ``fused`` counts the elements where
    x*a + b rounded once (from float64) differs from round(round(x*a) + b),
    so the check can see a contraction. In the built library's SASS: no HFMA2.BF16_V2 with three
    register sources, the form of a multiply and an add fused into one."""
    import re

    import torch

    from conditioned_diffusion_models_uad_torch.ops import _build
    from conditioned_diffusion_models_uad_torch.ops import fused_norm as F3

    g = torch.Generator(device="cuda").manual_seed(11)
    m = 1 << 20

    def wide(scale_lo, scale_hi):
        scale = torch.exp2(torch.randint(scale_lo, scale_hi + 1, (m, 8), generator=g,
                                         device="cuda").float())
        return (torch.randn((m, 8), generator=g, device="cuda") * scale).to(torch.bfloat16)

    x = wide(-8, 8)
    a = wide(-4, 4).float()
    b = wide(-4, 7).float()
    out = {"slices": m}
    for silu in (False, True):
        y_p, y_g, sq_p, sq_g = F3.bf16_slice_check(x, a, b, silu)
        torch.cuda.synchronize()
        key = "silu" if silu else "affine"
        out[key] = {"y_differ": int((y_p.view(torch.int16) != y_g.view(torch.int16)).sum()),
                    "square_differ": int((sq_p.view(torch.int32)
                                          != sq_g.view(torch.int32)).sum())}
        require(out[key]["y_differ"] == 0 and out[key]["square_differ"] == 0,
                f"K3 bf16x2 arithmetic differs from the generic rounding ({key}): "
                f"{out[key]}")
    once = (x.double() * a.double() + b.double()).float().to(torch.bfloat16)
    twice = ((x.float() * a).to(torch.bfloat16).float() + b).to(torch.bfloat16)
    out["fused"] = int((once.view(torch.int16) != twice.view(torch.int16)).sum())
    require(out["fused"] > 0, "K3 rounding check: no input tells one rounding from two")
    sass = subprocess.run(
        [str(Path(_build.nvcc_path()).parent / "cuobjdump"), "-sass",
         str(_build._lib_path("fused_norm"))],
        capture_output=True, text=True, check=True, timeout=300).stdout
    fma = re.compile(r"HFMA2(\.MMA)?\.BF16_V2\S* R\d+, -?R\d+\S*, -?R\d+\S*, -?R\d+\S* ;")
    out["sass_fused_bf16x2"] = sum(1 for line in sass.splitlines() if fma.search(line))
    out["sass_bf16x2_ops"] = sum(1 for line in sass.splitlines()
                                 if re.search(r"H(FMA|ADD|MUL)2\S*BF16_V2", line))
    require(out["sass_fused_bf16x2"] == 0 and out["sass_bf16x2_ops"] > 0,
            f"K3 SASS holds fused bf16x2 multiply-adds: {out}")
    return out


def phase_k3():
    """K3 on its own path: ``fused_groupnorm_silu`` at the UNet's three
    norm-site shapes (tools/bench_fused_norm.py: batch 288, bf16, FiLM
    [288, C] f32, SiLU on), then at cases of each variant's own (the cluster
    kernel with a ragged last rank at k = 16 and k = 4, and float32 with
    FiLM [1, C]; the two-pass kernel at a float32 flagship sample and at
    C = 36 bf16 without FiLM or SiLU). The launch counters are set to 0
    just before each call and read just after: each call must launch the
    variant ``kernel_for`` picks, once, and give the same output as that
    variant called alone, and as it gives for the samples in another order.
    Then each variant alone against the plain version; at the site shapes
    both variants are timed in turns (cluster, two-pass, two-pass,
    cluster). First, the bf16 roundings (``k3_bf16_rounding``)."""
    import torch

    from conditioned_diffusion_models_uad_torch.ops import _build
    from conditioned_diffusion_models_uad_torch.ops import fused_norm as F3

    rounding = k3_bf16_rounding()
    g = torch.Generator(device="cuda").manual_seed(5)

    def inputs(shape, dtype, film_rows):
        # each sample its own scale and shift, so that statistics taken from
        # the wrong sample show in the error
        b, n, c = shape
        scale = 0.5 + 1.5 * torch.rand((b, 1, 1), generator=g, device="cuda")
        shift = torch.rand((b, 1, 1), generator=g, device="cuda") - 0.5
        x = (torch.randn(shape, generator=g, device="cuda") * scale + shift).to(dtype)
        gamma = 1.0 + 0.1 * torch.randn(c, generator=g, device="cuda")
        beta = 0.1 * torch.randn(c, generator=g, device="cuda")
        film = None
        if film_rows:
            film = tuple(0.1 * torch.randn((film_rows, c), generator=g, device="cuda")
                         for _ in range(2))
        return x, gamma, beta, film

    names = {v: fn.__name__ for v, fn in F3.VARIANTS.items()}
    sites = [(288, 9216, 128), (288, 2304, 256), (288, 576, 256)]
    # (shape, dtype, film rows, silu, groups, variant kernel_for must pick)
    cases = [(s, torch.bfloat16, s[0], True, 32, "cluster") for s in sites] + [
        ((3, 9215, 128), torch.bfloat16, 3, True, 32, "cluster"),   # k 16, ragged
        ((2, 999, 256), torch.bfloat16, 0, True, 32, "cluster"),    # k 4, ragged
        ((4, 576, 128), torch.float32, 1, True, 32, "cluster"),
        ((8, 9216, 128), torch.float32, 1, True, 32, "two_pass"),   # 4.7 MB sample
        ((3, 100, 36), torch.bfloat16, 0, False, 12, "two_pass"),   # C*2 % 16 != 0
    ]
    recs = []
    path = {name: 0 for name in ("fused_groupnorm_silu", *names.values())}
    dispatched = {v: [] for v in names}  # the calls each variant's count comes from
    for shape, dtype, film_rows, silu, groups, want in cases:
        x, gamma, beta, film = inputs(shape, dtype, film_rows)
        b, n, c = shape
        plan = F3.kernel_for(dtype, n, c, groups)
        require(plan.variant == want, f"K3 {shape} {dtype}: kernel_for picked {plan}")
        counters = _zero_launches()
        y = F3.fused_groupnorm_silu(x, gamma, beta, film, groups=groups, apply_silu=silu)
        torch.cuda.synchronize()
        took = _read_launches(counters)
        for k in path:
            path[k] += took[k]
        dispatched[want].append(f"{list(shape)} {str(dtype).replace('torch.', '')}")
        require(took[names[want]] == 1 and took["fused_groupnorm_silu"] == 1
                and sum(took[v] for v in names.values()) == 1,
                f"K3 {shape} {dtype}: dispatch took {took}, wanted {names[want]}")
        require(y.shape == x.shape and y.dtype == x.dtype, f"K3 {shape} output")
        require(bool(torch.isfinite(y).all()), f"K3 {shape} output not finite")
        site = shape in sites
        variants = list(names) if site else [want]
        for variant in variants:
            rec = k3_record(x, gamma, beta, film, variant, apply_silu=silu, groups=groups)
            rec["dispatch"] = want
            if variant == "cluster":
                rec.update(k=plan.k, rows_per_rank=plan.rows_per_rank,
                           smem_bytes=plan.smem_bytes,
                           max_active_clusters=F3.resident_clusters(
                               plan, c, groups, dtype, torch.cuda.current_device()))
                require(F3.cluster_smem_on_card(plan, c, groups, dtype) == plan.smem_bytes,
                        f"K3 {shape}: kernel_for's shared memory differs from the kernel's")
            if variant == want:
                require(torch.equal(y, F3.VARIANTS[variant](x, gamma, beta, film,
                                                             groups=groups,
                                                             apply_silu=silu)),
                        f"K3 {shape}: fused_groupnorm_silu differs from {rec['name']}")
                # the samples in another order, so on other clusters and in
                # other turns: each sample's output must not change
                perm = torch.randperm(b, generator=g, device="cuda")
                pfilm = film if film_rows != b else tuple(f[perm] for f in film)
                require(torch.equal(y[perm], F3.VARIANTS[variant](
                    x[perm].contiguous(), gamma, beta, pfilm, groups=groups,
                    apply_silu=silu)),
                        f"K3 {shape}: {rec['name']} depends on the samples' order")
            recs.append(rec)
        del y
        fns = {v: (lambda fn=F3.VARIANTS[v]: fn(
            x, gamma, beta, film, groups=groups, apply_silu=silu)) for v in variants}
        order = variants + variants[::-1]  # cluster, two-pass, two-pass, cluster
        readings = {v: [] for v in variants}
        for v in order:
            readings[v].append(cuda_ms(fns[v], reps=20 if site else 5))
        plain_ms = cuda_ms(lambda: F3.groupnorm_silu_reference(
            x, gamma, beta, film, groups=groups, apply_silu=silu), reps=3, warmup=1)
        library_ms = _k3_library_ms(x, gamma, beta, groups)
        for rec, v in zip(recs[-len(variants):], variants):
            rec.update(ms=sum(readings[v]) / len(readings[v]), ms_readings=readings[v],
                       plain_ms=plain_ms, library_ms=library_ms,
                       library_call="F.group_norm, channels_last (GN + affine only)"
                       if library_ms is not None else None)
        del x, fns
        torch.cuda.empty_cache()
    for rec in recs:
        require(rec["allclose_ratio"] <= 1.0,
                f"K3 {rec['name']} {rec['shape']} {rec['dtype']} err {rec['max_abs_err']} "
                f"(allclose ratio {rec['allclose_ratio']})")
    ptxas = [line.strip() for line in _build.build_log.get("fused_norm", "").splitlines()
             if "registers" in line or "Compiling entry" in line or "spill" in line]
    emit({"phase": "k3", "nvidia_smi": nvidia_smi(), "bf16_rounding": rounding,
          "path_launches": path, "dispatched": dispatched, "ptxas": ptxas,
          "results": recs})

    def rec_of(variant, shape, dtype):
        return next(r for r in recs if r["name"] == names[variant]
                    and r["shape"] == list(shape) and r["dtype"] == dtype)

    # each variant's record in the kernels line is at a shape its dispatch
    # took, and its launches are counted over the calls ``dispatched`` lists
    out = {"cluster": rec_of("cluster", sites[0], "bfloat16"),
           "two_pass": rec_of("two_pass", (8, 9216, 128), "float32")}
    out["two_pass"]["at_flagship_bf16_in_turns"] = {
        key: rec_of("two_pass", sites[0], "bfloat16")[key] for key in (
            "shape", "dtype", "max_abs_err", "allclose_ratio", "ms", "ms_readings",
            "plain_ms", "bound_ms", "library_ms")}
    for v, rec in out.items():
        rec["launches"] = path[names[v]]
        rec["launches_counted_over"] = dispatched[v]
    return out


def kernel_kind(name: str) -> str:
    """Coarse class of a CUDA kernel, from its name."""
    low = name.lower()
    for kind, marks in (("K2 attention", ("attention_fwd_kernel",
                                          "attention_mma_fwd_kernel")),
                        ("K1 noise", ("fractal_noise_kernel",)),
                        ("K3 norm", ("gn_cluster_kernel", "gn_stats_kernel",
                                     "gn_apply_kernel")),
                        ("upsample/pool", ("upsample", "pool")),
                        ("sort/select", ("sort", "radix", "median", "kthvalue")),
                        ("scan", ("scan", "cumsum", "cummax", "cummin")),
                        ("index/scatter", ("index", "scatter", "gather", "bincount")),
                        ("convolution", ("conv", "xmma", "implicit", "cudnn",
                                         "fprop")),
                        ("gemm", ("gemm", "cutlass", "matmul")),
                        ("reduction", ("reduce",)),
                        ("copy", ("copy",)),
                        ("elementwise", ("elementwise",))):
        if any(m in low for m in marks):
            return kind
    return "other"


def _launch_counters():
    """Every wrapper's launch counter; ``fused_attention`` counts the launches
    of both K2 variants and ``fused_groupnorm_silu`` those of both K3
    variants, each of which also has its own."""
    from conditioned_diffusion_models_uad_torch.ops.attention import (
        attention_fwd_mma,
        attention_fwd_scalar,
        fused_attention,
    )
    from conditioned_diffusion_models_uad_torch.ops.fused_norm import (
        fused_groupnorm_silu,
        fused_groupnorm_silu_cluster,
        fused_groupnorm_silu_two_pass,
    )
    from conditioned_diffusion_models_uad_torch.ops.simplex_hash import fractal_noise_2d

    return {"fractal_noise_2d": fractal_noise_2d, "fused_attention": fused_attention,
            "attention_fwd_mma": attention_fwd_mma,
            "attention_fwd_scalar": attention_fwd_scalar,
            "fused_groupnorm_silu": fused_groupnorm_silu,
            "fused_groupnorm_silu_cluster": fused_groupnorm_silu_cluster,
            "fused_groupnorm_silu_two_pass": fused_groupnorm_silu_two_pass}


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
        counters = _zero_launches()
        t0 = time.perf_counter()
        reco, aux = task.reconstruct_with_aux(slices, seeds)
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = _read_launches(counters)
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
          "launches": launches, "cpu_s": outs["cpu"][2]})
    require(reco.shape == (4, 96, 96, 1), f"reco shape {tuple(reco.shape)}")
    require(bool(torch.isfinite(reco).all()), "fp32 reconstruction not finite")
    require(reco.std().item() > 1e-3, "fp32 reconstruction is constant")
    for k, v in err.items():
        require(v <= TOL_SLICE_FP32, f"card vs CPU {k} err {v}")
    require(launches["attention_fwd_scalar"] >= 1 and launches["attention_fwd_mma"] == 0,
            f"float32 attention did not take the scalar K2 kernel: {launches}")
    return launches


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
    for name in ("fractal_noise_2d", "fused_attention", "attention_fwd_mma"):
        require(launches[name] >= 1, f"{name} was not launched on the main path")
    require(launches["attention_fwd_scalar"] == 0,
            "bf16 attention slipped onto the scalar K2 kernel")

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
    kernels = kernel_events(prof)
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


def _eval_subjects(n, seed, lesion):
    """``n`` synthetic subjects at EVAL_SHAPE from a torch seed, as host
    arrays like the loader's: vol = vol_orig in [0, 1] inside an ellipsoid
    brain mask; on a lesion set one or two brighter spherical lesions of
    ~260-700 voxels, on a healthy set an all-zero seg."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator().manual_seed(seed)
    h, w, d = EVAL_SHAPE
    ii, jj, kk = torch.meshgrid(*(torch.arange(s, dtype=torch.float32) for s in EVAL_SHAPE),
                                indexing="ij")
    brain = (((ii - (h - 1) / 2) / (0.42 * h)) ** 2 + ((jj - (w - 1) / 2) / (0.36 * w)) ** 2
             + ((kk - (d - 1) / 2) / (0.45 * d)) ** 2) <= 1.0
    subs = []
    for i in range(n):
        tissue = F.avg_pool3d(torch.rand((1, 1, h, w, d), generator=g), 3, 1, 1,
                              count_include_pad=False)[0, 0]
        vol = brain * (0.2 + tissue)
        seg = torch.zeros(EVAL_SHAPE, dtype=torch.bool)
        if lesion:
            for _ in range(1 + int(torch.randint(0, 2, (1,), generator=g))):
                r = 4.0 + 1.5 * float(torch.rand(1, generator=g))
                c = [int(torch.randint(int(0.35 * s), int(0.65 * s), (1,), generator=g))
                     for s in EVAL_SHAPE]
                seg |= ((ii - c[0]) ** 2 + (jj - c[1]) ** 2 + (kk - c[2]) ** 2) <= r * r
            seg &= brain
            vol = torch.where(seg, 0.85 + 0.15 * torch.rand(EVAL_SHAPE, generator=g), vol)
        subs.append({"vol": vol.numpy(), "vol_orig": vol.numpy(),
                     "mask_orig": brain.float().numpy(), "seg_orig": seg.float().numpy(),
                     "ID": f"{'lesion' if lesion else 'healthy'}{seed}_{i}",
                     "label": int(lesion), "seed": seed * 100 + i})
    return subs


def _volume_seeds(task, seeds):
    """[G, E] simplex seeds, each volume's row from its own seed (the port's
    counterpart of fold_in(key, volume index)): a volume draws the same noise
    in whichever group it rides."""
    import torch

    return torch.cat([task.draw_seeds(torch.Generator().manual_seed(int(s)), 1) for s in seeds])


def _eval_rel(a: float, b: float) -> float:
    """Relative difference, 0 for two NaNs, inf for one."""
    if math.isnan(a) or math.isnan(b):
        return 0.0 if math.isnan(a) and math.isnan(b) else math.inf
    return abs(a - b) / max(abs(b), 1e-6)


def phase_eval_correctness():
    """Two lesion subjects reconstructed once on the card (flagship config,
    bf16), then scored by ``_volume_eval_core`` on the card and on the CPU
    from the same reconstruction, under both backend settings (host: the
    maps come back and scipy filters and measures them; device: component
    filter, counts and Hausdorff in the core). The residual, maps, counts,
    thresholds, best dice and squared Hausdorff pair must be equal card
    against CPU; float rows within TOL_EVAL_REL. The card's component filter
    must equal scipy's, and its Hausdorff pair the scipy host path's."""
    import numpy as np
    import torch

    from conditioned_diffusion_models_uad_torch.eval import cc, hausdorff
    from conditioned_diffusion_models_uad_torch.eval import metrics as M
    from conditioned_diffusion_models_uad_torch.eval.fused import (
        SCALAR_KEYS,
        _volume_eval_core,
        parse_packed,
    )
    from conditioned_diffusion_models_uad_torch.eval.harness import EvalConfig, EvalSession
    from conditioned_diffusion_models_uad_torch.eval.reconstruct import VolumeReconstructor

    task = _flagship_task("cuda")
    recon = VolumeReconstructor(task)
    subs = _eval_subjects(2, 40, lesion=True)
    outs = recon.batch_call([s["vol"] for s in subs], _volume_seeds(task, [s["seed"] for s in subs]))
    torch.cuda.synchronize()
    llen = recon.latent_len()
    host_ref, records, worst = {}, [], {"rel": 0.0, "key": None}
    for backend in ("host", "device"):
        session = EvalSession(EvalConfig(cc_backend=backend, hausdorff_backend=backend),
                              "Brats21", "val")
        flags = session._fused_flags(EVAL_SHAPE, seg_is_host=True)
        st = flags["statics"]
        for j, (sub, (reco, aux)) in enumerate(zip(subs, outs)):
            parsed, diffs = {}, {}
            for dev in ("cuda", "cpu"):
                vols = [torch.as_tensor(sub[k], device=dev)
                        for k in ("vol_orig", "mask_orig", "seg_orig")]
                nan = torch.tensor(float("nan"), device=dev)
                diff, buf = _volume_eval_core(vols[0], reco.to(dev), vols[1], vols[2], nan, nan,
                                              aux["loss"].to(dev), aux["latent"].to(dev), **st)
                diffs[dev] = diff.cpu()
                parsed[dev] = parse_packed(buf.cpu(), EVAL_SHAPE, llen, st["pack_seg"],
                                           st["pack_maps"])
            g, c = parsed["cuda"], parsed["cpu"]
            where = f"{backend} volume {j}"
            require(torch.equal(diffs["cuda"], diffs["cpu"]), f"eval diff differs card/CPU, {where}")
            for k in SCALAR_KEYS:
                a, b = g["scalars"][k], c["scalars"][k]
                if k in EXACT_EVAL_SCALARS:
                    require(a == b or (math.isnan(a) and math.isnan(b)),
                            f"eval {k} {a} != {b} card/CPU, {where}")
                else:
                    rel = _eval_rel(a, b)
                    if rel > worst["rel"]:
                        worst.update(rel=rel, key=f"{k}, {where}")
            require(np.array_equal(g["per_slice"][:, 1:], c["per_slice"][:, 1:]),
                    f"eval per-slice counts differ card/CPU, {where}")
            rel = float(np.max(np.abs(g["per_slice"][:, 0] - c["per_slice"][:, 0])
                               / np.maximum(np.abs(c["per_slice"][:, 0]), 1e-6)))
            if rel > worst["rel"]:
                worst.update(rel=rel, key=f"slice_score, {where}")
            for k in ("thresholded", "seg"):
                require((g[k] is None and c[k] is None) or np.array_equal(g[k], c[k]),
                        f"eval map {k} differs card/CPU, {where}")
            seg_np = sub["seg_orig"] > 0
            s = g["scalars"]
            rec = {"backend": backend, "volume": j, "lesion_size": s["lesion_size"],
                   "auroc": s["auroc"], "auprc": s["auprc"], "best_dice": s["best_dice"],
                   "th_record": s["th_record"]}
            if backend == "host":
                # the card's component filter and Hausdorff on the fetched map
                # against scipy's
                thr = g["thresholded"]
                filt_host = M.filter_3d_connected_components(thr, 8)
                thr_card = torch.from_numpy(thr).cuda()
                filt_card = cc.filter_3d_connected_components_device(thr_card, 8).cpu().numpy()
                rounds = cc.label_rounds(thr_card)[1]
                require(np.array_equal(filt_card, filt_host),
                        f"card component filter differs from scipy, volume {j}")
                pair = {dev: [float(v) for v in hausdorff.hausdorff_sq_pair(
                    torch.from_numpy(filt_host).to(dev), torch.from_numpy(seg_np).to(dev))]
                    for dev in ("cuda", "cpu")}
                require(pair["cuda"] == pair["cpu"], f"Hausdorff pair card/CPU {pair}")
                scipy_h = M.hausdorff_distance(filt_host, seg_np)
                card_h = (math.nan if min(pair["cuda"]) < 0 else math.sqrt(max(pair["cuda"])))
                require(card_h == scipy_h or (math.isnan(card_h) and math.isnan(scipy_h)),
                        f"card Hausdorff {card_h} != scipy {scipy_h}, volume {j}")
                host_ref[j] = (M.confusion_counts(filt_host, seg_np), pair["cuda"])
                rec.update(cc_rounds=rounds, hausdorff=scipy_h, hausdorff_sq_pair=pair["cuda"],
                           thresholded_voxels=int(thr.sum()), kept_voxels=int(filt_host.sum()),
                           counts=list(host_ref[j][0]))
            else:
                counts = tuple(int(s[k]) for k in ("tp", "fp", "tn", "fn"))
                require(counts == host_ref[j][0],
                        f"device counts {counts} != scipy-filtered {host_ref[j][0]}, volume {j}")
                require([s["haus_pt"], s["haus_tp"]] == host_ref[j][1],
                        f"in-core Hausdorff pair differs from the host setting's, volume {j}")
                rec["counts"] = list(counts)
            records.append(rec)
    emit({"phase": "eval_correctness", "config": "DDPMTaskConfig() (bf16)",
          "shape": list(EVAL_SHAPE), "volumes": len(subs), "tol_rel": TOL_EVAL_REL,
          "worst_float_rel": worst, "results": records})
    require(worst["rel"] <= TOL_EVAL_REL, f"eval float rows card/CPU: {worst}")


def _score_group(session, group, diff_g, packed_g, flags, llen, score_fn):
    """Scorer-thread body: the group's one fetch, then each volume's commit."""
    from conditioned_diffusion_models_uad_torch.eval.fused import parse_packed

    st = flags["statics"]
    done = 0
    try:
        buf = packed_g.cpu().numpy()
        for j, (i, sub) in enumerate(group):
            parsed = parse_packed(buf[j], EVAL_SHAPE, llen, st["pack_seg"], st["pack_maps"])
            session.test_step_precomputed(
                parsed, diff_g[j], flags, seg_available=True, batch_idx=i, ID=sub["ID"],
                label_vol=sub["label"], score_fn=score_fn, data_seg=sub["seg_orig"],
                seg_dev=sub["seg_dev"])
            done = j + 1
    except BaseException:
        for i, _ in group[done:]:
            session._abort_turn(i)
        raise


def _eval_protocol(task, recon, cfg, stages):
    """The orchestrated eval protocol (as conditioned_diffusion_models_uad_tpu/
    orchestrate.py drives it): per stage an EvalSession, groups of
    ``volumes_per_call`` subjects through ``batch_call_scored``, each group's
    packed buffer parsed and committed on a scorer thread, then
    ``test_end``; the test stage takes the val stage's threshold. Returns
    the sessions, the wall seconds and test_end ms per stage."""
    from concurrent.futures import ThreadPoolExecutor

    from conditioned_diffusion_models_uad_torch.eval.harness import EvalSession

    sessions, test_end_ms, threshold = {}, {}, None
    t_start = time.perf_counter()
    for dataset, stage, subs in stages:
        session = EvalSession(cfg, dataset, stage,
                              threshold=threshold if stage == "test" else None)
        flags = session._fused_flags(EVAL_SHAPE, seg_is_host=True)
        vpc = cfg.volumes_per_call
        with ThreadPoolExecutor(max_workers=cfg.scorer_threads) as scorer:
            pending = []
            for start in range(0, len(subs), vpc):
                group = [(i, subs[i]) for i in range(start, min(start + vpc, len(subs)))]
                diff_g, packed_g = recon.batch_call_scored(
                    [s for _, s in group], flags, _volume_seeds(task, [s["seed"] for _, s in group]))
                while len(pending) >= cfg.scorer_threads:
                    pending.pop(0).result()
                pending.append(scorer.submit(_score_group, session, group, diff_g, packed_g,
                                             flags, recon.latent_len(), task.anomaly_scores))
            for f in pending:
                f.result()
        t0 = time.perf_counter()
        session.test_end()
        test_end_ms[f"{dataset}/{stage}"] = (time.perf_counter() - t0) * 1e3
        if stage == "val" and not session.is_healthy:
            threshold = dict(session.threshold)
        sessions[(dataset, stage)] = session
    return sessions, time.perf_counter() - t_start, test_end_ms


def _scoring_stage_ms(orig, reco, mask, seg):
    """Device ms of the scoring stages of one volume (CUDA events): the
    post-process (residual, erosion, median, reco errors, scores), the sort
    + search, the component filter (with its rounds) and the Hausdorff pair."""
    from conditioned_diffusion_models_uad_torch.eval import cc, hausdorff
    from conditioned_diffusion_models_uad_torch.eval import metrics as M
    from conditioned_diffusion_models_uad_torch.eval import postprocess as P

    def post():
        diff = P.postprocess_residual(orig, reco, mask, erode_iterations=EVAL_SHAPE[1] // 25)
        P.reco_errors(orig, reco, seg)
        P.slice_anomaly_scores(diff, mask)
        P.volume_anomaly_score(diff, mask)
        return diff

    diff = post()
    x, y = diff.reshape(-1), (seg > 0).reshape(-1)
    th = M._seg_metrics_sorted_impl(x, y, x.max())[3]
    thr = diff > th
    filt = cc.filter_3d_connected_components_device(thr, 8)
    return {
        "post_process": cuda_ms(post, reps=5),
        "sort_search": cuda_ms(lambda: M._seg_metrics_sorted_impl(x, y, x.max()), reps=5),
        "cc": cuda_ms(lambda: cc.filter_3d_connected_components_device(thr, 8), reps=5),
        "cc_rounds": cc.label_rounds(thr)[1],
        "hausdorff": cuda_ms(lambda: hausdorff.hausdorff_sq_pair(filt, seg > 0), reps=5),
    }


def phase_eval_full_size():
    """The orchestrated eval protocol at the flagship config (bf16, full
    width) and scoring shape: a lesion set (val, then test with the val
    threshold) and a healthy set (IXI, val), four subjects each, two volumes
    a reconstruction call, under the device_fast backends and under the
    defaults (host). Launch counters are zeroed just before each protocol run
    and read just after. Then the timings: s per group with and without the
    scoring, the scoring stages of one volume, a profiled group, and K2 at
    the eval shape."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from conditioned_diffusion_models_uad_torch.eval.harness import EvalConfig
    from conditioned_diffusion_models_uad_torch.eval.reconstruct import VolumeReconstructor

    task = _flagship_task("cuda")
    recon = VolumeReconstructor(task)
    stages = [("Brats21", "val", _eval_subjects(4, 50, lesion=True)),
              ("Brats21", "test", _eval_subjects(4, 51, lesion=True)),
              ("IXI", "val", _eval_subjects(4, 52, lesion=False))]
    for _, _, subs in stages:
        for s in subs:  # the loader's pre-upload of the seg (val-stage pooling)
            s["seg_dev"] = torch.as_tensor(s["seg_orig"], device="cuda")
    n_vol = sum(len(s) for _, _, s in stages)
    settings = {"device_fast": dict(cc_backend="device", hausdorff_backend="device"),
                "host": {}}
    runs = {}
    for name, backends in settings.items():
        cfg = EvalConfig(volumes_per_call=2, fused_dispatch=True, **backends)
        groups = sum(-(-len(s) // cfg.volumes_per_call) for _, _, s in stages)
        counters = _zero_launches()
        sessions, wall_s, test_end_ms = _eval_protocol(task, recon, cfg, stages)
        torch.cuda.synchronize()
        launches = _read_launches(counters)
        les_val, les_test = sessions[("Brats21", "val")], sessions[("Brats21", "test")]
        healthy = sessions[("IXI", "val")].eval_dict
        rows = {st: {k: list(sessions[("Brats21", st)].eval_dict[k]) for k in (
            "TPPerVol", "FPPerVol", "TNPerVol", "FNPerVol", "lesionSizePerVol")}
            for st in ("val", "test")}
        runs[name] = {
            "groups": groups, "launches": launches, "wall_s": wall_s,
            "volumes_per_sec": n_vol / wall_s, "test_end_ms": test_end_ms,
            "threshold_total": les_val.threshold.get("total"),
            "DicePerVolMean": {st: sessions[("Brats21", st)].eval_dict["DicePerVolMean"]
                               for st in ("val", "test")},
            "AUPRCPerVolMean": {st: sessions[("Brats21", st)].eval_dict["AUPRCPerVolMean"]
                                for st in ("val", "test")},
            "AUCPerVolMean": les_test.eval_dict["AUCPerVolMean"],
            "HausPerVolMean": les_test.eval_dict["HausPerVolMean"],
            "healthy_t": {k: healthy.get(k) for k in ("t_1p", "t_5p", "t_10p")},
            "counts": rows,
        }
        r = runs[name]
        for st in ("val", "test"):
            require(math.isfinite(r["DicePerVolMean"][st]) and math.isfinite(r["AUPRCPerVolMean"][st]),
                    f"eval {name} {st}: DicePerVolMean/AUPRCPerVolMean not finite")
        require(r["threshold_total"] is not None and math.isfinite(r["threshold_total"]),
                f"eval {name}: no fitted val threshold")
        require(les_test.eval_dict["BestThresholdPerVol"] == [r["threshold_total"]] * 4,
                f"eval {name}: the test stage did not take the val threshold")
        require(all(v is not None and math.isfinite(v) for v in r["healthy_t"].values()),
                f"eval {name}: healthy-set thresholds {r['healthy_t']}")
        require(launches["fractal_noise_2d"] >= groups and launches["attention_fwd_mma"] >= groups,
                f"eval {name}: K1/K2 not launched on every group: {launches}")
        require(launches["attention_fwd_scalar"] == 0,
                f"eval {name}: bf16 attention slipped onto the scalar K2 kernel")
    require(runs["device_fast"]["counts"] == runs["host"]["counts"],
            "eval counts differ between the device_fast and host backends")
    require(runs["device_fast"]["threshold_total"] == runs["host"]["threshold_total"],
            "eval val threshold differs between the backends")

    # timings: one val group, scored and not, in turns
    cfg = EvalConfig(volumes_per_call=2, cc_backend="device", hausdorff_backend="device")
    from conditioned_diffusion_models_uad_torch.eval.harness import EvalSession

    flags = EvalSession(cfg, "Brats21", "val")._fused_flags(EVAL_SHAPE, seg_is_host=True)
    group = stages[0][2][:2]
    seeds = _volume_seeds(task, [s["seed"] for s in group])

    def scored():
        return recon.batch_call_scored(group, flags, seeds)[1].cpu()

    def reco_only():
        out = recon.batch_call([s["vol"] for s in group], seeds)
        torch.cuda.synchronize()
        return out

    readings = {"scored": [], "reconstruct": []}
    for key in ("scored", "reconstruct", "reconstruct", "scored"):
        fn = scored if key == "scored" else reco_only
        fn()
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        readings[key].append((time.perf_counter() - t0) / 3)
    reco0 = reco_only()[0][0]
    t = {k: torch.as_tensor(group[0][k], device="cuda") for k in ("vol_orig", "mask_orig",
                                                                  "seg_orig")}
    stage_ms = _scoring_stage_ms(t["vol_orig"], reco0, t["mask_orig"], t["seg_orig"])

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        scored()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = kernel_events(prof)
    busy_ms = sum(ev.self_device_time_total for ev in kernels) / 1e3
    by_kind = {}
    for ev in kernels:
        kind = kernel_kind(ev.key)
        by_kind[kind] = by_kind.get(kind, 0.0) + ev.self_device_time_total / 1e3
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "profile_eval_group.txt").write_text(
        prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=60))

    g = torch.Generator().manual_seed(8)
    k2_eval = k2_record(torch.randn((336, 576, 3, 4, 64), generator=g).to(torch.bfloat16).cuda(),
                        "mma")
    require(k2_eval["max_abs_err"] <= k2_eval["tol"], f"K2 at the eval shape: {k2_eval}")
    emit({"phase": "eval_full_size", "nvidia_smi": nvidia_smi(),
          "config": "DDPMTaskConfig() (bf16), EvalConfig(volumes_per_call=2, fused_dispatch)",
          "shape": list(EVAL_SHAPE), "volumes": n_vol,
          "stages": ["Brats21/val", "Brats21/test (val threshold)", "IXI/val"],
          "runs": runs,
          "s_per_group_reconstruct_score": float(np.mean(readings["scored"])),
          "s_per_group_reconstruct": float(np.mean(readings["reconstruct"])),
          "s_per_group_readings": readings,
          "scoring_ms_per_volume": stage_ms,
          "profiled_group_wall_ms": wall_ms, "profiled_group_kernel_ms": busy_ms,
          "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
          "kernel_ms_by_kind": by_kind,
          "k2_eval_shape": {k: k2_eval[k] for k in ("shape", "max_abs_err", "ms", "plain_ms",
                                                    "bound_ms", "bound_by", "library_ms")}})
    return runs["device_fast"]


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
    for name in ("fractal_noise_2d", "fused_attention", "attention_fwd_mma"):
        require(per_step[name] >= 1, f"{name} was not launched on every train step")
    require(per_step["attention_fwd_scalar"] == 0,
            "bf16 attention slipped onto the scalar K2 kernel")

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
    kernels = kernel_events(prof)
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
    if _IMPORT_ERROR is not None:
        print(f"chip_smoke: cannot import the port: {_IMPORT_ERROR}", file=sys.stderr)
        return 2

    phase_device()
    k1 = phase_k1()
    k2 = phase_k2()
    k3 = phase_k3()
    slice_launches = phase_slice_correctness()
    launches = phase_full_size()
    phase_eval_correctness()
    eval_run = phase_eval_full_size()
    phase_train_correctness()
    train_launches = phase_train_full_size()
    k2_mma, k2_scalar = k2["mma"], k2["scalar"]
    k2_mma["at_train_shape"] = {key: k2["mma_train"][key] for key in (
        "shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
    k2_scalar["at_flagship_bf16"] = {key: k2["scalar_bf16"][key] for key in (
        "shape", "dtype", "max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms")}
    k1["launches"] = launches["fractal_noise_2d"]
    k2_mma["launches"] = launches["attention_fwd_mma"]
    k2_scalar["launches"] = launches["attention_fwd_scalar"]
    k3_cluster, k3_two_pass = k3["cluster"], k3["two_pass"]
    for rec, name in ((k1, "fractal_noise_2d"), (k2_mma, "attention_fwd_mma"),
                      (k2_scalar, "attention_fwd_scalar"),
                      (k3_cluster, "fused_groupnorm_silu_cluster"),
                      (k3_two_pass, "fused_groupnorm_silu_two_pass")):
        rec["launches_by_path"] = {"reconstruct_call": launches[name],
                                   "train_step": train_launches[name],
                                   "eval_protocol": eval_run["launches"][name],
                                   "eval_group": eval_run["launches"][name] / eval_run["groups"]}
    for rec in (k3_cluster, k3_two_pass):
        rec["launches_by_path"]["k3_phase_calls"] = rec["launches"]
    k2_scalar["launches_by_path"]["slice_correctness_call"] = slice_launches[
        "attention_fwd_scalar"]
    emit({"kernels": [k1, k2_mma, k2_scalar, k3_cluster, k3_two_pass]})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
