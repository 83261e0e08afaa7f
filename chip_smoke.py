#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the hand-written kernels from ``conditioned_diffusion_models_uad_torch/
csrc`` with nvcc, holds each against its plain PyTorch version on the card,
then drives the port's paths (experiment cDDPM/DDPM_cond_spark_2D): the
flagship single-shot volume reconstruction (``DDPMTask.reconstruct_with_aux``;
bf16 attention takes K2's tensor-core variant, float32 its scalar one),
the fused GroupNorm+FiLM+SiLU op at the UNet's norm-site shapes
(``fused_groupnorm_silu``; and in the UNet fold's numerics through
``GroupNorm32`` at each eval cell's largest norm site against its eager
chain), the anomaly-scoring eval chain (phases
``eval_correctness``: the scoring core card against CPU and scipy on one
reconstruction; ``eval_full_size``: the orchestrated val/test/healthy
protocol through ``eval/reconstruct.py::VolumeReconstructor.
batch_call_scored`` and ``eval/harness.py::EvalSession``), the flagship
train step (``train/loop.py::train_step``), SparK pretraining of the
encoder (``spark_correctness``: one float32 train step and one masked eval,
card against CPU; ``spark_train_full_size``: the batch-32 bf16 step), the
iterative reconstruction (``iterative_correctness``: DDIM and a truncated
ancestral chain in float32, card against CPU; ``iterative_full_size``:
DDIM-50 and a 50-step ancestral chain on an eval group, bf16), the patched
DDPM (``patched_correctness``: the float32 grid eval and train step, card
against CPU; ``patched_full_size``: an eval group and the batch-32 step with
``use_checkpoint`` on and off), the model variants (``variants_correctness``:
the spatial transformer, conv up/down, the additive embedding, film_fold,
dropout and aug_full in float32, card against CPU, and the 3D simplex
noise; ``variants_full_size``: the batch-32 train step with aug_full and an
eval group of the spatial-transformer and film_fold configs, and the
UNetConfig-only flags on the UNet), the data preparation CLI
(``prepare_full_size``: synthetic raw IXI and BraTS subjects registered to
a synthetic atlas in a subprocess, one subject again on the CPU, the
prepared files through the datamodule), and the run from NIfTI files through
the port's CLI (``run_from_files``: SparK pretraining, then the cDDPM from its
encoder, each fit with validation, checkpoints and CSV logs, then the val ->
test eval from the files; an eval-only reload, the pDDPM fit and eval, an
eval-only DDIM rerun, device against host preprocessing; the files
are written by a child
process during the earlier phases that are not timed, and it is stopped while
a timed one runs). Then the native NIfTI reader against the Python parser
on those files (``native_io``: bit-equal, s a volume, prefetch rate); within
``run_from_files`` every read counted native, the numpy host pool installed,
and the eval-only reload run again as a program with and without the pool;
then data parallelism over ``torch.distributed`` with two gloo ranks on the
one card (``ddp_correctness``: float32 DDP steps of the cDDPM and SparK held
to one process with the ranks' choices replayed, and a 1-rank NCCL group
bit-equal to plain steps; ``ddp_full_size``: the bf16 batch-32 step, 16 a
rank; ``ddp_eval``: an eval group of 2 volumes, one a rank, which must equal
one process's group bit for bit). Eval runs each volume through the model in
a call of its own, so ``eval_full_size`` also requires one and two volumes a
call to give equal counts and packed rows, and times that dispatch beside
the group stacked into one call (as do ``iterative_full_size`` and
``patched_full_size``); ``ddpm_f32_full_size`` drives the unconditional DDPM
baseline (experiment cDDPM/DDPM, float32) at full width: a batch-32 train
step and an eval group, both through K2's float32 kernel;
``fullres_full_size`` drives the flagship config at full resolution
(``datamodule.rescale_factor=1``: 192x192, the middle block's attention over
S = 2304): a train step and an eval group through K2's long-sequence
tensor-core kernel, which is also held against the plain version on the
middle block's own qkv. Each path is driven with the
kernels' launch counters set to 0 just before it and read just after; so
is ``GroupNorm32.fold_calls``, and ``norm_route`` requires K3 at every fold
site of an eval path (a fit's validations among them) and no K3 launch in a
train step (a fit's train steps among them). Every
phase prints one JSON line (all of them also go to
``chiprun_out/chip_smoke.jsonl``); any failed check raises, so the process
exits non-zero. The last line is the device line ``{"ok": true, "device":
{...}}``.

Without CUDA, or run from a directory that holds no port package, it exits
non-zero before printing any result.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
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
# spark_correctness, card vs CPU in float32 (TF32 off), batch 4, one SparK
# train step from a common state with the card's choices replayed (the
# encoder's ReLUs and max-pool, the decoder's ReLU6 at 0) and the active grid
# shared: TRAIN_TOL's limits, the encoder's gradients as the cDDPM's and the
# densify + decoder gradients as its UNet's, the parameters' mean gap at
# lr * 1e-3 of SparK's AdamW lr; then one masked eval of a volume's slices
# from one key: the reconstruction at TOL_SLICE_FP32, per-slice losses 1e-4
# relative.
SPARK_TOL = {**{k: v for k, v in TRAIN_TOL.items() if k not in ("grad_unet", "param_mean")},
             "grad_decoder": TRAIN_TOL["grad_unet"]}
TOL_SPARK_EVAL_LOSS = 1e-4
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


LOG = ROOT / "chiprun_out" / "chip_smoke.jsonl"  # every emitted line, in full


def emit(obj) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    with open(LOG, "a") as f:
        f.write(line + "\n")


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
    # the reconstruction's 6 fields (2 volumes x 3 members through the task's
    # group entry), the train step's and a sampler step's one, a ragged
    # shape, an eval volume's 3 (a call a volume) and a pDDPM volume's 4
    # boxes, and the full-resolution eval volume's 3 and train step's 1
    for shape, n in (((96, 96), 6), ((96, 96), 1), ((37, 130), 3), ((96, 96), 3),
                     ((96, 96), 4), ((192, 192), 3), ((192, 192), 1)):
        seeds = torch.randint(0, 2**31 - 1, (n,), generator=g, dtype=torch.int32)
        seeds[0] = 2**31 - 2
        rec = k1_record(seeds.cuda(), shape)
        require(rec["max_abs_err"] <= TOL_K1, f"K1 {shape} err {rec['max_abs_err']}")
        recs.append(rec)
    emit({"phase": "k1", "results": recs})
    for at, rec in (("at_train_and_sampler_step_shape", recs[1]),
                    ("at_eval_volume_shape", recs[3]), ("at_pddpm_volume_shape", recs[4]),
                    ("at_fullres_eval_volume_shape", recs[5]),
                    ("at_fullres_train_step_shape", recs[6])):
        recs[0][at] = {key: rec[key] for key in ("shape", "max_abs_err", "ms", "graph_ms",
                                                  "plain_ms", "bound_ms", "bound_by")}
    return recs[0]


K2_VARIANTS = {"mma": ("attention_fwd_mma", "csrc/attention_mma.cu"),
               "mma_long": ("attention_fwd_mma_long", "csrc/attention_mma_long.cu"),
               "scalar": ("attention_fwd_scalar", "csrc/attention.cu")}
# the plain version's [B, H, S, S] float32 logits at most this many bytes a
# call: a longer qkv goes through it in batch chunks (the same function)
K2_PLAIN_CHUNK_BYTES = 4e9


def attention_plain(qkv):
    """``attention_reference`` on ``qkv``, in batch chunks whose logits take at
    most K2_PLAIN_CHUNK_BYTES (one chunk at every shape up to [576, 576, 3,
    4, 64]; the full-resolution [312, 2304, …] would need ~80 GB at once)."""
    import torch

    from conditioned_diffusion_models_uad_torch.ops.attention import attention_reference

    b, s, _, h, _ = qkv.shape
    per = max(1, int(K2_PLAIN_CHUNK_BYTES // (h * s * s * 4)))
    if per >= b:
        return attention_reference(qkv)
    return torch.cat([attention_reference(qkv[i:i + per]) for i in range(0, b, per)])


def timed_ms(fn, most=20):
    """``cuda_ms`` over up to ``most`` calls, fewer for a slow ``fn`` (about
    half a second of calls, at least 3)."""
    first = cuda_ms(fn, reps=1, warmup=1)
    return cuda_ms(fn, reps=max(3, min(most, int(500 / max(first, 1e-3)))), warmup=0)


def k2_record(qkv, kernel):
    """K2 variant ``kernel`` ("mma", "mma_long" or "scalar") called directly
    on ``qkv``: its error against the plain version, its time, the plain
    version's and SDPA's, and its bound."""
    import torch
    import torch.nn.functional as F

    from conditioned_diffusion_models_uad_torch.ops import attention as A

    name, source = K2_VARIANTS[kernel]
    wrapper = getattr(A, name)
    b, s, _, h, d = qkv.shape
    dtype = str(qkv.dtype).replace("torch.", "")
    got = wrapper(qkv)
    want = attention_plain(qkv)
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
        "ms": timed_ms(lambda: wrapper(qkv)),
        "plain_ms": cuda_ms(lambda: attention_plain(qkv), reps=3, warmup=1),
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
    version; and at [576, 576, …] bf16 the long-sequence tensor-core kernel
    and the scalar kernel called directly, to set beside the S <= 576
    tensor-core kernel, and the scalar kernel at the full-resolution eval
    shape. The float32 rows at [32, …] and [56, …] are the unconditional
    DDPM baseline's (DDPM.yaml, float32): a batch-32 train step and one
    eval volume (50 slices padded to 56, no noise ensemble). The bf16 rows
    at S = 2304 are the full-resolution cDDPM's (datamodule.rescale_factor
    =1: the 48x48 middle block): an eval volume (3 members x 104 rows) and
    a batch-32 train step."""
    import torch

    from conditioned_diffusion_models_uad_torch.ops import attention as A

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(1)
    # (key, shape, dtype, the variant called directly or None: dispatched)
    cases = [
        ("mma", (576, 576, 3, 4, 64), torch.bfloat16, None),     # eval, batch 576
        ("mma_train", (32, 576, 3, 4, 64), torch.bfloat16, None),  # train, batch 32
        ("mma_pddpm", (224, 576, 3, 4, 64), torch.bfloat16, None),  # pDDPM eval volume
        ("mma_iterative", (56, 576, 3, 4, 64), torch.bfloat16, None),  # a volume's step
        (None, (3, 100, 3, 2, 64), torch.bfloat16, None),        # ragged S
        (None, (2, 64, 3, 2, 32), torch.bfloat16, None),         # D = 32
        (None, (2, 600, 3, 2, 64), torch.bfloat16, None),        # S beyond the mma limit
        ("mma_long_eval", (312, 2304, 3, 4, 64), torch.bfloat16, None),  # full-res volume
        ("mma_long_train", (32, 2304, 3, 4, 64), torch.bfloat16, None),  # full-res step
        (None, (2, 2401, 3, 2, 64), torch.bfloat16, None),       # 49x49: ragged key tile
        (None, (2, 2401, 3, 2, 32), torch.bfloat16, None),       # and D = 32
        ("mma_long_576", (576, 576, 3, 4, 64), torch.bfloat16, "mma_long"),
        ("scalar_bf16", (576, 576, 3, 4, 64), torch.bfloat16, "scalar"),
        ("scalar_bf16_fullres", (312, 2304, 3, 4, 64), torch.bfloat16, "scalar"),
        ("scalar", (12, 576, 3, 4, 64), torch.float32, None),    # slice_correctness
        ("scalar_ddpm_train", (32, 576, 3, 4, 64), torch.float32, None),  # DDPM.yaml step
        ("scalar_ddpm_eval", (56, 576, 3, 4, 64), torch.float32, None),   # its eval volume
        (None, (3, 100, 3, 2, 64), torch.float32, None),
        (None, (2, 64, 3, 2, 32), torch.float32, None),
    ]
    recs, named = [], {}
    for key, shape, dtype, direct in cases:
        dispatched = direct is None
        qkv = torch.randn(shape, generator=g).to(dtype).cuda()
        kernel = A.kernel_for(dtype, shape[1], shape[-1]) if dispatched else direct
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
    for long_key, scalar_key in (("mma_long_576", "scalar_bf16"),
                                 ("mma_long_eval", "scalar_bf16_fullres")):
        named[long_key]["times_faster_than_scalar_bf16"] = (named[scalar_key]["ms"]
                                                            / named[long_key]["ms"])
    emit({"phase": "k2", "nvidia_smi": nvidia_smi(), "results": recs})
    return named


def k3_record(x, gamma, beta, film, variant, apply_silu=True, groups=32):
    """K3 variant ``variant`` ("cluster", "coop" or "two_pass") called directly on x
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
    bit for bit, with and without SiLU, in each numerics (the TPU kernel's,
    the fold's, the fold's with the FiLM after the norm). ``fused`` counts the elements where
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
    film = (wide(-6, -1).float(), wide(-4, 4).float())
    out = {"slices": m}
    for numerics, prefix in ((F3.TPU, ""), (F3.FOLD, "fold_"),
                             (F3.FOLD_FILM_AFTER, "fold_film_after_")):
        for silu in (False, True):
            y_p, y_g, sq_p, sq_g = F3.bf16_slice_check(
                x, a, b, silu, numerics, film if numerics == F3.FOLD_FILM_AFTER else None)
            torch.cuda.synchronize()
            key = prefix + ("silu" if silu else "affine")
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
    FiLM [1, C]; the one-read kernel at a float32 flagship sample, a ragged
    float32 sample with FiLM [B, C] and a 9.4 MB float32 sample; the two-pass
    kernel at C = 36 bf16 without FiLM or SiLU, at a 9.4 MB bf16 sample and at
    a 75 MB float32 sample, beyond the one-read kernel's resident grid).
    Then K3 in the UNet fold's numerics at each eval cell's largest norm site
    (``k3_fold_record``). The launch counters
    are set to 0 just before each call and read just after: each call must
    launch the variant ``kernel_for`` picks, once, and give the same output
    as that variant called alone (a second launch: bit-equal), and as it
    gives for the samples in another order. Then each variant alone against
    the plain version; at the site shapes the cluster and two-pass kernels,
    and at the float32 flagship sample the one-read and two-pass kernels,
    are timed in turns (picked, two-pass, two-pass, picked), CUDA events
    over back-to-back calls (``ms``: the wrapper's host time included where
    it exceeds the kernel's), and at the float32 sample also each call's
    device time from the profiler (``device_ms``). First, the bf16
    roundings (``k3_bf16_rounding``)."""
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
    f32_sample = (8, 9216, 128)  # a float32 flagship sample, 4.7 MB
    # (shape, dtype, film rows, silu, groups, variant kernel_for must pick)
    cases = [(s, torch.bfloat16, s[0], True, 32, "cluster") for s in sites] + [
        ((3, 9215, 128), torch.bfloat16, 3, True, 32, "cluster"),   # k 16, ragged
        ((2, 999, 256), torch.bfloat16, 0, True, 32, "cluster"),    # k 4, ragged
        ((4, 576, 128), torch.float32, 1, True, 32, "cluster"),
        (f32_sample, torch.float32, 1, True, 32, "coop"),
        ((3, 9215, 128), torch.float32, 3, True, 32, "coop"),      # ragged last tile
        ((2, 18432, 128), torch.float32, 2, True, 32, "coop"),     # beyond 16 CTAs
        ((2, 36864, 128), torch.bfloat16, 2, True, 32, "two_pass"),  # bf16 beyond 16 CTAs
        ((3, 100, 36), torch.bfloat16, 0, False, 12, "two_pass"),   # C*2 % 16 != 0
        ((1, 147456, 128), torch.float32, 1, True, 32, "two_pass"),  # beyond the grid
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
        in_turns = site or (shape == f32_sample and dtype == torch.float32)
        variants = [want, "two_pass"] if in_turns else [want]
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
            if variant == "coop":
                rec.update(rows_per_tile=plan.rows_per_rank, tiles_per_sample=plan.tiles,
                           smem_bytes=plan.smem_bytes, resident_blocks=plan.resident,
                           grid=F3.coop_grid(b, plan))
                require(F3.coop_smem_on_card(plan, c, groups, dtype) == plan.smem_bytes,
                        f"K3 {shape}: kernel_for's shared memory differs from the kernel's")
            if variant == want:
                require(torch.equal(y, F3.VARIANTS[variant](x, gamma, beta, film,
                                                             groups=groups,
                                                             apply_silu=silu)),
                        f"K3 {shape}: fused_groupnorm_silu differs from {rec['name']}")
                rec["bit_equal_two_launches"] = True
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
        order = variants + variants[::-1]  # picked, two-pass, two-pass, picked
        readings = {v: [] for v in variants}
        for v in order:
            readings[v].append(cuda_ms(fns[v], reps=20 if in_turns else 5))
        device = {}
        if in_turns and not site:
            marks = {"coop": (("gn_coop_kernel",), 1),
                     "two_pass": (("gn_stats_kernel", "gn_fold_kernel", "gn_apply_kernel"), 3)}
            for v in order:
                device.setdefault(v, []).append(profiled_kernel_ms(
                    fns[v], marks[v][0], reps=100, per_call=marks[v][1]))
        plain_ms = cuda_ms(lambda: F3.groupnorm_silu_reference(
            x, gamma, beta, film, groups=groups, apply_silu=silu), reps=3, warmup=1)
        library_ms = _k3_library_ms(x, gamma, beta, groups)
        for rec, v in zip(recs[-len(variants):], variants):
            rec.update(ms=sum(readings[v]) / len(readings[v]), ms_readings=readings[v],
                       plain_ms=plain_ms, library_ms=library_ms,
                       library_call="F.group_norm, channels_last (GN + affine only)"
                       if library_ms is not None else None)
            if v in device:
                rec.update(device_ms=sum(device[v]) / len(device[v]),
                           device_ms_readings=device[v])
        del x, fns
        torch.cuda.empty_cache()
    for rec in recs:
        require(rec["allclose_ratio"] <= 1.0,
                f"K3 {rec['name']} {rec['shape']} {rec['dtype']} err {rec['max_abs_err']} "
                f"(allclose ratio {rec['allclose_ratio']})")
    ptxas = [line.strip() for line in _build.build_log.get("fused_norm", "").splitlines()
             if "registers" in line or "Compiling entry" in line or "spill" in line]
    # the fold numerics at each eval cell's largest norm site and a cluster
    # site of each, a volume's rows (bf16), and at the DDPM f32 eval group's
    # largest cluster and one-read sites (float32), each mode
    every = ("after", "none", "fold")
    fold = [k3_fold_record(shape, g) for shape in ((168, 9216, 384), (312, 36864, 384))]
    fold += [k3_fold_record(shape, g, modes=every)
             for shape in ((168, 9216, 128), (312, 2304, 256))]
    fold += [k3_fold_record(shape, g, torch.float32, every)
             for shape in ((56, 2304, 256), (56, 9216, 384))]
    require([r["variant"] for r in fold[2:]] == ["cluster", "cluster", "cluster", "coop"],
            f"K3 fold records: {[(r['shape'], r['variant']) for r in fold]}")
    emit({"phase": "k3", "nvidia_smi": nvidia_smi(), "bf16_rounding": rounding,
          "path_launches": path, "dispatched": dispatched, "ptxas": ptxas,
          "results": recs, "fold": fold})

    def rec_of(variant, shape, dtype):
        return next(r for r in recs if r["name"] == names[variant]
                    and r["shape"] == list(shape) and r["dtype"] == dtype)

    # each variant's record in the kernels line is at a shape its dispatch
    # took, and its launches are counted over the calls ``dispatched`` lists
    out = {"cluster": rec_of("cluster", sites[0], "bfloat16"),
           "coop": rec_of("coop", f32_sample, "float32"),
           "two_pass": rec_of("two_pass", f32_sample, "float32")}
    out["two_pass"]["at_flagship_bf16_in_turns"] = {
        key: rec_of("two_pass", sites[0], "bfloat16")[key] for key in (
            "shape", "dtype", "max_abs_err", "allclose_ratio", "ms", "ms_readings",
            "plain_ms", "bound_ms", "library_ms")}
    out["coop"]["at_9mb_sample"] = {
        key: rec_of("coop", (2, 18432, 128), "float32")[key] for key in (
            "shape", "dtype", "max_abs_err", "allclose_ratio", "ms", "plain_ms",
            "bound_ms", "library_ms")}
    for v, rec in out.items():
        rec["launches"] = path[names[v]]
        rec["launches_counted_over"] = dispatched[v]
    return out


def _path_kind(path: str) -> str:
    """"train" for a path of train steps (autograd records every UNet call),
    "eval" for a path of forwards without grad (reconstructions, samplers, a
    fit's validations)."""
    if any(m in path for m in ("train_step", "fwd_bwd", "_steps_rank")):
        return "train"
    return "eval"


def norm_route(paths):
    """The UNet norm chain's route on each path: the share of the fold's
    calls on the card that took K3 (``GroupNorm32.fold_calls``; None on a
    path with no fold site). Requires K3 at every fold site of an eval path,
    one K3 call a site, and no K3 launch in a train step. A fit epoch comes
    in two paths, its validations and its train steps."""
    share = {}
    for path, counts in paths.items():
        k3, eager = counts["norm_fold_k3"], counts["norm_fold_eager"]
        share[path] = k3 / (k3 + eager) if k3 + eager else None
        kind = _path_kind(path)
        if kind == "eval":
            require(eager == 0 and counts["fused_groupnorm_silu"] == k3,
                    f"{path}: a fold site off K3 ({k3} on K3, {eager} eager, "
                    f"{counts['fused_groupnorm_silu']} K3 launches)")
        elif kind == "train":
            require(k3 == 0 and counts["fused_groupnorm_silu"] == 0,
                    f"{path}: K3 in a train step ({k3} fold calls, "
                    f"{counts['fused_groupnorm_silu']} launches)")
    emit({"phase": "norm_route", "fold_k3_share": share,
          "kind": {path: _path_kind(path) for path in paths}})
    return share


# the fold's float32 route against its eager chain: the largest relative L2
# gap of a chunk of samples (the statistics summed in another order) it may
# read; the TPU numerics' eps (1e-6 for 1e-5) reads several times more on
# ``k3_fold_record``'s float32 inputs, whose group variances of ~1e-3 make
# the eps count
FOLD_F32_REL_GAP = 2e-5


def _rel_l2(got, want) -> float:
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def k3_fold_record(shape, g, dtype=None, modes=("after",)):
    """K3 in the fold numerics through ``GroupNorm32`` at a UNet norm site
    [B, N, C] (N a square, bf16 unless ``dtype``) under no_grad, with SiLU,
    against the module's eager chain on the same input, in each FiLM mode of
    ``modes``: "none", "fold" (``film_fold``, composed into the
    coefficients) or "after" (after the norm, as a cell's out-norms call
    it). For each mode: the route's launches (one call, on K3), the share of
    elements bit-equal, the largest gap and the largest relative L2 gap of a
    chunk of samples; bf16 must be >= 99.9% bit-equal, float32 within
    FOLD_F32_REL_GAP, and in float32 the TPU numerics' kernel
    (``fused_groupnorm_silu``, eps 1e-6) on the same input is read beside
    it as the control that the limit must fail. In the first mode: ms in
    turns (K3, eager, eager, K3; CUDA events), K3's device ms from the
    profiler, and its bound (one read and one write of x)."""
    import torch

    from conditioned_diffusion_models_uad_torch.models.unet import GroupNorm32
    from conditioned_diffusion_models_uad_torch.ops import fused_norm as F3
    from conditioned_diffusion_models_uad_torch.utils.random_init import randomize_

    dtype = dtype or torch.bfloat16
    b, n, c = shape
    side = math.isqrt(n)
    # float32 at a 16th of the scale: the same cancellation, a variance at
    # which eps tells 1e-5 from 1e-6
    scale = 1.0 if dtype == torch.bfloat16 else 1 / 16
    mu = torch.randn((b, c, 1, 1), generator=g, device="cuda")
    sd = 0.5 + torch.rand((b, c, 1, 1), generator=g, device="cuda")
    x = ((torch.randn((b, c, side, side), generator=g, device="cuda") * sd + mu)
         * scale).to(dtype).contiguous(memory_format=torch.channels_last)
    norm = randomize_(GroupNorm32(c, f32_apply=False), 3).cuda()
    fs = tuple((0.3 * torch.randn((b, c, 1, 1), generator=g, device="cuda")).to(dtype)
               for _ in range(2))
    plan = F3._card_plan(x.permute(0, 2, 3, 1).reshape(b, n, c), 32)
    name = F3.VARIANTS[plan.variant].__name__
    chunk = 24

    def call(mode, fn, i=0, j=b):
        film = () if mode == "none" else tuple(f[i:j] for f in fs)
        return fn(x[i:j], *film, film_fold=mode == "fold", silu=True)

    def control(mode, i, j):
        film = None if mode == "none" else tuple(f[i:j].reshape(j - i, c).float() for f in fs)
        y = F3.fused_groupnorm_silu(x[i:j].permute(0, 2, 3, 1), norm.weight, norm.bias, film)
        return y.permute(0, 3, 1, 2)

    agreement = {}
    with torch.no_grad():
        for mode in modes:
            counters = _zero_launches()
            call(mode, norm)
            took = _read_launches(counters)
            require(took["norm_fold_k3"] == 1 and took["fused_groupnorm_silu"] == 1
                    and took[name] == 1,
                    f"K3 fold {list(shape)} {dtype} {mode}: the call took {took}")
            # compared a few samples at a time (each sample's output is its
            # own), so that both outputs and their float32 gap fit beside x
            same, err, rel, rel_control = 0, 0.0, 0.0, None
            for i in range(0, b, chunk):
                j = min(b, i + chunk)
                got, want = call(mode, norm, i, j), call(mode, norm.eager, i, j)
                bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
                same += int((got.view(bits) == want.view(bits)).sum())
                err = max(err, (got.float() - want.float()).abs().max().item())
                rel = max(rel, _rel_l2(got, want))
                if dtype == torch.float32:
                    rel_control = max(rel_control or 0.0, _rel_l2(control(mode, i, j), want))
            del got, want
            rec = {"bit_equal_share": same / x.numel(), "max_abs_err": err, "max_rel_l2": rel}
            if dtype == torch.float32:
                rec.update(limit_rel_l2=FOLD_F32_REL_GAP, tpu_numerics_rel_l2=rel_control)
                require(rel <= FOLD_F32_REL_GAP < rel_control,
                        f"K3 fold {list(shape)} float32 {mode}: relative gap {rel:.3g}, the "
                        f"TPU numerics' {rel_control:.3g}, limit {FOLD_F32_REL_GAP}")
            else:
                require(rec["bit_equal_share"] >= 0.999,
                        f"K3 fold {list(shape)} {mode}: {rec['bit_equal_share']:.5f} of the "
                        "elements bit-equal")
            agreement[mode] = rec
        fns = {"k3": lambda: call(modes[0], norm), "eager": lambda: call(modes[0], norm.eager)}
        readings = {"k3": [], "eager": []}
        for v in ("k3", "eager", "eager", "k3"):
            readings[v].append(cuda_ms(fns[v], reps=10 if v == "k3" else 2, warmup=1))
        marks = {"cluster": ("gn_cluster_kernel",), "coop": ("gn_coop_kernel",),
                 "two_pass": ("gn_stats_kernel", "gn_fold_kernel",
                              "gn_apply_kernel")}[plan.variant]
        device_ms = profiled_kernel_ms(fns["k3"], marks, reps=10, per_call=len(marks))
    nbytes = 2 * x.numel() * x.element_size()
    rec = {"name": name, "route": "cuda",
           "numerics": "fold (GroupNorm32 under no_grad), SiLU; FiLM by mode; timed: "
                       + modes[0],
           "source": f"{PKG}/csrc/fused_norm.cu", "shape": list(shape),
           "dtype": str(dtype).replace("torch.", ""), "variant": plan.variant,
           "plan": plan._asdict(), "agreement": agreement,
           "ms": sum(readings["k3"]) / 2, "ms_readings": readings["k3"],
           "device_ms": device_ms, "eager_ms": sum(readings["eager"]) / 2,
           "eager_ms_readings": readings["eager"],
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    rec["share_of_bound"] = rec["bound_ms"] / device_ms
    del x, norm, fs
    torch.cuda.empty_cache()
    return rec


def kernel_kind(name: str) -> str:
    """Coarse class of a CUDA kernel, from its name."""
    low = name.lower()
    for kind, marks in (("K2 attention", ("attention_fwd_kernel",
                                          "attention_mma_fwd_kernel",
                                          "attention_mma_long_fwd_kernel")),
                        ("K1 noise", ("fractal_noise_kernel",)),
                        ("K3 norm", ("gn_cluster_kernel", "gn_coop_kernel",
                                     "gn_stats_kernel", "gn_fold_kernel",
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
    of every K2 variant and ``fused_groupnorm_silu`` those of every K3
    variant, each of which also has its own."""
    from conditioned_diffusion_models_uad_torch.ops.attention import (
        attention_fwd_mma,
        attention_fwd_mma_long,
        attention_fwd_scalar,
        fused_attention,
    )
    from conditioned_diffusion_models_uad_torch.ops.fused_norm import (
        fused_groupnorm_silu,
        fused_groupnorm_silu_cluster,
        fused_groupnorm_silu_coop,
        fused_groupnorm_silu_two_pass,
    )
    from conditioned_diffusion_models_uad_torch.ops.simplex_hash import fractal_noise_2d

    return {"fractal_noise_2d": fractal_noise_2d, "fused_attention": fused_attention,
            "attention_fwd_mma": attention_fwd_mma,
            "attention_fwd_mma_long": attention_fwd_mma_long,
            "attention_fwd_scalar": attention_fwd_scalar,
            "fused_groupnorm_silu": fused_groupnorm_silu,
            "fused_groupnorm_silu_cluster": fused_groupnorm_silu_cluster,
            "fused_groupnorm_silu_coop": fused_groupnorm_silu_coop,
            "fused_groupnorm_silu_two_pass": fused_groupnorm_silu_two_pass}


def _zero_launches():
    """Sets every wrapper's launch counter and ``GroupNorm32.fold_calls`` to 0."""
    from conditioned_diffusion_models_uad_torch.models.unet import GroupNorm32

    counters = _launch_counters()
    for fn in counters.values():
        fn.launches = 0
    GroupNorm32.fold_calls.update(k3=0, eager=0)
    return counters


def _read_launches(counters):
    """Each wrapper's launches, and the UNet norm sites' fold calls on the
    card by route (``norm_fold_k3``, ``norm_fold_eager``)."""
    from conditioned_diffusion_models_uad_torch.models.unet import GroupNorm32

    return {**{name: fn.launches for name, fn in counters.items()},
            **{f"norm_fold_{route}": n for route, n in GroupNorm32.fold_calls.items()}}


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


def _eval_subjects(n, seed, lesion, shape=EVAL_SHAPE):
    """``n`` synthetic subjects at ``shape`` from a torch seed, as host
    arrays like the loader's: vol = vol_orig in [0, 1] inside an ellipsoid
    brain mask; on a lesion set one or two brighter spherical lesions of
    ~260-700 voxels, on a healthy set an all-zero seg."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator().manual_seed(seed)
    h, w, d = shape
    ii, jj, kk = torch.meshgrid(*(torch.arange(s, dtype=torch.float32) for s in shape),
                                indexing="ij")
    brain = (((ii - (h - 1) / 2) / (0.42 * h)) ** 2 + ((jj - (w - 1) / 2) / (0.36 * w)) ** 2
             + ((kk - (d - 1) / 2) / (0.45 * d)) ** 2) <= 1.0
    subs = []
    for i in range(n):
        tissue = F.avg_pool3d(torch.rand((1, 1, h, w, d), generator=g), 3, 1, 1,
                              count_include_pad=False)[0, 0]
        vol = brain * (0.2 + tissue)
        seg = torch.zeros(shape, dtype=torch.bool)
        if lesion:
            for _ in range(1 + int(torch.randint(0, 2, (1,), generator=g))):
                r = 4.0 + 1.5 * float(torch.rand(1, generator=g))
                c = [int(torch.randint(int(0.35 * s), int(0.65 * s), (1,), generator=g))
                     for s in shape]
                seg |= ((ii - c[0]) ** 2 + (jj - c[1]) ** 2 + (kk - c[2]) ** 2) <= r * r
            seg &= brain
            vol = torch.where(seg, 0.85 + 0.15 * torch.rand(shape, generator=g), vol)
        subs.append({"vol": vol.numpy(), "vol_orig": vol.numpy(),
                     "mask_orig": brain.float().numpy(), "seg_orig": seg.float().numpy(),
                     "ID": f"{'lesion' if lesion else 'healthy'}{seed}_{i}",
                     "label": int(lesion)})
    return subs


def _volume_seeds(task, idxs):
    """[G, E] simplex seeds of the volumes at stage indices ``idxs``, as the
    JAX package derives them from the flagship run's eval key (seed 3141,
    fold 0): a volume draws the same noise in whichever group it rides."""
    from conditioned_diffusion_models_uad_torch.orchestrate import eval_key, volume_seeds

    return volume_seeds(eval_key(3141, 0), idxs, task.cfg.ensemble_size)


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
    outs = recon.batch_call([s["vol"] for s in subs], _volume_seeds(task, range(len(subs))))
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


@contextlib.contextmanager
def group_stack_layout(recon, stacked: bool = True):
    """``recon``, with ``stacked`` in the dispatch before per-volume calls: a
    group's stacked slices through the task's group entry in one call (the
    UNet at E * G * pad rows, one K1 launch a group), to time the per-volume
    dispatch against it in one run on one card."""
    if stacked:
        recon._per_volume = lambda slices, draws, g: recon._reconstruct(slices, draws)
    try:
        yield recon
    finally:
        if stacked:
            del recon._per_volume


def _eval_protocol(task, recon, cfg, stages):
    """The orchestrated eval protocol: per stage an EvalSession, the stage's
    group loop (``orchestrate.run_stage``: groups of ``volumes_per_call``
    subjects through ``batch_call_scored``, each group's packed buffer
    committed on a scorer thread), then ``test_end``; the test stage takes
    the val stage's threshold. Returns the sessions, the wall seconds and
    test_end ms per stage."""
    from conditioned_diffusion_models_uad_torch.eval.harness import EvalSession
    from conditioned_diffusion_models_uad_torch.orchestrate import eval_key, run_stage

    sessions, test_end_ms, threshold = {}, {}, None
    t_start = time.perf_counter()
    for dataset, stage, subs in stages:
        session = EvalSession(cfg, dataset, stage,
                              threshold=threshold if stage == "test" else None)
        run_stage(session, recon, subs, eval_key(3141, 0),
                  volumes_per_call=cfg.volumes_per_call, scorer_threads=cfg.scorer_threads,
                  fused_dispatch=cfg.fused_dispatch, score_fn=task.anomaly_scores)
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
    defaults (host); then device_fast with one volume a call, whose counts
    and threshold must equal the two-volume run's (each volume goes through
    the model in a call of its own, so the layout moves no row), and
    device_fast with the group's volumes stacked into one model call (the
    dispatch before per-volume calls, timed beside it). Launch counters are
    zeroed just before each protocol run and read just after. Then: a group's
    packed buffer must equal its volumes' buffers scored one a call, bit for
    bit; the timings, s per group with and without the scoring, per-volume
    and stacked in turns; the scoring stages of one volume, a profiled group,
    and K2 at the eval shape (a volume's [168, …])."""
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
            s["_dev"] = {"seg_orig": torch.as_tensor(s["seg_orig"], device="cuda")}
    n_vol = sum(len(s) for _, _, s in stages)
    fast = dict(cc_backend="device", hausdorff_backend="device")
    settings = {"device_fast": (fast, 2, False), "host": ({}, 2, False),
                "device_fast_vpc1": (fast, 1, False), "device_fast_group_stack": (fast, 2, True)}
    runs = {}
    for name, (backends, vpc, stacked) in settings.items():
        cfg = EvalConfig(volumes_per_call=vpc, fused_dispatch=True, **backends)
        groups = sum(-(-len(s) // cfg.volumes_per_call) for _, _, s in stages)
        with group_stack_layout(recon, stacked):
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
        if not stacked:  # one K1 launch and one UNet call a volume
            n_calls = sum(-(-len(s) // vpc) * vpc for _, _, s in stages)
            require(launches["fractal_noise_2d"] == n_calls
                    and launches["attention_fwd_mma"] == n_calls,
                    f"eval {name}: {launches} for {n_calls} volume calls")
    for other in ("host", "device_fast_vpc1"):
        require(runs["device_fast"]["counts"] == runs[other]["counts"],
                f"eval counts differ between device_fast and {other}")
        require(runs["device_fast"]["threshold_total"] == runs[other]["threshold_total"],
                f"eval val threshold differs between device_fast and {other}")
    runs["device_fast_group_stack"]["counts_equal_to_per_volume"] = (
        runs["device_fast_group_stack"]["counts"] == runs["device_fast"]["counts"])

    # timings: one val group, scored and not, in turns
    cfg = EvalConfig(volumes_per_call=2, cc_backend="device", hausdorff_backend="device")
    from conditioned_diffusion_models_uad_torch.eval.harness import EvalSession

    flags = EvalSession(cfg, "Brats21", "val")._fused_flags(EVAL_SHAPE, seg_is_host=True)
    group = stages[0][2][:2]
    seeds = _volume_seeds(task, range(len(group)))

    def scored():
        return recon.batch_call_scored(group, flags, seeds)[1].cpu()

    def reco_only():
        out = recon.batch_call([s["vol"] for s in group], seeds)
        torch.cuda.synchronize()
        return out

    # volumes_per_call 1 and 2: the group's packed rows are its volumes'
    packed_2 = scored()
    packed_1 = [recon.batch_call_scored(group[j:j + 1], flags, seeds[j:j + 1])[1][0].cpu()
                for j in range(len(group))]
    vpc_bit_equal = [bool(torch.equal(packed_2[j], packed_1[j])) for j in range(len(group))]
    require(all(vpc_bit_equal), f"a group's packed rows differ from its volumes' alone: "
                                f"{vpc_bit_equal}")

    readings = {k: [] for k in ("scored", "scored_group_stack", "reconstruct",
                                "reconstruct_group_stack")}
    for key in ("scored", "scored_group_stack", "scored_group_stack", "scored",
                "reconstruct", "reconstruct_group_stack", "reconstruct_group_stack",
                "reconstruct"):
        fn = scored if key.startswith("scored") else reco_only
        with group_stack_layout(recon, key.endswith("stack")):
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
    k2_eval = k2_record(torch.randn((168, 576, 3, 4, 64), generator=g).to(torch.bfloat16).cuda(),
                        "mma")
    require(k2_eval["max_abs_err"] <= k2_eval["tol"], f"K2 at the eval shape: {k2_eval}")
    emit({"phase": "eval_full_size", "nvidia_smi": nvidia_smi(),
          "config": "DDPMTaskConfig() (bf16), EvalConfig(volumes_per_call=2, fused_dispatch)",
          "shape": list(EVAL_SHAPE), "volumes": n_vol,
          "stages": ["Brats21/val", "Brats21/test (val threshold)", "IXI/val"],
          "runs": runs,
          "s_per_group_reconstruct_score": float(np.mean(readings["scored"])),
          "s_per_group_reconstruct": float(np.mean(readings["reconstruct"])),
          "s_per_group_reconstruct_score_group_stack":
              float(np.mean(readings["scored_group_stack"])),
          "s_per_group_reconstruct_group_stack":
              float(np.mean(readings["reconstruct_group_stack"])),
          "s_per_group_readings": readings,
          "vpc1_vs_vpc2_packed_bit_equal": vpc_bit_equal,
          "scoring_ms_per_volume": stage_ms,
          "profiled_group_wall_ms": wall_ms, "profiled_group_kernel_ms": busy_ms,
          "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
          "kernel_ms_by_kind": by_kind,
          "k2_eval_shape": {k: k2_eval[k] for k in ("shape", "max_abs_err", "ms", "plain_ms",
                                                    "bound_ms", "bound_by", "library_ms")}})
    return runs["device_fast"]


def _train_setup(b, device, seed, hw=(96, 96)):
    """Random volumes [8, *hw, 40] on ``device``, one batch's slice indices,
    and the generator that made them."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    vols = torch.rand((8, *hw, 40), generator=g, device=device)
    vi = torch.randint(0, 8, (b,), generator=g, device=device)
    si = torch.randint(0, 40, (b,), generator=g, device=device)
    return (vols, None), vi, si, g


def _running_stats(task):
    return {k: v.detach().clone() for k, v in task.state_dict().items() if "running" in k}


def _train_one(task, opt, data, vi, si, draws, choices, replay, dtype=None):
    """One train step on the task's device, recording its piecewise choices
    into ``choices`` or replaying them: the loss, the gradients, parameters
    and running statistics after the step (CPU copies in ``dtype``, float64
    by default), and the count of replayed choices."""
    import torch

    from conditioned_diffusion_models_uad_torch.train.loop import train_step
    from conditioned_diffusion_models_uad_torch.utils.decisions import recorded_choices

    dev = task.device
    on_dev = tuple(None if x is None else x.to(dev) for x in data)
    with recorded_choices(choices, replay=replay) as count:
        loss = train_step(task, opt, on_dev, vi.to(dev), si.to(dev), draws)
    dtype = dtype or torch.float64
    return dict(loss=loss.item(), count=count,
                grads={n: p.grad.detach().to("cpu", dtype) for n, p in task.named_parameters()},
                params={n: p.detach().to("cpu", dtype) for n, p in task.named_parameters()},
                stats={k: v.to("cpu", dtype) for k, v in _running_stats(task).items()})


def _train_spread(a, b, lr, nets=(("encoder", "encoder."), ("unet", "unet."))):
    """How far step ``a`` is from step ``b``; ``nets`` names the parameter
    groups (name, prefix) whose worst gradient is reported (the prefix ''
    takes the parameters no earlier group took)."""
    import torch

    def normrel(x, y):
        return ((x - y).norm() / y.norm().clamp_min(1e-30)).item()

    d = torch.cat([(a["params"][n] - v).abs().reshape(-1) for n, v in b["params"].items()])
    out = {"loss": abs(a["loss"] - b["loss"]),
           "stats": max((normrel(a["stats"][k], v) for k, v in b["stats"].items()),
                        default=0.0),
           "param_mean": d.mean().item(), "param_share": (d > lr / 10).double().mean().item(),
           "flipped_share": b["count"]["flipped"] / b["count"]["made"]}
    taken = set()
    for net, prefix in nets:
        names = [n for n in b["grads"] if n.startswith(prefix) and n not in taken]
        taken.update(names)
        worst = max((normrel(a["grads"][n], b["grads"][n]), n) for n in names)
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


def _train_step_numbers(task, b, seed, profile_file, n_learn=50, reps=20, augment=True,
                        n_prof=3, n_parts=5):
    """The train step of ``task`` at batch ``b`` on the card, slices gathered
    from random volumes at the task's image size with aug_intensity (``augment='full'``: the full set,
    on the slices and their masks): 3 warm-up steps, then s/step over
    ``reps`` (the launch counters set to 0 just before them and read just
    after), layer ms between CUDA events over 5, a profiled window of
    ``n_prof`` steps (kernel ms by kind, top kernels, idle share; the table
    is written to ``profile_file`` in the output directory), and
    (``n_learn`` > 0)
    ``n_learn`` steps on the one batch, with the loss at one fixed set of
    draws (train mode, running statistics restored after each reading) read
    before and after. Returns (numbers, launches per step)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from conditioned_diffusion_models_uad_torch.train.loop import (
        gathered_batch,
        make_optimizer,
        train_step,
    )

    opt = make_optimizer(task)
    data, vi, si, g = _train_setup(b, "cuda", seed, tuple(task.cfg.image_hw))
    if augment == "full":
        data = (data[0], data[0] > 0.5)

    def step():
        return train_step(task, opt, data, vi, si, task.draw_train(g, b, augment=augment))

    for _ in range(3):
        loss = step()
    require(math.isfinite(loss.item()), "train loss not finite")

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    counters = _zero_launches()
    t0 = time.perf_counter()
    for _ in range(reps):
        loss = step()
    torch.cuda.synchronize()
    s_per_step = (time.perf_counter() - t0) / reps
    per_step = {k: v / reps for k, v in _read_launches(counters).items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # layer times: the train step's pieces between CUDA events
    parts = {"gather_augment": 0.0, "forward": 0.0, "backward": 0.0, "optimizer": 0.0}
    for _ in range(n_parts):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        draws = task.draw_train(g, b, augment=augment)
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
    (out_dir / profile_file).write_text(
        prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=60))

    learn = {}
    if n_learn:
        fixed = task.draw_train(g, b, augment=augment)

        def fixed_loss():
            stats = _running_stats(task)
            with torch.no_grad():
                value = task.loss(gathered_batch(data, vi, si, fixed.aug), fixed)[0].item()
            task.load_state_dict(stats, strict=False)
            return value

        before = fixed_loss()
        learn_losses = [step().item() for _ in range(n_learn)]
        after = fixed_loss()
        require(all(math.isfinite(v) for v in learn_losses), "train loss not finite")
        require(after < before, f"fixed-draw loss did not fall: {before} -> {after}")
        learn = {"fixed_draw_loss_before": before, "fixed_draw_loss_after": after,
                 "learn_steps": n_learn,
                 "learn_loss_first_last": [learn_losses[0], learn_losses[-1]]}
    return {"batch": b, "launches_per_step": per_step, "s_per_step": s_per_step,
            "train_slices_per_sec": b / s_per_step, "layer_ms": parts,
            "peak_memory_gb": peak_gb,
            "profiled_steps": n_prof, "profiled_wall_ms": wall_ms,
            "profiled_kernel_ms": busy_ms,
            "cuda_kernels_per_step": sum(ev.count for ev in kernels) / n_prof,
            "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            # the profiler slows the host; against the unprofiled step time
            "device_idle_share_unprofiled": max(0.0, 1.0 - busy_ms / n_prof
                                                / (s_per_step * 1e3)),
            "kernel_ms_per_step_by_kind": by_kind, "top_kernels": top, **learn}, per_step


def phase_train_full_size():
    """The flagship train step at full size: DDPMTaskConfig() defaults (bf16,
    compute norms, fused attention), batch 32 (configs/datamodule/IXI.yaml),
    slices gathered from random volumes on the card, aug_intensity on."""
    numbers, per_step = _train_step_numbers(_flagship_task("cuda"), 32, 7,
                                            "profile_train_step.txt")
    emit({"phase": "train_full_size", "nvidia_smi": nvidia_smi(),
          "config": "DDPMTaskConfig() (bf16, norm_precision=compute, fused_attention), "
                    "Adam lr 1e-4, aug_intensity", **numbers})
    for name in ("fractal_noise_2d", "fused_attention", "attention_fwd_mma"):
        require(per_step[name] >= 1, f"{name} was not launched on every train step")
    require(per_step["attention_fwd_scalar"] == 0,
            "bf16 attention slipped onto the scalar K2 kernel")
    return per_step


def _spark_task(device, **kw):
    from conditioned_diffusion_models_uad_torch.models.tasks import SparkTask, SparkTaskConfig
    from conditioned_diffusion_models_uad_torch.utils.random_init import randomize_

    return randomize_(SparkTask(SparkTaskConfig(**kw), device=device), 0)


def phase_spark_correctness():
    """SparK pretraining (experiment cDDPM/Spark_2D_pretrain: resnet50,
    dec_dim 128, 96x96) in float32 with TF32 off, batch 4: one train step on
    the card, repeated on the CPU from the card's state before it with the
    card's piecewise choices and active grid; then one masked eval of a
    volume's 40 slices from one key on both."""
    import copy

    import torch

    from conditioned_diffusion_models_uad_torch.train.loop import make_optimizer
    from conditioned_diffusion_models_uad_torch.utils import prng

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    b = 4
    data, vi, si, g = _train_setup(b, "cpu", 8)
    cpu_task = _spark_task("cpu", dtype="float32")
    draws = cpu_task.draw_train(g, b)
    card_task = _spark_task("cuda", dtype="float32")
    card_opt, cpu_opt = make_optimizer(card_task), make_optimizer(cpu_task)
    state = {k: v.detach().cpu().clone() for k, v in card_task.state_dict().items()}
    opt_state = copy.deepcopy(card_opt.state_dict())
    choices = []
    counters = _zero_launches()
    t0 = time.perf_counter()
    card = _train_one(card_task, card_opt, data, vi, si, draws, choices, replay=False)
    t1 = time.perf_counter()
    launches = _read_launches(counters)
    cpu_task.load_state_dict(state)
    cpu_opt.load_state_dict(opt_state)
    cpu = _train_one(cpu_task, cpu_opt, data, vi, si, draws, choices, replay=True)
    cpu_s = time.perf_counter() - t1
    lr = card_task.cfg.lr
    spread = _train_spread(card, cpu, lr, nets=(("encoder", "model.encoder."),
                                                ("decoder", "")))
    limit = {**SPARK_TOL, "param_mean": lr * 1e-3}

    # one masked eval from a common state: a volume's 40 slices, one key
    slices = data[0][0].movedim(-1, 0)[..., None]
    keys = torch.from_numpy(prng.fold_in(prng.PRNGKey(4141), [0]).astype("int64"))
    cpu_task.load_state_dict({k: v.cpu() for k, v in card_task.state_dict().items()})
    reco_card, aux_card = card_task.reconstruct_with_aux(slices, keys)
    reco_cpu, aux_cpu = cpu_task.reconstruct_with_aux(slices, keys)
    eval_err = {
        "reco": (reco_card.cpu() - reco_cpu).abs().max().item(),
        "loss_per_slice_rel": ((aux_card["loss_per_slice"].cpu() - aux_cpu["loss_per_slice"])
                               .abs() / aux_cpu["loss_per_slice"].abs()).max().item()}
    emit({"phase": "spark_correctness",
          "config": "SparkTaskConfig(dtype='float32') (resnet50, dec_dim 128, 96x96), TF32 off",
          "batch": b, "loss_cuda": card["loss"], "loss_cpu": cpu["loss"],
          "choices": cpu["count"], "card_vs_cpu": spread, "limit": limit,
          "eval_slices": slices.shape[0], "eval_err": eval_err,
          "eval_tol": {"reco": TOL_SLICE_FP32, "loss_per_slice_rel": TOL_SPARK_EVAL_LOSS},
          "launches": launches, "cuda_s": t1 - t0, "cpu_s": cpu_s})
    require(math.isfinite(card["loss"]), "card SparK loss not finite")
    for k, lim in limit.items():
        v = spread[k]
        require(v <= lim, f"SparK card vs CPU: {k} {v} > {lim}")
    require(bool(torch.isfinite(reco_card).all()) and reco_card.std().item() > 1e-3,
            "SparK masked reconstruction not finite or constant")
    require(eval_err["reco"] <= TOL_SLICE_FP32,
            f"SparK eval reco card vs CPU {eval_err['reco']}")
    require(eval_err["loss_per_slice_rel"] <= TOL_SPARK_EVAL_LOSS,
            f"SparK eval loss card vs CPU {eval_err['loss_per_slice_rel']}")
    require(all(v == 0 for v in launches.values()), f"a kernel launched on SparK: {launches}")


def phase_spark_train_full_size():
    """The SparK train step at full size: SparkTaskConfig() (resnet50,
    dec_dim 128, mask_ratio 0.65, 96x96 so f = 3 and 3 of 9 sites kept, bf16,
    AdamW(2e-4, wd 0.05, betas 0.9/0.95)), batch 32 gathered from random
    volumes on the card, aug_intensity on. It launches none of K1-K3."""
    numbers, per_step = _train_step_numbers(_spark_task("cuda"), 32, 9,
                                            "profile_spark_train_step.txt")
    emit({"phase": "spark_train_full_size", "nvidia_smi": nvidia_smi(),
          "config": "SparkTaskConfig() (resnet50, dec_dim 128, mask_ratio 0.65, 96x96, bf16, "
                    "norm_precision float32), AdamW lr 2e-4 wd 0.05 betas (0.9, 0.95), "
                    "aug_intensity", **numbers})
    require(all(v == 0 for v in per_step.values()), f"a kernel launched on SparK: {per_step}")
    return per_step


# the run from files: raw NIfTI at or above configs/datamodule/IXI.yaml's
# image_dim [192, 192, 100] on every axis, so the crop happens; 32 IXI train
# subjects (one batch-32 step an epoch), 2 val, 2 test, and 4 val + 4 test
# for each lesion set of the datamodule's testsets
# iterative_correctness: the flagship config in float32 (TF32 off), 2 volumes
# of 2 slices under the same keys and weights, card against CPU: a DDIM run
# of ITER_STEPS['ddim'] steps from t = 500 and an ancestral run truncated at
# t = ITER_STEPS['ancestral']. Each step feeds the previous one's output back
# through the UNet and through coefficients that grow near t = 0, so the
# single call's error grows with the steps. The card's first run (H100,
# PERF.md PR 8) measured 2.7e-5 (DDIM) and 1.5e-5 (ancestral); the limits
# leave ~20x for the spread of other inputs and steps.
ITER_STEPS = {"ddim": 4, "ancestral": 5}
TOL_ITERATIVE = {"ddim": 5e-4, "ancestral": 5e-4}


def _iterative_task(device, mode, steps, **kw):
    """The flagship task with ``reco_mode`` ``mode`` taking ``steps`` UNet
    calls: DDIM steps from test_timesteps 500, or an ancestral chain
    truncated at t = steps."""
    kw["sampling_steps" if mode == "ddim" else "test_timesteps"] = steps
    return _flagship_task(device, reco_mode=mode, **kw)


def phase_iterative_correctness():
    """The iterative reconstruction (``reco_mode`` 'ddim' and 'ancestral')
    on the card and on the CPU in float32, same weights and keys [2, 2]: the
    reconstructions within TOL_ITERATIVE, the NaN loss sentinel, and K1
    launched once a step (one field per volume, both volumes in one launch;
    the last step draws none, the initial noising one) and K2 once a UNet
    call."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(12)
    slices = torch.rand((4, 96, 96, 1), generator=g)
    keys = torch.randint(0, 2**32, (2, 2), generator=g, dtype=torch.int64)
    runs = {}
    for mode, steps in ITER_STEPS.items():
        outs, secs = {}, {}
        for dev in ("cuda", "cpu"):
            task = _iterative_task(dev, mode, steps, dtype="float32")
            counters = _zero_launches()
            t0 = time.perf_counter()
            reco, aux = task.reconstruct_with_aux(slices, keys)
            if dev == "cuda":
                torch.cuda.synchronize()
                launches = _read_launches(counters)
            secs[dev] = time.perf_counter() - t0
            outs[dev] = (reco.cpu(), {k: v.cpu() for k, v in aux.items()})
            del task
        reco = outs["cuda"][0]
        require(reco.shape == (4, 96, 96, 1) and bool(torch.isfinite(reco).all()),
                f"{mode}: reconstruction {tuple(reco.shape)} not finite")
        require(reco.std().item() > 1e-3, f"{mode}: reconstruction is constant")
        require(bool(torch.isnan(outs["cuda"][1]["loss_per_slice"]).all()),
                f"{mode}: the loss sentinel is not NaN")
        runs[mode] = {"steps": steps, "launches": launches, "cuda_s": secs["cuda"],
                      "cpu_s": secs["cpu"], "tol": TOL_ITERATIVE[mode],
                      "max_abs_err_vs_cpu": (reco - outs["cpu"][0]).abs().max().item(),
                      "latent_err": (outs["cuda"][1]["latent_per_slice"]
                                     - outs["cpu"][1]["latent_per_slice"]).abs().max().item()}
    emit({"phase": "iterative_correctness",
          "config": "DDPMTaskConfig(dtype='float32', reco_mode=ddim|ancestral), TF32 off",
          "volumes": 2, "slices": 4, "runs": runs})
    for mode, r in runs.items():
        require(r["max_abs_err_vs_cpu"] <= r["tol"],
                f"{mode}: card vs CPU {r['max_abs_err_vs_cpu']} > {r['tol']}")
        require(r["latent_err"] <= TOL_SLICE_FP32, f"{mode}: latent {r['latent_err']}")
        got = r["launches"]
        require(got["fractal_noise_2d"] == r["steps"],
                f"{mode}: K1 launched {got['fractal_noise_2d']} times in {r['steps']} steps")
        require(got["fused_attention"] == r["steps"] == got["attention_fwd_scalar"],
                f"{mode}: K2 launches {got} in {r['steps']} UNet calls (float32: scalar)")


def phase_iterative_full_size():
    """The iterative reconstruction at the flagship width (DDPMTaskConfig(),
    bf16) on one eval group of 2 volumes at EVAL_SHAPE (depth 50, padded to
    56: a chain a volume, 56 slices a UNet call) through
    ``VolumeReconstructor.batch_call`` with the orchestrator's keys: DDIM
    with 50 steps from t = 500 (timed with the launch counters, then against
    the group's volumes stacked into one chain of 112 slices, in turns; the
    idle share from a 5-step call under the profiler), then the ancestral
    chain truncated at t = 50 (the full 500-step chain is cut to 50 steps
    for time; the width is not cut). Returns the launches of each mode's
    call."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from conditioned_diffusion_models_uad_torch.eval.reconstruct import VolumeReconstructor
    from conditioned_diffusion_models_uad_torch.models.tasks import DDPMTask
    from conditioned_diffusion_models_uad_torch.orchestrate import eval_key, volume_draws

    vols = [s["vol"] for s in _eval_subjects(2, 31, True)]
    out, launches = {}, {}
    for mode, steps in (("ddim", 50), ("ancestral", 50)):
        task = _iterative_task("cuda", mode, steps)
        recon = VolumeReconstructor(task)
        draws = volume_draws(task, eval_key(3141, 0), [0, 1])
        torch.cuda.synchronize()
        counters = _zero_launches()
        t0 = time.perf_counter()
        res = recon.batch_call(vols, draws)
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        launches[mode] = got = _read_launches(counters)
        for reco, aux in res:
            require(reco.shape == EVAL_SHAPE and bool(torch.isfinite(reco).all()),
                    f"{mode} full size: reconstruction not finite")
            require(reco.float().std().item() > 1e-3, f"{mode} full size: constant")
            require(math.isnan(float(aux["loss"])), f"{mode} full size: loss is not NaN")
        require(got["fractal_noise_2d"] == 2 * steps and got["attention_fwd_mma"] == 2 * steps
                and got["attention_fwd_scalar"] == 0,
                f"{mode} full size: launches {got} in {steps} steps of 2 volumes")
        slices = 2 * 56
        out[mode] = {"steps": steps, "from_t": task.cfg.test_timesteps if mode == "ddim"
                     else steps, "unet_batch": slices // 2, "launches": got,
                     "s_per_call": call_s, "s_per_volume": call_s / 2,
                     "slice_denoises_per_sec": steps * slices / call_s}
        if mode == "ddim":  # per-volume chains against one stacked chain, in turns
            readings = {"per_volume": [call_s], "group_stack": []}
            for key in ("group_stack", "group_stack", "per_volume"):
                with group_stack_layout(recon, key == "group_stack"):
                    t0 = time.perf_counter()
                    recon.batch_call(vols, draws)
                    torch.cuda.synchronize()
                    readings[key].append(time.perf_counter() - t0)
            out[mode]["s_per_call_readings"] = readings
            out[mode]["s_per_call_group_stack"] = sum(readings["group_stack"]) / 2
        if mode == "ddim":  # the idle share, from a 5-step call on the same weights
            short = DDPMTask(dataclasses.replace(task.cfg, sampling_steps=5), device="cuda")
            short.load_state_dict(task.state_dict())
            short_recon = VolumeReconstructor(short)
            short_recon.batch_call(vols, draws)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                short_recon.batch_call(vols, draws)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            kernels = kernel_events(prof)
            busy_ms = sum(ev.self_device_time_total for ev in kernels) / 1e3
            by_kind = {}
            for ev in kernels:
                kind = kernel_kind(ev.key)
                by_kind[kind] = by_kind.get(kind, 0.0) + ev.self_device_time_total / 1e3 / 5
            out[mode]["profiled_5_steps"] = {
                "wall_ms": wall_ms, "kernel_ms": busy_ms,
                "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
                "kernel_ms_per_step_by_kind": by_kind}
            del short, short_recon
        del task, recon
    emit({"phase": "iterative_full_size", "nvidia_smi": nvidia_smi(),
          "config": "DDPMTaskConfig(reco_mode=ddim, sampling_steps=50) from t=500; "
                    "reco_mode=ancestral at test_timesteps=50 (cut from 500)",
          "volumes": 2, "shape": list(EVAL_SHAPE), **out})
    return launches


def _ddpm_f32_task():
    """experiment=cDDPM/DDPM (the unconditional baseline: UNet 128, mult
    (1, 2, 2), no encoder, no noise ensemble, float32) at full width, as the
    port's CLI materializes it, from seeded weights."""
    from conditioned_diffusion_models_uad_torch import config
    from conditioned_diffusion_models_uad_torch.models.tasks import DDPMTask
    from conditioned_diffusion_models_uad_torch.utils.random_init import randomize_

    cfg = config.materialize(config.compose(str(ROOT / "configs"), "cDDPM/DDPM", [])).model
    require(cfg.dtype == "float32" and not cfg.condition and not cfg.noise_ensemble,
            f"DDPM.yaml materialized as {cfg}")
    return randomize_(DDPMTask(cfg, device="cuda"), 0)


def phase_ddpm_f32_full_size():
    """The unconditional DDPM baseline (configs/experiment/cDDPM/DDPM.yaml,
    float32) at full width through the port's config loader, TF32 off as in
    every float32 phase: train steps at batch 32 (s/step over 3 after 3 of
    warm-up, a profiled window of 2), then one eval group of 2 lesion
    volumes at EVAL_SHAPE through ``batch_call_scored`` (a model call a
    volume: the UNet at 56 rows, one K1 launch) after a warm-up group, and
    that group under the profiler. The launch counters are zeroed just
    before each timed run and read just after: float32 attention must take
    ``attention_fwd_scalar`` on both paths and never the tensor-core
    kernel. Reports s/step, slice-denoises/s, the idle share and the scalar
    K2 kernel's share of kernel time. Returns the launches of a step and of
    the group."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from conditioned_diffusion_models_uad_torch.eval.fused import parse_packed
    from conditioned_diffusion_models_uad_torch.eval.reconstruct import VolumeReconstructor

    _no_tf32()
    tf32 = {"cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32}
    task = _ddpm_f32_task()
    train, per_step = _train_step_numbers(task, 32, 17, "profile_ddpm_f32_train_step.txt",
                                          n_learn=0, reps=3, n_prof=2, n_parts=2)
    k2_train = train["kernel_ms_per_step_by_kind"].get("K2 attention", 0.0)
    train["k2_kernel_share"] = k2_train * train["profiled_steps"] / train["profiled_kernel_ms"]

    recon = VolumeReconstructor(task)
    subs = _eval_subjects(2, 34, lesion=True)
    flags = _ddp_eval_flags()
    seeds = _volume_seeds(task, range(len(subs)))
    recon.batch_call_scored(subs, flags, seeds)[1].cpu()  # warm-up: the 56-row shapes
    torch.cuda.synchronize()
    counters = _zero_launches()
    t0 = time.perf_counter()
    _, packed = recon.batch_call_scored(subs, flags, seeds)
    packed = packed.cpu()
    group_s = time.perf_counter() - t0
    eval_launches = _read_launches(counters)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        recon.batch_call_scored(subs, flags, seeds)[1].cpu()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = kernel_events(prof)
    busy_ms = sum(ev.self_device_time_total for ev in kernels) / 1e3
    by_kind = {}
    for ev in kernels:
        kind = kernel_kind(ev.key)
        by_kind[kind] = by_kind.get(kind, 0.0) + ev.self_device_time_total / 1e3
    st = flags["statics"]
    rows = [parse_packed(packed[j], EVAL_SHAPE, recon.latent_len(), st["pack_seg"],
                         st["pack_maps"])["scalars"] for j in range(len(subs))]
    slices = 56 * len(subs)
    evaluation = {"volumes": len(subs), "shape": list(EVAL_SHAPE), "unet_batch": 56,
                  "s_per_group": group_s, "slice_denoises_per_sec": slices / group_s,
                  "launches": eval_launches, "profiled_wall_ms": wall_ms,
                  "profiled_kernel_ms": busy_ms,
                  "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
                  "kernel_ms_by_kind": by_kind,
                  "k2_kernel_share": by_kind.get("K2 attention", 0.0) / busy_ms,
                  "auprc": [r["auprc"] for r in rows], "best_dice": [r["best_dice"] for r in rows],
                  "aux_loss": [r["aux_loss"] for r in rows]}
    emit({"phase": "ddpm_f32_full_size", "nvidia_smi": nvidia_smi(),
          "config": "experiment=cDDPM/DDPM (unconditional, UNet 128, mult (1,2,2), "
                    "float32, noise_ensemble false), eval=device_fast scoring",
          "tf32": tf32, "train_step": train, "eval_group": evaluation})
    for name, per in (("train step", per_step), ("eval group", eval_launches)):
        require(per["attention_fwd_scalar"] >= 1 and per["attention_fwd_mma"] == 0,
                f"DDPM float32 {name}: K2 launches {per}")
        require(per["fractal_noise_2d"] >= 1, f"DDPM float32 {name}: K1 launches {per}")
    require(eval_launches["attention_fwd_scalar"] == len(subs)
            and eval_launches["fractal_noise_2d"] == len(subs),
            f"DDPM float32 eval group: one UNet call and one K1 launch a volume: "
            f"{eval_launches}")
    for r in rows:
        require(all(math.isfinite(r[k]) for k in ("auprc", "best_dice", "aux_loss")),
                f"DDPM float32 eval rows not finite: {r}")
    require(math.isfinite(train["s_per_step"]), "DDPM float32 step")
    return per_step, eval_launches


# the full-resolution cDDPM: configs/datamodule/IXI.yaml image_dim with
# datamodule.rescale_factor=1 (no downsample), so the UNet runs at 192x192
# and its 48x48 middle block attends over S = 2304 tokens
FULLRES_OVERRIDES = ["datamodule.rescale_factor=1"]
FULLRES_SHAPE = (192, 192, 100)
FULLRES_SEQ = 2304
FULLRES_TRAIN_BATCH = 32


def _fullres_task():
    """experiment=cDDPM/DDPM_cond_spark_2D with datamodule.rescale_factor=1,
    as the port's CLI materializes it (the flagship widths, bf16, fused
    attention, image_hw (192, 192)), from seeded weights."""
    from conditioned_diffusion_models_uad_torch import config
    from conditioned_diffusion_models_uad_torch.models.tasks import DDPMTask
    from conditioned_diffusion_models_uad_torch.utils.random_init import randomize_

    cfg = config.materialize(config.compose(str(ROOT / "configs"), "cDDPM/DDPM_cond_spark_2D",
                                            FULLRES_OVERRIDES)).model
    require(tuple(cfg.image_hw) == FULLRES_SHAPE[:2] and cfg.dtype == "bfloat16"
            and cfg.fused_attention, f"the full-resolution config materialized as {cfg}")
    return randomize_(DDPMTask(cfg, device="cuda"), 0)


def phase_fullres_full_size():
    """The full-resolution cDDPM (``_fullres_task``: 192x192, bf16): train
    steps at batch FULLRES_TRAIN_BATCH (s/step over 3 after 3 of warm-up, a
    profiled window of 2), then one eval group of 2 lesion volumes at
    FULLRES_SHAPE (100 slices padded to 104, 3 members: 312 UNet rows a
    volume call) through ``batch_call_scored`` after a warm-up group, and
    that group under the profiler. A forward hook on the middle
    ``AttentionBlock`` captures the warm-up's first volume call's qkv (it
    must be [312, 2304, 3, 4, 64]); the kernel's output on it is held
    against the plain version on the card at TOL_K2["bfloat16"] as the
    tests hold K2 (allclose, atol = rtol: these outputs reach |y| >= 8,
    where a bf16 ulp is 0.0625), and timed beside SDPA at the same qkv.
    The launch counters are zeroed just before
    each timed run and read just after: bf16 attention must take
    ``attention_fwd_mma_long`` once a volume call and once a step, and no
    other K2 variant. Reports s/step, peak memory, s a group,
    slice-denoises/s, scored volumes/s, the idle share, kernel ms by kind
    and K2's share. Returns the launches of a step and of the group."""
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from conditioned_diffusion_models_uad_torch.eval.fused import parse_packed
    from conditioned_diffusion_models_uad_torch.eval.reconstruct import VolumeReconstructor
    from conditioned_diffusion_models_uad_torch.ops import attention as A

    task = _fullres_task()
    train, per_step = _train_step_numbers(task, FULLRES_TRAIN_BATCH, 19,
                                          "profile_fullres_train_step.txt", n_learn=0,
                                          reps=3, n_prof=2, n_parts=2)
    k2_train = train["kernel_ms_per_step_by_kind"].get("K2 attention", 0.0)
    train["k2_kernel_share"] = k2_train / (train["profiled_kernel_ms"] / train["profiled_steps"])
    train["card_free_gb_at_peak"] = (torch.cuda.get_device_properties(0).total_memory / 1e9
                                     - train["peak_memory_gb"])
    task.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()

    recon = VolumeReconstructor(task)
    subs = _eval_subjects(2, 36, lesion=True, shape=FULLRES_SHAPE)
    flags = _ddp_eval_flags(FULLRES_SHAPE)
    seeds = _volume_seeds(task, range(len(subs)))
    captured = []

    def capture(mod, inputs, output):
        if not captured:
            captured.append(mod.qkv_of(inputs[0]).detach())

    hook = task.unet.middle_block[1].register_forward_hook(capture)
    torch.cuda.reset_peak_memory_stats()
    recon.batch_call_scored(subs, flags, seeds)[1].cpu()  # warm-up, and the capture
    hook.remove()
    torch.cuda.synchronize()
    counters = _zero_launches()
    t0 = time.perf_counter()
    _, packed = recon.batch_call_scored(subs, flags, seeds)
    packed = packed.cpu()
    group_s = time.perf_counter() - t0
    eval_launches = _read_launches(counters)
    eval_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        recon.batch_call_scored(subs, flags, seeds)[1].cpu()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = kernel_events(prof)
    busy_ms = sum(ev.self_device_time_total for ev in kernels) / 1e3
    by_kind = {}
    for ev in kernels:
        kind = kernel_kind(ev.key)
        by_kind[kind] = by_kind.get(kind, 0.0) + ev.self_device_time_total / 1e3
    st = flags["statics"]
    rows = [parse_packed(packed[j], FULLRES_SHAPE, recon.latent_len(), st["pack_seg"],
                         st["pack_maps"])["scalars"] for j in range(len(subs))]
    unet_rows = 104 * task.cfg.ensemble_size

    # the kernel on the middle block's own activations
    require(len(captured) == 1, "the middle AttentionBlock hook captured nothing")
    qkv = captured.pop()
    got = A.attention_fwd_mma_long(qkv).float()
    want = attention_plain(qkv).float()
    diff = (got - want).abs()
    tol = TOL_K2["bfloat16"]
    # the tests' allclose (atol = rtol = tol): on the UNet's activations the
    # outputs reach |y| >= 8, where one bf16 ulp is 0.0625
    ratio = (diff / (tol + tol * want.abs())).max().item()
    q, k, v = (qkv[:, :, i].transpose(1, 2).contiguous() for i in range(3))
    d = qkv.shape[-1]
    on_activations = {
        "shape": list(qkv.shape), "max_abs_err": diff.max().item(),
        "allclose_ratio": ratio, "tol_atol_rtol": [tol, tol],
        "max_abs_output": want.abs().max().item(),
        "ms": timed_ms(lambda: A.attention_fwd_mma_long(qkv)),
        "library_ms": cuda_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, scale=d ** -0.5), reps=10),
        "library_call": "F.scaled_dot_product_attention (never called by the port)"}
    del q, k, v, got, want, diff
    k2_ms = by_kind.get("K2 attention", 0.0)
    evaluation = {"volumes": len(subs), "shape": list(FULLRES_SHAPE),
                  "unet_batch": unet_rows, "s_per_group": group_s,
                  "slice_denoises_per_sec": unet_rows * len(subs) / group_s,
                  "scored_volumes_per_sec": len(subs) / group_s,
                  "peak_memory_gb": eval_peak_gb,
                  "launches": eval_launches, "profiled_wall_ms": wall_ms,
                  "profiled_kernel_ms": busy_ms,
                  "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
                  "kernel_ms_by_kind": by_kind, "k2_kernel_ms": k2_ms,
                  "k2_kernel_share": k2_ms / busy_ms,
                  "auprc": [r["auprc"] for r in rows],
                  "best_dice": [r["best_dice"] for r in rows],
                  "aux_loss": [r["aux_loss"] for r in rows]}
    emit({"phase": "fullres_full_size", "nvidia_smi": nvidia_smi(),
          "config": "experiment=cDDPM/DDPM_cond_spark_2D " + " ".join(FULLRES_OVERRIDES)
                    + f" (image_hw {tuple(task.cfg.image_hw)}, bf16, fused attention), "
                    "eval=device_fast scoring",
          "train_step": train, "eval_group": evaluation,
          "k2_on_middle_block_qkv": on_activations})
    require(qkv.shape == (unet_rows, FULLRES_SEQ, 3, 4, 64),
            f"the middle block's qkv is {tuple(qkv.shape)}, wanted S = {FULLRES_SEQ}")
    require(ratio <= 1.0, f"K2 on the middle block's qkv: {on_activations}")
    for name, per, want in (("train step", per_step, 1), ("eval group", eval_launches,
                                                          len(subs))):
        require(per["attention_fwd_mma_long"] == want and per["fused_attention"] == want
                and per["attention_fwd_mma"] == 0 and per["attention_fwd_scalar"] == 0,
                f"full-resolution {name}: K2 launches {per}, wanted {want} of "
                "attention_fwd_mma_long")
        require(per["fractal_noise_2d"] >= 1, f"full-resolution {name}: K1 launches {per}")
    for r in rows:
        require(all(math.isfinite(r[k]) for k in ("auprc", "best_dice", "aux_loss")),
                f"full-resolution eval rows not finite: {r}")
    require(math.isfinite(train["s_per_step"]), "full-resolution step")
    return per_step, eval_launches


def _patched_cfg(**kw):
    """The DDPM_patched experiment's task config, as the port's CLI
    materializes it (unconditional UNet 128, mult (1, 2, 2), 3 res blocks,
    96x96, 48x48 patches, inpainting, ResBlock recompute, bf16)."""
    import dataclasses

    from conditioned_diffusion_models_uad_torch import config

    tree = config.compose(str(ROOT / "configs"), "cDDPM/DDPM_patched", [])
    return dataclasses.replace(config.materialize(tree).model, **kw)


def _patched_task(device, **kw):
    from conditioned_diffusion_models_uad_torch.models.tasks import DDPMTask
    from conditioned_diffusion_models_uad_torch.utils.random_init import randomize_

    return randomize_(DDPMTask(_patched_cfg(**kw), device=device), 0)


def phase_patched_correctness():
    """The pDDPM in float32 (TF32 off), card against CPU, same weights: the
    grid eval reconstruction of 2 volumes of 2 slices under keys [2, 2]
    (4 boxes in one chunk: one UNet call, one K1 launch) at TOL_SLICE_FP32;
    then one train step at batch 4 with its patch boxes, repeated on the CPU
    from the card's state with the card's L1 signs replayed, under
    TRAIN_TOL (the UNet's gradients: pDDPM has no encoder)."""
    import copy

    import torch

    from conditioned_diffusion_models_uad_torch.train.loop import make_optimizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(13)
    slices = torch.rand((4, 96, 96, 1), generator=g)
    keys = torch.randint(0, 2**32, (2, 2), generator=g, dtype=torch.int64)
    outs = {}
    for dev in ("cuda", "cpu"):
        task = _patched_task(dev, dtype="float32")
        counters = _zero_launches()
        reco, aux = task.reconstruct_patched_with_aux(slices, keys)
        if dev == "cuda":
            torch.cuda.synchronize()
            eval_launches = _read_launches(counters)
        outs[dev] = (reco.cpu(), aux["loss_per_slice"].cpu())
    eval_err = {"reco": (outs["cuda"][0] - outs["cpu"][0]).abs().max().item(),
                "loss_per_slice": (outs["cuda"][1] - outs["cpu"][1]).abs().max().item()}

    b = 4
    data, vi, si, g = _train_setup(b, "cpu", 14)
    cpu_task = _patched_task("cpu", dtype="float32")
    card_task = _patched_task("cuda", dtype="float32")
    draws = cpu_task.draw_train(g, b)
    card_opt, cpu_opt = make_optimizer(card_task), make_optimizer(cpu_task)
    state = {k: v.detach().cpu().clone() for k, v in card_task.state_dict().items()}
    opt_state = copy.deepcopy(card_opt.state_dict())
    choices = []
    counters = _zero_launches()
    card = _train_one(card_task, card_opt, data, vi, si, draws, choices, replay=False)
    torch.cuda.synchronize()
    train_launches = _read_launches(counters)
    cpu_task.load_state_dict(state)
    cpu_opt.load_state_dict(opt_state)
    cpu = _train_one(cpu_task, cpu_opt, data, vi, si, draws, choices, replay=True)
    spread = _train_spread(card, cpu, card_task.cfg.lr, nets=(("unet", "unet."),))
    limits = {k: v for k, v in TRAIN_TOL.items() if k != "grad_encoder"}
    emit({"phase": "patched_correctness",
          "config": "experiment=cDDPM/DDPM_patched, dtype float32, TF32 off",
          "eval": {"slices": 4, "volumes": 2, "boxes": 4, "max_abs_err_vs_cpu": eval_err,
                   "tol": TOL_SLICE_FP32, "launches": eval_launches},
          "train": {"batch": b, "boxes": draws.box.tolist(), "loss_cuda": card["loss"],
                    "loss_cpu": cpu["loss"], "choices": cpu["count"],
                    "card_vs_cpu": spread, "limit": limits, "launches": train_launches}})
    reco = outs["cuda"][0]
    require(reco.shape == (4, 96, 96, 1) and bool(torch.isfinite(reco).all()),
            "pDDPM reconstruction not finite")
    for k, v in eval_err.items():
        require(v <= TOL_SLICE_FP32, f"pDDPM card vs CPU {k} err {v}")
    require(eval_launches["fractal_noise_2d"] == 1 and eval_launches["fused_attention"] == 1,
            f"pDDPM eval: one chunk should launch K1 and K2 once: {eval_launches}")
    require(math.isfinite(card["loss"]), "pDDPM train loss not finite")
    for k, lim in limits.items():
        require(spread[k] <= lim, f"pDDPM train card vs CPU: {k} {spread[k]} > {lim}")
    require(train_launches["fractal_noise_2d"] == 1 and train_launches["fused_attention"] >= 1,
            f"pDDPM train step launches {train_launches}")


def phase_patched_full_size():
    """The DDPM_patched config at full width (bf16): one eval group of 2
    volumes at EVAL_SHAPE (a call a volume, 56 slices x 4 boxes: a UNet call
    at batch 224 each) through ``VolumeReconstructor(patched=True).
    batch_call``, against the group stacked into one call (batch 448) in
    turns, then the
    batch-32 train step with ``use_checkpoint`` on and off: s/step over 10
    steps after 3 of warm-up, and peak memory. Returns the launches of the
    eval group and of one train step."""
    import dataclasses

    import torch

    from conditioned_diffusion_models_uad_torch.eval.reconstruct import VolumeReconstructor
    from conditioned_diffusion_models_uad_torch.models.tasks import DDPMTask
    from conditioned_diffusion_models_uad_torch.orchestrate import eval_key, volume_draws
    from conditioned_diffusion_models_uad_torch.train.loop import make_optimizer, train_step
    from conditioned_diffusion_models_uad_torch.utils.random_init import randomize_

    task = _patched_task("cuda")
    recon = VolumeReconstructor(task, patched=True)
    vols = [s["vol"] for s in _eval_subjects(2, 33, True)]
    draws = volume_draws(task, eval_key(3141, 0), [0, 1])
    recon.batch_call(vols, draws)  # warm-up: the batch-224 shapes
    torch.cuda.synchronize()
    counters = _zero_launches()
    t0 = time.perf_counter()
    res = recon.batch_call(vols, draws)
    torch.cuda.synchronize()
    group_s = time.perf_counter() - t0
    eval_launches = _read_launches(counters)
    for reco, aux in res:
        require(reco.shape == EVAL_SHAPE and bool(torch.isfinite(reco).all()),
                "pDDPM full size: reconstruction not finite")
        require(math.isfinite(float(aux["loss"])), "pDDPM full size: loss not finite")
    require(eval_launches["fractal_noise_2d"] == 2 and eval_launches["attention_fwd_mma"] == 2
            and eval_launches["attention_fwd_scalar"] == 0,
            f"pDDPM eval group launches {eval_launches}")
    readings = {"per_volume": [group_s], "group_stack": []}
    with group_stack_layout(recon):
        recon.batch_call(vols, draws)  # warm-up: the batch-448 shapes
    for key in ("group_stack", "group_stack", "per_volume"):
        with group_stack_layout(recon, key == "group_stack"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            recon.batch_call(vols, draws)
            torch.cuda.synchronize()
            readings[key].append(time.perf_counter() - t0)
    del task, recon

    b, train = 32, {}
    for ckpt in (True, False):
        task = randomize_(DDPMTask(_patched_cfg(use_checkpoint=ckpt), device="cuda"), 0)
        opt = make_optimizer(task)
        data, vi, si, g = _train_setup(b, "cuda", 15)
        for _ in range(3):
            loss = train_step(task, opt, data, vi, si, task.draw_train(g, b))
        require(math.isfinite(loss.item()), "pDDPM train loss not finite")
        reps = 10
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counters = _zero_launches()
        t0 = time.perf_counter()
        for _ in range(reps):
            loss = train_step(task, opt, data, vi, si, task.draw_train(g, b))
        torch.cuda.synchronize()
        s_step = (time.perf_counter() - t0) / reps
        per_step = {k: v / reps for k, v in _read_launches(counters).items()}
        require(math.isfinite(loss.item()), "pDDPM train loss not finite")
        train["use_checkpoint" if ckpt else "no_checkpoint"] = {
            "s_per_step": s_step, "train_slices_per_sec": b / s_step,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches_per_step": per_step}
        require(per_step["fractal_noise_2d"] == 1 and per_step["attention_fwd_mma"] >= 1,
                f"pDDPM train step launches {per_step}")
        del task, opt, data
        torch.cuda.empty_cache()
    emit({"phase": "patched_full_size", "nvidia_smi": nvidia_smi(),
          "config": "experiment=cDDPM/DDPM_patched (unet 128, mult (1,2,2), 3 res blocks, "
                    "96x96, 48x48 patches, inpaint, bf16)",
          "eval_group": {"volumes": 2, "shape": list(EVAL_SHAPE), "boxes": 4,
                         "unet_batch": 4 * 56, "s_per_group": group_s,
                         "s_per_volume": group_s / 2,
                         "slice_denoises_per_sec": 4 * 112 / group_s,
                         "s_per_group_group_stack": sum(readings["group_stack"]) / 2,
                         "s_per_group_readings": readings,
                         "launches": eval_launches},
          "train_step": {"batch": b, **train}})
    return eval_launches, train["use_checkpoint"]["launches_per_step"]


# the model variants: (name, DDPMTaskConfig flags) of the two task configs
# the CLI reaches (model.spatial_transformer / model.film_fold)
VARIANTS = (("spatial_transformer", {"spatial_transformer": True}),
            ("film_fold", {"film_fold": True}))
# the UNetConfig-only flags, on the UNetModel itself
UNET_ONLY_FLAGS = {"resblock_updown": False, "use_scale_shift_norm": False}
TOL_SIMPLEX3D = 1e-5


def _unet_calls(task):
    """A forward pre-hook on the task's UNet recording each call's batch;
    returns (list, handle)."""
    calls = []
    handle = task.unet.register_forward_pre_hook(lambda mod, args: calls.append(
        int(args[0].shape[0])))
    return calls, handle


def phase_variants_correctness():
    """The variants in float32 (TF32 off), card against CPU from the same
    seeded weights and draws: a reduced-width UNetModel forward with the
    UNetConfig-only flags and the spatial transformer; one DDPMTask train
    step of each variant at the flagship widths with dropout_unet 0.1 and
    aug_full (shared draws and dropout masks, the card's piecewise choices
    replayed on the CPU), held under TRAIN_TOL; the 3D simplex noise."""
    import copy

    import torch

    from conditioned_diffusion_models_uad_torch.models.unet import UNetConfig, UNetModel
    from conditioned_diffusion_models_uad_torch.ops.simplex3d import (
        SimplexNoise,
        fractal_noise_3d,
        fractal_noise_3d_fixed_t,
    )
    from conditioned_diffusion_models_uad_torch.train.loop import make_optimizer
    from conditioned_diffusion_models_uad_torch.utils.random_init import randomize_

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ucfg = UNetConfig(model_channels=64, channel_mult=(1, 2, 2), num_res_blocks=1,
                      spatial_transformer=True, **UNET_ONLY_FLAGS)
    g = torch.Generator().manual_seed(21)
    x = torch.rand((4, 96, 96, 1), generator=g) * 2 - 1
    t = torch.randint(0, 1000, (4,), generator=g)
    c = torch.randn((4, 128), generator=g)
    unet = randomize_(UNetModel(ucfg), 3).eval()
    with torch.no_grad():
        want = unet(x, t, c)
        unet.to("cuda", memory_format=torch.channels_last)
        got = unet(x.cuda(), t.cuda(), c.cuda()).cpu()
    unet_err = (got - want).abs().max().item()
    del unet
    require(bool(torch.isfinite(got).all()) and got.std().item() > 1e-3,
            "variant UNet output not finite or constant")
    require(unet_err <= TOL_SLICE_FP32, f"variant UNet card vs CPU {unet_err}")

    b = 4
    data, vi, si, g = _train_setup(b, "cpu", 8)
    data = (data[0], data[0] > 0.5)
    steps, secs = {}, {"cuda": 0.0, "cpu": 0.0}
    for name, flags in VARIANTS:
        kw = dict(dtype="float32", dropout_unet=0.1, **flags)
        cpu_task = _flagship_task("cpu", **kw)
        draws = cpu_task.draw_train(g, b, augment="full")
        card_task = _flagship_task("cuda", **kw)
        card_opt, cpu_opt = make_optimizer(card_task), make_optimizer(cpu_task)
        cpu_task.load_state_dict(card_task.state_dict())
        cpu_opt.load_state_dict(copy.deepcopy(card_opt.state_dict()))
        choices = []
        t0 = time.perf_counter()
        card = _train_one(card_task, card_opt, data, vi, si, draws, choices, replay=False)
        t1 = time.perf_counter()
        cpu = _train_one(cpu_task, cpu_opt, data, vi, si, draws, choices, replay=True)
        secs["cuda"] += t1 - t0
        secs["cpu"] += time.perf_counter() - t1
        steps[name] = {"loss_cuda": card["loss"], "loss_cpu": cpu["loss"],
                       "choices": cpu["count"],
                       "card_vs_cpu": _train_spread(card, cpu, card_task.cfg.lr)}
        del card_task, cpu_task, card, cpu
        torch.cuda.empty_cache()

    noise = {}
    shape3 = (32, 96, 96)
    for seed in (0, 12345):
        a = fractal_noise_3d(torch.tensor(seed, device="cuda"), shape3, 6, 0.8, 64.0)
        b3 = fractal_noise_3d(seed, shape3, 6, 0.8, 64.0, device="cpu")
        ft = fractal_noise_3d_fixed_t(seed, 37.0, (96, 96), 4, 0.6, 16.0, device="cuda")
        fc = fractal_noise_3d_fixed_t(seed, 37.0, (96, 96), 4, 0.6, 16.0, device="cpu")
        noise[str(seed)] = {"fractal_3d": (a.cpu() - b3).abs().max().item(),
                            "fixed_t": (ft.cpu() - fc).abs().max().item(),
                            "std": a.std().item()}
    counters = _zero_launches()
    field = SimplexNoise(7, device="cuda").rand_2d_octaves((96, 96), 6, 0.8, 64)
    k1_launches = _read_launches(counters)["fractal_noise_2d"]
    plain = SimplexNoise(7, device="cpu").rand_2d_octaves((96, 96), 6, 0.8, 64)
    noise["rand_2d_octaves"] = (field.cpu() - plain).abs().max().item()
    emit({"phase": "variants_correctness", "tf32": False,
          "unet": {"config": "UNetConfig(model_channels=64, mult (1,2,2), 1 res block, "
                             "spatial_transformer, resblock_updown=False, "
                             "use_scale_shift_norm=False, float32)", "batch": 4,
                   "max_abs_err_vs_cpu": unet_err, "tol": TOL_SLICE_FP32},
          "train_step": {"config": "DDPMTaskConfig(dtype='float32', dropout_unet=0.1) "
                                   "+ variant flag, aug_full", "batch": b, "steps": steps,
                         "limit": TRAIN_TOL, "cuda_s": secs["cuda"], "cpu_s": secs["cpu"]},
          "simplex3d": {"shape": list(shape3), "max_abs_err_vs_cpu": noise,
                        "tol": TOL_SIMPLEX3D, "rand_2d_octaves_k1_launches": k1_launches}})
    for name, st in steps.items():
        require(math.isfinite(st["loss_cuda"]), f"{name}: card train loss not finite")
        for k, lim in TRAIN_TOL.items():
            v = st["card_vs_cpu"][k]
            require(v <= lim, f"{name}: card vs CPU {k} {v} > {lim}")
    for seed, errs in noise.items():
        if seed == "rand_2d_octaves":
            require(errs <= TOL_K1, f"rand_2d_octaves card vs CPU {errs}")
            continue
        require(errs["std"] > 0.05, "3D simplex noise is constant")
        require(errs["fractal_3d"] <= TOL_SIMPLEX3D and errs["fixed_t"] <= TOL_SIMPLEX3D,
                f"3D simplex card vs CPU {errs}")
    require(k1_launches == 1, f"SimplexNoise.rand_2d_octaves launched K1 {k1_launches} times")


def _variant_eval_group(task):
    """One single-shot eval group (2 volumes at EVAL_SHAPE) through
    ``VolumeReconstructor.batch_call``, after a warm-up call: seconds, UNet
    calls and batches, and the launches."""
    import torch

    from conditioned_diffusion_models_uad_torch.eval.reconstruct import VolumeReconstructor
    from conditioned_diffusion_models_uad_torch.orchestrate import eval_key, volume_draws

    recon = VolumeReconstructor(task)
    vols = [s["vol"] for s in _eval_subjects(2, 33, True)]
    draws = volume_draws(task, eval_key(3141, 0), [0, 1])
    recon.batch_call(vols, draws)
    torch.cuda.synchronize()
    calls, hook = _unet_calls(task)
    counters = _zero_launches()
    t0 = time.perf_counter()
    res = recon.batch_call(vols, draws)
    torch.cuda.synchronize()
    group_s = time.perf_counter() - t0
    launches = _read_launches(counters)
    hook.remove()
    for reco, aux in res:
        require(reco.shape == EVAL_SHAPE and bool(torch.isfinite(reco).all())
                and reco.float().std().item() > 1e-3, "variant eval reconstruction")
    denoises = sum(calls)
    return {"volumes": 2, "shape": list(EVAL_SHAPE), "unet_calls": len(calls),
            "unet_batches": calls, "s_per_group": group_s,
            "slice_denoises_per_sec": denoises / group_s, "launches": launches}


def phase_variants_full_size():
    """The two variants at the flagship widths (DDPMTaskConfig(): UNet 128,
    mult (1,2,2), 3 res blocks, bf16, ResNet-50 encoder): (a) the spatial
    transformer with dropout_unet 0.1, (b) film_fold. Each: the batch-32
    train step with aug_full through train/loop.py (s/step, idle share,
    peak memory) and one single-shot eval group (slice-denoises/s). Then
    the UNetConfig-only flags on the UNetModel: a bf16 forward and backward
    at batch 32. Returns the launches of each path."""
    import torch

    from conditioned_diffusion_models_uad_torch.models.unet import UNetConfig, UNetModel
    from conditioned_diffusion_models_uad_torch.utils.random_init import randomize_

    out, launches = {}, {}
    for name, flags in VARIANTS:
        kw = dict(flags, dropout_unet=0.1) if name == "spatial_transformer" else dict(flags)
        t0 = time.perf_counter()
        task = _flagship_task("cuda", **kw)
        t1 = time.perf_counter()
        numbers, per_step = _train_step_numbers(task, 32, 17, f"profile_train_{name}.txt",
                                                n_learn=0, reps=10, augment="full", n_prof=1)
        t2 = time.perf_counter()
        group = _variant_eval_group(task)
        out[name] = {"flags": kw, "train_step": numbers, "eval_group": group,
                     "phase_s": {"setup": t1 - t0, "train": t2 - t1,
                                 "eval": time.perf_counter() - t2}}
        launches[f"{name}_train_step"] = per_step
        launches[f"{name}_eval_group"] = group["launches"]
        del task
        torch.cuda.empty_cache()

    cfg = UNetConfig(dtype="bfloat16", norm_precision="compute", fused_attention=True,
                     **UNET_ONLY_FLAGS)
    unet = randomize_(UNetModel(cfg), 5).to("cuda", memory_format=torch.channels_last)
    g = torch.Generator(device="cuda").manual_seed(9)
    x = torch.rand((32, 96, 96, 1), generator=g, device="cuda") * 2 - 1
    t = torch.randint(0, 1000, (32,), generator=g, device="cuda")
    c = torch.randn((32, 128), generator=g, device="cuda")

    def fwd_bwd():
        unet.zero_grad(set_to_none=True)
        y = unet(x, t, c)
        y.abs().mean().backward()
        return y

    for _ in range(2):
        y = fwd_bwd()
    require(bool(torch.isfinite(y).all()), "UNetConfig-only flags: output not finite")
    reps = 5
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = _zero_launches()
    t0 = time.perf_counter()
    for _ in range(reps):
        fwd_bwd()
    torch.cuda.synchronize()
    s_call = (time.perf_counter() - t0) / reps
    per_call = {k: v / reps for k, v in _read_launches(counters).items()}
    launches["unet_only_fwd_bwd"] = per_call
    out["unet_only_flags"] = {"flags": UNET_ONLY_FLAGS, "batch": 32,
                              "s_per_fwd_bwd": s_call, "slices_per_sec": 32 / s_call,
                              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                              "launches_per_call": per_call}
    del unet, x, y
    torch.cuda.empty_cache()
    emit({"phase": "variants_full_size", "nvidia_smi": nvidia_smi(),
          "config": "DDPMTaskConfig() (bf16, norm_precision=compute, fused_attention) + "
                    "variant flags, Adam lr 1e-4, aug_full", **out})
    st = out["spatial_transformer"]
    ff = out["film_fold"]
    for name, rec in (("spatial_transformer", st), ("film_fold", ff)):
        per_step = launches[f"{name}_train_step"]
        require(per_step["fractal_noise_2d"] >= 1, f"{name}: K1 not launched per step")
        require(rec["eval_group"]["launches"]["fractal_noise_2d"] >= 1,
                f"{name}: K1 not launched in the eval group")
    require(launches["spatial_transformer_train_step"]["fused_attention"] == 0
            and st["eval_group"]["launches"]["fused_attention"] == 0,
            "the spatial transformer launched K2")
    require(launches["film_fold_train_step"]["fused_attention"] == 1
            and launches["film_fold_train_step"]["attention_fwd_mma"] == 1,
            f"film_fold train step: K2 launches {launches['film_fold_train_step']}")
    require(ff["eval_group"]["launches"]["attention_fwd_mma"] == ff["eval_group"]["unet_calls"]
            and ff["eval_group"]["launches"]["attention_fwd_scalar"] == 0,
            f"film_fold eval group: K2 launches {ff['eval_group']}")
    require(per_call["attention_fwd_mma"] == 1, f"UNetConfig-only flags: K2 {per_call}")
    return launches


# prepare_full_size: IXI's T2 acquisitions (256 x 256 x 130 at 0.94 x 0.94 x
# 1.2 mm), BraTS 2021's grid (240 x 240 x 155 at 1 mm, skull-stripped), and
# an atlas on SRI24's grid (240 x 240 x 155 at 1 mm)
PREP_IXI = ((256, 256, 130), (0.94, 0.94, 1.2))
PREP_BRATS = ((240, 240, 155), (1.0, 1.0, 1.0))
PREP_SUBJECTS = {"IXI": 2, "Brats21": 1}  # cut from 4 and 2 to keep the script near 12 min
# card vs CPU on one prepared IXI subject with the card's affine replayed:
# the brain mask bit for bit, the volume relative to its largest value (the
# N4 fit's float32 normal equations over ~9e6 voxels, summed in another
# order)
TOL_PREPARE_REL = 1e-3


def _head(shape, spacing, g, *, skull, bias, rot_deg=0.0, shift_mm=(0.0, 0.0, 0.0),
          lesion=None):
    """A head-like phantom on the card: an ellipsoidal brain (radii 68 x 84 x
    58 mm) with smooth tissue texture, dark ventricles and an off-centre
    bright and dark structure, a skull shell (or, without it, the background
    zeroed as in a skull-stripped scan), optionally a smooth bias field, a
    rotation about the axis z, a shift, and a bright lesion (centre, radius
    in mm) returned as its segmentation. Intensities ~[0, 1000] with a
    little noise."""
    import torch

    dev = "cuda"
    axes = [(torch.arange(n, device=dev, dtype=torch.float32) - (n - 1) / 2) * sp
            for n, sp in zip(shape, spacing)]
    x, y, z = torch.meshgrid(*axes, indexing="ij")
    a = math.radians(rot_deg)
    xr = math.cos(a) * x - math.sin(a) * y - shift_mm[0]
    yr = math.sin(a) * x + math.cos(a) * y - shift_mm[1]
    zr = z - shift_mm[2]
    u, v, w = xr / 68.0, yr / 84.0, zr / 58.0
    r = torch.sqrt(u * u + v * v + w * w)

    def inside(d, width=0.02):
        return torch.sigmoid(d / width)

    tex = 0.0
    for _ in range(5):
        f = 1.0 + 3.0 * torch.rand(3, generator=g, device=dev)
        ph = 2 * math.pi * torch.rand(3, generator=g, device=dev)
        tex = tex + 0.06 * torch.cos(f[0] * math.pi * u + ph[0]) * torch.cos(
            f[1] * math.pi * v + ph[1]) * torch.cos(f[2] * math.pi * w + ph[2])
    vent = inside(0.18 - torch.sqrt((u / 0.6) ** 2 + ((v + 0.1) / 1.2) ** 2 + (w / 0.7) ** 2))
    blobs = (0.25 * torch.exp(-((u - 0.4) ** 2 + (v + 0.3) ** 2 + (w - 0.2) ** 2) / 0.02)
             - 0.2 * torch.exp(-((u + 0.35) ** 2 + (v - 0.35) ** 2 + (w + 0.3) ** 2) / 0.02))
    img = inside(1.0 - r) * (0.6 + tex + blobs - 0.45 * vent)
    seg = None
    if lesion is not None:
        (cx, cy, cz), rad = lesion
        d = torch.sqrt((x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2)
        seg = (d <= rad).float()
        img = img + 0.4 * inside(rad - d, 1.0) * inside(1.0 - r)
    if skull:
        img = img + 0.45 * inside(r - 1.12) * inside(1.22 - r)
    if bias:
        img = img * torch.exp(0.15 * u - 0.1 * v * w + 0.08 * w * w)
    img = 1000 * img + 8 * torch.randn(shape, generator=g, device=dev).abs()
    if not skull:
        img = torch.where(r < 1.0, img, torch.zeros_like(img))
    return img.clamp_min(0).cpu().numpy(), None if seg is None else seg.cpu().numpy()


def phase_prepare_full_size(work: Path):
    """The port's data preparation CLI in a subprocess on the card:
    PREP_SUBJECTS synthetic raw IXI-like subjects (skull, bias field, a
    random rotation and shift each) registered to a synthetic SRI24-grid
    atlas, and BraTS-like subjects with their ``_seg``, all made from a
    seed. s/subject and the
    seconds of each stage (from the CLI's --report; one subject at a time).
    One IXI subject again on the CPU in-process with the card's affine
    replayed: the brain mask equal, the volume within TOL_PREPARE_REL. Then
    a prepared subject of each set loads through the datamodule's device
    path, where run_from_files reads its files."""
    import dataclasses

    import numpy as np
    import torch

    from conditioned_diffusion_models_uad_torch.data.datamodules import (
        DataConfig,
        load_subject,
    )
    from conditioned_diffusion_models_uad_torch.data.nifti import read_nifti, write_nifti
    from conditioned_diffusion_models_uad_torch.data.preprocessing import (
        DATASET_STAGES,
        prepare_subject,
    )

    root = work / "prepare"
    g = torch.Generator(device="cuda").manual_seed(2024)
    t0 = time.perf_counter()
    atlas = root / "atlas" / "sri24_like.nii"
    atlas.parent.mkdir(parents=True)
    atlas_vol, _ = _head(*PREP_BRATS, g, skull=False, bias=False)
    write_nifti(str(atlas), atlas_vol, spacing=PREP_BRATS[1])
    raw = {name: root / "raw" / name for name in PREP_SUBJECTS}
    for name, n in PREP_SUBJECTS.items():
        raw[name].mkdir(parents=True)
        for i in range(n):
            rot = float(torch.empty(1).uniform_(-6, 6, generator=torch.Generator().manual_seed(
                100 * len(name) + i)))
            shift = tuple(float(s) for s in torch.empty(3).uniform_(
                -5, 5, generator=torch.Generator().manual_seed(7 * i + len(name))))
            if name == "IXI":
                vol, _ = _head(*PREP_IXI, g, skull=True, bias=True, rot_deg=rot,
                               shift_mm=shift)
                write_nifti(str(raw[name] / f"IXI{i:03d}-T2.nii"), vol, spacing=PREP_IXI[1])
            else:
                vol, seg = _head(*PREP_BRATS, g, skull=False, bias=True, rot_deg=rot,
                                 shift_mm=shift, lesion=((20.0, -15.0 + 10 * i, 10.0), 12.0))
                stem = raw[name] / f"BraTS2021_{i:05d}"
                write_nifti(f"{stem}.nii", vol, spacing=PREP_BRATS[1])
                write_nifti(f"{stem}_seg.nii", seg, spacing=PREP_BRATS[1])
    make_s = time.perf_counter() - t0

    runs = {}
    for name in PREP_SUBJECTS:
        out = root / "Data" / name
        report = root / f"report_{name}.jsonl"
        cmd = [sys.executable, "-m", f"{PKG}.data.prepare_cli", "--dataset", name,
               "--input", str(raw[name]), "--output", str(out), "--atlas", str(atlas),
               "--threads", "1", "--report", str(report)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=900)
        wall = time.perf_counter() - t0
        (ROOT / "chiprun_out" / f"prepare_cli_{name}.txt").write_text(
            proc.stdout + "\n--- stderr ---\n" + proc.stderr)
        require(proc.returncode == 0, f"prepare_cli {name} exited {proc.returncode}: "
                                      f"{proc.stderr[-2000:]}")
        rows = [json.loads(line) for line in report.read_text().splitlines()]
        stages = sorted({k for r in rows for k in r["seconds"]})
        runs[name] = {"subjects": len(rows), "cli_wall_s": wall,
                      "s_per_subject": sum(r["total_s"] for r in rows) / len(rows),
                      "stage_s_mean": {k: sum(r["seconds"].get(k, 0.0) for r in rows)
                                       / len(rows) for k in stages},
                      "reg_mse_first_last": [[r["reg_mse"][0][0], r["reg_mse"][-1][1]]
                                             for r in rows],
                      "rows": rows}
        runs[name]["files"] = sorted(p.name for p in out.iterdir())
        runs[name]["want_files"] = sorted(
            f"{Path(r['subject']).name.split('.')[0]}_{k}.nii.gz" for r in rows
            for k in (("t1", "mask", "seg") if name == "Brats21" else ("t1", "mask")))

    # one IXI subject on the CPU, the card's affine replayed
    row = runs["IXI"]["rows"][0]
    cfg = dataclasses.replace(DATASET_STAGES["IXI"], register=True)
    cpu_dir = root / "cpu"
    t0 = time.perf_counter()
    cpu_out = prepare_subject(str(raw["IXI"] / row["subject"]), str(cpu_dir), cfg,
                              atlas=read_nifti(str(atlas))[0], device="cpu",
                              affine=np.asarray(row["affine"], np.float32))
    cpu_s = time.perf_counter() - t0
    card_dir = root / "Data" / "IXI"
    card_mask = read_nifti(str(card_dir / Path(cpu_out["mask"]).name))[0]
    card_vol = read_nifti(str(card_dir / Path(cpu_out["img"]).name))[0]
    cpu_mask, cpu_vol = read_nifti(cpu_out["mask"])[0], read_nifti(cpu_out["img"])[0]
    mask_equal = card_mask.shape == cpu_mask.shape and bool(np.array_equal(card_mask, cpu_mask))
    vol_err = (float(np.abs(card_vol - cpu_vol).max() / np.abs(cpu_vol).max())
               if card_vol.shape == cpu_vol.shape else float("inf"))

    # the prepared files through the datamodule's device path
    loads = {}
    for name in PREP_SUBJECTS:
        out = root / "Data" / name
        stem = sorted(out.glob("*_t1.nii.gz"))[0].name[:-len("_t1.nii.gz")]
        r = {"img_path": str(out / f"{stem}_t1.nii.gz"),
             "mask_path": str(out / f"{stem}_mask.nii.gz"),
             "seg_path": str(out / f"{stem}_seg.nii.gz") if name == "Brats21" else None,
             "img_name": f"{stem}_t1", "age": 0, "label": int(name == "Brats21")}
        sub = load_subject(r, DataConfig(preprocess_backend="device"), keep_orig=True,
                           device="cuda")
        vol = sub["vol"]
        loads[name] = {"subject": stem, "vol_shape": list(vol.shape),
                       "brain_voxels": int((sub["mask"] > 0).sum()),
                       "seg_voxels": int((sub["seg"] > 0).sum()) if "seg" in sub else None}
        require(bool(torch.isfinite(vol).all()) and vol.max().item() > 0.5,
                f"{name}: the loaded prepared volume is not finite or empty")
        require(loads[name]["brain_voxels"] > 0.05 * vol.numel(), f"{name}: empty brain mask")
        if name == "Brats21":
            require(loads[name]["seg_voxels"] > 0, "Brats21: the lesion segmentation was lost")
    checks = {name: (rec.pop("files") == rec.pop("want_files"), rec.pop("rows"))
              for name, rec in runs.items()}
    emit({"phase": "prepare_full_size", "nvidia_smi": nvidia_smi(),
          "inputs": {"IXI": {"subjects": PREP_SUBJECTS["IXI"], "shape": PREP_IXI[0],
                             "spacing_mm": PREP_IXI[1], "skull": True, "bias": True},
                     "Brats21": {"subjects": PREP_SUBJECTS["Brats21"],
                                 "shape": PREP_BRATS[0], "spacing_mm": PREP_BRATS[1],
                                 "seg": True},
                     "atlas": {"shape": PREP_BRATS[0], "spacing_mm": PREP_BRATS[1]},
                     "made_s": make_s},
          "cli": runs, "card_vs_cpu": {"subject": row["subject"], "mask_equal": mask_equal,
                                       "vol_max_rel_err": vol_err, "tol": TOL_PREPARE_REL,
                                       "cpu_s": cpu_s, "shape": list(card_vol.shape)},
          "datamodule_load": loads})
    for name, (files_ok, _) in checks.items():
        require(files_ok, f"prepare_cli {name}: unexpected files")
    for name, rec in runs.items():
        for first, last in rec["reg_mse_first_last"]:
            require(last < first, f"{name}: registration raised the MSE ({first} -> {last})")
    require(mask_equal, "prepared brain mask: card and CPU differ")
    require(vol_err <= TOL_PREPARE_REL, f"prepared volume card vs CPU {vol_err}")


FILES_RAW_SHAPE = (196, 198, 104)
DDIM_RELOAD_STEPS = 5
FILES_SETS = ("Brats21", "MSLUB")
# device against host preprocessing of one subject: the transforms'
# tolerance in tests/test_torch_transforms.py (images), exact for labels
TOL_PREPROC = 1e-5
_GEN_DATA = (
    "import sys\n"
    "sys.path.insert(0, sys.argv[1])\n"
    "from conditioned_diffusion_models_uad_torch.data.synthetic import build_synthetic_root\n"
    "build_synthetic_root(sys.argv[2], shape=tuple(map(int, sys.argv[3].split(','))),\n"
    "                     n_train=32, n_val=2, n_test=2, n_eval=4,\n"
    "                     eval_sets=tuple(sys.argv[4].split(',')), seed=0)\n"
)


def start_file_data(work: Path):
    """Write the run-from-files DATA_DIR in a child process (numpy on the
    host; ~2 s a subject), at low priority, while the build and the
    correctness phases run; ``paused`` stops it for each timed phase."""
    return subprocess.Popen(
        ["nice", "-n", "19", sys.executable, "-c", _GEN_DATA, str(ROOT), str(work / "data"),
         ",".join(map(str, FILES_RAW_SHAPE)), ",".join(FILES_SETS)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


@contextlib.contextmanager
def paused(proc):
    """Stop ``proc`` (SIGSTOP) for the duration of a timed phase, so that the
    phase's host-bound numbers are taken without its load; continue it after."""
    running = proc.poll() is None
    if running:
        proc.send_signal(signal.SIGSTOP)
    try:
        yield
    finally:
        if running and proc.poll() is None:
            proc.send_signal(signal.SIGCONT)


def _preds_rows(preds):
    """(set/stage, key) -> value of every row of a preds dict."""
    return {(f"{st}/{name}", k): v for st, sets in preds.items()
            for name, d in sets.items() for k, v in d.items()}


def _compare_preds(a, b):
    """The exact rows (IDs, counts, thresholds) that differ, and the worst
    relative difference of the float rows."""
    import numpy as np

    exact_keys = ("IDs", "TPPerVol", "FPPerVol", "TNPerVol", "FNPerVol",
                  "BestThresholdPerVol", "lesionSizePerVol", "labelPerVol")
    ra, rb = _preds_rows(a), _preds_rows(b)
    differ, worst = [], {"rel": 0.0, "key": None}
    require(ra.keys() == rb.keys(), "the reloaded preds dict has other rows")
    for key, va in ra.items():
        vb = rb[key]
        if key[1] in exact_keys or key[1].startswith("t_"):
            if va != vb:
                differ.append("/".join(key))
            continue
        try:
            xa = np.asarray(va, dtype=np.float64).ravel()
            xb = np.asarray(vb, dtype=np.float64).ravel()
        except (TypeError, ValueError):
            if va != vb:
                differ.append("/".join(key))
            continue
        require(xa.shape == xb.shape, f"row {key} changed length")
        for x, y in zip(xa.tolist(), xb.tolist()):
            rel = _eval_rel(x, y)
            if rel > worst["rel"]:
                worst.update(rel=rel, key="/".join(key))
    return differ, worst


def release_card() -> float:
    """Free this process's cached, unused card memory, so that a child
    process on the same card can allocate it; the GB still allocated."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated() / 1e9


def _cli_subprocess(args, **env):
    """The port's CLI as a program (``python -m``, so it installs the host
    pool unless ``NP_MEMPOOL=0``); its wall seconds."""
    release_card()
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", PKG, *args], cwd=ROOT, capture_output=True,
                         text=True, timeout=900, env={**os.environ, **env})
    require(out.returncode == 0, f"CLI {args[-3:]} failed: {out.stderr[-3000:]}")
    return time.perf_counter() - t0


def phase_run_from_files(work: Path, data_wait_s: float):
    """The paper's two-stage pipeline from NIfTI files through the port's CLI
    (``__main__.main``), full width, device preprocessing, eval=device_fast:
    SparK pretraining (experiment=cDDPM/Spark_2D_pretrain), then the
    flagship experiment with ``pretrained_encoder=<the SparK run>``. Each
    fits 2 epochs with a validation after each (best and last checkpoints,
    CSV logs), then evaluates Brats21 and MSLUB val -> test. Then an
    eval-only rerun of the cDDPM from its 'last' checkpoint, the patched DDPM
    (experiment=cDDPM/DDPM_patched: fit and eval as above, from the same
    files) and an eval-only rerun of the cDDPM with model.reco_mode=ddim and
    DDIM_RELOAD_STEPS steps. The launch counters are set to 0 just before
    each fit and each eval stage and read just after. Then the artifacts,
    the cDDPM encoder's backbone at its fit's start against the SparK 'best'
    checkpoint (bit for bit), the eval-only rerun against the fit's eval
    (same counts, IDs and thresholds; float rows within TOL_EVAL_REL), and
    two subjects preprocessed on the card and on the host. The reads of the
    in-process runs are counted (``native.binding.reads``: every one native,
    none by the Python parser) with the numpy host pool installed
    (``pool_stats()``, which must count hits: the loader threads allocate
    from it); then the eval-only reload runs again as a program, once with
    the pool (hits again) and once with ``NP_MEMPOOL=0``."""
    import contextlib
    import csv
    import io
    import pickle

    import numpy as np
    import torch

    from conditioned_diffusion_models_uad_torch import orchestrate
    from conditioned_diffusion_models_uad_torch.__main__ import main as cli
    from conditioned_diffusion_models_uad_torch.data.datamodules import (
        Brats21,
        DataConfig,
        load_subject,
    )
    from conditioned_diffusion_models_uad_torch.native import binding
    from conditioned_diffusion_models_uad_torch.native.mempool import (
        enable_host_alloc_cache,
        pool_stats,
    )
    from conditioned_diffusion_models_uad_torch.train import loop
    from conditioned_diffusion_models_uad_torch.train.checkpoint import load_state

    data_dir, logs = work / "data", work / "logs"
    pool_on = enable_host_alloc_cache()  # as the CLI installs it as a program
    for k in binding.reads:
        binding.reads[k] = 0

    launches = {"fit": {}, "stages": {}, "val": {}}
    fit_start = {}
    orig_fit, orig_stage = loop.Trainer.fit, orchestrate.run_stage
    orig_validate = loop.Trainer.validate

    def fit(self, *a, **kw):
        fit_start.update({k: v.detach().cpu().clone() for k, v in self.task.state_dict().items()
                          if k.startswith("encoder.")})
        counters = _zero_launches()
        try:
            return orig_fit(self, *a, **kw)
        finally:
            torch.cuda.synchronize()
            launches["fit"] = _read_launches(counters)

    def validate(self, *a, **kw):
        # a fit's validations, summed apart from its count as a whole
        before = _read_launches(_launch_counters())
        try:
            return orig_validate(self, *a, **kw)
        finally:
            for k, v in _read_launches(_launch_counters()).items():
                launches["val"][k] = launches["val"].get(k, 0) + v - before[k]

    def run_stage(session, *a, **kw):
        counters = _zero_launches()
        try:
            return orig_stage(session, *a, **kw)
        finally:
            torch.cuda.synchronize()
            launches["stages"][f"{session.dataset}/{session.stage}"] = _read_launches(counters)

    common = ["eval=device_fast", "logger=csv", "datamodule.preprocess_backend=device",
              f"datamodule.data_dir={data_dir}", f"log_dir={logs}"]
    cddpm = "experiment=cDDPM/DDPM_cond_spark_2D"
    fit2 = ["trainer.max_epochs=2", "trainer.check_val_every_n_epoch=1"]
    runs = {"spark": ["experiment=cDDPM/Spark_2D_pretrain", "name=spark", *fit2],
            "fit_eval": [cddpm, "name=from_files", *fit2,
                         f"pretrained_encoder={logs / 'spark'}"],
            "reload": [cddpm, "name=reload", "only_eval=true",
                       f"load_checkpoint={logs / 'from_files'}", "checkpoint=last"],
            "pddpm": ["experiment=cDDPM/DDPM_patched", "name=pddpm", *fit2],
            "ddim_reload": [cddpm, "name=ddim_reload", "only_eval=true",
                            f"load_checkpoint={logs / 'from_files'}", "checkpoint=last",
                            "model.reco_mode=ddim",
                            f"model.sampling_steps={DDIM_RELOAD_STEPS}"]}
    wall, printed = {}, io.StringIO()
    loop.Trainer.fit, orchestrate.run_stage, loop.Trainer.validate = fit, run_stage, validate
    try:
        for name, args in runs.items():
            launches["stages"] = {}
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(printed):  # the config tree
                cli(common + args)
            torch.cuda.synchronize()
            wall[name] = time.perf_counter() - t0
            launches[name] = launches["stages"]
            launches[f"{name}_fit"], launches["fit"] = launches["fit"], {}
            launches[f"{name}_val"], launches["val"] = launches["val"], {}
    finally:
        loop.Trainer.fit, orchestrate.run_stage = orig_fit, orig_stage
        loop.Trainer.validate = orig_validate
    reads = dict(binding.reads)
    require(reads["native"] > 0 and reads["python"] == 0,
            f"run from files: NIfTI reads {reads} (every read must be native)")
    pool = pool_stats()
    require(pool_on and pool["hits"] > 0,
            f"run from files: the host pool served no allocation: {pool}")
    eval_launches, reload_launches = launches["fit_eval"], launches["reload"]
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "run_from_files_cli.txt").write_text(printed.getvalue())

    # the artifacts of both stages
    def artifacts(run):
        for rel in ("final_config.yaml", "config_tree.txt", "csv_fold0/metrics.csv",
                    "checkpoints/fold-0/meta.json", "checkpoints/fold-0/best/state.pt",
                    "checkpoints/fold-0/last/state.pt", "0_preds_dict.pkl", "0_timings.json"):
            require((run / rel).is_file(), f"run from files: {run.name}/{rel} missing")
        with open(run / "csv_fold0/metrics.csv", newline="") as f:
            rows = list(csv.DictReader(f))
        train_loss = [float(r["value"]) for r in rows if r["key"] == "train/loss"]
        val_loss = [float(r["value"]) for r in rows if r["key"] == "val/loss_comb"]
        require(len(train_loss) == 2 and len(val_loss) == 2
                and all(math.isfinite(v) for v in train_loss + val_loss),
                f"run from files {run.name}: train/loss {train_loss}, val/loss_comb {val_loss}")
        meta = json.loads((run / "checkpoints/fold-0/meta.json").read_text())
        require(meta["last"]["step"] == 2 and meta["best"]["step"] in (1, 2),
                f"{run.name} meta.json {meta}")
        ckpt_mb = {k: (run / f"checkpoints/fold-0/{k}/state.pt").stat().st_size / 2**20
                   for k in ("best", "last")}
        preds = pickle.loads((run / "0_preds_dict.pkl").read_bytes())
        summary = {}
        for stage in ("val", "test"):
            for name in FILES_SETS:
                d = preds[stage][name]
                summary[f"{name}/{stage}"] = {k: d[k] for k in ("DicePerVolMean",
                                                                "AUPRCPerVolMean")}
                require(len(d["IDs"]) == 4 and all(math.isfinite(v)
                                                    for v in summary[f"{name}/{stage}"].values()),
                        f"run from files {run.name} {name}/{stage}: {summary[f'{name}/{stage}']}")
        timings = json.loads((run / "0_timings.json").read_text())
        return train_loss, val_loss, meta, ckpt_mb, preds, summary, timings

    spark_run = logs / "spark"
    (sp_train_loss, sp_val_loss, sp_meta, sp_ckpt_mb, sp_preds, sp_summary,
     sp_timings) = artifacts(spark_run)
    for stage in ("val", "test"):
        for name in FILES_SETS:
            reco = sp_preds[stage][name]["AnomalyScoreRecoPerVol"]
            require(len(reco) == 4 and all(math.isfinite(v) and v > 0 for v in reco),
                    f"SparK eval {name}/{stage} scores {reco}")
    run = logs / "from_files"
    train_loss, val_loss, meta, ckpt_mb, preds, summary, timings = artifacts(run)
    # the cDDPM's fit started from the SparK 'best' checkpoint's backbone
    spark_best = load_state(str(spark_run / "checkpoints/fold-0/best"))["model"]
    backbone = [k for k in fit_start if not k.startswith("encoder.fc.")]
    require(len(backbone) == sum(k.startswith("model.encoder.") for k in spark_best) > 0,
            "the cDDPM encoder and the SparK backbone have other keys")
    differ = [k for k in backbone if not torch.equal(fit_start[k], spark_best["model." + k])]
    require(not differ, f"the cDDPM fit did not start from the SparK encoder: {differ[:5]}")
    reload_preds = pickle.loads((logs / "reload" / "0_preds_dict.pkl").read_bytes())
    differ, worst = _compare_preds(preds, reload_preds)
    require(not differ, f"eval-only reload differs in {differ}")
    require(worst["rel"] <= TOL_EVAL_REL, f"eval-only reload float rows: {worst}")

    # the eval-only reload as a program, with the host pool and without it
    pool_runs = {}
    for name, env in (("pool_on", {}), ("pool_off", {"NP_MEMPOOL": "0"})):
        wall_s = _cli_subprocess(common + [a.replace("name=reload", f"name=reload_{name}")
                                           for a in runs["reload"]], **env)
        t = json.loads((logs / f"reload_{name}" / "0_timings.json").read_text())
        p = pickle.loads((logs / f"reload_{name}" / "0_preds_dict.pkl").read_bytes())
        d, w = _compare_preds(preds, p)
        require(not d and w["rel"] <= TOL_EVAL_REL, f"reload {name} differs: {d} {w}")
        pool_runs[name] = {"cli_wall_s": wall_s, "eval_s": t["eval_s"],
                           "eval_stage_total_s": {k: v["total"] for k, v in t["eval"].items()},
                           "host_pool": t["host_pool"], "nifti_reads": t["nifti_reads"]}
    require(pool_runs["pool_on"]["host_pool"] is not None
            and pool_runs["pool_on"]["host_pool"]["hits"] > 0
            and pool_runs["pool_off"]["host_pool"] is None,
            f"the host pool gate did not hold, or the pool served nothing: {pool_runs}")

    # the pDDPM run and the DDIM rerun from the same files
    pd_train_loss, pd_val_loss, pd_meta, _, pd_preds, pd_summary, pd_timings = artifacts(
        logs / "pddpm")
    ddim_preds = pickle.loads((logs / "ddim_reload" / "0_preds_dict.pkl").read_bytes())
    ddim_summary = {}
    for stage in ("val", "test"):
        for name in FILES_SETS:
            d = ddim_preds[stage][name]
            ddim_summary[f"{name}/{stage}"] = {k: d[k] for k in ("DicePerVolMean",
                                                                 "AUPRCPerVolMean")}
            require(d["IDs"] == preds[stage][name]["IDs"]
                    and all(math.isfinite(v) for v in ddim_summary[f"{name}/{stage}"].values())
                    and all(math.isnan(v) for v in d["AnomalyScoreRegPerVol"]),
                    f"DDIM rerun {name}/{stage}: {ddim_summary[f'{name}/{stage}']}")

    # the kernels on each path: none on SparK's
    for where, got in ([("SparK fit", launches["spark_fit"])]
                       + [(f"SparK eval {k}", v) for k, v in launches["spark"].items()]):
        require(all(v == 0 for v in got.values()), f"run from files, {where}: {got}")
    fit_l = launches["fit_eval_fit"]
    for where, got in ([("fit", fit_l), ("pDDPM fit", launches["pddpm_fit"])]
                       + [(f"eval {k}", v) for k, v in eval_launches.items()]
                       + [(f"pDDPM eval {k}", v) for k, v in launches["pddpm"].items()]
                       + [(f"DDIM eval {k}", v) for k, v in launches["ddim_reload"].items()]):
        require(got["fractal_noise_2d"] >= 1 and got["attention_fwd_mma"] >= 1,
                f"run from files, {where}: K1/K2 not launched: {got}")
        require(got["attention_fwd_scalar"] == 0,
                f"run from files, {where}: bf16 attention took the scalar K2 kernel")
    eval_total = {k: sum(v[k] for v in eval_launches.values()) for k in fit_l}

    # two subjects preprocessed on the card and on the host
    cfg_dev = DataConfig(data_dir=str(data_dir), preprocess_backend="device")
    cfg_host = DataConfig(data_dir=str(data_dir))
    rows2 = Brats21(cfg_dev, 0, device="cuda").csv["val"][:2]
    load_subject(rows2[0], cfg_dev, keep_orig=True, device="cuda")  # warm-up
    secs = {"device": 0.0, "host": 0.0}
    preproc_err = {}
    for row in rows2:
        t0 = time.perf_counter()
        dev = load_subject(row, cfg_dev, keep_orig=True, device="cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        host = load_subject(row, cfg_host, keep_orig=True)
        secs["device"] += t1 - t0
        secs["host"] += time.perf_counter() - t1
        for k in ("vol", "vol_orig", "mask_orig", "seg_orig"):
            got = dev[k].cpu().numpy()
            require(got.shape == host[k].shape, f"preprocess {k} shape {got.shape}")
            err = float(np.abs(got - host[k]).max())
            preproc_err[k] = max(preproc_err.get(k, 0.0), err)
    require(preproc_err["vol"] <= TOL_PREPROC and preproc_err["vol_orig"] <= TOL_PREPROC,
            f"device against host preprocessing: {preproc_err}")
    require(preproc_err["mask_orig"] == 0 and preproc_err["seg_orig"] == 0,
            f"device against host labels: {preproc_err}")

    fit_t = timings["fit"]
    epochs = len(fit_t["epoch_s"])
    stages = timings["eval"]
    n_eval = sum(v["volumes"] for v in stages.values())
    eval_s = sum(v["total"] + v["test_end"] for v in stages.values())
    sp_fit, sp_stages = sp_timings["fit"], sp_timings["eval"]
    sp_n_eval = sum(v["volumes"] for v in sp_stages.values())
    sp_eval_s = sum(v["total"] + v["test_end"] for v in sp_stages.values())
    spark = {"config": "experiment=cDDPM/Spark_2D_pretrain (resnet50, dec_dim 128, "
                       "mask_ratio 0.65, 96x96, bf16, AdamW), trainer.max_epochs=2",
             "cli_wall_s": wall["spark"], "ingest_s": sp_timings["ingest_s"],
             "s_per_step": sum(sp_fit["epoch_s"]) / sp_fit["steps"],
             "epoch_s": sp_fit["epoch_s"], "val_s": sp_fit["val_s"], "ckpt_s": sp_fit["ckpt_s"],
             "ckpt_mb": sp_ckpt_mb, "train_loss": sp_train_loss, "val_loss": sp_val_loss,
             "meta": sp_meta, "eval_volumes": sp_n_eval, "eval_s": sp_eval_s,
             "eval_volumes_per_sec": sp_n_eval / sp_eval_s,
             "eval_loader_wait_s": sum(v["load"] for v in sp_stages.values()),
             "eval_stages": sp_stages, "metrics": sp_summary,
             "launches_fit": launches["spark_fit"], "launches_eval": launches["spark"]}
    emit({"phase": "run_from_files", "nvidia_smi": nvidia_smi(),
          "config": "experiment=cDDPM/DDPM_cond_spark_2D (full width) pretrained_encoder="
                    "<the SparK stage's run>, trainer.max_epochs=2, "
                    "check_val_every_n_epoch=1, eval=device_fast, logger=csv, "
                    "preprocess_backend=device",
          "spark_stage": spark, "encoder_from_spark": len(backbone),
          "raw_shape": list(FILES_RAW_SHAPE), "train_subjects": 32, "batch": 32,
          "data_wait_s": data_wait_s, "cli_wall_s": wall,
          "ingest_s": timings["ingest_s"], "ingest_subjects": 34,
          "ingest_subjects_per_sec_device": 34 / timings["ingest_s"],
          "s_per_epoch_steps": sum(fit_t["epoch_s"]) / epochs,
          "s_per_step": sum(fit_t["epoch_s"]) / fit_t["steps"],
          "epoch_s": fit_t["epoch_s"], "val_s": fit_t["val_s"], "ckpt_s": fit_t["ckpt_s"],
          "ckpt_join_s": fit_t.get("ckpt_join_s"),
          "ckpt_write_s_copy_and_files": fit_t.get("ckpt_write_s"), "nifti_reads": reads,
          "host_pool_installed": pool_on, "host_pool": pool,
          "reload_as_program": pool_runs,
          "s_per_epoch_with_val_ckpt": (sum(fit_t["epoch_s"]) + sum(fit_t["val_s"])
                                        + sum(fit_t["ckpt_s"])) / epochs,
          "ckpt_mb": ckpt_mb, "train_loss": train_loss, "val_loss": val_loss, "meta": meta,
          "eval_volumes": n_eval, "eval_s": eval_s,
          "eval_volumes_per_sec": n_eval / eval_s,
          "eval_loader_wait_s": sum(v["load"] for v in stages.values()),
          "eval_stages": stages, "metrics": summary,
          "reload_worst_float_rel": worst,
          "preprocess_subjects_per_sec": {k: len(rows2) / v for k, v in secs.items()},
          "preprocess_max_abs_err": preproc_err, "tol_preprocess": TOL_PREPROC,
          "launches_fit": fit_l, "launches_eval": eval_launches,
          "launches_reload_eval": reload_launches,
          "pddpm_stage": {"config": "experiment=cDDPM/DDPM_patched (full width, bf16, "
                                    "use_checkpoint), trainer.max_epochs=2",
                          "cli_wall_s": wall["pddpm"], "ingest_s": pd_timings["ingest_s"],
                          "s_per_step": sum(pd_timings["fit"]["epoch_s"])
                          / pd_timings["fit"]["steps"],
                          "train_loss": pd_train_loss, "val_loss": pd_val_loss,
                          "meta": pd_meta, "eval_s": sum(
                              v["total"] + v["test_end"] for v in pd_timings["eval"].values()),
                          "eval_stages": pd_timings["eval"], "metrics": pd_summary,
                          "launches_fit": launches["pddpm_fit"],
                          "launches_eval": launches["pddpm"]},
          "ddim_reload_stage": {"config": "the cDDPM's 'last' checkpoint, only_eval, "
                                          f"model.reco_mode=ddim, sampling_steps="
                                          f"{DDIM_RELOAD_STEPS}",
                                "cli_wall_s": wall["ddim_reload"], "metrics": ddim_summary,
                                "launches_eval": launches["ddim_reload"]}})
    pd_epochs = len(pd_timings["fit"]["epoch_s"])

    def total(stages):
        return {k: sum(v[k] for v in stages.values()) for k in fit_l}

    # a UNet fit's epoch in halves for ``norm_route``: its validations (no
    # grad: every fold call on K3) and its train steps (every call eager)
    halves = {}
    for name, path, n_epochs in (("fit_eval", "fit_epoch", epochs),
                                 ("pddpm", "pddpm_fit_epoch", pd_epochs)):
        fit_n, val_n = launches[f"{name}_fit"], launches[f"{name}_val"]
        require(val_n["norm_fold_k3"] > 0, f"{path}: no validation norm call on K3: {val_n}")
        halves[f"{path}.validation"] = {k: v / n_epochs for k, v in val_n.items()}
        halves[f"{path}.train_steps"] = {k: (v - val_n[k]) / n_epochs for k, v in fit_n.items()}

    return {"fit_epoch": {k: v / epochs for k, v in fit_l.items()},
            "pddpm_fit_epoch": {k: v / pd_epochs for k, v in launches["pddpm_fit"].items()},
            "pddpm_eval_from_files": total(launches["pddpm"]),
            "ddim_eval_from_files": total(launches["ddim_reload"]),
            "eval_from_files": eval_total,
            "added_cli_s": wall["pddpm"] + wall["ddim_reload"],
            "spark_fit_epoch": {k: v / epochs for k, v in launches["spark_fit"].items()},
            "spark_eval_from_files": {k: sum(v[k] for v in launches["spark"].values())
                                      for k in fit_l},
            "fit_halves": halves}


# --------------------------------------------------------------------------- #
# the native NIfTI reader, and data parallelism: ranks over gloo on the card
# --------------------------------------------------------------------------- #
CKPT_EPOCH_STEPS = 12
CKPT_EPOCHS = 4


class _RandomSlices:
    """A training source for ``Trainer.fit``: volumes on the card and
    ``steps`` batches of random (volume, slice) indices an epoch."""

    def __init__(self, vols, batch: int, steps: int):
        self.vols, self.masks = vols, None
        self.batch, self.steps = batch, steps

    def epoch_indices(self, rng):
        import numpy as np

        n, depth = self.vols.shape[0], self.vols.shape[-1]
        for _ in range(self.steps):
            yield (rng.integers(0, n, self.batch).astype(np.int32),
                   rng.integers(0, depth, self.batch).astype(np.int32))


def phase_ckpt_overlap(work: Path):
    """The fit loop's background checkpoint writer with epochs that outlast
    a write: the flagship bf16 task from its seeded weights, batch
    DDP_FULL_BATCH, CKPT_EPOCH_STEPS steps an epoch over random volumes on
    the card. First a 1-epoch fit without validation, which writes 'last'
    on the fit's thread at its end (the synchronous write, for comparison);
    then CKPT_EPOCHS epochs with a validation (one batch) and a checkpoint
    cycle (best and last) after each. Reads each cycle's stall (the
    snapshot and the wait for the previous write), the writer's host copy
    and file seconds, and each epoch's seconds: every epoch after the first
    starts with a write in flight."""
    import torch

    from conditioned_diffusion_models_uad_torch.train.checkpoint import FoldCheckpointer
    from conditioned_diffusion_models_uad_torch.train.loop import Trainer, TrainerConfig

    task = _flagship_task("cuda")
    g = torch.Generator(device="cuda").manual_seed(13)
    src = _RandomSlices(torch.rand((8, 96, 96, 40), generator=g, device="cuda"),
                        DDP_FULL_BATCH, CKPT_EPOCH_STEPS)

    def trainer(name, epochs):
        return Trainer(task, TrainerConfig(max_epochs=epochs, check_val_every_n_epoch=1,
                                           ckpt_dir=str(work / name), limit_val_batches=1))

    sync = trainer("ckpt_sync", 1)
    sync.fit(src)
    t = trainer("ckpt_overlap", CKPT_EPOCHS)
    t.fit(src, src)
    tm = t.timings
    meta = FoldCheckpointer(str(work / "ckpt_overlap")).meta
    mb = {k: (work / "ckpt_overlap" / "fold-0" / k / "state.pt").stat().st_size / 2**20
          for k in ("best", "last")}
    out = {"phase": "ckpt_overlap", "nvidia_smi": nvidia_smi(),
           "config": "DDPMTaskConfig() (bf16), Adam, aug_intensity, random volumes "
                     "[8, 96, 96, 40] on the card", "batch": DDP_FULL_BATCH,
           "steps_per_epoch": CKPT_EPOCH_STEPS, "epochs": CKPT_EPOCHS,
           "sync_write_last_s": sync.timings["ckpt_s"][0],
           "sync_fit_epoch_s": sync.timings["epoch_s"][0],
           "epoch_s": tm["epoch_s"], "val_s": tm["val_s"], "ckpt_s": tm["ckpt_s"],
           "ckpt_write_s_copy_and_files": tm["ckpt_write_s"],
           "ckpt_join_s": tm["ckpt_join_s"], "ckpt_mb": mb, "meta": meta}
    emit(out)
    require(len(tm["ckpt_s"]) == CKPT_EPOCHS and len(tm["ckpt_write_s"]) == CKPT_EPOCHS
            and meta["last"]["step"] == CKPT_EPOCHS,
            f"checkpoint overlap: {CKPT_EPOCHS} cycles expected: {out}")
    del task, sync, t, src
    release_card()
    return out


PREFETCH_THREADS = 4
NATIVE_IO_TIMED_FILES = 40


def wait_file_data(gen):
    """Wait for the child writing the run-from-files DATA_DIR; its seconds."""
    t0 = time.perf_counter()
    out, _ = gen.communicate(timeout=600)
    require(gen.returncode == 0, f"writing the NIfTI data failed: {(out or '')[-2000:]}")
    return time.perf_counter() - t0


def phase_native_io(work: Path):
    """Every synthetic ``.nii.gz`` of the run from files read by the native
    reader (``native/binding.py``) and by the Python parser: bit-equal arrays
    and spacings; then seconds a volume for each over the first
    NATIVE_IO_TIMED_FILES (in the page cache by then), and each over all the
    files through ``PrefetchLoader`` on PREFETCH_THREADS threads, in the
    order native, Python, Python, native."""
    import numpy as np

    from conditioned_diffusion_models_uad_torch.data import nifti
    from conditioned_diffusion_models_uad_torch.native import binding
    from conditioned_diffusion_models_uad_torch.utils.prefetch import PrefetchLoader

    t0 = time.perf_counter()
    require(binding.native_available(), "the native NIfTI reader did not build")
    build_s = time.perf_counter() - t0
    files = sorted(str(p) for p in (work / "data").rglob("*.nii.gz"))
    require(len(files) > 0, "no NIfTI files to read")
    voxels = 0
    for f in files:  # every file in the page cache before the timed passes
        a, sa = binding.read_nifti_native(f)
        b, hb = nifti.read_nifti_python(f)
        require(a.shape == b.shape and np.array_equal(a, b) and sa == hb.spacing,
                f"native and Python reads of {f} differ")
        voxels += a.size
    readers = {"native": lambda f: binding.read_nifti_native(f)[0],
               "python": lambda f: nifti.read_nifti_python(f)[0]}
    timed = files[:NATIVE_IO_TIMED_FILES]
    secs = {}
    for k, read in readers.items():  # one pass each over the cached files
        t0 = time.perf_counter()
        for f in timed:
            read(f)
        secs[k] = time.perf_counter() - t0
    prefetch = {k: [] for k in readers}
    for k in ("native", "python", "python", "native"):
        t0 = time.perf_counter()
        n = sum(1 for _ in PrefetchLoader(files, readers[k], num_threads=PREFETCH_THREADS))
        prefetch[k].append(n / (time.perf_counter() - t0))
    out = {"phase": "native_io", "nvidia_smi": nvidia_smi(), "files": len(files),
           "voxels_per_file": voxels / len(files),
           "libdeflate": os.path.exists(binding.LIBDEFLATE_HEADER), "build_s": build_s,
           "s_per_volume": {k: v / len(timed) for k, v in secs.items()},
           "timed_files": len(timed),
           "native_speedup": secs["python"] / secs["native"],
           "prefetch_threads": PREFETCH_THREADS,
           "prefetch_volumes_per_sec": prefetch,
           "prefetch_native_speedup": min(prefetch["native"]) / max(prefetch["python"]),
           "bit_equal": True}
    emit(out)
    return out


DDP_BATCH = 8
DDP_STEPS = 3
DDP_FULL_BATCH = 32
DDP_FULL_STEPS = 10
DDP_REDUCE_CALLS = 5
ONE_CARD_TWICE = ["cuda:0", "cuda:0"]


def _no_tf32():
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _state_digest(task) -> str:
    """sha256 of every parameter and buffer's bytes."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for t in task.state_dict().values():
        h.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def _ddp_correctness_rank(rank, work, data, vi, si, draws):
    """Rank ``rank`` of the float32 DDP steps: the cDDPM's DDP_STEPS steps
    and SparK's one, each recording its choices; rank 0 also writes the
    state before each cDDPM step after the first. Everything goes to files
    under ``work`` (the CPU copies are too big for the return value)."""
    import torch

    from conditioned_diffusion_models_uad_torch.train.checkpoint import to_cpu
    from conditioned_diffusion_models_uad_torch.train.loop import make_optimizer

    _no_tf32()
    work = Path(work)
    out = {}
    for kind, task_fn in (("cddpm", _flagship_task), ("spark", _spark_task)):
        task = task_fn("cuda", dtype="float32")
        opt = make_optimizer(task)
        counters = _zero_launches()
        for k, dr in enumerate(draws[kind]):
            if rank == 0 and k:
                torch.save({"model": to_cpu(task.state_dict()), "opt": to_cpu(opt.state_dict())},
                           work / f"{kind}_pre{k}.pt")
            choices = []
            res = _train_one(task, opt, data, vi, si, dr, choices, replay=False,
                             dtype=torch.float32)
            torch.save({"choices": choices, **(res if rank == 0 else {})},
                       work / f"{kind}_r{rank}_s{k}.pt")
        torch.cuda.synchronize()
        out[kind] = {"digest": _state_digest(task), "launches": _read_launches(counters)}
        del task, opt
        torch.cuda.empty_cache()
    return out


def _nccl_one_rank(rank, data, vi, si, draws):
    """The float32 cDDPM steps in a spawned 1-rank NCCL group."""
    from conditioned_diffusion_models_uad_torch.parallel.mesh import world

    return {"world": world(), **_plain_steps(data, vi, si, draws)}


def _plain_steps(data, vi, si, draws):
    """DDP_STEPS float32 cDDPM steps (deterministic cuDNN) from the seeded
    weights: the losses and the final state's digest."""
    import torch

    from conditioned_diffusion_models_uad_torch.train.loop import make_optimizer, train_step

    _no_tf32()
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        task = _flagship_task("cuda", dtype="float32")
        opt = make_optimizer(task)
        dev_data = tuple(None if x is None else x.cuda() for x in data)
        losses = [train_step(task, opt, dev_data, vi.cuda(), si.cuda(), dr).item()
                  for dr in draws]
        return {"losses": losses, "digest": _state_digest(task)}
    finally:
        torch.backends.cudnn.deterministic = det


def phase_ddp_correctness(work: Path):
    """Data parallelism held to one process on the card, float32, TF32 off:
    2 gloo ranks on cuda:0 take DDP_STEPS flagship cDDPM steps and one SparK
    step at global batch DDP_BATCH (full width, BatchNorm synced, masked on
    SparK); the ranks' parameters and running statistics end bit-equal; one
    process at batch DDP_BATCH repeats each step from rank 0's state before
    it with the ranks' choices (concatenated) replayed, within TRAIN_TOL
    (SPARK_TOL). Then a spawned 1-rank NCCL group's steps are bit-equal to
    this process's plain steps."""
    import shutil as _shutil

    import torch

    from conditioned_diffusion_models_uad_torch.parallel.mesh import spawn
    from conditioned_diffusion_models_uad_torch.train.loop import make_optimizer

    _no_tf32()
    files = work / "ddp"
    files.mkdir(parents=True, exist_ok=True)
    data, vi, si, g = _train_setup(DDP_BATCH, "cpu", 11)
    tasks = {"cddpm": _flagship_task("cuda", dtype="float32"),
             "spark": _spark_task("cuda", dtype="float32")}
    draws = {"cddpm": [tasks["cddpm"].draw_train(g, DDP_BATCH) for _ in range(DDP_STEPS)],
             "spark": [tasks["spark"].draw_train(g, DDP_BATCH)]}
    parent_gb = release_card()
    t0 = time.perf_counter()
    ranks = spawn(_ddp_correctness_rank, 2, "gloo", ONE_CARD_TWICE, str(files), data, vi, si,
                  draws)
    ranks_s = time.perf_counter() - t0
    out = {"phase": "ddp_correctness", "nvidia_smi": nvidia_smi(), "backend": "gloo", "ranks": 2, "devices": ONE_CARD_TWICE,
           "config": "DDPMTaskConfig(dtype='float32') and SparkTaskConfig(dtype='float32'), "
                     "TF32 off", "global_batch": DDP_BATCH, "ranks_s": ranks_s,
           "parent_allocated_gb": parent_gb}
    for kind, task in tasks.items():
        require(ranks[0][kind]["digest"] == ranks[1][kind]["digest"],
                f"{kind}: the two ranks' parameters or statistics differ")
        opt = make_optimizer(task)
        steps = []
        for k, dr in enumerate(draws[kind]):
            if k:
                pre = torch.load(files / f"{kind}_pre{k}.pt", weights_only=False)
                task.load_state_dict(pre["model"])
                opt.load_state_dict(pre["opt"])
            r0 = torch.load(files / f"{kind}_r0_s{k}.pt", weights_only=False)
            r1 = torch.load(files / f"{kind}_r1_s{k}.pt", weights_only=False)
            choices = [torch.cat([a, b]) for a, b in zip(r0.pop("choices"), r1["choices"])]
            single = _train_one(task, opt, data, vi, si, dr, choices, replay=True,
                                dtype=torch.float32)
            nets = ((("encoder", "encoder."), ("unet", "unet.")) if kind == "cddpm" else
                    (("encoder", "model.encoder."), ("decoder", "")))
            steps.append({"loss_ddp": r0["loss"], "loss_single": single["loss"],
                          "choices": single["count"],
                          "ddp_vs_single": _train_spread(r0, single, task.cfg.lr, nets)})
            del r0, r1, choices, single
        limit = TRAIN_TOL if kind == "cddpm" else {**SPARK_TOL, "param_mean": task.cfg.lr * 1e-3}
        out[kind] = {"steps": steps, "limit": limit, "launches_two_ranks": [
            r[kind]["launches"] for r in ranks]}
        for i, st in enumerate(steps):
            require(math.isfinite(st["loss_ddp"]), f"{kind} DDP loss not finite at step {i}")
            for key, lim in limit.items():
                v = st["ddp_vs_single"][key]
                require(v <= lim, f"{kind} DDP vs one process at step {i}: {key} {v} > {lim}")
        del opt
    kinds = list(tasks)
    del tasks
    _shutil.rmtree(files, ignore_errors=True)
    torch.cuda.empty_cache()

    release_card()
    t0 = time.perf_counter()
    nccl = spawn(_nccl_one_rank, 1, "nccl", ["cuda:0"], data, vi, si, draws["cddpm"])[0]
    nccl_s = time.perf_counter() - t0
    plain = _plain_steps(data, vi, si, draws["cddpm"])
    out["nccl_one_rank"] = {"world": nccl["world"], "losses": nccl["losses"],
                            "plain_losses": plain["losses"],
                            "bit_equal": nccl["digest"] == plain["digest"], "s": nccl_s}
    emit(out)
    require(nccl["losses"] == plain["losses"] and nccl["digest"] == plain["digest"],
            f"1-rank NCCL steps differ from the plain steps: {out['nccl_one_rank']}")
    return {kind: out[kind]["launches_two_ranks"] for kind in kinds}


def _ddp_full_rank(rank, steps, subs):
    """Rank ``rank`` of the full-size DDP phases, the flagship bf16 task from
    its seeded weights: first the eval group ``subs`` (one volume a rank;
    the gathered packed buffers, the launches around the call and its
    seconds), then the train step at global batch DDP_FULL_BATCH: s/step
    over ``steps`` (launch counters read around them), peak memory, the
    gradient all-reduce's seconds in a window of its own (DDP_REDUCE_CALLS
    calls, each between synchronizations), and a profiled window's idle
    share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from conditioned_diffusion_models_uad_torch.eval.reconstruct import VolumeReconstructor
    from conditioned_diffusion_models_uad_torch.parallel.mesh import barrier
    from conditioned_diffusion_models_uad_torch.train import loop

    task = _flagship_task("cuda")
    recon = VolumeReconstructor(task)
    flags = _ddp_eval_flags()
    seeds = _volume_seeds(task, range(len(subs)))
    recon.batch_call_scored(subs, flags, seeds)  # warm-up
    torch.cuda.synchronize()
    counters = _zero_launches()
    t0 = time.perf_counter()
    _, packed = recon.batch_call_scored(subs, flags, seeds)
    torch.cuda.synchronize()
    evaluation = {"s": time.perf_counter() - t0, "launches": _read_launches(counters),
                  "packed": packed.cpu(),
                  # one volume's __call__: slice-parallel, a rank's half of its depth
                  "call_reco": recon(subs[0]["vol"], seeds[:1]).float().cpu()}

    opt = loop.make_optimizer(task)
    data, vi, si, g = _train_setup(DDP_FULL_BATCH, "cuda", 7)  # the same on every rank

    def step():
        return loop.train_step(task, opt, data, vi, si, task.draw_train(g, DDP_FULL_BATCH))

    for _ in range(3):
        loss = step()
    require(math.isfinite(loss.item()), "DDP train loss not finite")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    barrier()
    counters = _zero_launches()
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = step()
    torch.cuda.synchronize()
    s_per_step = (time.perf_counter() - t0) / steps
    launches = {k: v / steps for k, v in _read_launches(counters).items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # the gradient all-reduce alone, in its own window, on the last step's
    # gradients
    reduce_s = []
    for _ in range(DDP_REDUCE_CALLS):
        barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop.all_reduce_grads(task)
        torch.cuda.synchronize()
        reduce_s.append(time.perf_counter() - t0)
    reduce_ms = 1e3 * sum(reduce_s) / len(reduce_s)
    barrier()
    n_prof = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_prof):
            loss = step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = sum(ev.self_device_time_total for ev in kernel_events(prof)) / 1e3
    return {"eval": evaluation,
            "train": {"s_per_step": s_per_step, "allreduce_ms": reduce_ms,
                      "launches_per_step": launches, "peak_memory_gb": peak_gb,
                      "loss": loss.item(), "profiled_wall_ms": wall_ms,
                      "profiled_kernel_ms": busy_ms,
                      "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms)}}


def _ddp_eval_flags(shape=EVAL_SHAPE):
    from conditioned_diffusion_models_uad_torch.eval.harness import EvalConfig, EvalSession

    session = EvalSession(EvalConfig(cc_backend="device", hausdorff_backend="device"),
                          "Brats21", "val", device="cuda")
    return session._fused_flags(shape, seg_is_host=True)


def phase_ddp_full_size_and_eval():
    """The flagship bf16 paths data-parallel, 2 gloo ranks on cuda:0, from
    the seeded weights. ``ddp_eval``: a group of 2 lesion volumes at
    EVAL_SHAPE, one a rank, reconstructed and scored by
    ``batch_call_scored`` and gathered; each volume's buffer must equal, bit
    for bit, this process's scoring of that volume alone and this process's
    scoring of the whole group (a model call a volume: the same UNet batch
    on a rank and in one process); one volume's ``__call__``, slice-parallel
    (a rank takes half its depth), is reported against one process: the one
    layout-dependent path. ``ddp_full_size``: the train
    step at global batch DDP_FULL_BATCH (16 a rank), DDP_FULL_STEPS timed
    steps. Both ranks share the one card and gloo moves the float32
    gradients through the host each step: a rig that drives the path at
    full size, not a speed configuration."""
    import torch

    from conditioned_diffusion_models_uad_torch.eval.fused import parse_packed
    from conditioned_diffusion_models_uad_torch.eval.reconstruct import VolumeReconstructor
    from conditioned_diffusion_models_uad_torch.parallel.mesh import spawn

    subs = _eval_subjects(2, 31, lesion=True)
    release_card()
    t0 = time.perf_counter()
    ranks = spawn(_ddp_full_rank, 2, "gloo", ONE_CARD_TWICE, DDP_FULL_STEPS, subs)
    phase_s = time.perf_counter() - t0
    train = [r["train"] for r in ranks]
    emit({"phase": "ddp_full_size", "nvidia_smi": nvidia_smi(), "backend": "gloo",
          "devices": ONE_CARD_TWICE,
          "config": "DDPMTaskConfig() (bf16, norm_precision=compute, fused_attention), "
                    "Adam lr 1e-4, aug_intensity", "global_batch": DDP_FULL_BATCH,
          "steps": DDP_FULL_STEPS, "ranks": train, "spawn_eval_and_train_s": phase_s})
    for r, numbers in enumerate(train):
        per = numbers["launches_per_step"]
        require(math.isfinite(numbers["loss"]), f"rank {r}: loss not finite")
        for name in ("fractal_noise_2d", "fused_attention", "attention_fwd_mma"):
            require(per[name] >= 1, f"rank {r}: {name} was not launched on every DDP step")
        require(per["attention_fwd_scalar"] == 0, f"rank {r}: bf16 attention took scalar K2")

    task = _flagship_task("cuda")
    recon = VolumeReconstructor(task)
    flags = _ddp_eval_flags()
    seeds = _volume_seeds(task, range(2))
    alone = [recon.batch_call_scored(subs[j:j + 1], flags, seeds[j:j + 1])[1][0].cpu()
             for j in range(2)]
    recon.batch_call_scored(subs, flags, seeds)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, group = recon.batch_call_scored(subs, flags, seeds)
    torch.cuda.synchronize()
    group_s = time.perf_counter() - t0
    st = flags["statics"]
    args = (EVAL_SHAPE, recon.latent_len(), st["pack_seg"], st["pack_maps"])
    gathered = ranks[0]["eval"]["packed"]
    vs_group = {"counts_moved": 0, "max_abs_float": 0.0}
    for j in range(2):
        g = parse_packed(gathered[j], *args)["scalars"]
        w = parse_packed(group[j], *args)["scalars"]
        for k, v in w.items():
            if k in ("tp", "fp", "tn", "fn"):
                vs_group["counts_moved"] += abs(g[k] - v) / 2
            elif not (math.isnan(v) and math.isnan(g[k])):
                vs_group["max_abs_float"] = max(vs_group["max_abs_float"], abs(g[k] - v))
    bit_equal = [bool(torch.equal(gathered[j], alone[j])) for j in range(2)]
    group_equal = [bool(torch.equal(gathered[j], group[j].cpu())) for j in range(2)]
    # the one layout-dependent path: a single volume's slice-parallel call
    call_diff = (ranks[0]["eval"]["call_reco"]
                 - recon(subs[0]["vol"], seeds[:1]).float().cpu()).abs()
    call_vs_one = {"max_abs": call_diff.max().item(),
                   "share_of_voxels_differing": (call_diff > 0).float().mean().item()}
    emit({"phase": "ddp_eval", "nvidia_smi": nvidia_smi(), "backend": "gloo",
          "devices": ONE_CARD_TWICE, "volumes": 2, "shape": list(EVAL_SHAPE),
          "config": "DDPMTaskConfig() (bf16), eval=device_fast scoring, one volume a rank",
          "rank_s": [r["eval"]["s"] for r in ranks], "single_group_s": group_s,
          "launches_by_rank": [r["eval"]["launches"] for r in ranks],
          "bit_equal_to_each_volume_alone": bit_equal,
          "bit_equal_to_single_group": group_equal, "vs_single_group": vs_group,
          "slice_parallel_call_vs_one_process": call_vs_one})
    require(torch.equal(ranks[0]["eval"]["call_reco"], ranks[1]["eval"]["call_reco"]),
            "the ranks gathered different slice-parallel reconstructions")
    require(math.isfinite(call_vs_one["max_abs"]), "slice-parallel reconstruction not finite")
    require(torch.equal(gathered, ranks[1]["eval"]["packed"]),
            "the ranks gathered different buffers")
    require(all(bit_equal), "a rank's scored volume differs from the volume scored alone")
    require(all(group_equal) and vs_group["counts_moved"] == 0,
            f"a rank's scored volume differs from this process's group: {vs_group}")
    for r in ranks:
        per = r["eval"]["launches"]
        require(per["fractal_noise_2d"] >= 1 and per["attention_fwd_mma"] >= 1,
                f"DDP eval: K1/K2 not launched on a rank: {per}")
    return [t["launches_per_step"] for t in train], [r["eval"]["launches"] for r in ranks]


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

    LOG.parent.mkdir(exist_ok=True)
    LOG.write_text("")
    work = Path(tempfile.mkdtemp(prefix="uad_from_files_"))
    gen = start_file_data(work)
    try:
        return run_phases(gen, work)
    finally:
        if gen.poll() is None:
            gen.kill()
            gen.wait()
        shutil.rmtree(work, ignore_errors=True)


def run_phases(gen, work: Path) -> int:
    import torch

    phase_s = {}

    def timed(fn, *args):
        """``fn(*args)``, its wall seconds kept under the phase's name."""
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[fn.__name__[len("phase_"):]] = time.perf_counter() - t0
        return out

    timed(phase_device)
    with paused(gen):
        k1 = timed(phase_k1)
        k2 = timed(phase_k2)
        k3 = timed(phase_k3)
    slice_launches = timed(phase_slice_correctness)
    with paused(gen):
        launches = timed(phase_full_size)
    timed(phase_eval_correctness)
    with paused(gen):
        eval_run = timed(phase_eval_full_size)
    timed(phase_train_correctness)
    with paused(gen):
        train_launches = timed(phase_train_full_size)
    timed(phase_spark_correctness)
    with paused(gen):
        spark_launches = timed(phase_spark_train_full_size)
    t_new = time.perf_counter()
    timed(phase_iterative_correctness)
    with paused(gen):
        iter_launches = timed(phase_iterative_full_size)
    timed(phase_patched_correctness)
    with paused(gen):
        pd_eval_launches, pd_train_launches = timed(phase_patched_full_size)
    new_phases_s = time.perf_counter() - t_new
    with paused(gen):
        ddpm_train_launches, ddpm_eval_launches = timed(phase_ddpm_f32_full_size)
        fullres_train_launches, fullres_eval_launches = timed(phase_fullres_full_size)
    t_var = time.perf_counter()
    timed(phase_variants_correctness)
    with paused(gen):
        var_launches = timed(phase_variants_full_size)
        timed(phase_prepare_full_size, work)
    variants_s = time.perf_counter() - t_var
    data_wait_s = wait_file_data(gen)
    t_new10 = time.perf_counter()
    timed(phase_native_io, work)
    files = timed(phase_run_from_files, work, data_wait_s)
    timed(phase_ckpt_overlap, work)
    ddp_correct_launches = timed(phase_ddp_correctness, work)
    ddp_train_launches, ddp_eval_launches = timed(phase_ddp_full_size_and_eval)
    phases10_s = time.perf_counter() - t_new10
    k2_mma, k2_long, k2_scalar = k2["mma"], k2["mma_long_eval"], k2["scalar"]
    for at, key_ in (("at_train_shape", "mma_train"), ("at_pddpm_eval_shape", "mma_pddpm"),
                     ("at_iterative_step_shape", "mma_iterative")):
        k2_mma[at] = {key: k2[key_][key] for key in (
            "shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
    for at, key_ in (("at_train_shape", "mma_long_train"),
                     ("called_directly_at_576", "mma_long_576")):
        k2_long[at] = {key: k2[key_][key] for key in (
            "shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
    k2_long["called_directly_at_576"]["times_faster_than_scalar_bf16"] = k2[
        "mma_long_576"]["times_faster_than_scalar_bf16"]
    for at, key_ in (("at_flagship_bf16", "scalar_bf16"),
                     ("at_fullres_bf16", "scalar_bf16_fullres")):
        k2_scalar[at] = {key: k2[key_][key] for key in (
            "shape", "dtype", "max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms")}
    for at, key_ in (("at_ddpm_train_shape", "scalar_ddpm_train"),
                     ("at_ddpm_eval_shape", "scalar_ddpm_eval")):
        k2_scalar[at] = {key: k2[key_][key] for key in (
            "shape", "dtype", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")}
    k1["launches"] = launches["fractal_noise_2d"]
    k2_mma["launches"] = launches["attention_fwd_mma"]
    # the float32 kernel's path is the DDPM baseline's (bf16 reconstruction
    # takes the tensor-core kernel): its eval group's count
    k2_scalar["launches"] = ddpm_eval_launches["attention_fwd_scalar"]
    k2_scalar["launches_counted_over"] = "ddpm_f32_eval_group"
    # the long-sequence kernel's path is the full-resolution cDDPM's eval group
    k2_long["launches"] = fullres_eval_launches["attention_fwd_mma_long"]
    k2_long["launches_counted_over"] = "fullres_eval_group"
    k3_cluster, k3_coop, k3_two_pass = k3["cluster"], k3["coop"], k3["two_pass"]
    paths = {"reconstruct_call": launches,
             "train_step": train_launches,
             "eval_protocol": eval_run["launches"],
             "eval_group": {k: v / eval_run["groups"] for k, v in eval_run["launches"].items()},
             "fit_epoch": files["fit_epoch"],
             "eval_from_files": files["eval_from_files"],
             "spark_train_step": spark_launches,
             "spark_fit_epoch": files["spark_fit_epoch"],
             "spark_eval_from_files": files["spark_eval_from_files"],
             "ddim_reconstruct_call": iter_launches["ddim"],
             "ancestral_reconstruct_call": iter_launches["ancestral"],
             "pddpm_eval_group": pd_eval_launches,
             "pddpm_train_step": pd_train_launches,
             "pddpm_fit_epoch": files["pddpm_fit_epoch"],
             "pddpm_eval_from_files": files["pddpm_eval_from_files"],
             "ddim_eval_from_files": files["ddim_eval_from_files"],
             "ddpm_f32_train_step": ddpm_train_launches,
             "ddpm_f32_eval_group": ddpm_eval_launches,
             "fullres_train_step": fullres_train_launches,
             "fullres_eval_group": fullres_eval_launches,
             **var_launches,
             **{f"ddp_train_step_rank{r}": per for r, per in enumerate(ddp_train_launches)},
             **{f"ddp_eval_group_rank{r}": per for r, per in enumerate(ddp_eval_launches)},
             **{f"ddp_fp32_{kind}_steps_rank{r}": per
                for kind, ranks in ddp_correct_launches.items()
                for r, per in enumerate(ranks)}}
    for rec, name in ((k1, "fractal_noise_2d"), (k2_mma, "attention_fwd_mma"),
                      (k2_long, "attention_fwd_mma_long"),
                      (k2_scalar, "attention_fwd_scalar"),
                      (k3_cluster, "fused_groupnorm_silu_cluster"),
                      (k3_coop, "fused_groupnorm_silu_coop"),
                      (k3_two_pass, "fused_groupnorm_silu_two_pass")):
        rec["launches_by_path"] = {path: counts[name] for path, counts in paths.items()}
    for rec in (k3_cluster, k3_coop, k3_two_pass):
        rec["launches_by_path"]["k3_phase_calls"] = rec["launches"]
    k2_scalar["launches_by_path"]["slice_correctness_call"] = slice_launches[
        "attention_fwd_scalar"]
    # a fit epoch in its two halves, its validations and its train steps
    norm_route({**{p: n for p, n in paths.items() if not p.endswith("fit_epoch")},
                **files["fit_halves"], "slice_correctness_call": slice_launches})
    emit({"phase": "timing", "iterative_and_patched_phases_s": new_phases_s,
          "variants_and_prepare_phases_s": variants_s,
          "run_from_files_pddpm_and_ddim_cli_s": files["added_cli_s"],
          "native_io_run_from_files_and_ddp_phases_s": phases10_s,
          "phase_s": phase_s})
    emit({"kernels": [k1, k2_mma, k2_long, k2_scalar, k3_cluster, k3_coop, k3_two_pass]})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
