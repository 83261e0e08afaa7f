"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, and loaded with ``ctypes``. All sources are
compiled in parallel (one ``nvcc`` per source) at first use, into
``_build/`` beside ``csrc/`` (listed in ``.gitignore``). A library's file name
carries a hash of its source and flags, so an edited source is rebuilt and an
unchanged one is reused. A failed build raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# per-library extra flags: the noise kernel keeps f32 operation order (no
# contraction to FMA) so it matches its plain version to within 1e-5
SOURCES: Dict[str, list] = {
    "simplex_noise": ["-fmad=false"],
    "attention": [],
    "fused_norm": [],
}

_loaded: Dict[str, ctypes.CDLL] = {}
# nvcc's stderr (ptxas register / shared-memory report) per library
build_log: Dict[str, str] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(
        src + " ".join(NVCC_FLAGS + SOURCES[name]).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all() -> float:
    """Compile every library not yet built, all ``nvcc`` runs in parallel.
    Returns the wall seconds spent (0 when everything was cached)."""
    todo = {n: _lib_path(n) for n in SOURCES if not _lib_path(n).is_file()}
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = {}
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *SOURCES[name], "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        ), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        stdout, stderr = proc.communicate()
        build_log[name] = stdout + stderr
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{stderr}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, building all libraries first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.is_file():
            build_all()
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib


def check(status: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")
