"""Builds and loads the port's CUDA kernels.

The sources under ``ssde_tpu_torch/csrc`` have a plain C interface. They are
compiled with ``nvcc`` into one shared library at first use and loaded with
``ctypes`` (no PyTorch headers, so the build takes seconds). The library goes
to ``build/ssde_tpu_torch/`` at the repo root, named by a hash of the sources
and flags, so an edited source rebuilds and an unchanged one loads from disk.

A missing ``nvcc`` is an error: on a CUDA machine nothing falls back to the
plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCES = (PACKAGE_DIR / "csrc" / "conv3x3.cu",)
BUILD_DIR = PACKAGE_DIR.parent / "build" / "ssde_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when the library was already built
    log: str              # nvcc's output (ptxas register/spill report)


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin);"
        " the CUDA kernels of ssde_tpu_torch cannot be built")


def _digest() -> str:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.ssde_conv3x3_fwd
    # x, w, b, out, B, Cin, H, W, Cout, dtype, reflect, act, stream
    fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, p]
    fn.restype = i


@functools.cache
def load_library() -> KernelLibrary:
    """Build (if the sources changed) and load the kernel library."""
    so = BUILD_DIR / f"libssde_tpu_torch-{_digest()}.so"
    seconds, log = 0.0, ""
    if not so.exists():
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = res.stdout + res.stderr
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{log}")
        os.replace(tmp, so)  # atomic: a concurrent build never sees half a file
    lib = ctypes.CDLL(str(so))
    _bind(lib)
    return KernelLibrary(lib, so, seconds, log)
