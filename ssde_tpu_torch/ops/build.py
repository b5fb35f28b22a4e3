"""Builds, loads and launches the port's CUDA kernels.

The sources under ``ssde_tpu_torch/csrc`` have a plain C interface. At
first use each is compiled by its own ``nvcc`` process, all started
together, and the objects are linked into one shared library that is
loaded with ``ctypes`` (no PyTorch headers, so the build takes seconds).
The library goes to ``build/ssde_tpu_torch/`` at the repo root, named by a
hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads from disk.

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
SOURCES = tuple(PACKAGE_DIR / "csrc" / name for name in
                ("conv3x3_tf32.cu", "conv3x3_tc.cu", "warp_family.cu", "photometric.cu",
                 "attention_win.cu"))
HEADERS = tuple(PACKAGE_DIR / "csrc" / name for name in ("conv3x3_common.cuh",))
BUILD_DIR = PACKAGE_DIR.parent / "build" / "ssde_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signature of every entry point after its pointer/int arguments: the
# last argument is always the CUDA stream, the return value a cudaError_t
SIGNATURES = {
    # float32 (3xTF32): x, wp, b, out, B, Cin, H, W, Cout, cin_pad, cc, bn, reflect, act
    "ssde_conv3x3_fwd_tf32": [_P] * 4 + [_I] * 10,
    # float32 (3xTF32): x, g, partial, dw, B, Cin, H, W, Cout, P, tile_m, reflect
    "ssde_conv3x3_dw_tf32": [_P] * 4 + [_I] * 8,
    # bf16: x, wp, b, out, B, Cin, H, W, Cout, cin_pad, cc, bn, reflect, act
    "ssde_conv3x3_fwd_bf16": [_P] * 4 + [_I] * 10,
    # bf16: x, g, partial, dw, B, Cin, H, W, Cout, P, tile_m, reflect
    "ssde_conv3x3_dw_bf16": [_P] * 4 + [_I] * 8,
    # img, grids, out, S, B, C, H, W, Ho, Wo
    "ssde_warp_family_fwd": [_P] * 3 + [_I] * 7,
    # img, grids, dout, dgrid, S, B, C, H, W, Ho, Wo
    "ssde_warp_family_bwd": [_P] * 4 + [_I] * 7,
    # pred, targ, out, G, B, C, H, W
    "ssde_photometric_fwd": [_P, _P, _P, _I, _I, _I, _I, _I],
    # pred, targ, gout, dpred, G, B, C, H, W
    "ssde_photometric_bwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I],
    # q, kp, vp, rel, out, B, C, H, W, dtype
    "ssde_attend3_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I],
    # q, kp, vp, rel, g, dq, dkp, dvp, partial, drel, B, C, H, W, n_partials, dtype
    "ssde_attend3_bwd": [_P] * 10 + [_I] * 6,
}


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
    for src in SOURCES + HEADERS:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _build(so: Path) -> str:
    """Compile every source in parallel, link them into ``so``; nvcc's log."""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in SOURCES]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for src, o in zip(SOURCES, objs)]
    logs, failed = [], []
    for src, p in zip(SOURCES, procs):
        out, _ = p.communicate()
        logs.append(f"[{src.name}]\n{out}")
        if p.returncode != 0:
            failed.append(src.name)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        res = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, so)  # atomic: a concurrent build never sees half a file
    finally:
        tmp.unlink(missing_ok=True)
        for o in objs:
            o.unlink(missing_ok=True)
    return "\n".join(logs)


@functools.cache
def load_library() -> KernelLibrary:
    """Build (if the sources changed) and load the kernel library."""
    so = BUILD_DIR / f"libssde_tpu_torch-{_digest()}.so"
    seconds, log = 0.0, ""
    if not so.exists():
        t0 = time.perf_counter()
        log = _build(so)
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    for name, args in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = [*args, _P]
        fn.restype = _I
    return KernelLibrary(lib, so, seconds, log)


def launch(name: str, device, *args) -> None:
    """Call entry point ``name`` with ``args`` on the current stream of
    ``device`` (which must be the current device); raise on a CUDA error."""
    import torch

    if device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensors are on {device}, the current device "
                         f"is cuda:{torch.cuda.current_device()}")
    err = getattr(load_library().lib, name)(
        *args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
