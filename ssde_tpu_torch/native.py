"""The native velodyne projection (counterpart of ``ssde_tpu/native.py``).

``native/velodyne.cpp`` is compiled with ``g++`` at first use into
``build/ssde_tpu_torch/`` and loaded with ``ctypes``; a source newer than
the library rebuilds it. A failed build raises: nothing falls back to the
numpy projection, which is the twin the tests hold it to
(``data/kitti_utils.project_velodyne_numpy``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parents[1]
SOURCE = _REPO / "native" / "velodyne.cpp"
LIBRARY = _REPO / "build" / "ssde_tpu_torch" / "libssde_native.so"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")  # as ssde_tpu/native.py builds it

_lock = threading.Lock()
_lib = None


def _build() -> None:
    LIBRARY.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_name(f"{LIBRARY.name}.{os.getpid()}.tmp")
    try:
        res = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE} ({res.returncode}):\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, LIBRARY)  # atomic: a concurrent build never sees half a file
    finally:
        tmp.unlink(missing_ok=True)


def get_lib() -> ctypes.CDLL:
    """The native library, built first if it is missing or older than its
    source."""
    global _lib
    with _lock:
        if _lib is None:
            if not LIBRARY.exists() or SOURCE.stat().st_mtime > LIBRARY.stat().st_mtime:
                _build()
            lib = ctypes.CDLL(str(LIBRARY))
            lib.project_velodyne.restype = ctypes.c_int64
            lib.project_velodyne.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_float),
            ]
            _lib = lib
        return _lib


def project_velodyne_native(points: np.ndarray, P: np.ndarray, height: int, width: int,
                            vel_depth: bool = False) -> np.ndarray:
    """(N, 4) points through the 3x4 ``P`` -> (height, width) float32
    depth, the nearest return per pixel (``native/velodyne.cpp``)."""
    lib = get_lib()
    pts = np.ascontiguousarray(points, dtype=np.float32)
    Pm = np.ascontiguousarray(P, dtype=np.float64).reshape(-1)
    out = np.zeros((height, width), dtype=np.float32)
    lib.project_velodyne(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), ctypes.c_int64(pts.shape[0]),
        Pm.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int32(height), ctypes.c_int32(width), ctypes.c_int32(1 if vel_depth else 0),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out
