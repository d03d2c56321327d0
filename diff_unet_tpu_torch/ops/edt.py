"""Exact 3D Euclidean distance transform on the host (``csrc/edt.cpp``),
the distance map under HD95 and the surface distances of
``metrics/metrics.py``.

The source is compiled with ``g++ -O3 -shared -fPIC`` at the first call,
never at import, into ``build/diff_unet_tpu_torch/`` (as the CUDA kernels
are, ``ops/_native.py``), keyed on a hash of the source and flags. The
library is written under a temporary name and renamed into place, so
processes that build it at once each see a whole file. It is loaded with
``ctypes``. A missing compiler or a failed build raises. Its plain
version is ``scipy.ndimage.distance_transform_edt``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from diff_unet_tpu_torch.ops._native import BUILD_DIR, CSRC

SOURCE = CSRC / "edt.cpp"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _build() -> Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode()
                            + SOURCE.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"libdut_edt_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = ["g++", *CXX_FLAGS, "-o", tmp, str(SOURCE)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except FileNotFoundError as e:
            raise RuntimeError("g++ not found: the distance transform of "
                               "diff_unet_tpu_torch needs a C++ compiler"
                               ) from e
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load() -> ctypes.CDLL:
    """The distance-transform library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            lib.edt3d.restype = None
            lib.edt3d.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float),
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.c_float, ctypes.c_float]
            _lib = lib
    return _lib


def distance_transform_edt(mask: np.ndarray,
                           sampling: Optional[Sequence[float]] = None
                           ) -> np.ndarray:
    """float32 (X, Y, Z): for every non-zero voxel of the 3D ``mask``, the
    Euclidean distance to the nearest zero voxel, with voxel spacing
    ``sampling`` (default 1); zero voxels get 0."""
    mask = np.ascontiguousarray(np.asarray(mask).astype(np.uint8))
    if mask.ndim != 3:
        raise ValueError(f"the distance transform takes a 3D volume, got "
                         f"shape {mask.shape}")
    sx, sy, sz = (1.0, 1.0, 1.0) if sampling is None else \
        (float(s) for s in sampling)
    out = np.empty(mask.shape, np.float32)
    load().edt3d(mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                 out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                 *mask.shape, sx, sy, sz)
    return out
