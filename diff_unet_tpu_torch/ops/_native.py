"""Build and load the port's CUDA kernels (``diff_unet_tpu_torch/csrc``).

The sources are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with ``ctypes``. The build runs at
the first CUDA call, never at import, and is keyed on a hash of the sources
and flags: the library lands in ``build/diff_unet_tpu_torch/`` beside the
package (listed in ``.gitignore``) and is reused while the sources are
unchanged. A missing ``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "diff_unet_tpu_torch"
SOURCES = ("window_attention.cu", "window_shift.cu", "conv3d.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
build_info: dict = {}   # {"path", "seconds", "log"} of the loaded library


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "diff_unet_tpu_torch need the CUDA toolkit")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _build() -> Path:
    out = BUILD_DIR / f"libdut_kernels_{_digest()}.so"
    if out.exists():
        build_info.update(path=str(out), seconds=0.0, log="(cached)")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *[str(CSRC / s) for s in SOURCES]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)     # atomic: a concurrent process sees a whole file
    build_info.update(path=str(out), seconds=seconds,
                      log=proc.stdout + proc.stderr)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong
    lib.window_attention_forward.argtypes = [p, p, p, p, i, i, i, i, i, f,
                                             i, p]
    lib.window_attention_forward.restype = i
    lib.shift_windows_forward.argtypes = [p, p, p, ll, ll, i, p]
    lib.shift_windows_forward.restype = i
    lib.conv3x3_forward.argtypes = [p, p, p, p, i, i, i, i, i, p, p, p, p,
                                    p, f, f, p, p, i, i, i, i, i, i, i, i,
                                    p]
    lib.conv3x3_forward.restype = i
    lib.kernels_error_string.argtypes = [i]
    lib.kernels_error_string.restype = ctypes.c_char_p
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    if _lib is None:
        _lib = _bind(ctypes.CDLL(str(_build())))
    return _lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        msg = load().kernels_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")


def forbid_grad(*tensors: torch.Tensor) -> None:
    """The kernels are forward-only: refuse a call autograd would need."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "diff_unet_tpu_torch CUDA kernels are forward-only (serving); "
            "run under torch.inference_mode() or torch.no_grad()")
