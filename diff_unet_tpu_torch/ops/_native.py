"""Build and load the port's CUDA kernels (``diff_unet_tpu_torch/csrc``).

The sources are compiled with ``nvcc`` for ``sm_90a``, one process per
source in parallel, and linked into one shared library with a plain C
interface, loaded with ``ctypes``. The build runs at
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
SOURCES = ("window_attention.cu", "window_shift.cu", "window_partition.cu",
           "conv3d.cu", "conv3d_wgrad.cu")
HEADERS = ("hopper.cuh",)          # included by the sources: in the hash
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _build() -> Path:
    """One nvcc per source, all started together, then one link."""
    out = BUILD_DIR / f"libdut_kernels_{_digest()}.so"
    log_path = out.with_suffix(".log")     # nvcc's output (ptxas -v)
    if out.exists():
        log = log_path.read_text() if log_path.exists() else "(cached)"
        build_info.update(path=str(out), seconds=0.0, log=log)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    log = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [os.path.join(tmpdir, s + ".o") for s in SOURCES]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(CSRC / s)]
                for s, o in zip(SOURCES, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        results = [(c, p.communicate()[0], p.returncode)
                   for c, p in zip(cmds, procs)]
        tmp = os.path.join(tmpdir, "lib.so")
        link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                "-o", tmp, *objs]
        for cmd, text, rc in results:
            log.append(text)
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}"
                                   f"\n{text}")
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(link)}\n{proc.stdout}"
                               f"{proc.stderr}")
        log_path.write_text("".join(log))
        os.replace(tmp, out)   # atomic: a concurrent process sees a whole file
    build_info.update(path=str(out), seconds=time.perf_counter() - t0,
                      log="".join(log))
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong
    lib.window_attention_forward.argtypes = [p] * 5 + [i] * 5 + [f, i, p]
    lib.window_attention_forward.restype = i
    lib.window_attention_backward.argtypes = [p] * 7 + [i] * 6 + [f, i, p]
    lib.window_attention_backward.restype = i
    lib.shift_windows_forward.argtypes = [p, p, p, ll, ll, i, p]
    lib.shift_windows_forward.restype = i
    for fn in (lib.window_partition_forward, lib.window_reverse_forward):
        fn.argtypes = [p, p] + [i] * 10 + [p]
        fn.restype = i
    conv_head = [p, p, p, p, i, i, i, i, i, p, p, p, p, p, f, f, p, p, p]
    lib.conv3x3_f32_forward.argtypes = conv_head + [i] * 7 + [p]
    lib.conv3x3_f32_forward.restype = i
    lib.conv3x3_bf16_forward.argtypes = conv_head + [p, p] + [i] * 10 + [p]
    lib.conv3x3_bf16_forward.restype = i
    lib.conv3x3_wgrad.argtypes = ([p] * 5 + [i] * 5 + [p] * 3 + [f]
                                  + [p] * 2 + [i] * 12 + [p])
    lib.conv3x3_wgrad.restype = i
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

