"""Drive the PyTorch port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card, ``nvcc`` and
PyTorch built for CUDA. Phases, each of which must pass:

1. the card: name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``diff_unet_tpu_torch/csrc`` with ``nvcc``;
3. every kernel against its plain PyTorch version on the card at the
   shapes the DiffSwinUNETR slice gives it (window attention at the four
   Swin stage geometries of a 96^3 ROI with sw_batch_size 2, shifted and
   unshifted, bf16 and fp32; the window shift forward and inverse at the
   7^3 / 4^3 / 2^3 window grids, bit-exact), with CUDA-event times;
4. a small DiffSwinUNETR denoiser step (feature 12, 32^3, fp32, TF32 off)
   on the card against the same weights on the CPU's plain path;
5. the slice at full width: a ``Predictor`` with the values of
   ``cfg/btcv/test.yaml`` (diff_swin_unetr, feature 48, 13 classes, 96^3
   ROI, sw_batch_size 2, overlap 0.25, DDIM-10, bf16) and seeded random
   weights serves synthetic CT volumes; outputs are checked for shape and
   finiteness, and both kernels' launch counters must have grown.

It prints one JSON line with the kernels, then, last, one JSON line with
``"ok": true`` and the device. Any failed phase exits non-zero before that.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
ROOT = Path(__file__).resolve().parent
ATTN_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
MODEL_TOL = 1e-3
# (stage, BW, heads, N, window grid of the padded stage or None when the
# window is clamped and never shifted) for a 96^3 ROI at sw_batch_size 2
ATTN_CASES = [
    ("stage1", 686, 3, 343, (7, 7, 7)),
    ("stage2", 128, 6, 343, (4, 4, 4)),
    ("stage3", 16, 12, 343, (2, 2, 2)),
    ("stage4", 2, 24, 216, None),
]
SHIFT_CASES = [((7, 7, 7), 48), ((4, 4, 4), 96), ((2, 2, 2), 192)]


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
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


def phase_card() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    return card


def phase_build() -> None:
    from diff_unet_tpu_torch.ops import _native

    t0 = time.perf_counter()
    _native.load()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_native.build_info['seconds']:.2f} s) "
        f"-> {_native.build_info['path']}")
    for line in _native.build_info["log"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")


def phase_kernels(dev: torch.device) -> dict:
    from diff_unet_tpu_torch.ops.swin import window_region_ids
    from diff_unet_tpu_torch.ops.window_attention import (
        window_attention, window_attention_plain)
    from diff_unet_tpu_torch.ops.window_shift import (
        shift_windows, shift_windows_plain)

    g = torch.Generator(device=dev).manual_seed(SEED)
    report = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, bw, h, n, grid in ATTN_CASES:
            for shifted in ((False, True) if grid else (False,)):
                qkv = torch.randn((bw, n, 3, h, 16), generator=g, device=dev
                                  ).to(dtype)
                bias = 0.5 * torch.randn((h, n, n), generator=g, device=dev)
                ids = None
                if shifted:
                    dims = tuple(7 * k for k in grid)
                    ids = torch.from_numpy(window_region_ids(
                        dims, (7, 7, 7), (3, 3, 3))).to(dev)
                got = window_attention(qkv, bias, ids)
                want = window_attention_plain(qkv, bias, ids)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                ms = cuda_ms(lambda: window_attention(qkv, bias, ids))
                plain_ms = cuda_ms(
                    lambda: window_attention_plain(qkv, bias, ids))
                tag = (f"window_attention {name} {'shift' if shifted else 'noshift'}"
                       f" {str(dtype)[6:]} BW={bw} H={h} N={n}")
                log(f"{tag}: max_abs_err {err:.3e} (tol "
                    f"{ATTN_TOL[dtype]:.0e}) kernel {ms:.4f} ms plain "
                    f"{plain_ms:.4f} ms")
                if not err <= ATTN_TOL[dtype]:
                    fail(f"{tag} disagrees with its plain version")
                if name == "stage1" and shifted and dtype == torch.bfloat16:
                    report["window_attention"] = dict(
                        max_abs_err=err, ms=ms, plain_ms=plain_ms)
    for grid, c in SHIFT_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((2 * int(np.prod(grid)), 343, c), generator=g,
                            device=dev).to(dtype)
            for ss in ((3, 3, 3), (-3, -3, -3)):
                got = shift_windows(x, (7, 7, 7), ss, grid)
                want = shift_windows_plain(x, (7, 7, 7), ss, grid)
                exact = torch.equal(got, want)
                ms = cuda_ms(lambda: shift_windows(x, (7, 7, 7), ss, grid))
                plain_ms = cuda_ms(
                    lambda: shift_windows_plain(x, (7, 7, 7), ss, grid))
                tag = (f"shift_windows grid={grid} C={c} ss={ss} "
                       f"{str(dtype)[6:]}")
                log(f"{tag}: bit-exact {exact} kernel {ms:.4f} ms plain "
                    f"{plain_ms:.4f} ms")
                if not exact:
                    fail(f"{tag} is not bit-exact")
                if grid == (7, 7, 7) and ss[0] > 0 and dtype == torch.bfloat16:
                    report["shift_windows"] = dict(
                        max_abs_err=(got.float() - want.float()).abs().max()
                        .item(), ms=ms, plain_ms=plain_ms)
    return report


def phase_small_model(dev: torch.device) -> None:
    from diff_unet_tpu_torch.models.swin_unetr import DiffSwinUNETR
    from diff_unet_tpu_torch.utils.weights import init_random

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    s, classes = 32, 3
    cpu = init_random(DiffSwinUNETR(classes, image_size=(s,) * 3,
                                    feature_size=12), SEED).eval()
    gpu = DiffSwinUNETR(classes, image_size=(s,) * 3, feature_size=12)
    gpu.load_state_dict(cpu.state_dict())
    gpu = gpu.to(dev).eval()
    rng = np.random.default_rng(SEED)
    image = torch.from_numpy(rng.standard_normal((2, s, s, s, 1),
                                                 np.float32))
    x = torch.from_numpy(rng.standard_normal((2, s, s, s, classes),
                                             np.float32))
    t = torch.tensor([5, 250])
    with torch.inference_mode():
        want = cpu.denoise(image, x, t)
        got = gpu.denoise(image.to(dev), x.to(dev), t.to(dev)).cpu()
    err = (got - want).abs().max().item()
    log(f"small model denoise (feature 12, {s}^3, fp32, TF32 off) cuda vs "
        f"cpu: max_abs_err {err:.3e} (tol {MODEL_TOL:.0e}, max|y| "
        f"{want.abs().max().item():.3f})")
    if not (torch.isfinite(got).all() and err <= MODEL_TOL):
        fail("small DiffSwinUNETR on the card disagrees with the CPU")


def synthetic_ct(shape, seed: int, dev: torch.device) -> torch.Tensor:
    """A (D, H, W, 1) volume in [0, 1]: smooth random blobs plus noise."""
    g = torch.Generator(device=dev).manual_seed(seed)
    coarse = torch.randn((1, 1, *[max(2, s // 16) for s in shape]),
                         generator=g, device=dev)
    smooth = torch.nn.functional.interpolate(coarse, size=shape,
                                             mode="trilinear")
    vol = torch.sigmoid(2.0 * smooth) + 0.05 * torch.randn(
        (1, 1, *shape), generator=g, device=dev)
    return vol.clamp(0.0, 1.0)[0].permute(1, 2, 3, 0).contiguous()


def phase_serve(dev: torch.device) -> dict:
    from diff_unet_tpu_torch.engine.engine import Predictor
    from diff_unet_tpu_torch.ops.window_attention import window_attention
    from diff_unet_tpu_torch.ops.window_shift import shift_windows

    pred = Predictor.from_config(
        ROOT / "cfg/btcv/test.yaml", model_path=None,
        classes=str(ROOT / "cfg/btcv/classes.yaml"), device=dev, seed=SEED)
    log(f"predictor: {pred.model_name} feature 48, {pred.num_classes} "
        f"classes, roi {pred._inferer.roi}, sw_batch_size "
        f"{pred.sw_batch_size}, overlap {pred.overlap}, dtype {pred.dtype}")
    shapes = [(96, 192, 192), (80, 160, 176), (96, 96, 96)]
    volumes = [synthetic_ct(s, SEED + i, dev) for i, s in enumerate(shapes)]
    pred.infer(volumes[2])                 # warm-up: cuDNN plans, tables
    torch.cuda.synchronize()

    window_attention.launches = 0
    shift_windows.launches = 0
    results, seconds = [], []
    for v in volumes:
        t0 = time.perf_counter()
        results.append(pred.serve([v])[0])
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    counts = {"window_attention": window_attention.launches,
              "shift_windows": shift_windows.launches}

    steps = pred.seg.sample_steps
    for shape, (logits, binary), sec in zip(shapes, results, seconds):
        bucket_roi = tuple(max(r, s) for r, s in zip(pred._inferer.roi, shape))
        n_win = len(pred._inferer._starts(bucket_roi))
        log(f"volume {shape}: {n_win} windows, {sec:.3f} s, "
            f"{n_win * steps / sec:.3f} DDIM window-steps/s")
        want = (*shape, pred.num_classes)
        if tuple(logits.shape) != want or tuple(binary.shape) != want:
            fail(f"output shape {tuple(logits.shape)} != {want}")
        if not torch.isfinite(logits).all():
            fail(f"non-finite logits for volume {shape}")
        if not ((binary == 0) | (binary == 1)).all():
            fail("binary output is not {0, 1}")
    log(f"launches during serving: {counts}")
    for k, c in counts.items():
        if c <= 0:
            fail(f"kernel {k} was not launched on the main path")
    return counts


def main() -> None:
    card = phase_card()
    dev = torch.device("cuda", 0)
    phase_build()
    report = phase_kernels(dev)
    phase_small_model(dev)
    counts = phase_serve(dev)
    replaces = {
        "window_attention": ("diff_unet_tpu_torch/csrc/window_attention.cu",
                             "diff_unet_tpu/ops/pallas_attention.py:115"),
        "shift_windows": ("diff_unet_tpu_torch/csrc/window_shift.cu",
                          "diff_unet_tpu/ops/pallas_shift.py:71"),
    }
    kernels = [dict(name=k, route="cuda", source=src, replaces=rep,
                    launches=counts[k], **report[k])
               for k, (src, rep) in replaces.items()]
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
