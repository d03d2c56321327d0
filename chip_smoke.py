"""Drive the PyTorch port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card, ``nvcc`` and
PyTorch built for CUDA. Phases, each of which must pass:

1. the card: name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``diff_unet_tpu_torch/csrc`` with ``nvcc``;
3. every kernel against its plain PyTorch version on the card at the
   shapes its slice gives it, with CUDA-event times of the kernel, the
   plain version and one PyTorch library call computing the same function
   (timed only as a yardstick; the port never calls it):
   a. window attention at the four Swin stage geometries of a 96^3 ROI
      with sw_batch_size 2, shifted and unshifted, bf16 and fp32
      (library: ``scaled_dot_product_attention`` with the bias and region
      mask as ``attn_mask``); the window shift forward and inverse at the
      7^3 / 4^3 / 2^3 window grids, bit-exact (library: ``index_select``
      with the same table);
   b. the 3x3x3 conv at every distinct conv of DiffUNet at a 96^3 ROI with
      sw_batch_size 4 (stems, prologue and statistics, two-part UpCat
      inputs, 96^3 down to 6^3 and up to 512 -> 512), plus the switches of
      the other TPU conv kernels (bias and LeakyReLU; no bias), bf16 and
      fp32 (library: ``F.conv3d`` on the channels_last_3d view in the same
      dtype, with ``var_mean`` of the output where statistics are on);
4. small models on the card against the same weights on the CPU's plain
   path, fp32 with TF32 off: a DiffSwinUNETR denoiser step (feature 12,
   32^3) and a DiffUNet denoiser step (features (8, 8, 16, 32, 64, 8),
   32^3);
5. each slice at full width, a ``Predictor`` from the repository's config
   with seeded random weights serving synthetic CT volumes; outputs are
   checked for shape, finiteness and a binary mask:
   a. ``cfg/btcv/test.yaml`` (diff_swin_unetr, feature 48, 13 classes,
      96^3 ROI, sw_batch_size 2, overlap 0.25, DDIM-10, bf16); both Swin
      kernels' launch counters must have grown;
   b. ``cfg/amos/test.yaml`` (diff_unet, features (64, 64, 128, 256, 512,
      64), 15 classes, 96^3 ROI, sw_batch_size 4, overlap 0.25, DDIM-10,
      bf16); the conv kernel must have run exactly 10 + 18 * 10 times per
      window batch.

Each path is driven with its kernels' launch counters set to 0 just before
it and read just after. It prints one JSON line with the kernels (times,
error, launches, and the least time the card could take, from this run's
shapes and the H100 SXM peaks), then, last, one JSON line with
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
# H100 SXM peaks (NVIDIA data sheet, dense): memory rate, and the operation
# rate of each type on the unit that the kernels use
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
# (tag, part channels, Cout, side, prologue, stats, bias, LeakyReLU) for
# every distinct 3x3x3 conv of DiffUNet at a 96^3 ROI with sw_batch_size 4
# (N = 4); then the switches of the other TPU conv kernels at the L0 shape
CONV_N = 4
CONV_CASES = [
    ("encoder stem", [1], 64, 96, False, True, True, False),
    ("denoiser stem", [1, 15], 64, 96, False, True, True, False),
    ("L0 conv_1", [64], 64, 96, True, True, True, False),
    ("L0 upcat", [64, 64], 64, 96, False, True, True, False),
    ("L1 conv_0", [64], 64, 48, False, True, True, False),
    ("L1 conv_1", [64], 64, 48, True, True, True, False),
    ("L1 upcat", [64, 64], 64, 48, False, True, True, False),
    ("L2 conv_0", [64], 128, 24, False, True, True, False),
    ("L2 conv_1", [128], 128, 24, True, True, True, False),
    ("L2 upcat", [128, 128], 128, 24, False, True, True, False),
    ("L3 conv_0", [128], 256, 12, False, True, True, False),
    ("L3 conv_1", [256], 256, 12, True, True, True, False),
    ("L3 upcat", [256, 256], 256, 12, False, True, True, False),
    ("L4 conv_0", [256], 512, 6, False, True, True, False),
    ("L4 conv_1", [512], 512, 6, True, True, True, False),
    ("bias+lrelu (pallas_packed_conv / pallas_aug_conv)", [64], 64, 96,
     False, False, True, True),
    ("no bias (pallas_conv)", [64], 64, 96, False, False, False, False),
]
CONV_REPORT = ("L0 conv_1", torch.bfloat16)   # the kernels line's conv entry
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


def bound(nbytes: float, flops: float, dtype: torch.dtype) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the type's peak, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOP_PER_S[dtype] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


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


def attention_library_ms(qkv: torch.Tensor, bias: torch.Tensor,
                         ids) -> float:
    """``scaled_dot_product_attention`` over the same q, k, v views with the
    bias and the shifted-window region mask as its ``attn_mask``."""
    bw, n, _, h, _ = qkv.shape
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    mask = bias[None]
    if ids is not None:
        region = torch.where(ids[:, None, :] != ids[:, :, None], -100.0, 0.0)
        mask = (mask + region[:, None]).repeat(bw // ids.shape[0], 1, 1, 1)
    mask = mask.to(qkv.dtype)
    return cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask))


def phase_kernels(dev: torch.device) -> dict:
    from diff_unet_tpu_torch.ops.swin import window_region_ids
    from diff_unet_tpu_torch.ops.window_attention import (
        window_attention, window_attention_plain)
    from diff_unet_tpu_torch.ops.window_shift import (
        shift_table, shift_windows, shift_windows_plain)

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
                library_ms = attention_library_ms(qkv, bias, ids)
                bnd = bound(nbytes(qkv, bias, ids, got),
                            4.0 * bw * h * n * n * 16, dtype)
                tag = (f"window_attention {name} {'shift' if shifted else 'noshift'}"
                       f" {str(dtype)[6:]} BW={bw} H={h} N={n}")
                log(f"{tag}: max_abs_err {err:.3e} (tol "
                    f"{ATTN_TOL[dtype]:.0e}) kernel {ms:.4f} ms plain "
                    f"{plain_ms:.4f} ms library {library_ms:.4f} ms bound "
                    f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
                if not err <= ATTN_TOL[dtype]:
                    fail(f"{tag} disagrees with its plain version")
                if name == "stage1" and shifted and dtype == torch.bfloat16:
                    report["window_attention"] = dict(
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        library_ms=library_ms, **bnd)
                del qkv, bias, ids, got, want
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
                table = torch.from_numpy(shift_table(
                    (7, 7, 7), ss, grid)).to(dev)
                rows = x.view(2, -1, c)
                idx = table.long()
                library_ms = cuda_ms(lambda: rows.index_select(1, idx))
                bnd = bound(nbytes(x, got, table), 0.0, dtype)
                tag = (f"shift_windows grid={grid} C={c} ss={ss} "
                       f"{str(dtype)[6:]}")
                log(f"{tag}: bit-exact {exact} kernel {ms:.4f} ms plain "
                    f"{plain_ms:.4f} ms library {library_ms:.4f} ms bound "
                    f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
                if not exact:
                    fail(f"{tag} is not bit-exact")
                if grid == (7, 7, 7) and ss[0] > 0 and dtype == torch.bfloat16:
                    report["shift_windows"] = dict(
                        max_abs_err=(got.float() - want.float()).abs().max()
                        .item(), ms=ms, plain_ms=plain_ms,
                        library_ms=library_ms, **bnd)
    return report


def phase_conv(dev: torch.device) -> dict:
    """The 3x3x3 conv kernel against its plain version at every CONV_CASES
    shape, bf16 and fp32, with kernel / plain / library times."""
    from diff_unet_tpu_torch.ops.conv3d import (
        KERNEL_TOL, STATS_TOL, conv3x3, conv3x3_plain)

    torch.backends.cudnn.allow_tf32 = False      # the library's fp32 is fp32
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    report = {}
    for tag, chans, cout, side, pro_on, stats, has_bias, act in CONV_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            shape = (CONV_N, side, side, side)
            cin = sum(chans)
            parts = [torch.randn((*shape, c), generator=g, device=dev)
                     .to(dtype) for c in chans]
            w = torch.randn((cout, cin, 3, 3, 3), generator=g, device=dev) \
                / (27 * cin) ** 0.5
            b = (0.1 * torch.randn((cout,), generator=g, device=dev)
                 if has_bias else None)
            pro = None
            if pro_on:
                pro = tuple(torch.randn((CONV_N, cin), generator=g,
                                        device=dev) * sd + mu
                            for mu, sd in ((1.0, 0.3), (0.0, 0.3),
                                           (0.0, 0.2))) + (0.1,)
            kw = dict(prologue=pro, negative_slope=0.1 if act else None,
                      with_stats=stats)
            got = conv3x3(parts, w, b, **kw)
            want = conv3x3_plain(parts, w, b, **kw)
            torch.cuda.synchronize()
            st_err = st_tol = 0.0
            gst = None
            if stats:
                (got, gst), (want, wst) = got, want
                st_err = (gst - wst).abs().max().item()
                st_tol = STATS_TOL * wst.abs().max().item()
                del wst
            ref = max(1.0, want.float().abs().max().item())
            err = (got.float() - want.float()).abs().max().item()
            tol = KERNEL_TOL[dtype] * ref
            del want
            reps = 3 if side == 96 else 10
            ms = cuda_ms(lambda: conv3x3(parts, w, b, **kw), reps, 1)
            plain_ms = cuda_ms(lambda: conv3x3_plain(parts, w, b, **kw),
                               reps, 1)
            x_cl = torch.cat(parts, dim=-1).permute(0, 4, 1, 2, 3)
            w_cl = w.to(dtype).contiguous(
                memory_format=torch.channels_last_3d)
            b_l = None if b is None else b.to(dtype)

            def library():
                y = torch.nn.functional.conv3d(x_cl, w_cl, b_l, padding=1)
                if stats:
                    torch.var_mean(y, dim=(2, 3, 4))

            library_ms = cuda_ms(library, reps, 1)
            del x_cl
            flops = 2.0 * got.numel() * 27 * cin
            bnd = bound(nbytes(*parts, got, gst, b, *(pro or ())[:3])
                        + w.numel() * got.element_size(), flops, dtype)
            name = (f"conv3x3 {tag} {str(dtype)[6:]} {chans}->{cout} at "
                    f"{CONV_N}x{side}^3")
            log(f"{name}: max_abs_err {err:.3e} (tol {tol:.3e})"
                + (f" stats err {st_err:.3e} (tol {st_tol:.3e})"
                   if stats else "")
                + f" kernel {ms:.4f} ms plain {plain_ms:.4f} ms library "
                f"{library_ms:.4f} ms bound {bnd['bound_ms']:.4f} ms "
                f"({bnd['bound_by']}), kernel {flops / ms / 1e9:.1f} "
                "TFLOP/s")
            if not (err <= tol and st_err <= st_tol
                    and torch.isfinite(got).all()):
                fail(f"{name} disagrees with its plain version")
            if (tag, dtype) == CONV_REPORT:
                report["conv3x3"] = dict(max_abs_err=err, ms=ms,
                                         plain_ms=plain_ms,
                                         library_ms=library_ms, **bnd)
            del parts, got, gst
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


def phase_small_diff_unet(dev: torch.device) -> None:
    from diff_unet_tpu_torch.models.diff_unet import DiffUNet
    from diff_unet_tpu_torch.utils.weights import init_random

    s, classes, fea = 32, 3, (8, 8, 16, 32, 64, 8)
    cpu = init_random(DiffUNet(classes, features=fea), SEED).eval()
    gpu = DiffUNet(classes, features=fea)
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
    log(f"small DiffUNet denoise (features {fea}, {s}^3, fp32, TF32 off) "
        f"cuda vs cpu: max_abs_err {err:.3e} (tol {MODEL_TOL:.0e}, max|y| "
        f"{want.abs().max().item():.3f})")
    if not (torch.isfinite(got).all() and err <= MODEL_TOL):
        fail("small DiffUNet on the card disagrees with the CPU")


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


def phase_serve(dev: torch.device, data: str, counters: dict,
                per_batch: int = 0) -> dict:
    """Serve the three synthetic volumes with a Predictor built from
    ``cfg/<data>/test.yaml``; ``counters`` maps kernel names to their
    wrappers, whose counts are set to 0 just before and read just after.
    ``per_batch`` > 0: each counter must equal it times the window
    batches."""
    from diff_unet_tpu_torch.engine.engine import Predictor

    pred = Predictor.from_config(
        ROOT / f"cfg/{data}/test.yaml", model_path=None,
        classes=str(ROOT / f"cfg/{data}/classes.yaml"), device=dev,
        seed=SEED)
    log(f"predictor: {pred.model_name}, {pred.num_classes} classes, roi "
        f"{pred._inferer.roi}, sw_batch_size {pred.sw_batch_size}, overlap "
        f"{pred.overlap}, dtype {pred.dtype}, "
        f"{sum(p.numel() for p in pred.module.parameters())} parameters")
    shapes = [(96, 192, 192), (80, 160, 176), (96, 96, 96)]
    volumes = [synthetic_ct(s, SEED + i, dev) for i, s in enumerate(shapes)]
    pred.infer(volumes[2])                 # warm-up: cuDNN plans, tables
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    for fn in counters.values():
        fn.launches = 0
    results, seconds = [], []
    for v in volumes:
        t0 = time.perf_counter()
        results.append(pred.serve([v])[0])
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    counts = {k: fn.launches for k, fn in counters.items()}

    steps = pred.seg.sample_steps
    batches = 0
    for shape, (logits, binary), sec in zip(shapes, results, seconds):
        roi_padded = tuple(max(r, s) for r, s in zip(pred._inferer.roi, shape))
        n_win = len(pred._inferer._starts(roi_padded))
        n_batch = sum(len(starts) for starts, _ in
                      pred._inferer._geometry(roi_padded))
        batches += n_batch
        log(f"volume {shape}: {n_win} windows in {n_batch} batches, "
            f"{sec:.3f} s, {n_win * steps / sec:.3f} DDIM window-steps/s")
        want = (*shape, pred.num_classes)
        if tuple(logits.shape) != want or tuple(binary.shape) != want:
            fail(f"output shape {tuple(logits.shape)} != {want}")
        if not torch.isfinite(logits).all():
            fail(f"non-finite logits for volume {shape}")
        if not ((binary == 0) | (binary == 1)).all():
            fail("binary output is not {0, 1}")
    log(f"peak device memory while serving: "
        f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB")
    log(f"launches during {data} serving ({batches} window batches): "
        f"{counts}")
    for k, c in counts.items():
        if c <= 0:
            fail(f"kernel {k} was not launched on the main path")
        if per_batch and c != per_batch * batches:
            fail(f"kernel {k}: {c} launches, predicted {per_batch} x "
                 f"{batches} = {per_batch * batches}")
    return counts


def main() -> None:
    card = phase_card()
    dev = torch.device("cuda", 0)
    phase_build()
    from diff_unet_tpu_torch.ops.conv3d import conv3x3
    from diff_unet_tpu_torch.ops.window_attention import window_attention
    from diff_unet_tpu_torch.ops.window_shift import shift_windows

    report = phase_kernels(dev)
    report.update(phase_conv(dev))
    phase_small_model(dev)
    phase_small_diff_unet(dev)
    counts = phase_serve(dev, "btcv", {"window_attention": window_attention,
                                       "shift_windows": shift_windows})
    # 10 TwoConv convs in the encoder, 18 in each of the 10 denoiser steps
    counts.update(phase_serve(dev, "amos", {"conv3x3": conv3x3},
                              per_batch=10 + 18 * 10))
    replaces = {
        "window_attention": ("diff_unet_tpu_torch/csrc/window_attention.cu",
                             "diff_unet_tpu/ops/pallas_attention.py:115"),
        "shift_windows": ("diff_unet_tpu_torch/csrc/window_shift.cu",
                          "diff_unet_tpu/ops/pallas_shift.py:71"),
        "conv3x3": ("diff_unet_tpu_torch/csrc/conv3d.cu",
                    "diff_unet_tpu/ops/pallas_packed_conv.py:132; "
                    "diff_unet_tpu/ops/pallas_packed_conv.py:241; "
                    "diff_unet_tpu/ops/pallas_aug_conv.py:65; "
                    "diff_unet_tpu/ops/pallas_conv.py:29"),
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
