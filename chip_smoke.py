"""Drive the PyTorch port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card, ``nvcc`` and
PyTorch built for CUDA. Phases, each of which must pass:

1. the card: name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``diff_unet_tpu_torch/csrc`` with ``nvcc``
   (one process per source, in parallel), print each kernel's ptxas
   registers and spills, and fail if the bf16 conv kernel spills;
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
   c. the window partition (zero padding fused) and its reverse (crop
      fused) at the four Swin stage geometries, B = 1 and 2, bf16 and fp32,
      bit-exact (library: ``index_select`` of the pre-padded token rows by
      the partition table);
   d. the backwards: the shift's backward kernel and the partition's
      adjoint pair against autograd through the plain versions, bit-exact;
      the attention's gradients (qkv and bias; the backward recomputes the
      plain version) at the four stage geometries of a training batch,
      within 1e-4 (fp32) and 3e-2 (bf16) of each gradient's max |g|; at
      stage 1 in bf16 also the library's backward (``torch.autograd.grad``
      through ``scaled_dot_product_attention`` with the f32 bias as a float
      ``attn_mask``) and the bytes bound of a backward;
4. small models on the card against the same weights on the CPU's plain
   path, fp32 with TF32 off: a DiffSwinUNETR denoiser step (feature 12,
   32^3), a DiffUNet denoiser step (features (8, 8, 16, 32, 64, 8), 32^3),
   and two DiffSwinUNETR train steps (feature 12, 32^3, the same t and
   noise): loss, grad norm, every gradient, and the parameters after them
   within 2 lr per step;
5. each slice at full width from the repository's config with seeded
   random weights:
   a. ``cfg/btcv/test.yaml`` (diff_swin_unetr, feature 48, 13 classes,
      96^3 ROI, sw_batch_size 2, overlap 0.25, DDIM-10, bf16): a
      ``Predictor`` serves synthetic CT volumes; each Swin kernel must have
      run its exact count per window batch;
   b. ``cfg/amos/test.yaml`` (diff_unet, features (64, 64, 128, 256, 512,
      64), 15 classes, 96^3 ROI, sw_batch_size 4, overlap 0.25, DDIM-10,
      bf16): the conv kernel must have run exactly 10 + 18 * 10 times per
      window batch;
   c. ``cfg/btcv/train.yaml`` (diff_swin_unetr, feature 48, 13 classes +
      background, 96^3 patches, batch 1, bf16 over fp32 parameters,
      mse+bce+dice, label smoothing, AdamW with warmup-cosine): a
      ``Trainer`` takes ``TRAIN_STEPS`` steps on synthetic batches
      (``max_epochs`` 1: the warmup does not depend on it); losses and
      grad norms finite, parameters moved, and each Swin kernel's exact
      count per step, forward and backward; then the median s/step of
      the trainer's step over the same batches with the card synchronised
      around each step, and the peak device memory of ``train()``.

Serving outputs are checked for shape, finiteness and a binary mask. Each
path is driven with its kernels' launch counters set to 0 just before it
and read just after. It prints one JSON line with the kernels (times,
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
HOLD_CYCLES = 100_000_000     # about 50 ms of the SM clock
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
# (stage, side of the stage's input, C, window) for a 96^3 ROI: 48^3 pads
# to 49^3, 24^3 to 28^3, 12^3 to 14^3; at 6^3 the window clamps to 6
PARTITION_CASES = [("stage1", 48, 48, 7), ("stage2", 24, 96, 7),
                   ("stage3", 12, 192, 7), ("stage4", 6, 384, 6)]
# (stage, BW, heads, N, shifted) of a training batch of one 96^3 patch
ATTN_GRAD_CASES = [("stage1", 343, 3, 343, True), ("stage2", 64, 6, 343, True),
                   ("stage3", 8, 12, 343, True), ("stage4", 1, 24, 216, False)]
TRAIN_STEPS = 8
# per window batch of BTCV serving (1 embed + 10 denoiser Swin passes of 4
# stages) and per BTCV train step (the encoder's and the denoiser's Swin
# pass): forward launches, and launches inside the backward
SERVE_PER_BATCH = {"window_attention": 88, "shift_windows": 66,
                   "window_partition": 44, "window_reverse": 44}
TRAIN_PER_STEP = {"window_attention": (16, 0), "shift_windows": (12, 12),
                  "window_partition": (8, 8), "window_reverse": (8, 8)}


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
    """Device ms per call: the stream is held by a spinning kernel while the
    host queues every call, so the events time the device and not the
    host's issue rate (a small kernel's wrapper takes longer on the host
    than the kernel on the card)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
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
    # ptxas -v: each entry function's properties (stack and spills), then
    # its registers; the bf16 conv kernels must not spill
    name = ""
    for line in _native.build_info["log"].splitlines():
        if "Function properties for" in line:
            name = line.split("Function properties for")[-1].strip()
        elif "spill" in line or "registers" in line:
            log(f"  ptxas: {name[:60]}: {line.strip()}")
            if ("conv3d_wgmma" in name and "spill" in line
                    and " 0 bytes spill stores, 0 bytes spill loads"
                    not in line):
                fail(f"the bf16 conv kernel spills: {name}: {line.strip()}")


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


def attention_backward_library_ms(qkv: torch.Tensor, bias: torch.Tensor,
                                  ids, cot: torch.Tensor) -> float:
    """``torch.autograd.grad`` of qkv and the f32 bias through
    ``scaled_dot_product_attention``, the bias (plus the region mask) as a
    float ``attn_mask`` in the compute dtype: the backward alone, on a
    graph built once."""
    bw, n, _, h, _ = qkv.shape
    q_in = qkv.detach().clone().requires_grad_()
    b_in = bias.detach().clone().requires_grad_()
    q, k, v = (q_in[:, :, i].transpose(1, 2) for i in range(3))
    mask = b_in[None]
    if ids is not None:
        region = torch.where(ids[:, None, :] != ids[:, :, None], -100.0, 0.0)
        mask = (mask + region[:, None]).repeat(bw // ids.shape[0], 1, 1, 1)
    out = torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask.to(qkv.dtype)).transpose(1, 2)
    return cuda_ms(lambda: torch.autograd.grad(
        out, (q_in, b_in), cot, retain_graph=True), reps=5, warmup=1)


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


def reset(counters: dict) -> None:
    for fn in counters.values():
        fn.launches = 0
        if hasattr(fn, "backward_launches"):
            fn.backward_launches = 0


def partition_tables(padded, ws, valid):
    """int64 (nW*N,) padded-voxel index of every window row, and (valid
    voxels,) window row of every voxel of the cropped volume."""
    from diff_unet_tpu_torch.ops.window_shift import partition_np

    size = int(np.prod(padded))
    table = partition_np(np.arange(size).reshape(padded), ws).reshape(-1)
    row = np.empty(size, np.int64)
    row[table] = np.arange(size)
    inv = row.reshape(padded)[:valid[0], :valid[1], :valid[2]].reshape(-1)
    return table.astype(np.int64), inv


def phase_partition(dev: torch.device) -> dict:
    """Kernel 7 (partition with the pad fused, reverse with the crop fused)
    against the plain versions at the four Swin stage geometries."""
    from diff_unet_tpu_torch.ops.window_partition import (
        partition_windows, partition_windows_plain, reverse_windows,
        reverse_windows_plain)

    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    report = {}
    for name, side, c, w in PARTITION_CASES:
        ws, dims = (w,) * 3, (side,) * 3
        pad = tuple((w - side % w) % w for _ in range(3))
        padded = tuple(side + p for p in pad)
        table, inv = (torch.from_numpy(a).to(dev)
                      for a in partition_tables(padded, ws, dims))
        for b in (1, 2):
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn((b, *dims, c), generator=g, device=dev
                                ).to(dtype)
                with torch.no_grad():
                    wt = partition_windows(x, ws, pad)
                    back = reverse_windows(wt, ws, padded, dims)
                exact = (torch.equal(wt, partition_windows_plain(x, ws, pad))
                         and torch.equal(back, reverse_windows_plain(
                             wt, ws, padded, dims))
                         and torch.equal(back, x))
                rows = torch.nn.functional.pad(
                    x, (0, 0, 0, pad[2], 0, pad[1], 0, pad[0])).view(b, -1, c)
                wrows = wt.view(b, -1, c)
                with torch.no_grad():
                    times = {
                        "window_partition": (
                            cuda_ms(lambda: partition_windows(x, ws, pad)),
                            cuda_ms(lambda: partition_windows_plain(x, ws,
                                                                    pad)),
                            cuda_ms(lambda: rows.index_select(1, table)),
                            bound(nbytes(x, wt), 0.0, dtype)),
                        "window_reverse": (
                            cuda_ms(lambda: reverse_windows(wt, ws, padded,
                                                            dims)),
                            cuda_ms(lambda: reverse_windows_plain(
                                wt, ws, padded, dims)),
                            cuda_ms(lambda: wrows.index_select(1, inv)),
                            # the valid rows read, the volume written
                            bound(2 * nbytes(x), 0.0, dtype)),
                    }
                for kernel, (ms, plain_ms, library_ms, bnd) in times.items():
                    tag = (f"{kernel} {name} {dims}->{padded} C={c} B={b} "
                           f"{str(dtype)[6:]}")
                    log(f"{tag}: bit-exact {exact} kernel {ms:.4f} ms plain "
                        f"{plain_ms:.4f} ms library {library_ms:.4f} ms bound "
                        f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
                    # the training batch's largest call is the one reported
                    if (name, b, dtype) == ("stage1", 1, torch.bfloat16):
                        report[kernel] = dict(
                            max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                            library_ms=library_ms, **bnd)
                if not exact:
                    fail(f"window partition {name} B={b} {dtype} is not "
                         "bit-exact")
                del x, wt, back, rows, wrows
    return report


def phase_backward(dev: torch.device) -> dict:
    """The shift's backward kernel and the partition pair's adjoints
    against autograd through the plain versions (bit-exact), and the
    attention's gradients at the training batch's stage geometries."""
    from diff_unet_tpu_torch.ops.swin import window_region_ids
    from diff_unet_tpu_torch.ops.window_attention import (
        window_attention, window_attention_plain)
    from diff_unet_tpu_torch.ops.window_partition import (
        partition_windows, partition_windows_plain)
    from diff_unet_tpu_torch.ops.window_shift import (
        shift_table, shift_windows, shift_windows_plain)

    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    report = {}
    for grid, c in SHIFT_CASES:
        ws, ss = (7, 7, 7), (3, 3, 3)
        inv = tuple(-s for s in ss)
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((int(np.prod(grid)), 343, c), generator=g,
                            device=dev).to(dtype)
            cot = torch.randn(x.shape, generator=g, device=dev).to(dtype)
            grads = []
            for fn in (shift_windows, shift_windows_plain):
                xg = x.clone().requires_grad_()
                fn(xg, ws, ss, grid).backward(cot)
                grads.append(xg.grad)
            exact = torch.equal(*grads)
            with torch.no_grad():
                ms = cuda_ms(lambda: shift_windows(cot, ws, inv, grid))
                plain_ms = cuda_ms(
                    lambda: shift_windows_plain(cot, ws, inv, grid))
                table = torch.from_numpy(shift_table(ws, inv, grid)).to(
                    dev).long()
                library_ms = cuda_ms(
                    lambda: cot.view(1, -1, c).index_select(1, table))
            # the cotangent read, the gradient written, the int32 table
            bnd = bound(2 * nbytes(cot) + 4 * table.numel(), 0.0, dtype)
            tag = f"shift_windows backward grid={grid} C={c} {str(dtype)[6:]}"
            log(f"{tag}: bit-exact {exact} kernel {ms:.4f} ms plain "
                f"{plain_ms:.4f} ms library {library_ms:.4f} ms bound "
                f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
            if not exact:
                fail(f"{tag} is not bit-exact")
            if grid == (7, 7, 7) and dtype == torch.bfloat16:
                report["shift_windows_backward"] = dict(
                    max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                    library_ms=library_ms, **bnd)
    for name, side, c, w in PARTITION_CASES:
        ws, dims = (w,) * 3, (side,) * 3
        pad = tuple((w - side % w) % w for _ in range(3))
        x = torch.randn((1, *dims, c), generator=g, device=dev
                        ).to(torch.bfloat16)
        xg, xp = x.clone().requires_grad_(), x.clone().requires_grad_()
        wt = partition_windows(xg, ws, pad)
        cot = torch.randn(wt.shape, generator=g, device=dev).to(x.dtype)
        wt.backward(cot)
        partition_windows_plain(xp, ws, pad).backward(cot)
        log(f"window_partition backward (window_reverse) {name}: bit-exact "
            f"{torch.equal(xg.grad, xp.grad)}")
        if not torch.equal(xg.grad, xp.grad):
            fail(f"window partition backward {name} is not bit-exact")
    for dtype in (torch.float32, torch.bfloat16):
        for name, bw, h, n, shifted in ATTN_GRAD_CASES:
            qkv = torch.randn((bw, n, 3, h, 16), generator=g, device=dev
                              ).to(dtype)
            bias = 0.5 * torch.randn((h, n, n), generator=g, device=dev)
            ids = None
            if shifted:
                grid = round(bw ** (1 / 3)) * 7
                ids = torch.from_numpy(window_region_ids(
                    (grid,) * 3, (7, 7, 7), (3, 3, 3))).to(dev)
            cot = torch.randn((bw, n, h, 16), generator=g, device=dev
                              ).to(dtype)
            grads, times = [], []
            for fn in (window_attention, window_attention_plain):
                q = qkv.clone().requires_grad_()
                b = bias.clone().requires_grad_()
                out = fn(q, b, ids)
                grads.append(torch.autograd.grad(out, (q, b), cot,
                                                 retain_graph=True))
                times.append(cuda_ms(lambda: torch.autograd.grad(
                    out, (q, b), cot, retain_graph=True), reps=5, warmup=1))
                del out
            errs = [((a.float() - w.float()).abs().max()
                     / w.float().abs().max()).item()
                    for a, w in zip(*grads)]
            tag = (f"window_attention backward {name} BW={bw} H={h} N={n} "
                   f"{str(dtype)[6:]}")
            extra = ""
            if name == "stage1" and dtype == torch.bfloat16:
                library_ms = attention_backward_library_ms(qkv, bias, ids,
                                                           cot)
                # qkv and dout read, dqkv and the f32 dbias written, once
                bnd = bound(2 * nbytes(qkv) + nbytes(cot, bias), 0.0, dtype)
                extra = (f", library {library_ms:.4f} ms, bound "
                         f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
            log(f"{tag}: qkv / bias grad err {errs[0]:.3e} / {errs[1]:.3e} "
                f"of max|g| (tol {ATTN_TOL[dtype]:.0e}); backward "
                f"(recompute) {times[0]:.4f} ms, plain backward "
                f"{times[1]:.4f} ms{extra}")
            if not max(errs) <= ATTN_TOL[dtype]:
                fail(f"{tag} disagrees with autograd through the plain "
                     "version")
            del qkv, bias, cot, grads
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


def phase_small_train(dev: torch.device) -> None:
    """Two train steps of a small DiffSwinUNETR on the card and on the CPU
    from the same weights, t and noise (fp32, TF32 off)."""
    from diff_unet_tpu_torch.api import DiffusionSegmenter
    from diff_unet_tpu_torch.engine.train import TrainStep, make_optimizer
    from diff_unet_tpu_torch.losses.losses import CompositeLoss
    from diff_unet_tpu_torch.models.swin_unetr import DiffSwinUNETR
    from diff_unet_tpu_torch.utils.weights import init_random

    s, classes, lr = 32, 3, 2e-4
    rng = np.random.default_rng(SEED)
    steps = [(rng.random((1, s, s, s, 1), np.float32),
              np.eye(classes, dtype=np.float32)[
                  rng.integers(0, classes, (1, s, s, s))],
              np.array([int(rng.integers(0, 1000))]),
              rng.standard_normal((1, s, s, s, classes), np.float32))
             for _ in range(2)]
    runs = []
    for where in (torch.device("cpu"), dev):
        model = init_random(DiffSwinUNETR(classes, image_size=(s,) * 3,
                                          feature_size=12), SEED).to(where)
        opt, schedule = make_optimizer(model.parameters(), lr=lr,
                                       weight_decay=1e-4)
        step = TrainStep(DiffusionSegmenter(model, classes),
                         CompositeLoss("mse,bce,dice", classes), opt,
                         schedule)
        record = []
        for image, labels, t, noise in steps:
            m = step(torch.from_numpy(image).to(where),
                     torch.from_numpy(labels).to(where),
                     t=torch.from_numpy(t).to(where),
                     noise=torch.from_numpy(noise).to(where))
            record.append((m["loss"].item(), m["grad_norm"].item(),
                           [p.grad.detach().cpu().clone()
                            for p in model.parameters()]))
        runs.append((record, [p.detach().cpu() for p in model.parameters()]))
    (cpu, cpu_params), (card, card_params) = runs
    worst = [0.0, 0.0, 0.0]            # loss / grad norm rel, grad vs tol
    for (lc, nc, gc), (lg, ng, gg) in zip(cpu, card):
        worst[0] = max(worst[0], abs(lg - lc) / abs(lc))
        worst[1] = max(worst[1], abs(ng - nc) / abs(nc))
        gmax = max(a.abs().max().item() for a in gc)
        for a, b in zip(gc, gg):
            # a tensor whose exact gradient is ~0 (a conv bias before an
            # instance norm) is judged on the model's gradient scale
            scale = max(a.abs().max().item(), 0.1 * gmax)
            worst[2] = max(worst[2], (b - a).abs().max().item() / scale)
    # Adam moves a weight by about lr wherever |g| >> eps, whatever |g|, so
    # a gradient at rounding noise (a conv bias before an instance norm)
    # may take the other sign on the card: 2 lr per step apart at most
    ptol = 2 * lr * len(steps)
    names = [n for n, _ in model.named_parameters()]
    perrs = [(a - b).abs().max().item()
             for a, b in zip(cpu_params, card_params)]
    i = int(np.argmax(perrs))
    gmax = max(a.abs().max().item() for a in cpu[-1][2])
    log(f"small model train steps (feature 12, {s}^3, fp32, TF32 off) cuda "
        f"vs cpu: loss rel {worst[0]:.3e}, grad norm rel {worst[1]:.3e} (tol "
        f"{MODEL_TOL:.0e}); worst gradient error {worst[2]:.3e} of max(|g| "
        f"max, 0.1 model max) (tol {MODEL_TOL:.0e}); parameters after "
        f"{len(steps)} steps {perrs[i]:.3e} (tol {ptol:.0e}), worst "
        f"{names[i]} whose last |g| max is "
        f"{cpu[-1][2][i].abs().max().item() / gmax:.1e} of the model's; "
        f"losses {[round(r[0], 6) for r in cpu]}")
    if not (max(worst) <= MODEL_TOL and perrs[i] <= ptol
            and all(np.isfinite(r[0]) for r in card)):
        fail("small DiffSwinUNETR train steps on the card disagree with the "
             "CPU")


def phase_serve(dev: torch.device, data: str, counters: dict,
                per_batch: dict) -> dict:
    """Serve the three synthetic volumes with a Predictor built from
    ``cfg/<data>/test.yaml``; ``counters`` maps kernel names to their
    wrappers, whose counts are set to 0 just before and read just after;
    each must equal ``per_batch[name]`` times the window batches."""
    from diff_unet_tpu_torch.data.synthetic import synthetic_ct
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

    reset(counters)
    results, seconds = [], []
    for v in volumes:
        t0 = time.perf_counter()
        results.append(pred.serve([v])[0])
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    counts = {k: fn.launches for k, fn in counters.items()}
    backward = {k: getattr(fn, "backward_launches", 0)
                for k, fn in counters.items()}

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
        if c != per_batch[k] * batches or backward[k]:
            fail(f"kernel {k}: {c} launches ({backward[k]} in a backward), "
                 f"predicted {per_batch[k]} x {batches} = "
                 f"{per_batch[k] * batches}")
    return {k: {f"{data}_serve": c} for k, c in counts.items()}


def phase_train(dev: torch.device, counters: dict) -> dict:
    """``Trainer.from_config("cfg/btcv/train.yaml")`` at full width on
    synthetic batches for ``TRAIN_STEPS`` steps; returns each counter's
    (forward, backward) launches."""
    from diff_unet_tpu_torch.data.synthetic import SyntheticSegmentation
    from diff_unet_tpu_torch.engine.engine import Trainer

    t0 = time.perf_counter()
    data = SyntheticSegmentation((96, 96, 96), num_labels=14, batch_size=1,
                                 batches=TRAIN_STEPS, seed=SEED)
    trainer = Trainer.from_config(
        ROOT / "cfg/btcv/train.yaml", train_data=data, device=dev,
        classes=str(ROOT / "cfg/btcv/classes.yaml"), seed=SEED,
        max_epochs=1)
    torch.cuda.synchronize()
    log(f"trainer: {trainer.model_name}, {trainer.num_classes} classes, "
        f"patch {trainer._inferer.roi}, batch {trainer.batch_size}, dtype "
        f"{trainer.dtype}, label smoothing {trainer.label_smoothing}, "
        f"{sum(p.numel() for p in trainer.module.parameters())} parameters; "
        f"set-up (data, smoothing, model) {time.perf_counter() - t0:.1f} s")
    before = [p.detach().clone() for p in trainer.module.parameters()]
    torch.cuda.reset_peak_memory_stats(dev)
    reset(counters)
    trainer.train()
    torch.cuda.synchronize()
    counts = {k: (fn.launches, getattr(fn, "backward_launches", 0))
              for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    hist = trainer.history
    moved = sum(int(not torch.equal(a, p))
                for a, p in zip(before, trainer.module.parameters()))
    log("train steps: " + "; ".join(
        f"loss {h['loss']:.5f} grad_norm {h['grad_norm']:.5f} lr "
        f"{h['lr']:.3e}" for h in hist))
    log(f"launches during BTCV training ({len(hist)} steps), (forward, "
        f"backward): {counts}")
    # s/step: the trainer's step over its batches once more, the card
    # synchronised before and after each step (after the counts are read)
    step_s = []
    for image, labels in trainer.batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(image, labels, generator=trainer.generator)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    log(f"train: median {np.median(step_s[1:]):.4f} s/step over steps "
        f"2..{len(step_s)} of a synchronised pass, {step_s}; peak device "
        f"memory {peak:.2f} GiB over the {len(hist)} steps of train(); "
        f"{moved} of {len(before)} parameter tensors moved")
    if len(hist) != TRAIN_STEPS:
        fail(f"the trainer took {len(hist)} steps, not {TRAIN_STEPS}")
    if not all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               and h["grad_norm"] > 0 for h in hist):
        fail("a train step has a non-finite loss or a zero grad norm")
    if hist[0]["lr"] != 0.0 or not moved:
        fail("the parameters did not move once the lr was above 0")
    for k, (fwd, bwd) in counts.items():
        want = tuple(n * len(hist) for n in TRAIN_PER_STEP[k])
        if (fwd, bwd) != want:
            fail(f"kernel {k}: {(fwd, bwd)} launches (forward, backward) in "
                 f"{len(hist)} steps, predicted {want}")
    return counts


def main() -> None:
    card = phase_card()
    dev = torch.device("cuda", 0)
    phase_build()
    from diff_unet_tpu_torch.ops.conv3d import conv3x3
    from diff_unet_tpu_torch.ops.window_attention import window_attention
    from diff_unet_tpu_torch.ops.window_partition import (
        partition_windows, reverse_windows)
    from diff_unet_tpu_torch.ops.window_shift import shift_windows

    report = phase_kernels(dev)
    report.update(phase_conv(dev))
    report.update(phase_partition(dev))
    report.update(phase_backward(dev))
    phase_small_model(dev)
    phase_small_diff_unet(dev)
    phase_small_train(dev)
    swin = {"window_attention": window_attention,
            "shift_windows": shift_windows,
            "window_partition": partition_windows,
            "window_reverse": reverse_windows}
    paths = {k: {} for k in (*swin, "shift_windows_backward", "conv3x3")}
    for k, v in phase_serve(dev, "btcv", swin, SERVE_PER_BATCH).items():
        paths[k].update(v)
    # 10 TwoConv convs in the encoder, 18 in each of the 10 denoiser steps
    paths["conv3x3"].update(phase_serve(dev, "amos", {"conv3x3": conv3x3},
                                        {"conv3x3": 10 + 18 * 10})["conv3x3"])
    paths["shift_windows_backward"]["btcv_serve"] = 0
    counts = phase_train(dev, swin)
    # the partition kernel runs forward and in the reverse's backward, and
    # the other way round; the shift's backward launch is reported apart
    for k in ("window_partition", "window_reverse"):
        paths[k]["btcv_train"] = sum(counts[k])
    paths["window_attention"]["btcv_train"] = counts["window_attention"][0]
    (paths["shift_windows"]["btcv_train"],
     paths["shift_windows_backward"]["btcv_train"]) = counts["shift_windows"]
    replaces = {
        "window_attention": ("diff_unet_tpu_torch/csrc/window_attention.cu",
                             "diff_unet_tpu/ops/pallas_attention.py:115"),
        "shift_windows": ("diff_unet_tpu_torch/csrc/window_shift.cu",
                          "diff_unet_tpu/ops/pallas_shift.py:71"),
        "shift_windows_backward": (
            "diff_unet_tpu_torch/csrc/window_shift.cu",
            "diff_unet_tpu/ops/pallas_shift.py:71 (its custom_vjp, :141-152)"),
        "window_partition": ("diff_unet_tpu_torch/csrc/window_partition.cu",
                             "benchmarks/pallas_partition_probe.py:54"),
        "window_reverse": ("diff_unet_tpu_torch/csrc/window_partition.cu",
                           "benchmarks/pallas_partition_probe.py:54 (its "
                           "inverse, diff_unet_tpu/ops/swin.py:95)"),
        "conv3x3": ("diff_unet_tpu_torch/csrc/conv3d.cu",
                    "diff_unet_tpu/ops/pallas_packed_conv.py:132; "
                    "diff_unet_tpu/ops/pallas_packed_conv.py:241; "
                    "diff_unet_tpu/ops/pallas_aug_conv.py:65; "
                    "diff_unet_tpu/ops/pallas_conv.py:29"),
    }
    # launches: this slice's main path (BTCV training) where the kernel
    # runs there, else its own slice's serving path
    kernels = [dict(name=k, route="cuda", source=src, replaces=rep,
                    launches=paths[k].get("btcv_train",
                                          paths[k].get("amos_serve")),
                    launches_by_path=paths[k], **report[k])
               for k, (src, rep) in replaces.items()]
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
