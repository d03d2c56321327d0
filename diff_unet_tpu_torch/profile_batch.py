"""Profile one sliding-window batch of the port's serving path, or one
train step of its training path, on the card.

    python -m diff_unet_tpu_torch.profile_batch amos [--out FILE]
    python -m diff_unet_tpu_torch.profile_batch btcv [--out FILE]
    python -m diff_unet_tpu_torch.profile_batch btcv_train [--out FILE]

``btcv_train`` builds the ``Trainer`` of ``cfg/btcv/train.yaml`` on
synthetic batches (``data/synthetic.py``) and profiles its train step
(q_sample, denoise, loss, backward, AdamW) the same way.

Builds the ``Predictor`` of ``cfg/<data>/test.yaml`` with seeded random
weights and runs what it runs for each window batch: the image embedding
and the DDIM loop over ``sw_batch_size`` windows of the ROI (stitching
excluded). After two warm-up batches it times three batches without the
profiler (host clock ended by ``torch.cuda.synchronize()``), then traces one
with ``torch.profiler`` (CPU and CUDA activities). It prints the card, the
un-profiled seconds per batch, the traced batch's summed device time and
the device's busy share (device time over un-profiled wall time), and the
top device kernels by summed device time; ``--out`` gets the whole
``key_averages`` table (CPU operators and kernels). For a model built from
``TwoConv`` blocks (DiffUNet) it also counts the 3x3x3 conv operations of
a batch (forward hooks on the blocks' outputs) and sets them beside the
conv kernel's device time and the bf16 peak. Needs a CUDA card; it fails
without one.
"""
from __future__ import annotations

import argparse
import subprocess
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
PEAK_BF16_FLOP_PER_S = 989e12      # H100 SXM, dense (NVIDIA data sheet)


def _device_us(evt, self_only: bool) -> float:
    """Device time of a profiler average in microseconds (the attribute is
    ``device_time`` in newer PyTorch, ``cuda_time`` in older)."""
    for name in ("device_time", "cuda_time"):
        attr = f"self_{name}_total" if self_only else f"{name}_total"
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    raise AttributeError("profiler event has no device time")


def _window_batch(dev: torch.device, data: str):
    """The Predictor of ``cfg/<data>/test.yaml`` and one window batch of
    its serving path."""
    from diff_unet_tpu_torch.engine.engine import Predictor

    pred = Predictor.from_config(
        ROOT / f"cfg/{data}/test.yaml", model_path=None,
        classes=str(ROOT / f"cfg/{data}/classes.yaml"), device=dev, seed=0)
    sw, roi = pred.sw_batch_size, pred._inferer.roi
    g = torch.Generator(device=dev).manual_seed(0)
    windows = torch.rand((sw, *roi, 1), generator=g, device=dev)
    noise = torch.randn((sw, *roi, pred.num_classes), generator=g,
                        device=dev)

    def batch():
        with torch.inference_mode():
            return pred.seg.ddim_sample(windows, noise=noise)

    return pred, batch, (f"one window batch of {sw} x {roi} (embed + "
                         f"DDIM-{pred.seg.sample_steps})")


def _train_step(dev: torch.device):
    """The Trainer of ``cfg/btcv/train.yaml`` and one of its train steps
    on a synthetic batch."""
    from diff_unet_tpu_torch.data.synthetic import SyntheticSegmentation
    from diff_unet_tpu_torch.engine.engine import Trainer

    trainer = Trainer.from_config(
        ROOT / "cfg/btcv/train.yaml", device=dev, seed=0, max_epochs=1,
        classes=str(ROOT / "cfg/btcv/classes.yaml"),
        train_data=SyntheticSegmentation((96, 96, 96), batches=1))
    image, labels = trainer.batches[0]

    def step():
        return trainer.train_step(image, labels,
                                  generator=trainer.generator)

    return trainer, step, (f"one train step of batch {trainer.batch_size} "
                           f"x {trainer._inferer.roi} (label smoothing "
                           f"{trainer.label_smoothing})")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("data", choices=("amos", "btcv", "btcv_train"))
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_batch needs a CUDA card")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from diff_unet_tpu_torch.ops.blocks import TwoConv

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    if args.data == "btcv_train":
        pred, batch, what = _train_step(dev)
    else:
        pred, batch, what = _window_batch(dev, args.data)

    conv_flops = [0.0]

    def count(mod, args, out):
        parts = args[0] if isinstance(args[0], (list, tuple)) else [args[0]]
        cin, cout = sum(p.shape[-1] for p in parts), out.shape[-1]
        conv_flops[0] += 2.0 * out.numel() * 27 * (cin + cout)

    hooks = [m.register_forward_hook(count) for m in pred.module.modules()
             if isinstance(m, TwoConv)]
    batch()
    for h in hooks:
        h.remove()
    batch()
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        batch()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        batch()
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    # a user annotation's device row (``Optimizer.step#AdamW.step``) spans
    # kernels that have rows of their own: count the kernels only (an
    # annotation is flagged, or shares its name with its host-side range)
    host = {e.key for e in avgs if e.device_type == DeviceType.CPU}
    kernels = [e for e in avgs if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e.key not in host]
    device_ms = sum(_device_us(e, True) for e in kernels) / 1e3
    wall_ms = min(walls) * 1e3
    print(card)
    print(f"{pred.model_name} ({args.data}): {what}, dtype {pred.dtype}")
    print(f"un-profiled wall per {args.data} unit: "
          f"{', '.join(f'{w * 1e3:.1f}' for w in walls)} ms")
    print(f"traced device time: {device_ms:.1f} ms; busy share "
          f"{device_ms / wall_ms:.3f} of the fastest un-profiled one")
    if conv_flops[0]:
        sw = pred.sw_batch_size
        conv_ms = sum(_device_us(e, True) for e in kernels
                      if "conv3d_" in e.key) / 1e3
        print(f"3x3x3 conv work per batch: {conv_flops[0] / 1e12:.3f} TFLOP "
              f"({conv_flops[0] / sw / 1e12:.3f} per window); conv kernel "
              f"{conv_ms:.1f} ms ({conv_ms / device_ms:.1%} of the device "
              f"time) = "
              f"{conv_flops[0] / conv_ms / 1e9:.1f} TFLOP/s; bound at the "
              f"bf16 peak {conv_flops[0] / PEAK_BF16_FLOP_PER_S * 1e3:.1f} ms")
    rows = sorted(kernels, key=lambda e: _device_us(e, True), reverse=True)
    print(f"{'device ms':>10} {'share':>7} {'calls':>6}  kernel")
    for e in rows[:args.top]:
        us = _device_us(e, True)
        print(f"{us / 1e3:10.2f} {us / 1e3 / device_ms:7.1%} "
              f"{e.count:6d}  {e.key[:90]}")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        sort = ("self_device_time_total"
                if hasattr(rows[0], "self_device_time_total")
                else "self_cuda_time_total")
        table = avgs.table(sort_by=sort, row_limit=200)
        args.out.write_text(f"{card}\n{table}")


if __name__ == "__main__":
    main()
