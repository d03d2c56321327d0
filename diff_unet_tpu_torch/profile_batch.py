"""Profile one sliding-window batch of the port's serving path, or one
train step of its training path, on the card.

    python -m diff_unet_tpu_torch.profile_batch amos [--out FILE]
    python -m diff_unet_tpu_torch.profile_batch btcv [--out FILE]
    python -m diff_unet_tpu_torch.profile_batch swin_unetr [--out FILE]
    python -m diff_unet_tpu_torch.profile_batch btcv_train [--out FILE]
    python -m diff_unet_tpu_torch.profile_batch amos_train [--out FILE]
    python -m diff_unet_tpu_torch.profile_batch msd_train [--out FILE]
    python -m diff_unet_tpu_torch.profile_batch swin_unetr_train [--out FILE]
    python -m diff_unet_tpu_torch.profile_batch smooth_serve [--out FILE]
    python -m diff_unet_tpu_torch.profile_batch smooth_train [--out FILE]
    python -m diff_unet_tpu_torch.profile_batch attention_serve [--out FILE]
    python -m diff_unet_tpu_torch.profile_batch int8_serve [--out FILE]
    python -m diff_unet_tpu_torch.profile_batch int8_static_serve [--out FILE]
    python -m diff_unet_tpu_torch.profile_batch btcv_int8_serve [--out FILE]
    python -m diff_unet_tpu_torch.profile_batch btcv_int8_static_serve [--out FILE]
    python -m diff_unet_tpu_torch.profile_batch attention_train [--out FILE]
    python -m diff_unet_tpu_torch.profile_batch mim_train [--out FILE]

The ``_train`` modes build the ``Trainer`` of ``cfg/btcv/train.yaml``
(batch 1, 14 label values), ``cfg/amos/train.yaml`` (batch 10, 16 label
values; ``smooth_train`` and ``attention_train`` with that
``model_name``),
``cfg/msd/train.yaml`` (batch 4, 3 label values) or the BTCV
config with ``model_name=swin_unetr`` on synthetic batches
(``data/synthetic.py``) and profile its train step (q_sample, denoise,
loss, backward, AdamW; the plain model: forward, loss, backward, AdamW)
the same way. ``mim_train`` profiles one HybridMIM pretraining step of
``pretrain_mim`` at its defaults (batch 2 of 64^3, float32).

The others build the ``Predictor`` of ``cfg/<data>/test.yaml`` (``swin_unetr``:
the BTCV config with that model; ``smooth_serve``, ``attention_serve``:
the AMOS config with ``smooth_diff_unet`` or ``attention_diff_unet``;
``int8_serve``: the AMOS config with ``quantize``, W8A8 int8 with dynamic
scales; ``int8_static_serve``: the same with static scales calibrated on
the profiled batch's own trajectory; ``btcv_int8_serve`` and
``btcv_int8_static_serve``: the same on the BTCV config's DiffSwinUNETR)
with seeded random weights and run
what
it runs for each window batch: the image embedding and the DDIM loop over
``sw_batch_size`` windows of the ROI, or the plain model's one forward
(stitching excluded). After two warm-up batches it times three batches without the
profiler (host clock ended by ``torch.cuda.synchronize()``), then traces one
with ``torch.profiler`` (CPU and CUDA activities). It prints the card, the
un-profiled seconds per batch, the traced batch's summed device time and
the device's busy share (device time over un-profiled wall time), and the
top device kernels by summed device time; ``--out`` gets the whole
``key_averages`` table (CPU operators and kernels). For a model built from
``TwoConv`` blocks (DiffUNet, SmoothDiffUNet; AttentionDiffUNet also from
``ConvBNReLU2`` and ``UpConv``) it also counts the 3x3x3 conv operations
of a batch (forward hooks on the blocks' outputs) and sets them beside
the conv kernels' device time (each conv kernel named with its own time:
``mim_train``'s are the 3xTF32 instances) and the peak of the compute
dtype (bf16; float32 as 3xTF32 on the tensor cores, with the FFMA peak
beside it; int8 for a quantized model). Needs a CUDA card; it fails
without one.
"""
from __future__ import annotations

import argparse
import subprocess
import time
from pathlib import Path
from types import SimpleNamespace

import torch

ROOT = Path(__file__).resolve().parents[1]
# H100 SXM, dense (NVIDIA data sheet): bf16 tensor cores, float32 FFMA;
# the float32 convs run as 3xTF32 (three tf32 products at 495 TFLOP/s a
# float32 product)
PEAK_FLOP_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12,
                   torch.int8: 1979e12}
TF32X3_FLOP_PER_S = 495e12 / 3


def _device_us(evt, self_only: bool) -> float:
    """Device time of a profiler average in microseconds (the attribute is
    ``device_time`` in newer PyTorch, ``cuda_time`` in older)."""
    for name in ("device_time", "cuda_time"):
        attr = f"self_{name}_total" if self_only else f"{name}_total"
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    raise AttributeError("profiler event has no device time")


# the config and model of each mode's name
_CONFIGS = {"btcv": ("btcv", {}), "amos": ("amos", {}), "msd": ("msd", {}),
            "swin_unetr": ("btcv", {"model_name": "swin_unetr"}),
            "smooth": ("amos", {"model_name": "smooth_diff_unet"}),
            "attention": ("amos", {"model_name": "attention_diff_unet"}),
            "int8": ("amos", {"quantize": True}),
            "int8_static": ("amos", {"quantize": True}),
            "btcv_int8": ("btcv", {"quantize": True}),
            "btcv_int8_static": ("btcv", {"quantize": True})}


def _window_batch(dev: torch.device, data: str):
    """The Predictor of ``cfg/<data>/test.yaml`` and one window batch of
    its serving path."""
    from diff_unet_tpu_torch.api import PlainSegmenter
    from diff_unet_tpu_torch.engine.engine import Predictor

    cfg, extra = _CONFIGS[data]
    pred = Predictor.from_config(
        ROOT / f"cfg/{cfg}/test.yaml", model_path=None,
        classes=str(ROOT / f"cfg/{cfg}/classes.yaml"), device=dev, seed=0,
        **extra)
    sw, roi = pred.sw_batch_size, pred._inferer.roi
    g = torch.Generator(device=dev).manual_seed(0)
    windows = torch.rand((sw, *roi, 1), generator=g, device=dev)
    noise = torch.randn((sw, *roi, pred.num_classes), generator=g,
                        device=dev)

    if data.endswith("int8_static"):
        from diff_unet_tpu_torch.engine.quantize import \
            quantize_inference_params
        quantize_inference_params(pred, [windows], noise=[noise])

    if isinstance(pred.seg, PlainSegmenter):
        def batch():
            with torch.inference_mode():
                return pred.seg.predict(windows)

        return pred, batch, f"one window batch of {sw} x {roi} (a forward)"

    def batch():
        with torch.inference_mode():
            return pred.seg.ddim_sample(windows, noise=noise)

    return pred, batch, (f"one window batch of {sw} x {roi} (embed + "
                         f"DDIM-{pred.seg.sample_steps})")


# labels of the synthetic batches (the classes table's entries) and batch
# size of each train config
_TRAIN = {"btcv": (14, 1), "amos": (16, 10), "msd": (3, 4),
          "swin_unetr": (14, 1), "smooth": (16, 10), "attention": (16, 10)}


def _train_step(dev: torch.device, data: str):
    """The Trainer of ``cfg/<data>/train.yaml`` and one of its train steps
    on a synthetic batch."""
    from diff_unet_tpu_torch.data.synthetic import SyntheticSegmentation
    from diff_unet_tpu_torch.engine.engine import Trainer

    labels, batch = _TRAIN[data]
    cfg, extra = _CONFIGS[data]
    trainer = Trainer.from_config(
        ROOT / f"cfg/{cfg}/train.yaml", device=dev, seed=0, max_epochs=1,
        classes=str(ROOT / f"cfg/{cfg}/classes.yaml"),
        train_data=SyntheticSegmentation((96, 96, 96), num_labels=labels,
                                         batch_size=batch, batches=1),
        **extra)
    image, labels = trainer.batches[0]

    def step():
        return trainer.train_step(image, labels,
                                  generator=trainer.generator)

    return trainer, step, (f"one train step of batch {trainer.batch_size} "
                           f"x {trainer._inferer.roi} (label smoothing "
                           f"{trainer.label_smoothing})")


def _mim_step(dev: torch.device):
    """``pretrain_mim``'s pretrainer at its defaults and one of its steps
    on a synthetic batch."""
    from diff_unet_tpu_torch.pretrain_mim import build, synthetic_batch

    model, step = build(device=dev)
    x = synthetic_batch(torch.Generator(device=dev).manual_seed(0), 2, 64)
    info = SimpleNamespace(module=model, model_name="hybrid_mim",
                           dtype=torch.float32)
    return info, lambda: step(x), ("one pretraining step of batch 2 x "
                                   "64^3 (mask patch 16)")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("data", choices=(
        "amos", "btcv", "swin_unetr", "smooth_serve", "attention_serve",
        "int8_serve", "int8_static_serve", "btcv_int8_serve",
        "btcv_int8_static_serve",
        *(f"{k}_train" for k in _TRAIN), "mim_train"))
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_batch needs a CUDA card")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from diff_unet_tpu_torch.models.attention_diff_unet import \
        ConvBNReLU2, UpConv
    from diff_unet_tpu_torch.ops.blocks import TwoConv

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    train = args.data.endswith("_train")
    if args.data == "mim_train":
        pred, batch, what = _mim_step(dev)
    elif train:
        pred, batch, what = _train_step(dev, args.data[:-len("_train")])
    else:
        pred, batch, what = _window_batch(dev, args.data.removesuffix(
            "_serve"))

    conv_flops = [0.0]
    # the stems' inputs need no grad
    stems = ("embed_model.conv_0", "model.conv_0", "embed_model.head",
             "model.head", "conv_0")

    def counter(name):
        def count(mod, args, out):
            parts = (args[0] if isinstance(args[0], (list, tuple))
                     else [args[0]])
            cin, cout = sum(p.shape[-1] for p in parts), out.shape[-1]
            # an UpConv runs one conv (on its upsampled input)
            f0, f1 = (2.0 * out.numel() * 27 * c for c in (
                cin, 0 if isinstance(mod, UpConv) else cout))
            # a train step adds the wgrad of both convs and the dgrad of
            # all but a stem's first, where the pass has a gradient
            conv_flops[0] += ((3 * f0 + 3 * f1 - (f0 if name in stems
                                                   else 0.0))
                              if train and torch.is_grad_enabled()
                              else f0 + f1)
        return count

    hooks = [m.register_forward_hook(counter(name))
             for name, m in pred.module.named_modules()
             if isinstance(m, (TwoConv, ConvBNReLU2, UpConv))]
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
        conv_ms = sum(_device_us(e, True) for e in kernels
                      if "conv3d_" in e.key) / 1e3
        per = ("forward, dgrad and wgrad" if train else
               f"{conv_flops[0] / pred.sw_batch_size / 1e12:.3f} per "
               "window")
        dt = (torch.int8 if getattr(pred, "quantize", False)
              else torch.bfloat16 if pred.dtype == torch.bfloat16
              else torch.float32)
        print(f"3x3x3 conv work per {args.data} unit: "
              f"{conv_flops[0] / 1e12:.3f} TFLOP ({per}); conv kernels "
              f"{conv_ms:.1f} ms ({conv_ms / device_ms:.1%} of the device "
              f"time) = "
              f"{conv_flops[0] / conv_ms / 1e9:.1f} TFLOP/s; bound at the "
              f"{str(dt)[6:]} peak "
              f"{conv_flops[0] / PEAK_FLOP_PER_S[dt] * 1e3:.1f} ms"
              + (f", at the 3xTF32 rate "
                 f"{conv_flops[0] / TF32X3_FLOP_PER_S * 1e3:.1f} ms"
                 if dt == torch.float32 else ""))
        for e in sorted((e for e in kernels if "conv3d_" in e.key),
                        key=lambda e: _device_us(e, True), reverse=True):
            print(f"  conv kernel {_device_us(e, True) / 1e3:8.2f} ms "
                  f"{e.count:5d} calls  {e.key[:110]}")
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
