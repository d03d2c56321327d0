"""Offline W8A8 quantization of a serving model (counterpart of
``diff_unet_tpu/engine/quantize.py``).

A model built with ``quantize=True`` quantizes its conv kernels and takes
a dynamic activation scale in every forward unless its int8 state is
recorded (``ops/blocks.py``: buffers ``wq``, ``sw``, ``sa``, ``up_wq``,
``up_sw``, ``up_sa`` of DiffUNet; ``conv1_*``, ``conv2_*``, ``conv3_*`` of
DiffSwinUNETR's UNETR blocks). ``quantize_inference_params`` records it:

- always the int8 kernels and their per-Cout scales, from the float
  weights, so a serving forward never quantizes a weight again; any
  recorded activation scale is dropped;
- with ``calibration_images``, static activation scales: each window batch
  runs the real respaced DDIM trajectory from its x_T with dynamic scales,
  and each conv keeps the largest scale it saw over every step and image.

A static scale removes the abs-max reduction from each conv input and makes
a window's answer independent of its batch companions; dynamic scales are
batch statistics (one max over the whole window batch).
"""
from __future__ import annotations

from typing import Iterable, Optional, Sequence, Union

import torch
from torch import nn

from diff_unet_tpu_torch.api import DiffusionSegmenter
from diff_unet_tpu_torch.engine.sliding_window import volume_seed
from diff_unet_tpu_torch.ops.blocks import quant_sites
from diff_unet_tpu_torch.ops.int8 import quantize_kernel


def _segmenter(target) -> DiffusionSegmenter:
    if isinstance(target, DiffusionSegmenter):
        return target
    seg = getattr(target, "seg", None)            # an Engine
    if isinstance(seg, DiffusionSegmenter):
        return seg
    if isinstance(target, nn.Module):
        return DiffusionSegmenter(module=target,
                                  num_classes=target.out_channels)
    raise TypeError(f"expected an Engine, a DiffusionSegmenter or a "
                    f"quantized DiffUNet or DiffSwinUNETR, got "
                    f"{type(target).__name__}")


@torch.no_grad()
def quantize_inference_params(
        target: Union[nn.Module, DiffusionSegmenter, object],
        calibration_images: Optional[Iterable[torch.Tensor]] = None, *,
        noise: Optional[Sequence[torch.Tensor]] = None,
        seed: int = 0) -> nn.Module:
    """Record the int8 state of ``target``'s quantized module (an Engine,
    a ``DiffusionSegmenter`` or the module itself; a bare module is served
    by the default 1000-step, DDIM-10 schedule) and return the module.

    Each element of ``calibration_images`` is a window batch (s, D, H, W,
    1) on the module's device. Image i starts from x_T = ``noise[i]``
    (s, D, H, W, num_classes) when given, else from a generator seeded with
    ``volume_seed(seed, i)`` (the JAX package draws ``normal(fold_in(key(
    seed), i))``, which a test can pass as ``noise``)."""
    seg = _segmenter(target)
    sites = list(quant_sites(seg.module))
    if not sites:
        raise ValueError("the module has no int8 convs: build it with "
                         "quantize=True")
    for owner, prefix, weight, axis in sites:
        wq, sw = quantize_kernel(weight, axis)
        setattr(owner, prefix + "wq", wq)
        setattr(owner, prefix + "sw", sw)
        setattr(owner, prefix + "sa", None)
    if calibration_images is None:
        return seg.module
    owners = {id(o): o for o, *_ in sites}.values()
    try:
        for o in owners:
            o.calibration = {}
        for i, img in enumerate(calibration_images):
            shape = (img.shape[0], *img.shape[1:-1], seg.num_classes)
            if noise is not None:
                x_t = noise[i].to(img.device, torch.float32)
            else:
                g = torch.Generator(device=img.device)
                g.manual_seed(volume_seed(seed, i))
                x_t = torch.randn(shape, generator=g, device=img.device)
            if tuple(x_t.shape) != shape:
                raise ValueError(f"x_T of image {i} must be {shape}, got "
                                 f"{tuple(x_t.shape)}")
            seg.ddim_sample(img, noise=x_t)
        for o in owners:
            for prefix, sa in o.calibration.items():
                setattr(o, prefix + "sa", sa)
            for prefix, source in getattr(o, "shared_scales", {}).items():
                setattr(o, prefix + "sa", getattr(o, source + "sa"))
    finally:
        for o in owners:
            o.calibration = None
    return seg.module
