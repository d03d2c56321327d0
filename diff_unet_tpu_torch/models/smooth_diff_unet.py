"""Smooth-Diff-UNet: a BasicUNet image encoder with a learnable Laplacian
smoothing before each ``Down``, and a layer-norm BasicUNet denoiser
(counterpart of ``diff_unet_tpu/models/smooth_diff_unet.py``, the
unpacked ``pack == 1`` execution; its pack-2 variants are TPU lane
layout).

``SmoothLayer`` computes x + w * laplacian6(x) with a zero boundary and a
learned (D, H, W, C) weight per level; ``FFParser`` is a learned complex
filter over the (H, W) spectrum of each depth slice, which the JAX
package provides but no model of it runs. Channel-last (NDHWC);
submodule and parameter names follow the flax scopes (``smooth_{i}/
weights``, ``weight_real``, ``weight_imag``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from diff_unet_tpu_torch.models.basic_unet import DEFAULT_FEATURES, \
    BasicUNetDenoiser, BasicUNetEncoder
from diff_unet_tpu_torch.models.diff_unet import DiffUNet


class SmoothLayer(nn.Module):
    """x + weights * laplacian6(x), zero-padded boundaries; ``weights`` is
    (D, H, W, C) float32, drawn as 0.5 * N(0, 1). The six neighbours are
    slices of one padded tensor, added in the JAX package's order; the
    Laplacian is computed in x's dtype, with the weights rounded to it."""

    def __init__(self, spatial_shape: Sequence[int], channels: int):
        super().__init__()
        self.weights = nn.Parameter(torch.empty(*spatial_shape, channels))
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.weights.normal_(0.0, 1.0, generator=generator).mul_(0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xp = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
        d, h, w = x.shape[1:4]
        lap = -6.0 * x
        for axis in (1, 2, 3):
            for off in (0, 2):
                sl = [slice(None), slice(1, d + 1), slice(1, h + 1),
                      slice(1, w + 1)]
                sl[axis] = slice(off, x.shape[axis] + off)
                lap = lap + xp[tuple(sl)]
        return x + lap * self.weights.to(x.dtype)


class FFParser(nn.Module):
    """A learned complex filter over the (H, W) spectrum of each depth
    slice: irfft2(rfft2(x) * (weight_real + i weight_imag)), orthonormal,
    in float32, returned in x's dtype. The weights are (D, H, W // 2 + 1,
    C), drawn as N(0, 0.02)."""

    def __init__(self, spatial_shape: Sequence[int], channels: int):
        super().__init__()
        d, h, w = spatial_shape
        self.hw = (h, w)
        self.weight_real = nn.Parameter(torch.empty(d, h, w // 2 + 1,
                                                    channels))
        self.weight_imag = nn.Parameter(torch.empty(d, h, w // 2 + 1,
                                                    channels))
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            for p in (self.weight_real, self.weight_imag):
                p.normal_(0.0, 0.02, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = torch.fft.rfft2(x.float(), dim=(2, 3), norm="ortho")
        xf = xf * torch.complex(self.weight_real.float(),
                                self.weight_imag.float())
        out = torch.fft.irfft2(xf, s=self.hw, dim=(2, 3), norm="ortho")
        return out.to(x.dtype)


def level_shapes(image_size: int, spatial_size: int
                 ) -> List[Tuple[int, int, int]]:
    """(D, H, W) of encoder levels 0-3 for a (spatial_size, image_size,
    image_size) window."""
    return [(spatial_size >> i, image_size >> i, image_size >> i)
            for i in range(4)]


class SmoothUNetEncoder(BasicUNetEncoder):
    """``BasicUNetEncoder`` with ``smooth_{i}`` applied to level i before
    ``down_{i+1}``. It returns the level maps as they leave their TwoConv,
    unsmoothed: the smoothing feeds only the next ``Down``."""

    def __init__(self, features: Sequence[int] = DEFAULT_FEATURES,
                 in_channels: int = 1, image_size: int = 96,
                 spatial_size: int = 96,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(features, in_channels, dtype=dtype)
        for i, shape in enumerate(level_shapes(image_size, spatial_size)):
            self.add_module(f"smooth_{i}",
                            SmoothLayer(shape, tuple(features)[i]))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs = [self.conv_0([x])]
        for i in range(4):
            s = getattr(self, f"smooth_{i}")(outs[i])
            outs.append(getattr(self, f"down_{i + 1}")(s))
        return outs


class SmoothDiffUNet(DiffUNet):
    """The smoothing encoder (``embed_model``) and a BasicUNet denoiser
    with layer norm (``model``) over [image, x_t] -> class logits; the
    methods are DiffUNet's."""

    def __init__(self, out_channels: int, in_channels: int = 1,
                 image_size: int = 96, spatial_size: int = 96,
                 features: Sequence[int] = DEFAULT_FEATURES,
                 dtype: Optional[torch.dtype] = None):
        nn.Module.__init__(self)
        self.embed_model = SmoothUNetEncoder(features, in_channels,
                                             image_size, spatial_size,
                                             dtype=dtype)
        self.model = BasicUNetDenoiser(out_channels,
                                       in_channels + out_channels, features,
                                       norm="layer", dtype=dtype)
