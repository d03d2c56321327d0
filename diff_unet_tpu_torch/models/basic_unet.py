"""BasicUNet image encoder and time-conditioned denoiser (counterpart of
``diff_unet_tpu/models/basic_unet.py``, unpacked execution only).

Channel-last (NDHWC); LeakyReLU slope 0.1; instance norm (the denoiser
also layer norm, ``norm="layer"``); default features (64, 64, 128, 256,
512, 64). Every 3x3x3 conv runs on the conv kernel through ``TwoConv``
(``ops/conv3d.py``), or with ``quantize`` W8A8 on its s8 instance
(``ops/int8.py``), as are the UpCat transposed convs; the 1x1 logits conv
stays float, as in the JAX package. Submodule names follow the flax
scopes.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from diff_unet_tpu_torch.ops.blocks import Conv, Down, TimestepEmbedder, \
    TwoConv, UpCat

DEFAULT_FEATURES = (64, 64, 128, 256, 512, 64)


class BasicUNetEncoder(nn.Module):
    """Five-level conv encoder; returns the feature map of every level."""

    def __init__(self, features: Sequence[int] = DEFAULT_FEATURES,
                 in_channels: int = 1, negative_slope: float = 0.1,
                 dtype: Optional[torch.dtype] = None,
                 quantize: bool = False):
        super().__init__()
        fea = tuple(features)
        self.conv_0 = TwoConv(in_channels, fea[0], use_temb=False,
                              negative_slope=negative_slope, dtype=dtype,
                              quantize=quantize)
        for i in range(1, 5):
            self.add_module(f"down_{i}", Down(
                fea[i - 1], fea[i], use_temb=False,
                negative_slope=negative_slope, dtype=dtype,
                quantize=quantize))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs = [self.conv_0([x])]
        for i in range(1, 5):
            outs.append(getattr(self, f"down_{i}")(outs[-1]))
        return outs


class BasicUNetDenoiser(nn.Module):
    """Time-conditioned UNet over [image, x_t] with the encoder's feature
    maps added at each level, four UpCat stages and a 1x1 conv to the class
    logits. ``in_channels`` is the channel count of the [image, x_t]
    concat (or of x_t alone); ``norm`` is every TwoConv's, "instance" or
    "layer"."""

    def __init__(self, out_channels: int, in_channels: int,
                 features: Sequence[int] = DEFAULT_FEATURES,
                 negative_slope: float = 0.1, norm: str = "instance",
                 dtype: Optional[torch.dtype] = None,
                 quantize: bool = False):
        super().__init__()
        fea = tuple(features)
        kw = dict(negative_slope=negative_slope, norm=norm, dtype=dtype,
                  quantize=quantize)
        self.temb = TimestepEmbedder(dtype=dtype)
        self.conv_0 = TwoConv(in_channels, fea[0], **kw)
        for i in range(1, 5):
            self.add_module(f"down_{i}", Down(fea[i - 1], fea[i], **kw))
        self.upcat_4 = UpCat(fea[4], fea[3], fea[4] // 2, fea[3], **kw)
        self.upcat_3 = UpCat(fea[3], fea[2], fea[3] // 2, fea[2], **kw)
        self.upcat_2 = UpCat(fea[2], fea[1], fea[2] // 2, fea[1], **kw)
        # last stage keeps the channel count (halves=False)
        self.upcat_1 = UpCat(fea[1], fea[0], fea[1], fea[5], **kw)
        self.final_conv = Conv(fea[5], out_channels, 1, dtype=dtype)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                embeddings: Optional[Sequence[torch.Tensor]] = None,
                image: Optional[torch.Tensor] = None) -> torch.Tensor:
        temb = self.temb(t)
        parts = [x] if image is None else [image, x]
        xs = [self.conv_0(parts, temb)]
        for i in range(1, 5):
            if embeddings is not None:
                xs[-1] = xs[-1] + embeddings[i - 1]
            xs.append(getattr(self, f"down_{i}")(xs[-1], temb))
        if embeddings is not None:
            xs[4] = xs[4] + embeddings[4]
        u = self.upcat_4(xs[4], xs[3], temb)
        u = self.upcat_3(u, xs[2], temb)
        u = self.upcat_2(u, xs[1], temb)
        u = self.upcat_1(u, xs[0], temb)
        return self.final_conv(u)
