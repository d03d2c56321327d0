"""DiffUNet, the flagship diffusion segmentation model (counterpart of
``diff_unet_tpu/models/diff_unet.py``, the unpacked ``pack == 1``
execution): a BasicUNet image encoder (``embed_model``) and a BasicUNet
denoiser (``model``) over [image, x_t] -> class logits. ``quantize``
serves it W8A8 int8 (``ops/int8.py``): every 3x3x3 conv of both and the
denoiser's transposed convs (inference only)."""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from diff_unet_tpu_torch.models.basic_unet import DEFAULT_FEATURES, \
    BasicUNetDenoiser, BasicUNetEncoder


class DiffUNet(nn.Module):
    def __init__(self, out_channels: int, in_channels: int = 1,
                 features: Sequence[int] = DEFAULT_FEATURES,
                 dtype: Optional[torch.dtype] = None,
                 quantize: bool = False):
        super().__init__()
        self.out_channels = out_channels
        self.embed_model = BasicUNetEncoder(features, in_channels,
                                            dtype=dtype, quantize=quantize)
        self.model = BasicUNetDenoiser(out_channels,
                                       in_channels + out_channels, features,
                                       dtype=dtype, quantize=quantize)

    def forward(self, image, x, t):
        return self.denoise(image, x, t)

    def embed(self, image):
        return self.embed_model(image)

    def denoise(self, image, x, t):
        return self.model(x, t, self.embed_model(image), image)

    def denoise_with_embeddings(self, x, t, embeddings, image):
        """Denoiser only: the DDIM loop embeds each window once."""
        return self.model(x, t, embeddings, image)
