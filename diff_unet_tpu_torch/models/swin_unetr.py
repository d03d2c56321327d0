"""Diffusion Swin-UNETR: image encoder, time-conditioned denoiser, and the
two together (counterpart of ``diff_unet_tpu/models/swin_unetr.py``,
unpacked execution only).

Channel-last (NDHWC) throughout; LeakyReLU slope 0.01 in the UNETR
residual blocks; submodule names follow the flax scopes.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from diff_unet_tpu_torch.ops.blocks import TEMB_FEATURES, Conv, \
    ConvTranspose, Dense, InstanceNorm, TimestepEmbedder, swish
from diff_unet_tpu_torch.ops.swin import SwinTransformer

NEGATIVE_SLOPE = 0.01   # LeakyReLU of the UNETR blocks (MONAI dynunet)


class UnetResBlock(nn.Module):
    """conv -> norm -> lrelu [-> +t_proj] -> conv -> norm (+skip) -> lrelu."""

    def __init__(self, in_channels: int, out_channels: int,
                 time_conditioned: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = Conv(in_channels, out_channels, 3, dtype=dtype)
        self.norm1 = InstanceNorm(out_channels, dtype=dtype)
        self.t_proj = (Dense(TEMB_FEATURES, out_channels, dtype=dtype)
                       if time_conditioned else None)
        self.conv2 = Conv(out_channels, out_channels, 3, dtype=dtype)
        self.norm2 = InstanceNorm(out_channels, dtype=dtype)
        if in_channels != out_channels:
            self.conv3 = Conv(in_channels, out_channels, 1, dtype=dtype)
            self.norm3 = InstanceNorm(out_channels, dtype=dtype)
        else:
            self.conv3 = self.norm3 = None

    def forward(self, x: torch.Tensor,
                temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = F.leaky_relu(self.norm1(self.conv1(x)), NEGATIVE_SLOPE)
        if self.t_proj is not None and temb is not None:
            proj = self.t_proj(swish(temb))
            h = h + proj[:, None, None, None, :].to(h.dtype)
        h = self.norm2(self.conv2(h))
        residual = x if self.conv3 is None else self.norm3(self.conv3(x))
        return F.leaky_relu(h + residual, NEGATIVE_SLOPE)


class UnetrBasicBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 time_conditioned: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.layer = UnetResBlock(in_channels, out_channels,
                                  time_conditioned, dtype=dtype)

    def forward(self, x, temb=None):
        return self.layer(x, temb)


class UnetrUpBlock(nn.Module):
    """2x transposed conv -> concat skip -> UnetResBlock."""

    def __init__(self, in_channels: int, out_channels: int,
                 time_conditioned: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.transp_conv = ConvTranspose(in_channels, out_channels,
                                         dtype=dtype)
        self.conv_block = UnetResBlock(2 * out_channels, out_channels,
                                       time_conditioned, dtype=dtype)

    def forward(self, x, skip, temb=None):
        h = self.transp_conv(x)
        h = torch.cat([h, skip.to(h.dtype)], dim=-1)
        return self.conv_block(h, temb)


def reverse_attention(x: torch.Tensor) -> torch.Tensor:
    """r = x * (1 - sigmoid(x))."""
    return x * (1.0 - torch.sigmoid(x))


class SwinUNETREncoder(nn.Module):
    """Image embedder: un-timed Swin ViT + 4 conv encoders; returns
    (hidden_states, enc0, enc1, enc2, enc3)."""

    def __init__(self, feature_size: int = 48, in_channels: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        fs = feature_size
        self.swinViT = SwinTransformer(in_channels, fs, dtype=dtype)
        self.encoder1 = UnetrBasicBlock(in_channels, fs, False, dtype=dtype)
        self.encoder2 = UnetrBasicBlock(fs, fs, False, dtype=dtype)
        self.encoder3 = UnetrBasicBlock(2 * fs, 2 * fs, False, dtype=dtype)
        self.encoder4 = UnetrBasicBlock(4 * fs, 4 * fs, False, dtype=dtype)

    def forward(self, x: torch.Tensor):
        hidden = self.swinViT(x)
        return (tuple(hidden), self.encoder1(x), self.encoder2(hidden[0]),
                self.encoder3(hidden[1]), self.encoder4(hidden[2]))


class SwinUNETRDenoiser(nn.Module):
    """Time-conditioned Swin-UNETR denoiser with reverse-attention decoder
    residuals. Input is [image, x] concatenated on channels."""

    def __init__(self, out_channels: int, in_channels: int = 1,
                 feature_size: int = 48,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        fs = feature_size
        cin = in_channels + out_channels
        self.t_embedder = TimestepEmbedder(dtype=dtype)
        self.swinViT = SwinTransformer(cin, fs, time_conditioned=True,
                                       dtype=dtype)
        self.encoder1 = UnetrBasicBlock(cin, fs, dtype=dtype)
        self.encoder2 = UnetrBasicBlock(fs, fs, dtype=dtype)
        self.encoder3 = UnetrBasicBlock(2 * fs, 2 * fs, dtype=dtype)
        self.encoder4 = UnetrBasicBlock(4 * fs, 4 * fs, dtype=dtype)
        self.encoder10 = UnetrBasicBlock(16 * fs, 16 * fs, dtype=dtype)
        self.decoder5 = UnetrUpBlock(16 * fs, 8 * fs, dtype=dtype)
        self.decoder4 = UnetrUpBlock(8 * fs, 4 * fs, dtype=dtype)
        self.decoder3 = UnetrUpBlock(4 * fs, 2 * fs, dtype=dtype)
        self.decoder2 = UnetrUpBlock(2 * fs, fs, dtype=dtype)
        self.decoder1 = UnetrUpBlock(fs, fs, dtype=dtype)
        self.out = Conv(fs, out_channels, 1, dtype=dtype)

    def forward(self, x, t, embeddings=None, image=None):
        temb = self.t_embedder(t)
        if image is not None:
            x = torch.cat([image, x.to(image.dtype)], dim=-1)
        hidden = self.swinViT(x, temb)
        if embeddings is not None:
            hidden = [h + c for h, c in zip(hidden, embeddings[0])]
        encs = []
        for i, (blk, inp) in enumerate(zip(
                (self.encoder1, self.encoder2, self.encoder3, self.encoder4),
                (x, hidden[0], hidden[1], hidden[2]))):
            e = blk(inp, temb)
            encs.append(e if embeddings is None else e + embeddings[1 + i])
        enc0, enc1, enc2, enc3 = encs
        dec4 = self.encoder10(hidden[4], temb)
        dec3 = self.decoder5(dec4, hidden[3], temb)
        dec2 = self.decoder4(dec3, enc3, temb) + reverse_attention(enc3)
        dec1 = self.decoder3(dec2, enc2, temb) + reverse_attention(enc2)
        dec0 = self.decoder2(dec1, enc1, temb) + reverse_attention(enc1)
        out = self.decoder1(dec0, enc0, temb) + reverse_attention(enc0)
        return self.out(out)


class DiffSwinUNETR(nn.Module):
    """Diffusion Swin-UNETR: ``embed_model`` (encoder) + ``model``
    (denoiser)."""

    def __init__(self, out_channels: int, in_channels: int = 1,
                 image_size: Tuple[int, int, int] = (96, 96, 96),
                 feature_size: int = 48,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        for m in image_size:
            if m % 32:
                raise ValueError("image size must be divisible by 2^5 for "
                                 f"the Swin pyramid, got {image_size}")
        self.embed_model = SwinUNETREncoder(feature_size, in_channels,
                                            dtype=dtype)
        self.model = SwinUNETRDenoiser(out_channels, in_channels,
                                       feature_size, dtype=dtype)

    def forward(self, image, x, t):
        return self.denoise(image, x, t)

    def embed(self, image):
        return self.embed_model(image)

    def denoise(self, image, x, t):
        return self.model(x, t, self.embed_model(image), image)

    def denoise_with_embeddings(self, x, t, embeddings, image):
        return self.model(x, t, embeddings, image)
