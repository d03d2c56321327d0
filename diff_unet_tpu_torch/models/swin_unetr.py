"""Swin-UNETR models (counterpart of ``diff_unet_tpu/models/swin_unetr.py``,
unpacked execution only): the diffusion model's image encoder,
time-conditioned denoiser and the two together (``DiffSwinUNETR``), and the
plain segmentation baseline (``SwinUNETR``).

Channel-last (NDHWC) throughout; LeakyReLU slope 0.01 in the UNETR
residual blocks; submodule names follow the flax scopes.

``quantize`` (DiffSwinUNETR, inference) runs every UNETR block's convs
W8A8, as the JAX package's ``quantize=True`` blocks do at ``pack=1``: the
3x3x3 convs on the s8 conv kernel (``ops/int8.py:conv3x3_int8``), the 1x1
residual projections as int8 GEMMs (``conv1x1_int8``); the Swin ViT, the
UpBlocks' transposed convs and the ``out`` head stay float.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from diff_unet_tpu_torch.ops.blocks import TEMB_FEATURES, Conv, \
    ConvTranspose, Dense, InstanceNorm, TimestepEmbedder, _quant_init, \
    norm_affine, quant_act_scale, quant_conv1x1, quant_conv3x3, swish
from diff_unet_tpu_torch.ops.int8 import apply_prologue, quantize_input
from diff_unet_tpu_torch.ops.swin import SwinTransformer

NEGATIVE_SLOPE = 0.01   # LeakyReLU of the UNETR blocks (MONAI dynunet)


class UnetResBlock(nn.Module):
    """conv -> norm -> lrelu [-> +t_proj] -> conv -> norm (+skip) -> lrelu.

    ``quantize`` (inference) runs conv1 and conv2 W8A8 on the s8 conv
    kernel with its statistics (int8 state ``conv1_*``, ``conv2_*``) and
    conv3, the 1x1 residual projection where Cin != Cout, as an int8 GEMM
    (``conv3_*``): norm1, LeakyReLU(0.01) and the t_proj add are conv2's
    input prologue, in the kernel with a recorded scale on conv2, else in
    tensor code (a dynamic scale is the abs-max of their output); norm2,
    norm3 and the tail run in tensor code. conv1 and conv3 read the same
    input, so their scales are one number (``conv1_sa``; JAX records it
    under both names): the input is quantized once, to an int8 tensor that
    both convs read. The
    input is a tensor or the list of parts whose channel concat it is,
    quantized in their promoted dtype (the JAX concat's); the outputs are
    in ``dtype`` or that one, as the JAX rescale gives them."""

    def __init__(self, in_channels: int, out_channels: int,
                 time_conditioned: bool = True,
                 dtype: Optional[torch.dtype] = None,
                 quantize: bool = False):
        super().__init__()
        self.dtype = dtype
        self.quantize = quantize
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
        if quantize:
            for prefix, *_ in self.int8_sites():
                _quant_init(self, prefix)
            # conv3 reads conv1's input, so it takes conv1's scale
            self.shared_scales = ({"conv3_": "conv1_"} if self.conv3
                                  is not None else {})

    def int8_sites(self):
        yield "conv1_", self.conv1.weight, 0
        yield "conv2_", self.conv2.weight, 0
        if self.conv3 is not None:
            yield "conv3_", self.conv3.weight, 0

    def forward(self, x: Union[torch.Tensor, Sequence[torch.Tensor]],
                temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.quantize:
            return self._forward_int8(
                [x] if isinstance(x, torch.Tensor) else list(x), temb)
        h = F.leaky_relu(self.norm1(self.conv1(x)), NEGATIVE_SLOPE)
        if self.t_proj is not None and temb is not None:
            proj = self.t_proj(swish(temb))
            h = h + proj[:, None, None, None, :].to(h.dtype)
        h = self.norm2(self.conv2(h))
        residual = x if self.conv3 is None else self.norm3(self.conv3(x))
        return F.leaky_relu(h + residual, NEGATIVE_SLOPE)

    def _forward_int8(self, parts, temb):
        pdt = functools.reduce(torch.promote_types, [p.dtype for p in parts])
        parts = [p.to(pdt) for p in parts]
        dt = self.dtype or pdt
        count = math.prod(parts[0].shape[1:4])
        sa = quant_act_scale(self, "conv1_", parts)
        conv1_in = parts
        if self.conv3 is not None:
            # conv3 reads conv1's input: one int8 tensor for both convs
            qs = quantize_input(parts, sa)
            conv1_in = [qs[0] if len(qs) == 1 else torch.cat(qs, -1)]
        # the convs in the JAX block's order: conv1, conv2, conv3
        y1, st1 = quant_conv3x3(self, "conv1_", self.conv1, conv1_in, dt,
                                sa=sa)
        film = None
        if self.t_proj is not None and temb is not None:
            film = self.t_proj(swish(temb)).to(dt)
        pro = (*norm_affine(self.norm1, st1, count, dt), film, NEGATIVE_SLOPE)
        if self.conv2_sa is None:
            # a dynamic scale is the abs-max of u: materialize it
            y2, st2 = quant_conv3x3(self, "conv2_", self.conv2,
                                    apply_prologue([y1], pro), dt)
        else:
            y2, st2 = quant_conv3x3(self, "conv2_", self.conv2, [y1], dt,
                                    prologue=pro)
        a2, b2 = norm_affine(self.norm2, st2, count, dt)
        h = y2 * a2[:, None, None, None] + b2[:, None, None, None]
        if self.conv3 is None:
            residual = parts[0]
        else:
            residual = self.norm3(quant_conv1x1(self, "conv3_", self.conv3,
                                                conv1_in[0], sa, dt))
        return F.leaky_relu(h + residual, NEGATIVE_SLOPE)


class UnetrBasicBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 time_conditioned: bool = True,
                 dtype: Optional[torch.dtype] = None,
                 quantize: bool = False):
        super().__init__()
        self.layer = UnetResBlock(in_channels, out_channels,
                                  time_conditioned, dtype=dtype,
                                  quantize=quantize)

    def forward(self, x, temb=None):
        return self.layer(x, temb)


class UnetrUpBlock(nn.Module):
    """2x transposed conv -> concat skip -> UnetResBlock (``quantize``: the
    block W8A8 over the parts [upsampled, skip], the transposed conv
    float)."""

    def __init__(self, in_channels: int, out_channels: int,
                 time_conditioned: bool = True,
                 dtype: Optional[torch.dtype] = None,
                 quantize: bool = False):
        super().__init__()
        self.transp_conv = ConvTranspose(in_channels, out_channels,
                                         dtype=dtype)
        self.conv_block = UnetResBlock(2 * out_channels, out_channels,
                                       time_conditioned, dtype=dtype,
                                       quantize=quantize)

    def forward(self, x, skip, temb=None):
        h = self.transp_conv(x)
        if self.conv_block.quantize:
            return self.conv_block([h, skip], temb)
        h = torch.cat([h, skip.to(h.dtype)], dim=-1)
        return self.conv_block(h, temb)


def reverse_attention(x: torch.Tensor) -> torch.Tensor:
    """r = x * (1 - sigmoid(x))."""
    return x * (1.0 - torch.sigmoid(x))


class SwinUNETREncoder(nn.Module):
    """Image embedder: un-timed Swin ViT + 4 conv encoders; returns
    (hidden_states, enc0, enc1, enc2, enc3)."""

    def __init__(self, feature_size: int = 48, in_channels: int = 1,
                 dtype: Optional[torch.dtype] = None,
                 quantize: bool = False):
        super().__init__()
        fs = feature_size
        kw = dict(dtype=dtype, quantize=quantize)
        self.swinViT = SwinTransformer(in_channels, fs, dtype=dtype)
        self.encoder1 = UnetrBasicBlock(in_channels, fs, False, **kw)
        self.encoder2 = UnetrBasicBlock(fs, fs, False, **kw)
        self.encoder3 = UnetrBasicBlock(2 * fs, 2 * fs, False, **kw)
        self.encoder4 = UnetrBasicBlock(4 * fs, 4 * fs, False, **kw)

    def forward(self, x: torch.Tensor):
        hidden = self.swinViT(x)
        return (tuple(hidden), self.encoder1(x), self.encoder2(hidden[0]),
                self.encoder3(hidden[1]), self.encoder4(hidden[2]))


class SwinUNETRDenoiser(nn.Module):
    """Time-conditioned Swin-UNETR denoiser with reverse-attention decoder
    residuals. Input is [image, x] concatenated on channels."""

    def __init__(self, out_channels: int, in_channels: int = 1,
                 feature_size: int = 48,
                 dtype: Optional[torch.dtype] = None,
                 quantize: bool = False):
        super().__init__()
        fs = feature_size
        cin = in_channels + out_channels
        kw = dict(dtype=dtype, quantize=quantize)
        self.t_embedder = TimestepEmbedder(dtype=dtype)
        self.swinViT = SwinTransformer(cin, fs, time_conditioned=True,
                                       dtype=dtype)
        self.encoder1 = UnetrBasicBlock(cin, fs, **kw)
        self.encoder2 = UnetrBasicBlock(fs, fs, **kw)
        self.encoder3 = UnetrBasicBlock(2 * fs, 2 * fs, **kw)
        self.encoder4 = UnetrBasicBlock(4 * fs, 4 * fs, **kw)
        self.encoder10 = UnetrBasicBlock(16 * fs, 16 * fs, **kw)
        self.decoder5 = UnetrUpBlock(16 * fs, 8 * fs, **kw)
        self.decoder4 = UnetrUpBlock(8 * fs, 4 * fs, **kw)
        self.decoder3 = UnetrUpBlock(4 * fs, 2 * fs, **kw)
        self.decoder2 = UnetrUpBlock(2 * fs, fs, **kw)
        self.decoder1 = UnetrUpBlock(fs, fs, **kw)
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
    (denoiser); ``quantize`` runs both's UNETR blocks W8A8 (inference)."""

    def __init__(self, out_channels: int, in_channels: int = 1,
                 image_size: Tuple[int, int, int] = (96, 96, 96),
                 feature_size: int = 48,
                 dtype: Optional[torch.dtype] = None,
                 quantize: bool = False):
        super().__init__()
        for m in image_size:
            if m % 32:
                raise ValueError("image size must be divisible by 2^5 for "
                                 f"the Swin pyramid, got {image_size}")
        self.out_channels = out_channels
        self.embed_model = SwinUNETREncoder(feature_size, in_channels,
                                            dtype=dtype, quantize=quantize)
        self.model = SwinUNETRDenoiser(out_channels, in_channels,
                                       feature_size, dtype=dtype,
                                       quantize=quantize)

    def forward(self, image, x, t):
        return self.denoise(image, x, t)

    def embed(self, image):
        return self.embed_model(image)

    def denoise(self, image, x, t):
        return self.model(x, t, self.embed_model(image), image)

    def denoise_with_embeddings(self, x, t, embeddings, image):
        return self.model(x, t, embeddings, image)


class SwinUNETR(nn.Module):
    """The plain (non-diffusion) Swin-UNETR segmentation baseline: the
    denoiser's topology without timestep conditioning, conditioning
    embeddings or reverse attention; image (N, D, H, W, Cin) -> logits
    (N, D, H, W, out_channels)."""

    def __init__(self, out_channels: int, in_channels: int = 1,
                 image_size: Tuple[int, int, int] = (96, 96, 96),
                 feature_size: int = 48,
                 depths: Tuple[int, ...] = (2, 2, 2, 2),
                 num_heads: Tuple[int, ...] = (3, 6, 12, 24),
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        for m in image_size:
            if m % 32:
                raise ValueError("image size must be divisible by 2^5 for "
                                 f"the Swin pyramid, got {image_size}")
        fs = feature_size
        self.swinViT = SwinTransformer(in_channels, fs, depths=depths,
                                       num_heads=num_heads, dtype=dtype)
        self.encoder1 = UnetrBasicBlock(in_channels, fs, False, dtype=dtype)
        self.encoder2 = UnetrBasicBlock(fs, fs, False, dtype=dtype)
        self.encoder3 = UnetrBasicBlock(2 * fs, 2 * fs, False, dtype=dtype)
        self.encoder4 = UnetrBasicBlock(4 * fs, 4 * fs, False, dtype=dtype)
        self.encoder10 = UnetrBasicBlock(16 * fs, 16 * fs, False,
                                         dtype=dtype)
        self.decoder5 = UnetrUpBlock(16 * fs, 8 * fs, False, dtype=dtype)
        self.decoder4 = UnetrUpBlock(8 * fs, 4 * fs, False, dtype=dtype)
        self.decoder3 = UnetrUpBlock(4 * fs, 2 * fs, False, dtype=dtype)
        self.decoder2 = UnetrUpBlock(2 * fs, fs, False, dtype=dtype)
        self.decoder1 = UnetrUpBlock(fs, fs, False, dtype=dtype)
        self.out = Conv(fs, out_channels, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hidden = self.swinViT(x)
        enc0 = self.encoder1(x)
        enc1 = self.encoder2(hidden[0])
        enc2 = self.encoder3(hidden[1])
        enc3 = self.encoder4(hidden[2])
        dec4 = self.encoder10(hidden[4])
        dec3 = self.decoder5(dec4, hidden[3])
        dec2 = self.decoder4(dec3, enc3)
        dec1 = self.decoder3(dec2, enc2)
        dec0 = self.decoder2(dec1, enc1)
        return self.out(self.decoder1(dec0, enc0))
