"""Attention-Diff-UNet: an attention-gated UNet as the diffusion denoiser
(counterpart of ``diff_unet_tpu/models/attention_diff_unet.py``).

Channel-last (NDHWC); features (32, 64, 128, 256, 512); submodule names
follow the flax scopes. Every 3x3x3 conv runs on the conv kernel
(``ops/conv3d.py:conv3x3``): a ``ConvBNReLU2`` takes its batch-norm
statistics from the kernel's per-(sample, channel) sums added over the
samples (``batch_affine_from_stats``), feeds the first norm and ReLU to
the second conv as its prologue, and ends in ``scale_shift_relu``;
``UpConv``'s conv does the same. The attention gates' 1x1 convs and their
``BatchStatsNorm``s, the sigmoid and the gating run in tensor code, as in
the JAX package, which computes them outside any Pallas kernel.

Batch norm takes its statistics from the batch in eval too (the JAX
package's documented deviation), so a window's logits depend on the other
windows of its batch.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from diff_unet_tpu_torch.models.diff_unet import DiffUNet
from diff_unet_tpu_torch.ops.blocks import BatchStatsNorm, Conv, \
    TimestepEmbedder, TwoConv, _compute_dtype, scale_shift_relu
from diff_unet_tpu_torch.ops.conv3d import batch_affine_from_stats, conv3x3

ATT_FEATURES = (32, 64, 128, 256, 512)


def _check_spatial(x: torch.Tensor, levels: int) -> None:
    """The nearest 2x upsample of a floor-pooled odd edge is a voxel short
    of the skip it is gated with, so the model takes only sizes that halve
    evenly ``levels - 1`` times (the JAX model fails there too)."""
    unit = 2 ** (levels - 1)
    if any(s % unit for s in x.shape[1:4]):
        raise ValueError(
            f"attention_diff_unet with {levels} levels needs spatial sizes "
            f"that are multiples of 2^{levels - 1} = {unit}, got "
            f"{tuple(x.shape[1:4])}")


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool3d(x.permute(0, 4, 1, 2, 3), 2).permute(0, 2, 3, 4, 1)


def upsample_nearest2(x: torch.Tensor) -> torch.Tensor:
    """``jax.image.resize(x, 2x, "nearest")`` over (D, H, W): at an exact
    2x, output voxel i takes input voxel i // 2."""
    n, d, h, w, c = x.shape
    return x[:, :, None, :, None, :, None].expand(
        n, d, 2, h, 2, w, 2, c).reshape(n, 2 * d, 2 * h, 2 * w, c)


def _conv_batch_affine(parts: List[torch.Tensor], conv: Conv,
                       norm: BatchStatsNorm, prologue=None):
    """The conv on the kernel, y, and ``norm`` as the per-channel affine
    (a, b) from the kernel's statistics."""
    y, st = conv3x3(parts, conv.weight, conv.bias, prologue=prologue,
                    with_stats=True)
    a, b = batch_affine_from_stats(st, norm.weight, norm.bias,
                                   math.prod(y.shape[1:4]))
    return y, (a, b)


class ConvBNReLU2(nn.Module):
    """(3x3x3 conv -> BatchStatsNorm -> ReLU) x 2, scopes ``conv_{i}`` and
    ``norm_{i}``; ``parts`` is the input as a list of tensors whose channel
    concat is the conv input (no concat is built). Fused: ``conv_0``
    returns its statistics; the first norm and ReLU run as ``conv_1``'s
    prologue (the per-channel affine broadcast to every sample, slope 0),
    rounded once where the JAX package rounds the norm's output;
    ``conv_1``'s norm and ReLU are ``scale_shift_relu``. The composition
    of the modules (``Conv``, ``BatchStatsNorm``, ReLU) is the reference
    it is held against."""

    def __init__(self, in_features: int, features: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.conv_0 = Conv(in_features, features, 3, dtype=dtype)
        self.norm_0 = BatchStatsNorm(features, dtype=dtype)
        self.conv_1 = Conv(features, features, 3, dtype=dtype)
        self.norm_1 = BatchStatsNorm(features, dtype=dtype)

    def forward(self, parts: List[torch.Tensor]) -> torch.Tensor:
        dt = _compute_dtype(self.dtype, parts[0], self.conv_0.weight)
        parts = [p.to(dt).contiguous() for p in parts]
        n = parts[0].shape[0]
        y0, (a0, b0) = _conv_batch_affine(parts, self.conv_0, self.norm_0)
        pro = (a0.expand(n, -1), b0.expand(n, -1), None, 0.0)
        y1, (a1, b1) = _conv_batch_affine([y0], self.conv_1, self.norm_1,
                                          pro)
        return scale_shift_relu(y1, a1, b1)


class UpConv(nn.Module):
    """Nearest 2x upsample -> 3x3x3 conv -> BatchStatsNorm -> ReLU (scopes
    ``conv``, ``norm``), the conv on the kernel with its statistics."""

    def __init__(self, in_features: int, features: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.conv = Conv(in_features, features, 3, dtype=dtype)
        self.norm = BatchStatsNorm(features, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(self.dtype, x, self.conv.weight)
        y, (a, b) = _conv_batch_affine([upsample_nearest2(x.to(dt))],
                                       self.conv, self.norm)
        return scale_shift_relu(y, a, b)


class AttentionCatLayer(nn.Module):
    """Upsample the deeper map (``up``), gate the skip x_e with psi =
    sigmoid(BN(psi(relu(BN(w_g(g)) + BN(w_x(x_e)))))) (1x1 convs), a
    ``ConvBNReLU2`` (``out``) over [x_e * psi, g], then the time-
    conditioned instance-norm ``TwoConv`` (``convs``) over [x_e, y]."""

    def __init__(self, in_features: int, cat_features: int,
                 out_features: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        f_int = out_features // 2
        self.up = UpConv(in_features, out_features, dtype=dtype)
        self.w_g = Conv(out_features, f_int, 1, dtype=dtype)
        self.w_g_norm = BatchStatsNorm(f_int, dtype=dtype)
        self.w_x = Conv(cat_features, f_int, 1, dtype=dtype)
        self.w_x_norm = BatchStatsNorm(f_int, dtype=dtype)
        self.psi = Conv(f_int, 1, 1, dtype=dtype)
        self.psi_norm = BatchStatsNorm(1, dtype=dtype)
        self.out = ConvBNReLU2(cat_features + out_features, out_features,
                               dtype=dtype)
        self.convs = TwoConv(cat_features + out_features, out_features,
                             dtype=dtype)

    def forward(self, x: torch.Tensor, x_e: torch.Tensor,
                temb: torch.Tensor) -> torch.Tensor:
        g = self.up(x)
        wg = self.w_g_norm(self.w_g(g))
        wx = self.w_x_norm(self.w_x(x_e))
        psi = torch.sigmoid(self.psi_norm(self.psi(F.relu(wg + wx))))
        y = self.out([x_e * psi, g])
        return self.convs([x_e, y], temb)


class AttentionUNetEncoder(nn.Module):
    """A ``ConvBNReLU2`` head, then (2x max-pool, ``ConvBNReLU2``) per
    level; returns every level's map."""

    def __init__(self, features: Sequence[int] = ATT_FEATURES,
                 in_channels: int = 1, dtype: Optional[torch.dtype] = None):
        super().__init__()
        fea = tuple(features)
        self.levels = len(fea)
        self.head = ConvBNReLU2(in_channels, fea[0], dtype=dtype)
        for i in range(len(fea) - 1):
            self.add_module(f"down_{i}", ConvBNReLU2(fea[i], fea[i + 1],
                                                     dtype=dtype))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        _check_spatial(x, self.levels)
        outs = [self.head([x])]
        for i in range(self.levels - 1):
            outs.append(getattr(self, f"down_{i}")([_max_pool(outs[-1])]))
        return outs


class AttentionUNetDecoder(nn.Module):
    """The denoiser over [image, x_t]: its own encoder chain with the image
    encoder's maps added at each level, attention-gated upsampling with the
    timestep embedding, and a 1x1 conv (``out``) to the class logits.
    ``in_channels`` is the channel count of the [image, x_t] concat."""

    def __init__(self, out_channels: int, in_channels: int,
                 features: Sequence[int] = ATT_FEATURES,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        fea = tuple(features)
        self.levels = len(fea)
        self.temb = TimestepEmbedder(dtype=dtype)
        self.head = ConvBNReLU2(in_channels, fea[0], dtype=dtype)
        for i in range(len(fea) - 1):
            self.add_module(f"down_{i}", ConvBNReLU2(fea[i], fea[i + 1],
                                                     dtype=dtype))
        rev = fea[::-1]
        ch = rev[0]
        for i in range(len(rev) - 1):
            out_ch = rev[i + 1] if rev[i] != rev[i + 1] else rev[i] * 2
            self.add_module(f"up_{i}", AttentionCatLayer(
                ch, rev[i + 1], out_ch, dtype=dtype))
            ch = out_ch
        self.out = Conv(ch, out_channels, 1, dtype=dtype)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                embeddings: Optional[Sequence[torch.Tensor]] = None,
                image: Optional[torch.Tensor] = None) -> torch.Tensor:
        _check_spatial(x, self.levels)
        temb = self.temb(t)
        feats = [self.head([x] if image is None else [image, x])]
        if embeddings is not None:
            feats[0] = feats[0] + embeddings[0]
        for i in range(self.levels - 1):
            h = getattr(self, f"down_{i}")([_max_pool(feats[-1])])
            if embeddings is not None:
                h = h + embeddings[i + 1]
            feats.append(h)
        feats = feats[::-1]
        y = feats[0]
        for i in range(self.levels - 1):
            y = getattr(self, f"up_{i}")(y, feats[i + 1], temb)
        return self.out(y)


class AttentionDiffUNet(DiffUNet):
    """The attention encoder (``embed_model``) and the attention denoiser
    (``model``) over [image, x_t] -> class logits; the methods are
    DiffUNet's."""

    def __init__(self, out_channels: int, in_channels: int = 1,
                 features: Sequence[int] = ATT_FEATURES,
                 dtype: Optional[torch.dtype] = None):
        nn.Module.__init__(self)
        self.embed_model = AttentionUNetEncoder(features, in_channels,
                                                dtype=dtype)
        self.model = AttentionUNetDecoder(out_channels,
                                          in_channels + out_channels,
                                          features, dtype=dtype)
