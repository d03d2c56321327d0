"""Channel-last (NDHWC) building blocks with flax's parameter names.

Counterparts of ``flax.linen`` ``Dense``/``Conv``/``ConvTranspose``/
``LayerNorm`` and of ``diff_unet_tpu/ops/blocks.py`` (``swish``,
``timestep_embedding``, ``TimestepEmbedder``, ``InstanceNorm``). Parameters
are float32; ``dtype`` is the compute dtype (bf16 under ``use_amp``), to
which inputs and weights are cast at each call, as flax does. ``None``
computes in the promoted dtype of input and weights.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

TEMB_DIM = 128
TEMB_FEATURES = 512
EPS = 1e-5              # LayerNorm and InstanceNorm epsilon


def _compute_dtype(dtype: Optional[torch.dtype], x: torch.Tensor,
                   w: torch.Tensor) -> torch.dtype:
    return dtype or torch.promote_types(x.dtype, w.dtype)


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None) -> None:
    """Truncated normal with variance 1/fan_in (flax ``lecun_normal``)."""
    std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


class Dense(nn.Module):
    """``nn.Dense``: y = x W^T + b; ``weight`` is (out, in)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = (nn.Parameter(torch.zeros(out_features)) if bias
                     else None)
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        lecun_normal_(self.weight.data, self.weight.shape[1], generator)
        if self.bias is not None:
            self.bias.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(self.dtype, x, self.weight)
        b = self.bias.to(dt) if self.bias is not None else None
        return F.linear(x.to(dt), self.weight.to(dt), b)


class Conv(nn.Module):
    """``nn.Conv`` over NDHWC: cubic kernel, 'SAME' (stride 1) or 'VALID'
    padding, zero-initialised bias; ``weight`` is (out, in, kd, kh, kw)."""

    def __init__(self, in_features: int, out_features: int, kernel: int = 3,
                 stride: int = 1, padding: str = "SAME",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if padding == "SAME" and stride != 1:
            raise NotImplementedError("SAME padding is ported for stride 1")
        self.dtype = dtype
        self.stride = stride
        self.padding = (kernel - 1) // 2 if padding == "SAME" else 0
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features, kernel, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        w = self.weight
        lecun_normal_(w.data, w.shape[1] * w.shape[2] * w.shape[3] * w.shape[4],
                      generator)
        self.bias.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(self.dtype, x, self.weight)
        # NDHWC storage viewed as NCDHW is PyTorch's channels_last_3d format
        y = F.conv3d(x.to(dt).permute(0, 4, 1, 2, 3), self.weight.to(dt),
                     self.bias.to(dt), stride=self.stride,
                     padding=self.padding)
        return y.permute(0, 2, 3, 4, 1)


class ConvTranspose(nn.Module):
    """``nn.ConvTranspose`` with kernel = stride = 2 over NDHWC; ``weight``
    is PyTorch's (in, out, 2, 2, 2) (flax's kernel spatially flipped)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(in_features, out_features, 2, 2, 2))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        lecun_normal_(self.weight.data, self.weight.shape[0] * 8, generator)
        self.bias.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(self.dtype, x, self.weight)
        y = F.conv_transpose3d(x.to(dt).permute(0, 4, 1, 2, 3),
                               self.weight.to(dt), self.bias.to(dt), stride=2)
        return y.permute(0, 2, 3, 4, 1)


class LayerNorm(nn.Module):
    """``nn.LayerNorm(epsilon=1e-5)`` over the last dim, f32 statistics."""

    def __init__(self, features: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight, self.bias,
                         EPS)
        return y.to(self.dtype or x.dtype)


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def timestep_embedding(t: torch.Tensor, dim: int = TEMB_DIM) -> torch.Tensor:
    """[sin(t*w), cos(t*w)], w = exp(-log(10000) * i / (dim/2 - 1)), for
    an even ``dim``."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / (half - 1))
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=1)


class TimestepEmbedder(nn.Module):
    """Sinusoidal embedding -> Dense -> swish -> Dense."""

    def __init__(self, embedding_dim: int = TEMB_DIM,
                 out_features: int = TEMB_FEATURES,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.embedding_dim = embedding_dim
        self.dense_0 = Dense(embedding_dim, out_features, dtype=dtype)
        self.dense_1 = Dense(out_features, out_features, dtype=dtype)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        x = timestep_embedding(t, self.embedding_dim)
        return self.dense_1(swish(self.dense_0(x)))


class InstanceNorm(nn.Module):
    """Instance norm over the spatial dims of NDHWC, affine, eps 1e-5.

    One-pass f32 statistics as in the JAX package: var = E[x^2] - E[x]^2
    clamped at 0, with the affine folded into one multiply-add in the
    compute dtype. Written by hand: ``F.instance_norm`` rejects 1^3 maps."""

    def __init__(self, features: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        axes: Sequence[int] = tuple(range(1, x.dim() - 1))
        xf = x.float()
        mean = xf.mean(dim=axes, keepdim=True)
        ex2 = (xf * xf).mean(dim=axes, keepdim=True)
        var = torch.clamp(ex2 - mean * mean, min=0.0)
        inv = torch.rsqrt(var + EPS)
        scale = inv * self.weight.float()
        a = scale.to(x.dtype)
        b = (self.bias.float() - mean * scale).to(x.dtype)
        return (x * a + b).to(self.dtype or x.dtype)
