"""Channel-last (NDHWC) building blocks with flax's parameter names.

Counterparts of ``flax.linen`` ``Dense``/``Conv``/``ConvTranspose``/
``LayerNorm`` and of ``diff_unet_tpu/ops/blocks.py`` (``swish``,
``timestep_embedding``, ``TimestepEmbedder``, ``InstanceNorm``,
``BatchStatsNorm``, flax's default ``nn.LayerNorm`` over channels
(``ChannelLayerNorm``), and the DiffUNet blocks ``ConvNormAct``,
``TwoConv``, ``Down``, ``UpCat`` with instance or layer norm and
LeakyReLU, and their W8A8 int8 execution, ``quantize``), and
``scale_shift_relu``, the batch norm's per-channel affine and ReLU on a
conv's output. Parameters
are float32; ``dtype`` is the compute dtype (bf16 under ``use_amp``), to
which inputs and weights are cast at each call, as flax does. ``None``
computes in the promoted dtype of input and weights.
"""
from __future__ import annotations

import functools
import math
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from diff_unet_tpu_torch.ops.conv3d import _acc_dtype, conv3x3, \
    norm_affine_from_stats
from diff_unet_tpu_torch.ops.int8 import QUANT_ON_LOAD, act_scale, \
    apply_prologue, conv1x1_int8, conv3x3_int8, deconv2_int8, \
    quantize_act, quantize_input, quantize_kernel

TEMB_DIM = 128
TEMB_FEATURES = 512
EPS = 1e-5              # LayerNorm, InstanceNorm and BatchStatsNorm epsilon
LN_EPS = 1e-6           # ChannelLayerNorm: flax nn.LayerNorm's default
NORMS = ("instance", "layer")


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


class BatchStatsNorm(nn.Module):
    """Batch norm from the current batch, without running averages, in
    training and in eval alike (the JAX package's documented deviation
    from torch's eval mode, keeping the model stateless): statistics over
    the samples and the voxels in float32 (float64 stays float64), the
    two-pass variance mean((x - mean)^2), epsilon 1e-5, the affine in
    float32, the result rounded to the compute dtype. Unfused: the
    attention gates use it, and the fused conv chains of
    ``models/attention_diff_unet.py`` are held against it."""

    def __init__(self, features: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        acc = _acc_dtype(x.dtype)
        axes = tuple(range(x.dim() - 1))
        xf = x.to(acc)
        mean = xf.mean(dim=axes, keepdim=True)
        var = torch.square(xf - mean).mean(dim=axes, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + EPS)
        y = y * self.weight.to(acc) + self.bias.to(acc)
        return y.to(self.dtype or x.dtype)


def _scale_shift_relu(y, a, b):
    return torch.relu(torch.addcmul(b, y, a)).to(y.dtype)


class _ScaleShiftReLU(torch.autograd.Function):
    """``scale_shift_relu`` with a backward that keeps only y (which the
    conv before it saves anyway) and the output: autograd through the
    float32 expression would keep two float32 copies of the map."""

    @staticmethod
    def forward(ctx, y, a, b):
        z = _scale_shift_relu(y, a, b)
        ctx.save_for_backward(y, a, z)
        return z

    @staticmethod
    def backward(ctx, dz):
        y, a, z = ctx.saved_tensors
        t = torch.where(z > 0, dz, 0).to(a.dtype)
        needs = ctx.needs_input_grad
        dy = (t * a).to(y.dtype) if needs[0] else None
        da = (t * y).sum((0, 1, 2, 3)) if needs[1] else None
        db = t.sum((0, 1, 2, 3)) if needs[2] else None
        return dy, da, db


def scale_shift_relu(y: torch.Tensor, a: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """relu(y * a + b) over the channels of NDHWC y with (C,) a and b:
    computed in a's dtype (float32, or float64) and rounded once to y's,
    where the JAX package rounds its batch norm's output; a ReLU commutes
    with that rounding."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (y, a, b)):
        return _ScaleShiftReLU.apply(y, a, b)
    return _scale_shift_relu(y, a, b)


class _LayerNormAct(torch.autograd.Function):
    """``layer_norm_act``'s forward with a backward that recomputes the
    normalised values from x and the saved per-voxel (mean, 1/std): only
    those two float32 values a voxel are kept beside x, which the conv
    before it saves anyway."""

    @staticmethod
    def forward(ctx, x, gamma, beta, const, slope):
        mean, rstd = _ln_stats(x)
        z = _ln_tail(x, mean, rstd, gamma, beta, const, slope)
        ctx.slope = slope
        ctx.const_dtype = None if const is None else const.dtype
        ctx.save_for_backward(x, gamma, beta, mean, rstd)
        return z

    @staticmethod
    def backward(ctx, dz):
        x, gamma, beta, mean, rstd = ctx.saved_tensors
        slope = ctx.slope
        acc = _acc_dtype(x.dtype)
        needs = ctx.needs_input_grad
        dz = dz.to(acc)
        dconst = dz.sum((1, 2, 3)) if needs[3] else None
        xhat = (x.to(acc) - mean) * rstd
        dy = dz
        if slope is not None:
            # y >= 0 takes the identity, as jax.nn.leaky_relu does
            y = _ln_tail(x, mean, rstd, gamma, beta, None, None)
            dy = torch.where(y >= 0, dz, dz * slope)
        dgamma = (dy * xhat).sum((0, 1, 2, 3)) if needs[1] else None
        dbeta = dy.sum((0, 1, 2, 3)) if needs[2] else None
        dx = None
        if needs[0]:
            dxhat = dy * gamma.to(acc)
            dx = rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                         - xhat * (dxhat * xhat).mean(-1, keepdim=True))
            dx = dx.to(x.dtype)
        return (dx, None if dgamma is None else dgamma.to(gamma.dtype),
                None if dbeta is None else dbeta.to(beta.dtype),
                None if dconst is None else dconst.to(ctx.const_dtype), None)


def _ln_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-voxel mean and 1/sqrt(var + 1e-6) over the channels, with
    flax's one-pass variance E[x^2] - E[x]^2 clamped at 0, in float32
    (float64 for float64 x)."""
    xf = x.to(_acc_dtype(x.dtype))
    mean = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean,
                      min=0.0)
    return mean, torch.rsqrt(var + LN_EPS)


def _ln_tail(x, mean, rstd, gamma, beta, const, slope):
    """The normalised, scaled and shifted x (flax's order: (x - mean) *
    (rstd * gamma) + beta, in float32) rounded to x's dtype, then the
    LeakyReLU and the add of ``const`` (N, C) in that dtype."""
    acc = _acc_dtype(x.dtype)
    y = ((x.to(acc) - mean) * (rstd * gamma.to(acc)) + beta.to(acc)
         ).to(x.dtype)
    if slope is not None:
        y = F.leaky_relu(y, slope)
    if const is not None:
        y = y + const.to(x.dtype)[:, None, None, None, :]
    return y


def layer_norm_act(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   slope: Optional[float] = None,
                   const: Optional[torch.Tensor] = None) -> torch.Tensor:
    """flax ``nn.LayerNorm()`` over the channels of NDHWC x (epsilon 1e-6,
    the one-pass variance E[x^2] - E[x]^2 clamped at 0, float32 statistics;
    float64 stays float64), then LeakyReLU(``slope``) and + ``const``
    (N, C), with the JAX package's rounding points: the norm's output is
    rounded to x's dtype, the activation and the add run in it."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, gamma, beta,
                                                          const)):
        return _LayerNormAct.apply(x, gamma, beta, const, slope)
    return _ln_tail(x, *_ln_stats(x), gamma, beta, const, slope)


class ChannelLayerNorm(nn.Module):
    """flax ``nn.LayerNorm()`` at its defaults over the last dim of NDHWC:
    epsilon 1e-6 and the one-pass variance (``layer_norm_act``). The Swin
    ``LayerNorm`` above (epsilon 1e-5, two-pass) is another function."""

    def __init__(self, features: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_act(x, self.weight, self.bias).to(
            self.dtype or x.dtype)


# ---- W8A8 int8 state (the JAX package's flax "quant" collection) ----
#
# A quantized conv keeps its recorded state in non-persistent buffers named
# after the JAX package's sow names: ``wq`` (the int8 kernel, in the float
# kernel's layout), ``sw`` (its (Cout,) float32 scales) and ``sa`` (the
# static activation scale) on ``ConvNormAct``; ``up_wq``, ``up_sw`` and
# ``up_sa`` on ``UpCat`` for its transposed conv; ``conv1_*``, ``conv2_*``
# and ``conv3_*`` on the Swin-UNETR ``UnetResBlock``. Checkpoints never
# carry them. Unrecorded, each forward quantizes the kernel and takes a
# dynamic scale in the graph; ``engine/quantize.py`` records them. Each
# quantized module lists its int8 convs in ``int8_sites()``, and in
# ``shared_scales`` ({prefix: source prefix}) the convs that read another's
# input and so take its activation scale, recorded as the same tensor.


def _quant_init(mod: nn.Module, prefix: str) -> None:
    for name in ("wq", "sw", "sa"):
        mod.register_buffer(prefix + name, None, persistent=False)
    # while calibrating: {prefix: max dynamic scale seen}, else None
    mod.calibration = None


def quant_weights(mod: nn.Module, prefix: str, weight: torch.Tensor,
                  out_axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recorded (int8 kernel, scales), or the kernel quantized now."""
    wq = getattr(mod, prefix + "wq")
    if wq is not None:
        return wq, getattr(mod, prefix + "sw")
    return quantize_kernel(weight, out_axis)


def quant_act_scale(mod: nn.Module, prefix: str,
                    parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The recorded static scale, or the dynamic one of these parts (one
    scale over their concat), which a calibration pass keeps the max of."""
    sa = getattr(mod, prefix + "sa")
    if sa is not None:
        return sa
    sa = act_scale(parts)
    if mod.calibration is not None:
        seen = mod.calibration.get(prefix)
        mod.calibration[prefix] = sa if seen is None else torch.maximum(
            seen, sa)
    return sa


def norm_affine(norm: nn.Module, stats: torch.Tensor, count: int,
                dt: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """``InstanceNorm`` ``norm`` as the (N, C) affine (a, b) from a conv's
    statistics over ``count`` voxels, rounded to the compute dtype ``dt``
    as the norm rounds it."""
    a, b = norm_affine_from_stats(stats, norm.weight, norm.bias, count)
    return a.to(dt), b.to(dt)


def quant_conv3x3(mod: nn.Module, prefix: str, conv: nn.Module,
                  parts: Sequence[torch.Tensor], out_dtype: torch.dtype,
                  prologue=None, sa: Optional[torch.Tensor] = None):
    """The W8A8 3x3x3 conv of ``mod``'s int8 site ``prefix`` (float
    ``conv``) over the parts' concat, with its (N, 2, Cout) statistics:
    int8 parts with their scale ``sa``, or float parts with one activation
    scale over all of them (``sa``, or the site's own), each quantized in
    its dtype by the s8 kernel as it loads them, after the norm
    ``prologue`` (a, b, film, slope) where one is given (which needs a
    recorded scale: a dynamic one is the abs-max of the parts as given).
    float64 parts (the CPU's exact parity dtype, which the kernel does not
    take) are quantized here first, as the JAX blocks quantize before
    ``conv_int8``: the int8 input stands at the conv's boundary, where the
    parity tests read it."""
    wq, sw = quant_weights(mod, prefix, conv.weight, 0)
    if sa is None:
        sa = quant_act_scale(mod, prefix, parts)
    if parts[0].dtype not in (torch.int8, *QUANT_ON_LOAD):
        parts, prologue = quantize_input(parts, sa, prologue), None
    return conv3x3_int8(parts, wq, sa, sw, conv.bias, out_dtype,
                        with_stats=True, prologue=prologue)


def quant_conv1x1(mod: nn.Module, prefix: str, conv: nn.Module,
                  xq: torch.Tensor, sa: torch.Tensor,
                  out_dtype: torch.dtype) -> torch.Tensor:
    """The W8A8 1x1x1 conv of ``mod``'s int8 site ``prefix`` (float
    ``conv``) of int8 ``xq`` quantized with ``sa``, rescaled to
    ``out_dtype``."""
    wq, sw = quant_weights(mod, prefix, conv.weight, 0)
    return conv1x1_int8(xq, wq, sa, sw, conv.bias, out_dtype)


def quant_sites(module: nn.Module):
    """(owner, prefix, float kernel, Cout axis) of every int8 conv of
    ``module``, as each quantized module lists them (``int8_sites``)."""
    for m in module.modules():
        if getattr(m, "quantize", False) and hasattr(m, "int8_sites"):
            for prefix, weight, axis in m.int8_sites():
                yield m, prefix, weight, axis


class ConvNormAct(nn.Module):
    """Conv3D(k3, same, bias) -> norm -> LeakyReLU, unfused (MONAI 'NDA'
    order); ``norm`` is "instance" (``InstanceNorm``) or "layer"
    (``ChannelLayerNorm``), both in scope ``norm``. ``TwoConv`` runs these
    parameters through the conv kernel; this composition is the reference
    it is held against. ``quantize`` adds the int8 state (``wq``, ``sw``,
    ``sa``) and ``conv_int8``."""

    def __init__(self, in_features: int, features: int,
                 negative_slope: float = 0.1, norm: str = "instance",
                 dtype: Optional[torch.dtype] = None,
                 quantize: bool = False):
        super().__init__()
        if norm not in NORMS:
            raise NotImplementedError(f"norm {norm!r} (ported: {NORMS})")
        self.negative_slope = negative_slope
        self.quantize = quantize
        self.conv = Conv(in_features, features, 3, dtype=dtype)
        self.norm = (InstanceNorm if norm == "instance"
                     else ChannelLayerNorm)(features, dtype=dtype)
        if quantize:
            _quant_init(self, "")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(self.norm(self.conv(x)), self.negative_slope)

    def int8_sites(self):
        yield "", self.conv.weight, 0

    def conv_int8(self, parts: Sequence[torch.Tensor],
                  out_dtype: torch.dtype, prologue=None):
        """W8A8 conv of the parts' concat (``quant_conv3x3``): (y in
        ``out_dtype``, its (N, 2, Cout) statistics)."""
        return quant_conv3x3(self, "", self.conv, parts, out_dtype, prologue)


class TwoConv(nn.Module):
    """conv_0 -> norm -> LeakyReLU [-> + temb_proj(swish(temb))] -> conv_1
    -> norm -> LeakyReLU. ``parts`` is the input as a list of tensors whose
    channel concat is the conv input (the UpCat skip and upsampled maps;
    the denoiser's image and x_t).

    With instance norm it is the fused chain of the JAX package's
    ``PallasFusedTwoConv``: each conv returns its f32 (sum, sum of squares)
    per (sample, channel); the first norm, activation and FiLM add run as
    the second conv's input prologue; the second norm and activation are
    one multiply-add and a LeakyReLU. A layer norm takes its statistics per
    voxel over the channels, which neither the kernel's statistics nor its
    per-(sample, channel) prologue can give: each conv runs with its bias
    only, and ``layer_norm_act`` takes the norm, the activation and the
    FiLM add in tensor code, rounded where the JAX package rounds.

    ``quantize`` (inference, instance norm) runs both convs W8A8 on the s8
    conv kernel (``ConvNormAct.conv_int8``), as the JAX package's quantized
    ``ConvNormAct`` does: conv_0 (with statistics) -> norm, LeakyReLU and
    FiLM add in the compute dtype -> one activation scale -> conv_1 (with
    statistics) -> norm -> LeakyReLU. The kernel quantizes each conv's
    input as it loads it; with a recorded (static) scale on conv_1 the
    norm, LeakyReLU and FiLM add run there too, as its prologue, and their
    output is never written; a dynamic scale is the abs-max of that output,
    so it is materialized first. The input parts are quantized in their
    promoted dtype, as the JAX package quantizes their concat, uncast."""

    def __init__(self, in_features: int, features: int, use_temb: bool = True,
                 negative_slope: float = 0.1, norm: str = "instance",
                 dtype: Optional[torch.dtype] = None,
                 quantize: bool = False):
        super().__init__()
        if quantize and norm != "instance":
            raise NotImplementedError("W8A8 int8 runs the instance-norm "
                                      "TwoConv only")
        self.dtype = dtype
        self.negative_slope = negative_slope
        self.norm = norm
        self.quantize = quantize
        self.conv_0 = ConvNormAct(in_features, features, negative_slope,
                                  norm, dtype=dtype, quantize=quantize)
        self.temb_proj = (Dense(TEMB_FEATURES, features, dtype=dtype)
                          if use_temb else None)
        self.conv_1 = ConvNormAct(features, features, negative_slope, norm,
                                  dtype=dtype, quantize=quantize)

    def forward(self, parts: Union[torch.Tensor, List[torch.Tensor]],
                temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        if isinstance(parts, torch.Tensor):
            parts = [parts]
        c0, c1 = self.conv_0, self.conv_1
        slope = self.negative_slope
        film = None
        if self.temb_proj is not None and temb is not None:
            film = self.temb_proj(swish(temb))
        if self.quantize:
            # quantized in the parts' promoted dtype, the JAX concat's, and
            # computed in ``dtype`` or that one, as the JAX rescale outputs
            pdt = functools.reduce(torch.promote_types,
                                   [p.dtype for p in parts])
            return self._forward_int8([p.to(pdt) for p in parts], film,
                                      self.dtype or pdt)
        dt = _compute_dtype(self.dtype, parts[0], c0.conv.weight)
        parts = [p.to(dt).contiguous() for p in parts]
        if self.norm == "layer":
            y0 = conv3x3(parts, c0.conv.weight, c0.conv.bias)
            u = layer_norm_act(y0, c0.norm.weight, c0.norm.bias, slope, film)
            y1 = conv3x3([u], c1.conv.weight, c1.conv.bias)
            return layer_norm_act(y1, c1.norm.weight, c1.norm.bias, slope)
        count = math.prod(parts[0].shape[1:4])
        y0, st0 = conv3x3(parts, c0.conv.weight, c0.conv.bias,
                          with_stats=True)
        a0, b0 = norm_affine_from_stats(st0, c0.norm.weight, c0.norm.bias,
                                        count)
        y1, st1 = conv3x3([y0], c1.conv.weight, c1.conv.bias,
                          prologue=(a0, b0, None if film is None
                                    else film.float(), slope),
                          with_stats=True)
        a1, b1 = norm_affine_from_stats(st1, c1.norm.weight, c1.norm.bias,
                                        count)
        y = (y1 * a1.to(dt)[:, None, None, None]
             + b1.to(dt)[:, None, None, None])
        return F.leaky_relu(y, slope)

    def _forward_int8(self, parts, film, dt):
        c0, c1 = self.conv_0, self.conv_1
        slope = self.negative_slope
        count = math.prod(parts[0].shape[1:4])
        # InstanceNorm's affine rounded to the compute dtype, applied in it
        # (with the FiLM add) by apply_prologue or the kernel
        y0, st0 = c0.conv_int8(parts, dt)
        pro = (*norm_affine(c0.norm, st0, count, dt),
               None if film is None else film.to(dt), slope)
        if c1.sa is None:
            # a dynamic scale is the abs-max of u: materialize it
            y1, st1 = c1.conv_int8(apply_prologue([y0], pro), dt)
        else:
            y1, st1 = c1.conv_int8([y0], dt, prologue=pro)
        return apply_prologue([y1], (*norm_affine(c1.norm, st1, count, dt),
                                     None, slope))[0]


class Down(nn.Module):
    """2x max-pool, then TwoConv (scope ``convs``)."""

    def __init__(self, in_features: int, features: int, use_temb: bool = True,
                 negative_slope: float = 0.1, norm: str = "instance",
                 dtype: Optional[torch.dtype] = None,
                 quantize: bool = False):
        super().__init__()
        self.convs = TwoConv(in_features, features, use_temb, negative_slope,
                             norm, dtype=dtype, quantize=quantize)

    def forward(self, x: torch.Tensor,
                temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = F.max_pool3d(x.permute(0, 4, 1, 2, 3), 2).permute(0, 2, 3, 4, 1)
        return self.convs([x], temb)


class UpCat(nn.Module):
    """2x transposed conv (scope ``upsample``), replicate-pad to the skip's
    shape where it has odd edges, then TwoConv over [skip, upsampled]
    (scope ``convs``). ``quantize`` runs the transposed conv W8A8
    (``deconv2_int8``, state ``up_wq``, ``up_sw``, ``up_sa``) and the
    TwoConv quantized."""

    def __init__(self, in_features: int, skip_features: int,
                 up_features: int, features: int, use_temb: bool = True,
                 negative_slope: float = 0.1, norm: str = "instance",
                 dtype: Optional[torch.dtype] = None,
                 quantize: bool = False):
        super().__init__()
        self.quantize = quantize
        self.upsample = ConvTranspose(in_features, up_features, dtype=dtype)
        self.convs = TwoConv(skip_features + up_features, features, use_temb,
                             negative_slope, norm, dtype=dtype,
                             quantize=quantize)
        if quantize:
            _quant_init(self, "up_")

    def int8_sites(self):
        yield "up_", self.upsample.weight, 1

    def forward(self, x: torch.Tensor, x_skip: torch.Tensor,
                temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.quantize:
            up = self.upsample
            wq, sw = quant_weights(self, "up_", up.weight, 1)
            sa = quant_act_scale(self, "up_", [x])
            x0 = deconv2_int8(quantize_act(x, sa), wq, sa, sw, up.bias,
                              _compute_dtype(up.dtype, x, up.weight))
        else:
            x0 = self.upsample(x)
        pads = [s - u for s, u in zip(x_skip.shape[1:4], x0.shape[1:4])]
        if any(pads):
            x0 = F.pad(x0.permute(0, 4, 1, 2, 3),
                       (0, pads[2], 0, pads[1], 0, pads[0]),
                       mode="replicate").permute(0, 2, 3, 4, 1)
        return self.convs([x_skip, x0], temb)
