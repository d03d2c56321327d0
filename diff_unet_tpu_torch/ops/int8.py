"""W8A8 int8 serving primitives (counterpart of ``diff_unet_tpu/ops/int8.py``).

Symmetric, zero-point-free quantization, as the JAX package defines it:

- weights: a per-output-channel scale ``sw = max(max |k|, 1e-12) / 127``
  in float32 over every axis but Cout, and ``kq = clip(round(k / sw),
  -127, 127)`` as int8 (``quantize_kernel``);
- activations: one scale per tensor, dynamic (``act_scale``: ``max(max
  |x|, 1e-8) / 127`` in float32, over the whole batch) or a calibrated
  constant; ``quantize_act`` divides in x's own dtype and rounds;
- int8 x int8 products summed in int32, then one float32 dequantize:
  ``rescale`` = ``f32(acc) * (sa * sw) + b``, rounded to the output dtype.

Rounding is half to even everywhere (``torch.round``, ``jnp.round``; the
kernel's conversions use round-to-nearest intrinsics, never ``roundf``).
In bf16 the divide ``x / bf16(sa)`` is rounded to bf16 before the round,
as written; XLA on the CPU may keep the quotient in float32, so a bf16
comparison with the JAX package can differ by one at exact .5 quotients.

The convs: ``conv3x3_int8`` (3x3x3 SAME over int8 NDHWC parts whose
channel concat is the input, as ``ops/conv3d.py:conv3x3`` takes them) and
``deconv2_int8`` (the k2 s2 transposed conv of ``UpCat``). Each returns the
raw int32 sums, or with ``sa`` and ``sw`` the rescaled output (and, for
the conv, the per-(sample, channel) sum and sum of squares of the float32
values, as the bf16 conv takes its statistics). CPU tensors take the plain
versions: a float64 convolution of the int8 values, exact since |acc| <=
127^2 * 27 * Cin < 2^53 (float32 is not), rounded to int32. CUDA tensors
take ``csrc/conv3d.cu``'s s8 kernel (the conv; its launches are counted in
``conv3x3_int8.launches``) and, for the deconv, one int8 GEMM (voxels,
Cin) x (Cin, 8 Cout) through ``torch._int_mm`` (the JAX package leaves it
to XLA: no Pallas kernel), then the rescale and the scatter into the 2x
grid in tensor code.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from diff_unet_tpu_torch.ops import _native
from diff_unet_tpu_torch.ops.conv3d import MAX_PARTS, S8_TILE_ROWS, \
    _cdiv, _check_parts, _part_args, _ptr, packed_weight, stats_slots

QMAX = 127

Parts = Union[torch.Tensor, Sequence[torch.Tensor]]


def _as_parts(parts: Parts) -> list:
    return [parts] if isinstance(parts, torch.Tensor) else list(parts)


def quantize_kernel(weight: torch.Tensor, out_axis: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Float kernel -> (int8 kernel in the same layout, (Cout,) float32
    scales), Cout on ``out_axis``: 0 for the conv's (Cout, Cin, 3, 3, 3),
    1 for the transposed conv's (Cin, Cout, 2, 2, 2). The kernel is taken
    in float32, as the JAX package casts it."""
    k = weight.detach().float()
    dims = tuple(d for d in range(k.dim()) if d != out_axis)
    sw = torch.clamp(k.abs().amax(dim=dims), min=1e-12) / 127.0
    shape = [1] * k.dim()
    shape[out_axis] = -1
    kq = torch.clamp(torch.round(k / sw.reshape(shape)), -QMAX, QMAX)
    return kq.to(torch.int8), sw


def act_scale(parts: Parts) -> torch.Tensor:
    """Dynamic per-tensor scale of the parts' channel concat: max(max |x|
    in float32, 1e-8) / 127, a float32 scalar on the parts' device. The
    extremes are taken in x's dtype (one pass, no float32 copy): rounding
    to float32 is monotone, so max |f32(x)| = f32(max |x|)."""
    ext = [torch.aminmax(p.detach()) for p in _as_parts(parts)]
    amax = torch.stack([torch.maximum(-lo, hi).float() for lo, hi in ext])
    return torch.clamp(amax.amax(), min=1e-8) / 127.0


def quantize_act(x: torch.Tensor, sa: torch.Tensor) -> torch.Tensor:
    """clip(round(x / sa), -127, 127) as contiguous int8, the divide in
    x's dtype."""
    q = torch.round(x / sa.to(x.device, x.dtype))
    return torch.clamp(q, -QMAX, QMAX).to(torch.int8).contiguous()


def rescale(acc: torch.Tensor, sa: torch.Tensor, sw: torch.Tensor,
            bias: Optional[torch.Tensor], out_dtype: torch.dtype
            ) -> torch.Tensor:
    """The dequantize epilogue f32(acc) * (sa * sw) + bias in float32 (the
    product sa * sw first, each operation rounded on its own), rounded to
    ``out_dtype``; Cout is acc's last axis."""
    return _rescale_f32(acc, sa, sw, bias).to(out_dtype)


def _rescale_f32(acc, sa, sw, bias):
    y = acc.float() * (sa.float() * sw.float())
    if bias is not None:
        y = y + bias.float()
    return y


def _stats(y: torch.Tensor, acc_dtype: torch.dtype) -> torch.Tensor:
    """(N, 2, C) sum and sum of squares of NDHWC y over the voxels."""
    y = y.to(acc_dtype)
    return torch.stack([y.sum(dim=(1, 2, 3)), (y * y).sum(dim=(1, 2, 3))],
                       dim=1)


def _finish(acc, sa, sw, bias, out_dtype, with_stats):
    """Raw int32 sums, or the rescaled output (and its statistics, in
    float64 for a float64 output, else float32)."""
    if sa is None:
        return acc
    y = _rescale_f32(acc, sa, sw, bias)
    out = y.to(out_dtype)
    if not with_stats:
        return out
    return out, _stats(y, torch.float64 if out_dtype == torch.float64
                       else torch.float32)


def conv3x3_int8_plain(parts: Parts, wq: torch.Tensor) -> torch.Tensor:
    """int32 (N, D, H, W, Cout): the SAME 3x3x3 conv of the int8 parts'
    concat with the int8 (Cout, Cin, 3, 3, 3) kernel, as a float64
    convolution of the int8 values (exact), rounded."""
    x = torch.cat([p.double() for p in _as_parts(parts)], dim=-1)
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), wq.double(), padding=1)
    return torch.round(y).to(torch.int32).permute(0, 2, 3, 4, 1).contiguous()


def deconv2_int8_plain(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """int32 (N, 2D, 2H, 2W, Cout): the kernel-2 stride-2 transposed conv
    of int8 NDHWC xq with the int8 (Cin, Cout, 2, 2, 2) kernel (PyTorch's
    layout, ``ops/blocks.py:ConvTranspose``), in float64 (exact)."""
    y = F.conv_transpose3d(xq.double().permute(0, 4, 1, 2, 3), wq.double(),
                           stride=2)
    return torch.round(y).to(torch.int32).permute(0, 2, 3, 4, 1).contiguous()


def _launch(parts: list, wq: torch.Tensor, sa, sw, bias, out_dtype,
            with_stats: bool):
    chans = _check_parts(parts, (torch.int8,))
    x0 = parts[0]
    dev = x0.device
    n, d, h, w = x0.shape[:4]
    cin, cout = sum(chans), wq.shape[0]
    if wq.dtype != torch.int8 or tuple(wq.shape) != (cout, cin, 3, 3, 3):
        raise ValueError(f"wq must be int8 ({cout}, {cin}, 3, 3, 3) for "
                         f"parts of {chans} channels, got {wq.dtype} "
                         f"{tuple(wq.shape)}")
    raw = sa is None
    if raw:
        kind, dt = 0, torch.int32
    elif out_dtype in (torch.float32, torch.bfloat16):
        kind, dt = (1 if out_dtype == torch.float32 else 2), out_dtype
        sa = sa.to(dev, torch.float32).reshape(()).contiguous()
        sw = sw.to(dev, torch.float32).contiguous()
        if tuple(sw.shape) != (cout,):
            raise ValueError(f"sw must be ({cout},), got {tuple(sw.shape)}")
        if bias is not None:
            bias = bias.to(dev, torch.float32).contiguous()
    else:
        raise TypeError(f"s8 kernel output dtype {out_dtype} not supported "
                        "(float32 or bfloat16)")
    if with_stats and raw:
        raise ValueError("statistics need the rescaled output (sa, sw)")
    out = torch.empty((n, d, h, w, cout), dtype=dt, device=dev)
    stats = stats_part = None
    if with_stats:
        stats = torch.zeros((n, 2, cout), dtype=torch.float32, device=dev)
        slots = stats_slots(n, (d, h, w), rows=S8_TILE_ROWS)
        stats_part = torch.empty(slots * 2 * cout,
                                 dtype=torch.float32, device=dev)
    wt = packed_weight(wq, torch.int8, dev)
    err = _native.load().conv3x3_s8_forward(
        *_part_args(parts, chans), wt.data_ptr(), _ptr(sa), _ptr(sw),
        _ptr(bias), kind, out.data_ptr(), _ptr(stats), _ptr(stats_part),
        n, d, h, w, cout, wt.shape[1], wt.shape[0], _native.stream_ptr(dev))
    _native.check(err, "conv3x3_s8_forward")
    return (out, stats) if with_stats else out


def conv3x3_int8(parts: Parts, wq: torch.Tensor,
                 sa: Optional[torch.Tensor] = None,
                 sw: Optional[torch.Tensor] = None,
                 bias: Optional[torch.Tensor] = None,
                 out_dtype: torch.dtype = torch.bfloat16, *,
                 with_stats: bool = False):
    """The W8A8 3x3x3 SAME conv of int8 NDHWC parts (their channel concat)
    with int8 (Cout, Cin, 3, 3, 3) ``wq``: the int32 sums, or with ``sa``
    (a scalar) and ``sw`` (Cout,) the ``rescale``d output in ``out_dtype``
    (and with ``with_stats`` its (N, 2, Cout) statistics). CPU parts take
    the plain version (any float ``out_dtype``); CUDA parts launch the s8
    kernel (bf16 or float32 out) or raise."""
    parts = _as_parts(parts)
    if not parts or len(parts) > MAX_PARTS:
        raise ValueError(f"conv3x3_int8 takes 1 to {MAX_PARTS} parts, got "
                         f"{len(parts)}")
    if (sa is None) != (sw is None):
        raise ValueError("sa and sw go together")
    if parts[0].device.type == "cpu":
        return _finish(conv3x3_int8_plain(parts, wq), sa, sw, bias,
                       out_dtype, with_stats)
    out = _launch(parts, wq, sa, sw, bias, out_dtype, with_stats)
    conv3x3_int8.launches += 1
    return out


conv3x3_int8.launches = 0


def _int_mm_padded(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """a (M, K) @ b_t.T -> int32 (M, N) through ``torch._int_mm``, with M
    padded past 16 and K to a multiple of 8 by zeros, as it requires; b_t
    is (N, K) row-major (the column-major right operand)."""
    m, k = a.shape
    kp = _cdiv(k, 8) * 8
    mp = max(m, 32)
    if kp != k or mp != m:
        a = F.pad(a, (0, kp - k, 0, mp - m))
        b_t = F.pad(b_t, (0, kp - k))
    return torch._int_mm(a.contiguous(), b_t.contiguous().t())[:m]


def deconv2_int8(xq: torch.Tensor, wq: torch.Tensor,
                 sa: Optional[torch.Tensor] = None,
                 sw: Optional[torch.Tensor] = None,
                 bias: Optional[torch.Tensor] = None,
                 out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The W8A8 kernel-2 stride-2 transposed conv of int8 NDHWC ``xq``
    with int8 (Cin, Cout, 2, 2, 2) ``wq``: int32 (N, 2D, 2H, 2W, Cout), or
    the ``rescale``d output with ``sa`` and ``sw``. Output voxel (2z + a,
    2y + b, 2x + c) is sum_ci x[z, y, x, ci] * wq[ci, :, a, b, c], so on
    the card it is one int8 GEMM of the voxels with the (Cin, 8 Cout)
    kernel, then the scatter."""
    if (sa is None) != (sw is None):
        raise ValueError("sa and sw go together")
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError("deconv2_int8 takes int8 xq and wq")
    cin, cout = wq.shape[:2]
    if xq.dim() != 5 or xq.shape[-1] != cin or tuple(wq.shape[2:]) != (2,) * 3:
        raise ValueError(f"xq (N, D, H, W, {cin}) and wq ({cin}, Cout, 2, 2, "
                         f"2) expected, got {tuple(xq.shape)} and "
                         f"{tuple(wq.shape)}")
    if xq.device.type == "cpu":
        acc = deconv2_int8_plain(xq, wq)
    else:
        n, d, h, w = xq.shape[:4]
        b_t = wq.permute(2, 3, 4, 1, 0).reshape(8 * cout, cin)
        acc = _int_mm_padded(xq.reshape(-1, cin), b_t)
        acc = acc.reshape(n, d, h, w, 2, 2, 2, cout).permute(
            0, 1, 4, 2, 5, 3, 6, 7).reshape(n, 2 * d, 2 * h, 2 * w, cout)
    return _finish(acc, sa, sw, bias, out_dtype, False)
