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

The convs: ``conv3x3_int8`` (3x3x3 SAME over NDHWC parts whose channel
concat is the input, as ``ops/conv3d.py:conv3x3`` takes them),
``conv1x1_int8`` (the 1x1x1 residual projection of the Swin-UNETR blocks)
and ``deconv2_int8`` (the k2 s2 transposed conv of ``UpCat``). Each returns the
raw int32 sums, or with ``sa`` and ``sw`` the rescaled output (and, for
the conv, the per-(sample, channel) sum and sum of squares of the float32
values, as the bf16 conv takes its statistics). The conv takes int8 parts,
or float parts (``QUANT_ON_LOAD``) with ``sa``, which it quantizes on load
as ``quantize_input`` does: ``quantize_act`` of each part, after the norm
prologue ``(a, b, film, slope)`` where one is given (the tensor chain of
``TwoConv``: ``leaky_relu(x * a + b, slope) + film``, each operation
rounded to the parts' dtype). CPU tensors take the plain versions: that
tensor code, then a float64 convolution of the int8 values, exact since
|acc| <= 127^2 * 27 * Cin < 2^53 (float32 is not), rounded to int32. CUDA
tensors take ``csrc/conv3d.cu``'s s8 instance of the wgmma conv kernel
(the conv; its launches are counted in ``conv3x3_int8.launches``); the
1x1 conv is one int8 GEMM (voxels, Cin) x (Cin, Cout) through
``torch._int_mm`` (counted in ``conv1x1_int8.launches``), the deconv one
(voxels, Cin) x (Cin, 8 Cout), then the rescale on that compact output and
the scatter of the result into the 2x grid in tensor code (the JAX package
leaves both to XLA: no Pallas kernel).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from diff_unet_tpu_torch.ops import _native
from diff_unet_tpu_torch.ops.conv3d import CHUNK_S8, MAX_PARTS, Prologue, \
    _cdiv, _check_parts, _part_args, _prologue_args, _ptr, conv_plan, \
    packed_weight, stats_slots

QMAX = 127
# the float dtypes the s8 kernel quantizes on load (its element types); on
# the CPU the plain version quantizes any float dtype
QUANT_ON_LOAD = (torch.bfloat16, torch.float32)

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


def apply_prologue(parts: Parts, prologue: Prologue) -> list:
    """The norm prologue on each part, in its dtype as TwoConv's tensor
    chain computes it: ``leaky_relu(x * a + b, slope) + film``, with ``a``,
    ``b`` and ``film`` (N, Cin) over the parts' concat (``film`` may be
    None, ``slope`` None for no activation), each rounded to the dtype."""
    a, b, film, slope = prologue
    out, off = [], 0
    for p in _as_parts(parts):
        c = p.shape[-1]

        def bc(v):
            return v[:, off:off + c].to(p.dtype)[:, None, None, None]

        u = p * bc(a) + bc(b)
        if slope is not None:
            u = F.leaky_relu(u, slope)
        if film is not None:
            u = u + bc(film)
        out.append(u)
        off += c
    return out


def quantize_input(parts: Parts, sa: torch.Tensor,
                   prologue: Optional[Prologue] = None) -> list:
    """The int8 parts the conv takes from float parts: ``quantize_act`` of
    each part with the one scale ``sa``, after ``apply_prologue`` where a
    prologue is given."""
    parts = _as_parts(parts)
    if prologue is not None:
        parts = apply_prologue(parts, prologue)
    return [quantize_act(p, sa) for p in parts]


def conv3x3_int8_plain(parts: Parts, wq: torch.Tensor,
                       sa: Optional[torch.Tensor] = None,
                       prologue: Optional[Prologue] = None) -> torch.Tensor:
    """int32 (N, D, H, W, Cout): the SAME 3x3x3 conv of the int8 parts'
    concat with the int8 (Cout, Cin, 3, 3, 3) kernel, as a float64
    convolution of the int8 values (exact), rounded. Float parts are
    first quantized with ``sa`` (and ``prologue``) by ``quantize_input``."""
    parts = _as_parts(parts)
    if parts[0].dtype != torch.int8:
        parts = quantize_input(parts, sa, prologue)
    x = torch.cat([p.double() for p in parts], dim=-1)
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
            with_stats: bool, prologue: Optional[Prologue]):
    chans = _check_parts(parts, (torch.int8, *QUANT_ON_LOAD))
    x0 = parts[0]
    dt, dev = x0.dtype, x0.device
    n, d, h, w = x0.shape[:4]
    cin, cout = sum(chans), wq.shape[0]
    if wq.dtype != torch.int8 or tuple(wq.shape) != (cout, cin, 3, 3, 3):
        raise ValueError(f"wq must be int8 ({cout}, {cin}, 3, 3, 3) for "
                         f"parts of {chans} channels, got {wq.dtype} "
                         f"{tuple(wq.shape)}")
    raw = out_dtype == torch.int32
    if not raw and out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"s8 kernel output dtype {out_dtype} not supported "
                        "(int32, float32 or bfloat16)")
    if sa is not None:
        sa = sa.to(dev, torch.float32).reshape(()).contiguous()
    if not raw:
        sw = sw.to(dev, torch.float32).contiguous()
        if tuple(sw.shape) != (cout,):
            raise ValueError(f"sw must be ({cout},), got {tuple(sw.shape)}")
        if bias is not None:
            bias = bias.to(dev, torch.float32).contiguous()
    else:
        sw = bias = None
    pro, pro_slope = (None, None, None), 1.0
    if prologue is not None:
        # a, b and film rounded to the parts' dtype, as the tensor chain
        # applies them, then carried as float32 rows (exact)
        pro, pro_slope = _prologue_args(
            (*[None if v is None else v.to(dt) for v in prologue[:3]],
             prologue[3]), n, cin, dev)
    out = torch.empty((n, d, h, w, cout), dtype=out_dtype, device=dev)
    # float32 parts are gathered: TMA would stage 51 KB a chunk
    aligned = (dt != torch.float32
               and all(p.data_ptr() % 16 == 0 for p in parts))
    plan = conv_plan(n, (d, h, w), chans, cout, aligned, CHUNK_S8)
    stats = stats_part = partial = counter = None
    if with_stats:
        stats = torch.zeros((n, 2, cout), dtype=torch.float32, device=dev)
        stats_part = torch.empty(stats_slots(plan) * 2 * cout,
                                 dtype=torch.float32, device=dev)
    if plan.split > 1:
        n_partial, n_counter = plan.workspace()
        partial = torch.empty(n_partial, dtype=torch.int32, device=dev)
        counter = torch.zeros(n_counter, dtype=torch.int32, device=dev)
    wt = packed_weight(wq, torch.int8, dev, plan.bn)
    in_kind = (torch.int8, torch.bfloat16, torch.float32).index(dt)
    err = _native.load().conv3x3_s8_forward(
        *_part_args(parts, chans), in_kind, wt.data_ptr(), _ptr(sa),
        _ptr(sw), _ptr(bias), *map(_ptr, pro), pro_slope,
        (torch.int32, torch.float32, torch.bfloat16).index(out_dtype),
        out.data_ptr(), _ptr(stats), _ptr(stats_part), _ptr(partial),
        _ptr(counter), n, d, h, w, cout, plan.bn, plan.nchunk, plan.split,
        plan.per_split, int(plan.tma), _native.stream_ptr(dev))
    _native.check(err, "conv3x3_s8_forward")
    return (out, stats) if with_stats else out


def conv3x3_int8(parts: Parts, wq: torch.Tensor,
                 sa: Optional[torch.Tensor] = None,
                 sw: Optional[torch.Tensor] = None,
                 bias: Optional[torch.Tensor] = None,
                 out_dtype: torch.dtype = torch.bfloat16, *,
                 with_stats: bool = False,
                 prologue: Optional[Prologue] = None):
    """The W8A8 3x3x3 SAME conv of NDHWC parts (their channel concat) with
    int8 (Cout, Cin, 3, 3, 3) ``wq``. The parts are int8, or float with
    ``sa`` (on CUDA ``QUANT_ON_LOAD``), quantized on load as by
    ``quantize_input`` (with ``prologue``, a norm prologue ``(a, b, film,
    slope)``). Returns the int32 sums (``out_dtype`` int32, or no
    ``sw``), or with ``sa`` (a scalar) and ``sw`` (Cout,) the
    ``rescale``d output in ``out_dtype`` (and with ``with_stats`` its (N,
    2, Cout) statistics). CPU parts take the plain version (any float
    ``out_dtype``); CUDA parts launch the s8 kernel (int32, bf16 or float32
    out) or raise."""
    parts = _as_parts(parts)
    if not parts or len(parts) > MAX_PARTS:
        raise ValueError(f"conv3x3_int8 takes 1 to {MAX_PARTS} parts, got "
                         f"{len(parts)}")
    if sw is not None and sa is None:
        raise ValueError("sw needs sa")
    quantized = parts[0].dtype == torch.int8
    if not quantized and (sa is None or not parts[0].dtype.is_floating_point):
        raise TypeError(f"conv3x3_int8 takes int8 parts, or float parts "
                        f"with sa; got {parts[0].dtype}")
    if prologue is not None and quantized:
        raise ValueError("a prologue needs float parts")
    if sw is None:
        out_dtype = torch.int32
    if with_stats and out_dtype == torch.int32:
        raise ValueError("statistics need the rescaled output (sa, sw)")
    if parts[0].device.type == "cpu":
        acc = conv3x3_int8_plain(parts, wq, sa, prologue)
        if out_dtype == torch.int32:
            return acc
        return _finish(acc, sa, sw, bias, out_dtype, with_stats)
    out = _launch(parts, wq, sa, sw, bias, out_dtype, with_stats, prologue)
    conv3x3_int8.launches += 1
    return out


conv3x3_int8.launches = 0


def _int_mm_padded(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """a (M, K) @ b_t.T -> int32 (M, N) through ``torch._int_mm``, with M
    padded past 16 and K and N to multiples of 8 by zeros, as it requires;
    b_t is (N, K) row-major (the column-major right operand)."""
    m, k = a.shape
    n = b_t.shape[0]
    kp, np8 = _cdiv(k, 8) * 8, _cdiv(n, 8) * 8
    mp = max(m, 32)
    if kp != k or mp != m:
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if kp != k or np8 != n:
        b_t = F.pad(b_t, (0, kp - k, 0, np8 - n))
    out = torch._int_mm(a.contiguous(), b_t.contiguous().t())
    return out[:m] if np8 == n else out[:m, :n]


def conv1x1_int8_plain(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """int32 (N, D, H, W, Cout): the 1x1x1 conv of int8 NDHWC xq with the
    int8 (Cout, Cin, 1, 1, 1) kernel, as a float64 product of the int8
    values (exact: |acc| <= 127^2 * Cin < 2^53), rounded."""
    y = torch.einsum("ndhwc,oc->ndhwo", xq.double(), wq.double().flatten(1))
    return torch.round(y).to(torch.int32).contiguous()


def conv1x1_int8(xq: torch.Tensor, wq: torch.Tensor,
                 sa: Optional[torch.Tensor] = None,
                 sw: Optional[torch.Tensor] = None,
                 bias: Optional[torch.Tensor] = None,
                 out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The W8A8 1x1x1 conv of int8 NDHWC ``xq`` with int8 (Cout, Cin, 1,
    1, 1) ``wq``: int32 (N, D, H, W, Cout), or the ``rescale``d output in
    ``out_dtype`` with ``sa`` and ``sw``. CPU tensors take the plain
    version; on the card it is one int8 GEMM (voxels, Cin) x (Cin, Cout)."""
    if (sa is None) != (sw is None):
        raise ValueError("sa and sw go together")
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError("conv1x1_int8 takes int8 xq and wq")
    cout, cin = wq.shape[:2]
    if xq.dim() != 5 or xq.shape[-1] != cin or tuple(wq.shape[2:]) != (1,) * 3:
        raise ValueError(f"xq (N, D, H, W, {cin}) and wq ({cout}, {cin}, 1, "
                         f"1, 1) expected, got {tuple(xq.shape)} and "
                         f"{tuple(wq.shape)}")
    if xq.device.type == "cpu":
        acc = conv1x1_int8_plain(xq, wq)
    else:
        acc = _int_mm_padded(xq.reshape(-1, cin), wq.reshape(cout, cin)
                             ).reshape(*xq.shape[:4], cout)
        conv1x1_int8.launches += 1
    return _finish(acc, sa, sw, bias, out_dtype, False)


conv1x1_int8.launches = 0


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
        return _finish(deconv2_int8_plain(xq, wq), sa, sw, bias, out_dtype,
                       False)
    n, d, h, w = xq.shape[:4]
    b_t = wq.permute(2, 3, 4, 1, 0).reshape(8 * cout, cin)
    acc = _int_mm_padded(xq.reshape(-1, cin), b_t).view(n, d, h, w, 2, 2, 2,
                                                        cout)
    out = torch.empty((n, 2 * d, 2 * h, 2 * w, cout),
                      dtype=torch.int32 if sa is None else out_dtype,
                      device=xq.device)
    # (n, d, h, w, a, b, c, Cout) view of output voxel (2z + a, 2y + b,
    # 2x + c): the GEMM's rows scatter as they are written
    grid = out.view(n, d, 2, h, 2, w, 2, cout).permute(0, 1, 3, 5, 2, 4, 6,
                                                       7)
    if sa is None:
        grid.copy_(acc)
        return out
    # rescale's values in two passes: f32(acc) * (sa * sw) promoted from
    # int32 in the product, then the bias added in float32 and rounded to
    # out_dtype as it is written
    y = acc * (sa.float() * sw.float())
    if bias is None:
        grid.copy_(y)
    else:
        torch.add(y, bias.float(), out=grid)
    return out
