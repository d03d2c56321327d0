"""3x3x3 'same' conv over channel-last parts: the CUDA kernel and its plain
PyTorch version, plus the instance-norm affine taken from its statistics.

Counterpart of ``diff_unet_tpu/ops/pallas_conv.py`` (``conv3d_same``),
``ops/pallas_aug_conv.py`` (``conv3x3_aug``) and
``ops/pallas_packed_conv.py`` (``conv3x3_packed_aug`` and
``conv3x3_packed_aug_pipelined``): one function with switches,

    u = prologue(concat(parts))      at in-bounds voxels; the halo reads 0
    y = conv3x3x3_same(u, weight) + bias
    y = leaky_relu(y, negative_slope)                      (optional)
    stats[n] = (sum, sum of squares) of y over the voxels   (optional)

on unpacked NDHWC tensors (the pack-2 layouts of the TPU kernels are lane
geometry). ``parts`` is a list of (N, D, H, W, C_i) tensors whose channel
concat is the input; no concat is built. ``prologue`` is ``(scale, shift,
const, negative_slope)`` with (N, Cin) float32 tensors (``const`` may be
None, ``negative_slope`` None for no activation): ``lrelu(x * scale +
shift) + const`` per (sample, channel), evaluated in float32 and rounded to
the compute dtype. ``weight`` is PyTorch's (Cout, Cin, 3, 3, 3). The
compute dtype is that of the parts (float32 or bfloat16); products
accumulate in float32, ``stats`` (N, 2, Cout) float32 are taken from that
accumulator before the output is rounded to the compute dtype. The kernel
source is ``csrc/conv3d.cu``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from diff_unet_tpu_torch.ops import _native

EPS = 1e-5
MAX_PARTS = 4
# Kernel against plain version on the card, as a fraction of the largest
# |plain| value: both sum the same products in float32 and differ only in
# order, so float32 outputs agree to 1e-4 and bfloat16 outputs to two bf16
# ulps (2^-6) of the largest (one rounding of a near-tie can flip); the
# float32 statistics to 1e-4 of the largest in either dtype.
KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}
STATS_TOL = 1e-4
Prologue = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor],
                 Optional[float]]


def _apply_prologue(x: torch.Tensor, prologue: Prologue) -> torch.Tensor:
    """float32 prologue on a float32 (N, D, H, W, Cin) tensor."""
    scale, shift, const, slope = prologue

    def b(v):
        return v.float()[:, None, None, None, :]

    u = x * b(scale) + b(shift)
    if slope is not None:
        u = F.leaky_relu(u, slope)
    if const is not None:
        u = u + b(const)
    return u


def conv3x3_plain(parts: Sequence[torch.Tensor], weight: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, *,
                  prologue: Optional[Prologue] = None,
                  negative_slope: Optional[float] = None,
                  with_stats: bool = False):
    """Plain PyTorch version with the kernel's rounding points: the
    prologue in float32 rounded to the compute dtype, weights rounded to
    it, a float32 convolution (TF32 off) of those values, bias, activation
    and statistics in float32, then the output rounded."""
    dt = parts[0].dtype
    x = torch.cat([p.float() for p in parts], dim=-1)
    if prologue is not None:
        x = _apply_prologue(x, prologue).to(dt).float()
    w = weight.to(dt).float()
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        y = F.conv3d(x.permute(0, 4, 1, 2, 3), w, padding=1)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    y = y.permute(0, 2, 3, 4, 1)
    if bias is not None:
        y = y + bias.float()
    if negative_slope is not None:
        y = F.leaky_relu(y, negative_slope)
    out = y.to(dt)
    if not with_stats:
        return out
    stats = torch.stack([y.sum(dim=(1, 2, 3)), (y * y).sum(dim=(1, 2, 3))],
                        dim=1)
    return out, stats


def _f32_rows(v: Optional[torch.Tensor], n: int, cin: int,
              dev: torch.device, name: str) -> Optional[torch.Tensor]:
    if v is None:
        return None
    v = v.to(dev, torch.float32).contiguous()
    if tuple(v.shape) != (n, cin):
        raise ValueError(f"prologue {name} must be ({n}, {cin}), got "
                         f"{tuple(v.shape)}")
    return v


def conv3x3(parts: Sequence[torch.Tensor], weight: torch.Tensor,
            bias: Optional[torch.Tensor] = None, *,
            prologue: Optional[Prologue] = None,
            negative_slope: Optional[float] = None,
            with_stats: bool = False):
    """y, or (y, stats) with ``with_stats``. CPU tensors take the plain
    version; CUDA tensors launch the kernel (forward only) or raise."""
    parts = list(parts)
    if not parts or len(parts) > MAX_PARTS:
        raise ValueError(f"conv3x3 takes 1 to {MAX_PARTS} parts, got "
                         f"{len(parts)}")
    x0 = parts[0]
    if x0.device.type == "cpu":
        return conv3x3_plain(parts, weight, bias, prologue=prologue,
                             negative_slope=negative_slope,
                             with_stats=with_stats)
    _native.require_cuda(x0, "parts[0]")
    _native.forbid_grad(*parts, weight)
    dt, dev = x0.dtype, x0.device
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"parts dtype {dt} not supported (float32 or "
                        "bfloat16)")
    if x0.dim() != 5:
        raise ValueError(f"parts must be (N, D, H, W, C), got "
                         f"{tuple(x0.shape)}")
    n, d, h, w = x0.shape[:4]
    for i, p in enumerate(parts):
        if (p.dim() != 5 or tuple(p.shape[:4]) != (n, d, h, w)
                or p.dtype != dt or p.device != dev):
            raise ValueError(f"part {i} {tuple(p.shape)} {p.dtype} on "
                             f"{p.device} does not match part 0 "
                             f"{tuple(x0.shape)} {dt} on {dev}")
        if not p.is_contiguous():
            raise ValueError(f"part {i} must be contiguous (NDHWC)")
    chans = [p.shape[4] for p in parts]
    cin = sum(chans)
    cout = weight.shape[0]
    if tuple(weight.shape) != (cout, cin, 3, 3, 3):
        raise ValueError(f"weight must be ({cout}, {cin}, 3, 3, 3) for "
                         f"parts of {chans} channels, got "
                         f"{tuple(weight.shape)}")
    if bias is not None:
        if tuple(bias.shape) != (cout,):
            raise ValueError(f"bias must be ({cout},), got "
                             f"{tuple(bias.shape)}")
        bias = bias.to(dev, torch.float32).contiguous()
    pro = [None, None, None]
    pro_slope = 1.0
    if prologue is not None:
        scale, shift, const, slope = prologue
        pro = [_f32_rows(v, n, cin, dev, name) for v, name in
               ((scale, "scale"), (shift, "shift"), (const, "const"))]
        if pro[0] is None or pro[1] is None:
            raise ValueError("prologue needs scale and shift")
        pro_slope = 1.0 if slope is None else float(slope)
    # (Cout, K) with K = (kd, kh, kw, ci) flattened, zero-padded to the
    # kernel's tiles: K to a multiple of 32, Cout to a multiple of 64
    k = 27 * cin
    k_pad, cout_pad = -(-k // 32) * 32, -(-cout // 64) * 64
    wt = torch.zeros((cout_pad, k_pad), dtype=dt, device=dev)
    wt[:cout, :k] = weight.to(dev, dt).permute(0, 2, 3, 4, 1).reshape(cout, k)
    out = torch.empty((n, d, h, w, cout), dtype=dt, device=dev)
    stats = (torch.zeros((n, 2, cout), dtype=torch.float32, device=dev)
             if with_stats else None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    ptrs = [p.data_ptr() for p in parts] + [None] * (MAX_PARTS - len(parts))
    chans_arg = chans + [0] * (MAX_PARTS - len(parts))
    err = _native.load().conv3x3_forward(
        *ptrs, *chans_arg, len(parts), wt.data_ptr(), ptr(bias), *map(ptr, pro),
        pro_slope, 1.0 if negative_slope is None else float(negative_slope),
        out.data_ptr(), ptr(stats), n, d, h, w, cout, k_pad, cout_pad,
        0 if dt == torch.float32 else 1, _native.stream_ptr(dev))
    _native.check(err, "conv3x3_forward")
    conv3x3.launches += 1
    return (out, stats) if with_stats else out


conv3x3.launches = 0


def norm_affine_from_stats(stats: torch.Tensor, gamma: torch.Tensor,
                           beta: torch.Tensor, count: int,
                           eps: float = EPS
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Instance norm as a per-(sample, channel) affine from the conv's
    (sum, sum of squares) over ``count`` voxels: one pass, variance clamped
    at 0. Returns (a, b), both (N, C) float32, with ``y * a + b`` the
    normalised, scaled and shifted ``y``."""
    mean = stats[:, 0] / count
    var = torch.clamp(stats[:, 1] / count - mean * mean, min=0.0)
    a = torch.rsqrt(var + eps) * gamma.float()
    return a, beta.float() - mean * a
