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

The bfloat16 kernel's launch plan (``conv_plan``: output bricks, Cout
block, the split of the channel chunks across CTAs, TMA or gathered halo)
and its weight layout (``pack_weight``) are chosen here, in Python, from
the shapes; the packed weights are kept per weight tensor and parameter
version (``packed_weight``).
"""
from __future__ import annotations

import dataclasses
import weakref
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
# the bfloat16 kernel's geometry (csrc/conv3d.cu, namespace hw): a CTA
# owns a (z, y, x) brick of output voxels of one sample, one z slice for
# each of its two consumer warpgroups, and takes the input in chunks of
# CHUNK channels; grids under MIN_CTAS CTAs split the chunks
BRICK = (2, 8, 8)
CONSUMER_THREADS = 256
CHUNK = 16
MIN_CTAS = 2 * 132                 # two CTAs for each SM of an H100
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


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """Launch plan of the bfloat16 kernel for one conv: the work is
    ``grid`` = (bricks, Cout blocks of ``bn``, ``split``) tiles, tile
    (brick, block, s) taking the channel chunks ``chunks(s)``. The kernel
    gives a small grid a CTA for each tile and runs a large one on
    persistent CTAs (as many as fit on the card), each walking the bricks
    with the stride of their count."""
    n: int
    dims: Tuple[int, int, int]     # (D, H, W)
    cin: int
    cout: int
    bn: int                        # output channels per CTA: 64 or 128
    nchunk: int                    # ceil(cin / CHUNK)
    split: int                     # CTAs that share one output tile
    per_split: int                 # chunks per split (the last may be short)
    tma: bool                      # halo by TMA (else gathered)

    @property
    def blocks(self) -> Tuple[int, int, int]:
        return tuple(_cdiv(s, b) for s, b in zip(self.dims, BRICK))

    @property
    def grid(self) -> Tuple[int, int, int]:
        return (self.n * self.blocks[0] * self.blocks[1] * self.blocks[2],
                _cdiv(self.cout, self.bn), self.split)

    def brick(self, i: int) -> Tuple[int, int, int, int]:
        """(sample, z0, y0, x0) of brick i, decoded as the kernel does; its
        voxels outside the volume are masked out of the store and the
        statistics."""
        nzb, nyb, nxb = self.blocks
        xb, i = i % nxb, i // nxb
        yb, i = i % nyb, i // nyb
        zb, n = i % nzb, i // nzb
        return n, zb * BRICK[0], yb * BRICK[1], xb * BRICK[2]

    def chunks(self, s: int) -> range:
        return range(s * self.per_split,
                     min(self.nchunk, (s + 1) * self.per_split))

    def workspace(self) -> Tuple[int, int]:
        """(f32 partial-tile elements, int32 counters) for split > 1."""
        if self.split == 1:
            return 0, 0
        tiles = self.grid[0] * self.grid[1]
        return tiles * self.split * CONSUMER_THREADS * self.bn // 2, tiles


def conv_plan(n: int, dims: Sequence[int], chans: Sequence[int], cout: int,
              aligned: bool = True) -> ConvPlan:
    """The bfloat16 kernel's plan from the shapes: Cout blocks of 64 (Cout
    <= 64) or 128; a grid under ``MIN_CTAS`` CTAs splits the channel chunks
    across more; the halo comes by TMA when every part's channels are a
    multiple of ``CHUNK`` (a chunk then lies in one part) and its pointer
    is 16-byte aligned (``aligned``)."""
    cin = sum(chans)
    nchunk = _cdiv(cin, CHUNK)
    bn = 64 if cout <= 64 else 128
    blocks = [_cdiv(s, b) for s, b in zip(dims, BRICK)]
    ctas = n * blocks[0] * blocks[1] * blocks[2] * _cdiv(cout, bn)
    split = min(nchunk, _cdiv(MIN_CTAS, ctas)) if ctas < MIN_CTAS else 1
    per_split = _cdiv(nchunk, split)
    return ConvPlan(n=n, dims=tuple(dims), cin=cin, cout=cout, bn=bn,
                    nchunk=nchunk, split=_cdiv(nchunk, per_split),
                    per_split=per_split,
                    tma=aligned and all(c % CHUNK == 0 for c in chans))


def pack_weight(weight: torch.Tensor, bn: int) -> torch.Tensor:
    """(Cout, Cin, 3, 3, 3) -> the bfloat16 kernel's layout (Cout_pad / bn,
    nchunk, 27, 2, bn, 8), zero-padded: element [cb, j, tap, g, c, e] is
    weight[cb * bn + c, 16 j + 8 g + e, tap]. One (cb, j, dz) slab of 9
    taps is one contiguous stage of the kernel's weight ring, in wgmma's
    core-matrix layout (8 output channels x 8 input channels, 128 bytes)."""
    cout, cin = weight.shape[:2]
    ncb, nchunk = _cdiv(cout, bn), _cdiv(cin, CHUNK)
    w = torch.zeros((ncb * bn, nchunk * CHUNK, 27), dtype=weight.dtype,
                    device=weight.device)
    w[:cout, :cin] = weight.reshape(cout, cin, 27)
    w = w.reshape(ncb, bn, nchunk, 2, 8, 27).permute(0, 2, 5, 3, 1, 4)
    return w.contiguous()


def unpack_weight(packed: torch.Tensor, cout: int, cin: int) -> torch.Tensor:
    """The inverse of ``pack_weight``: (Cout, Cin, 3, 3, 3)."""
    ncb, nchunk, _, _, bn, _ = packed.shape
    w = packed.permute(0, 4, 1, 3, 5, 2).reshape(ncb * bn, nchunk * CHUNK,
                                                 27)
    return w[:cout, :cin].reshape(cout, cin, 3, 3, 3)


def pack_weight_f32(weight: torch.Tensor) -> torch.Tensor:
    """The float32 kernel's layout: (Cout_pad, K_pad), k = tap * Cin + ci,
    K padded to a multiple of 32 and Cout to 64 with zeros."""
    cout, cin = weight.shape[:2]
    k = 27 * cin
    w = torch.zeros((_cdiv(cout, 64) * 64, _cdiv(k, 32) * 32),
                    dtype=weight.dtype, device=weight.device)
    w[:cout, :k] = weight.permute(0, 2, 3, 4, 1).reshape(cout, k)
    return w


_PACKED: dict = {}   # id(weight) -> (weakref to it, key, packed weights)


def packed_weight(weight: torch.Tensor, dtype: torch.dtype,
                  device: torch.device, bn: int = 0) -> torch.Tensor:
    """``weight`` in the kernel's layout for ``dtype`` (``pack_weight``
    with Cout blocks of ``bn`` for bfloat16, ``pack_weight_f32`` for
    float32), on ``device``. The result is kept while the weight tensor
    lives and reused while its storage, version counter (bumped by every
    in-place update), dtype, device and ``bn`` stay the same. Inference
    tensors have no version counter: they are packed at every call."""
    try:
        key = (weight.data_ptr(), weight._version, dtype, device, bn)
    except RuntimeError:
        key = None
    entry = _PACKED.get(id(weight))
    if (key is not None and entry is not None and entry[0]() is weight
            and entry[1] == key):
        return entry[2]
    w = weight.detach().to(device, dtype)
    packed = pack_weight(w, bn) if dtype == torch.bfloat16 \
        else pack_weight_f32(w)
    if key is not None:
        i = id(weight)
        _PACKED[i] = (weakref.ref(weight, lambda _: _PACKED.pop(i, None)),
                      key, packed)
    packed_weight.packs += 1
    return packed


packed_weight.packs = 0


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
    out = torch.empty((n, d, h, w, cout), dtype=dt, device=dev)
    stats = (torch.zeros((n, 2, cout), dtype=torch.float32, device=dev)
             if with_stats else None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    ptrs = [p.data_ptr() for p in parts] + [None] * (MAX_PARTS - len(parts))
    chans_arg = chans + [0] * (MAX_PARTS - len(parts))
    common = (*ptrs, *chans_arg, len(parts))
    epilogue = (ptr(bias), *map(ptr, pro), pro_slope,
                1.0 if negative_slope is None else float(negative_slope),
                out.data_ptr(), ptr(stats))
    stream = _native.stream_ptr(dev)
    if dt == torch.bfloat16:
        plan = conv_plan(n, (d, h, w), chans, cout,
                         aligned=all(p.data_ptr() % 16 == 0 for p in parts))
        wt = packed_weight(weight, dt, dev, plan.bn)
        n_partial, n_counter = plan.workspace()
        partial = counter = None
        if plan.split > 1:
            partial = torch.empty(n_partial, dtype=torch.float32, device=dev)
            counter = torch.zeros(n_counter, dtype=torch.int32, device=dev)
        err = _native.load().conv3x3_bf16_forward(
            *common, wt.data_ptr(), *epilogue, ptr(partial), ptr(counter),
            n, d, h, w, cout, plan.bn, plan.nchunk, plan.split,
            plan.per_split, int(plan.tma), stream)
        _native.check(err, "conv3x3_bf16_forward")
    else:
        wt = packed_weight(weight, dt, dev)
        err = _native.load().conv3x3_f32_forward(
            *common, wt.data_ptr(), *epilogue, n, d, h, w, cout,
            wt.shape[1], wt.shape[0], stream)
        _native.check(err, "conv3x3_f32_forward")
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
