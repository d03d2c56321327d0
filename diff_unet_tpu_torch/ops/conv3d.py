"""3x3x3 'same' conv over channel-last parts: the CUDA kernel and its plain
PyTorch version, plus the instance-norm and batch-norm affines taken from
its statistics.

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
source is ``csrc/conv3d.cu``: bfloat16 on the tensor cores, float32 as
3xTF32 on them (each value split into tf32 big and small parts, three
products a term: float32 accuracy, about 1e-6 relative). Its statistics are
reproducible: each output brick stores its partial sums in a slot of its
own, which a second kernel adds up in slot order, so two runs on the same
inputs give the same bits.

The kernel's launch plan (``conv_plan``: output bricks, Cout block, the
split of the channel chunks across CTAs, TMA or gathered halo) and its
weight layout (``pack_weight``; float32 ``pack_weight_tf32``, the big and
small parts side by side) are chosen here, in Python, from the shapes; the
packed weights are kept per weight tensor and parameter version
(``packed_weight``).

Gradients (``_Conv3x3``, an autograd Function that ``conv3x3`` routes
through when autograd needs one): with ``g`` the gradient at the conv's
pre-activation output,

    g  = (dy + dsum + 2 y dsumsq) * lrelu'(y)       (y: the saved output)
    dbias = sum of g over the voxels
    du = conv3x3_dgrad(g, weight): the same SAME conv of g with the
         spatially flipped weights whose Cin and Cout are swapped, on the
         forward kernel (a second weight pack)
    dW = conv3x3_wgrad(g, parts, prologue): the sum over the voxels of
         g[p, co] * u[p + tap, ci], with u the prologue's rounded output,
         on a kernel of its own (``csrc/conv3d_wgrad.cu``)

and the prologue's adjoint in plain tensor code (the halo reads 0, so it
has no halo term): dx = du * a * lrelu'(x a + b), da = sum du lrelu' x,
db = sum du lrelu', dconst = sum du, per (sample, channel). g is rounded
to the compute dtype before both products, as the kernels take it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import weakref
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from diff_unet_tpu_torch.ops import _native

EPS = 1e-5
MAX_PARTS = 4
# Kernel against plain version on the card, as a fraction of the largest
# |plain| value: both sum the same products in float32 and differ in order
# (and, in float32, by the 3xTF32 split's ~1e-6 of each product), so
# float32 outputs agree to 1e-4 and bfloat16 outputs to two bf16 ulps
# (2^-6) of the largest (one rounding of a near-tie can flip); the float32
# statistics to 1e-4 of the largest in either dtype.
KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}
STATS_TOL = 1e-4
# the weight-gradient kernel against its plain version, as a fraction of
# max |plain|: both sum the same products (of bf16 values, or of fp32
# values as 3xTF32) in float32, in another order, over up to ~10^7 voxels
WGRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}
# the Function's gradients against autograd through the plain version, as
# a fraction of each gradient's max |g|: in bfloat16 the Function rounds g
# to bf16 before both products, where autograd keeps it in float32
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# the wgmma kernel's geometry (csrc/conv3d.cu, namespace hw): a CTA owns a
# (z, y, x) brick of output voxels of one sample, one z slice for each of
# its two consumer warpgroups, and takes the input in chunks of CHUNK
# bfloat16, CHUNK_F32 float32 (3xTF32) or CHUNK_S8 int8 channels (32 bytes
# of K a voxel in each); grids under MIN_CTAS CTAs split the chunks
BRICK = (2, 8, 8)
CONSUMER_THREADS = 256
CHUNK = 16
CHUNK_F32 = 8
CHUNK_S8 = 32
SMS = 132                          # streaming multiprocessors of an H100
MIN_CTAS = 2 * SMS                 # two CTAs for each SM
Prologue = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor],
                 Optional[float]]


def _acc_dtype(dt: torch.dtype) -> torch.dtype:
    """The dtype the plain versions compute in: float64 stays float64
    (the CPU tests' exact reference), everything else is float32."""
    return torch.float64 if dt == torch.float64 else torch.float32


def _apply_prologue(x: torch.Tensor, prologue: Prologue) -> torch.Tensor:
    """The prologue on an (N, D, H, W, Cin) tensor, in its dtype."""
    scale, shift, const, slope = prologue

    def b(v):
        return v.to(x.dtype)[:, None, None, None, :]

    u = x * b(scale) + b(shift)
    if slope is not None:
        u = F.leaky_relu(u, slope)
    if const is not None:
        u = u + b(const)
    return u


@contextlib.contextmanager
def _no_tf32():
    """cuDNN convolutions in full float32 inside the block."""
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def _conv_input(parts: Sequence[torch.Tensor],
                prologue: Optional[Prologue]) -> torch.Tensor:
    """u, the conv's input as the kernels see it: the parts' concat, the
    prologue in the plain versions' dtype rounded to the compute dtype."""
    dt = parts[0].dtype
    acc = _acc_dtype(dt)
    x = torch.cat([p.to(acc) for p in parts], dim=-1)
    if prologue is not None:
        x = _apply_prologue(x, prologue).to(dt).to(acc)
    return x


def conv3x3_plain(parts: Sequence[torch.Tensor], weight: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, *,
                  prologue: Optional[Prologue] = None,
                  negative_slope: Optional[float] = None,
                  with_stats: bool = False):
    """Plain PyTorch version with the kernel's rounding points: the
    prologue in float32 rounded to the compute dtype, weights rounded to
    it, a float32 convolution (TF32 off) of those values, bias, activation
    and statistics in float32, then the output rounded. float64 parts
    compute in float64 throughout."""
    dt = parts[0].dtype
    acc = _acc_dtype(dt)
    x = _conv_input(parts, prologue)
    w = weight.to(dt).to(acc)
    with _no_tf32():
        y = F.conv3d(x.permute(0, 4, 1, 2, 3), w, padding=1)
    y = y.permute(0, 2, 3, 4, 1)
    if bias is not None:
        y = y + bias.to(acc)
    if negative_slope is not None:
        y = F.leaky_relu(y, negative_slope)
    out = y.to(dt)
    if not with_stats:
        return out
    stats = torch.stack([y.sum(dim=(1, 2, 3)), (y * y).sum(dim=(1, 2, 3))],
                        dim=1)
    return out, stats


def flip_weight(weight: torch.Tensor) -> torch.Tensor:
    """The dgrad weights: W'[ci, co, t] = W[co, ci, 26 - t]."""
    return weight.transpose(0, 1).flip(2, 3, 4)


def conv3x3_dgrad_plain(g: torch.Tensor, weight: torch.Tensor
                        ) -> torch.Tensor:
    """Plain version of the input gradient: ``conv3x3_plain`` of g with the
    flipped weights (same rounding points), (N, D, H, W, Cin)."""
    return conv3x3_plain([g], flip_weight(weight))


def conv3x3_wgrad_plain(g: torch.Tensor, parts: Sequence[torch.Tensor],
                        prologue: Optional[Prologue] = None
                        ) -> torch.Tensor:
    """Plain version of the weight gradient: cuDNN's (or the CPU's) weight
    gradient of the rounded conv input u and of g, in float32 with TF32
    off (float64 for float64), (Cout, Cin, 3, 3, 3)."""
    u = _conv_input(parts, prologue).permute(0, 4, 1, 2, 3)
    gt = g.to(u.dtype).permute(0, 4, 1, 2, 3)
    shape = (g.shape[-1], u.shape[1], 3, 3, 3)
    with _no_tf32():
        return torch.nn.grad.conv3d_weight(u, shape, gt, padding=1)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """Launch plan of the wgmma kernel (bfloat16, float32 or int8) for
    one conv: the work is
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
    nchunk: int                    # ceil(cin / chunk)
    split: int                     # CTAs that share one output tile
    per_split: int                 # chunks per split (the last may be short)
    tma: bool                      # halo by TMA (else gathered)
    chunk: int = CHUNK             # channels a chunk: CHUNK, CHUNK_F32,
                                   # CHUNK_S8

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
        """(partial-tile elements, f32 or int32 for int8, and int32
        counters) for split > 1."""
        if self.split == 1:
            return 0, 0
        tiles = self.grid[0] * self.grid[1]
        return tiles * self.split * CONSUMER_THREADS * self.bn // 2, tiles


def stats_slots(plan: ConvPlan) -> int:
    """Slots of the statistics' partial sums (each ``2 * Cout`` floats):
    one per brick of the wgmma kernel's ``plan``, sample s's the run s *
    per .. (s + 1) * per - 1; the kernel adds them up in that order."""
    return plan.grid[0]


def conv_plan(n: int, dims: Sequence[int], chans: Sequence[int], cout: int,
              aligned: bool = True, chunk: int = CHUNK) -> ConvPlan:
    """The wgmma kernel's plan from the shapes, with chunks of ``chunk``
    channels (``CHUNK``; float32 ``CHUNK_F32``, int8 ``CHUNK_S8``): Cout
    blocks of 64 (Cout <= 64) or 128; a grid under ``MIN_CTAS`` CTAs
    splits the channel chunks across more; the halo comes by TMA when
    every part's channels are a multiple of ``chunk`` (a chunk then lies
    in one part) and its pointer is 16-byte aligned (``aligned``).

    float32 (3xTF32) runs one CTA an SM with Cout blocks of 64 (a tap's
    sums beside the brick's fill the registers); the chunks split as far
    as one wave of ``SMS`` holds. At 4^3 (HybridMIM, N 2) one wave of
    BN-64 CTAs ran the dgrad rows of ``chip_smoke.py``'s phase 3h 1.4-3.6x
    faster than BN 128 split over two waves (H100)."""
    cin = sum(chans)
    nchunk = _cdiv(cin, chunk)
    blocks = [_cdiv(s, b) for s, b in zip(dims, BRICK)]
    bricks = n * blocks[0] * blocks[1] * blocks[2]
    if chunk == CHUNK_F32:
        # one CTA an SM, Cout blocks of 64; the chunks split as far as one
        # wave holds
        bn = 64
        ctas = bricks * _cdiv(cout, bn)
        split = max(1, min(nchunk, SMS // ctas))
        per_split = _cdiv(nchunk, split)
    else:
        bn = 64 if cout <= 64 else 128
        ctas = bricks * _cdiv(cout, bn)
        split = min(nchunk, _cdiv(MIN_CTAS, ctas)) if ctas < MIN_CTAS else 1
        per_split = _cdiv(nchunk, split)
    return ConvPlan(n=n, dims=tuple(dims), cin=cin, cout=cout, bn=bn,
                    nchunk=nchunk, split=_cdiv(nchunk, per_split),
                    per_split=per_split,
                    tma=aligned and all(c % chunk == 0 for c in chans),
                    chunk=chunk)


# the weight-gradient kernel's geometry (csrc/conv3d_wgrad.cu). float32
# (3xTF32 mma.sync): a CTA owns WGRAD_F32_TILE (Cout, Cin) channels x the
# nine (y, x) taps of one z tap; a chunk is whole (sample, z) slices where
# a slice has at most WGRAD_F32_SLICE voxels (as many as fit WGRAD_F32_K
# voxels and two stages in WGRAD_F32_RING_BYTES), else a patch of
# WGRAD_F32_PATCH[1] x's by one of WGRAD_F32_ROWS rows (WGRAD_F32_PATCH
# where h is a multiple of 16) of one slice; K is padded to the k8 step.
WGRAD_F32_TILE = (64, 32)
WGRAD_F32_PATCH = (16, 8)
WGRAD_F32_ROWS = (8, 12, 16, 24)
WGRAD_F32_SLICE = 160
WGRAD_F32_K = 128
WGRAD_F32_RING_BYTES = 200 * 1024
# bfloat16 (wgmma): a CTA owns WGRAD_BF16_TILE[0] Cout x WGRAD_BF16_TILE[1]
# Cin (WGRAD_STEM_CI at Cin <= WGRAD_STEM_CI: the stems) x the nine (y, x)
# taps of one z tap; a chunk is whole slices where a slice is at most
# WGRAD_K voxels, else 128 voxels of one slice (256 for the stems), K a
# multiple of WGRAD_K_UNIT (the kernel keeps four k16 steps in flight).
# The chunks are split as far as the estimate below gains, with a
# workspace of at most WGRAD_WORKSPACE bytes.
WGRAD_BF16_TILE = (64, 64)
WGRAD_STEM_CI = 16
WGRAD_K = 192
WGRAD_K_UNIT = 64
WGRAD_WORKSPACE = 32e6
# the kernel's ring of stages (shared memory) and the fewest stages it runs
# with: a chunk must fit three times
WGRAD_RING_BYTES = 200 * 1024
WGRAD_MIN_STAGES = 3
# for the split estimate: a CTA's multiply-adds a second (60% of an SM's
# bf16 peak; float32, one CTA an SM, 40% of its TF32 peak over the three
# products of 3xTF32) and the bytes a second of the partials' second pass
_WGRAD_FMA_PER_S = 0.6 * 989e12 / 2 / SMS
_WGRAD_F32_FMA_PER_S = 0.4 * 495e12 / 3 / 2 / SMS
_WGRAD_REDUCE_BYTES_PER_S = 2.5e12


@dataclasses.dataclass(frozen=True)
class WgradPlan:
    """Launch plan of the weight-gradient kernel: ``groups`` CTA tiles of
    (Cout block, Cin block of ``ci_tile``, z tap) times ``split`` runs of
    ``per_split`` chunks; each run's partial dW goes to a workspace that a
    second pass sums in a fixed order (split 1 writes dW itself). A chunk
    is ``slices`` (sample, z) slices x ``ty`` x ``tx`` output voxels at one
    (y, x) tile; ``nchunk`` counts those of the middle z tap. ``dense``: a
    z tap's chunks enumerate only the slices whose z + dz lies in the
    volume (both kernels do)."""
    n: int
    dims: Tuple[int, int, int]
    groups: int
    nchunk: int
    split: int
    per_split: int
    ci_tile: int
    tx: int
    ty: int
    slices: int
    dense: bool

    def chunks(self, s: int) -> range:
        return range(s * self.per_split,
                     min(self.nchunk, (s + 1) * self.per_split))

    def chunk(self, q: int, dz: int) -> Tuple[int, int, list]:
        """(y0, x0) and the (sample, z) slices that chunk q of z tap dz
        adds up, decoded as the kernel decodes it ([] for a chunk it
        skips, or past the last)."""
        d, h, w = self.dims
        nxt, nyt = _cdiv(w, self.tx), _cdiv(h, self.ty)
        x0, y0 = q % nxt * self.tx, q // nxt % nyt * self.ty
        first = q // (nxt * nyt) * self.slices
        nz = d - abs(dz) if self.dense else d
        out = []
        for i in range(first, min(first + self.slices, self.n * nz)):
            n, z = divmod(i, nz)
            z += (dz < 0) if self.dense else 0
            if 0 <= z + dz < d:
                out.append((n, z))
        return y0, x0, out


def wgrad_stage_bytes(tx: int, ty: int, slices: int, ci_tile: int) -> int:
    """Shared memory of one stage of the bf16 kernel's ring: the g tile
    (128 bytes a voxel) and each slice's (ty + 2) x (tx + 2) halo tile of
    u, its rows rounded up to 8, at ci_tile * 2 bytes a voxel."""
    rows = _cdiv((ty + 2) * (tx + 2), 8) * 8
    return _cdiv(slices * ty * tx * 128 + slices * rows * ci_tile * 2,
                 1024) * 1024


def _wgrad_chunk(h: int, w: int, ci_tile: int) -> Tuple[int, int, int]:
    """(tx, ty, slices) of a bfloat16 chunk: runs of 8 x, tx 16 unless 8
    pads less; whole slices while a slice has at most WGRAD_K voxels (ty
    its rows, rounded up to even), as many as fit in WGRAD_K, else 128
    voxels of one slice (256 at the stems' Cin tile). K = slices * ty * tx
    is a multiple of WGRAD_K_UNIT and a stage fits WGRAD_MIN_STAGES times
    in the ring: where whole slices cannot give that, fewer slices or
    padding rows do."""
    tx = 16 if _cdiv(w, 16) * 16 <= _cdiv(w, 8) * 8 else 8
    if h * tx > WGRAD_K:
        # the stems' 16 channels leave room for chunks of 256 voxels: more
        # gathered loads in flight a chunk
        return tx, (256 if ci_tile == WGRAD_STEM_CI else 128) // tx, 1
    ty = h + h % 2
    while True:
        for slices in range(max(1, WGRAD_K // (ty * tx)), 0, -1):
            fits = (WGRAD_MIN_STAGES * wgrad_stage_bytes(tx, ty, slices,
                                                         ci_tile)
                    <= WGRAD_RING_BYTES)
            if slices * ty * tx % WGRAD_K_UNIT == 0 and fits:
                return tx, ty, slices
        ty += 2


def _wgrad_split(nchunk: int, groups: int, chunk_s: float,
                 out_bytes: int) -> Tuple[int, int]:
    """(split, per_split) with the least estimated time: the waves of
    ``groups * split`` CTAs on SMS SMs, each its chunks and one more (the
    pipeline's fill and the epilogue), plus the partials' second pass."""
    if nchunk == 0:                    # an empty volume: dW is zeros
        return 1, 1
    best = None
    for split in range(1, min(nchunk, 8 * SMS) + 1):
        per = _cdiv(nchunk, split)
        if _cdiv(nchunk, per) != split:
            continue
        if split > 1 and split * out_bytes > WGRAD_WORKSPACE:
            break
        t = _cdiv(groups * split, SMS) * (per + 1) * chunk_s
        if split > 1:
            t += (split + 1) * out_bytes / _WGRAD_REDUCE_BYTES_PER_S
        if best is None or t < best[0]:
            best = (t, split, per)
    return best[1], best[2]


def wgrad_f32_stage_bytes(tx: int, ty: int, slices: int) -> int:
    """Shared memory of one stage of the float32 kernel: the g rows (K
    padded to 8, WGRAD_F32_TILE[0] + 8 floats each) and each slice's (ty +
    2) x (tx + 2) halo tile of u (WGRAD_F32_TILE[1] + 8 floats a voxel)."""
    k8 = _cdiv(slices * ty * tx, 8) * 8
    co, ci = WGRAD_F32_TILE
    return 4 * (k8 * (co + 8) + slices * (ty + 2) * (tx + 2) * (ci + 8))


def _wgrad_chunk_f32(h: int, w: int) -> Tuple[int, int, int]:
    """(tx, ty, slices) of a float32 chunk: whole slices where a slice has
    at most WGRAD_F32_SLICE voxels, as many as WGRAD_F32_K voxels hold (at
    least one) while two stages fit WGRAD_F32_RING_BYTES; else a patch of
    WGRAD_F32_PATCH[1] x's and the most rows of WGRAD_F32_ROWS that pad h
    the least (at 24^3, 24 rows and not 16: none of them padding)."""
    if h * w > WGRAD_F32_SLICE:
        tx = WGRAD_F32_PATCH[1]
        ty = min(WGRAD_F32_ROWS, key=lambda t: (_cdiv(h, t) * t, -t))
        return tx, ty, 1
    slices = max(1, WGRAD_F32_K // (h * w))
    while (slices > 1 and 2 * wgrad_f32_stage_bytes(w, h, slices)
           > WGRAD_F32_RING_BYTES):
        slices -= 1
    return w, h, slices


@functools.lru_cache(maxsize=None)
def wgrad_plan(n: int, dims: Tuple[int, int, int], cin: int, cout: int,
               dtype: torch.dtype = torch.bfloat16) -> WgradPlan:
    d, h, w = dims
    if dtype != torch.bfloat16:
        tx, ty, slices = _wgrad_chunk_f32(h, w)
        co_tile, ci_tile = WGRAD_F32_TILE
        fma_per_s = _WGRAD_F32_FMA_PER_S
    else:
        ci_tile = (WGRAD_STEM_CI if cin <= WGRAD_STEM_CI
                   else WGRAD_BF16_TILE[1])
        tx, ty, slices = _wgrad_chunk(h, w, ci_tile)
        co_tile = WGRAD_BF16_TILE[0]
        fma_per_s = _WGRAD_FMA_PER_S
    nchunk = _cdiv(n * d, slices) * _cdiv(h, ty) * _cdiv(w, tx)
    groups = _cdiv(cout, co_tile) * _cdiv(cin, ci_tile) * 3
    chunk_s = slices * ty * tx * co_tile * ci_tile * 9 / fma_per_s
    split, per_split = _wgrad_split(nchunk, groups, chunk_s,
                                    cout * cin * 27 * 4)
    return WgradPlan(n=n, dims=(d, h, w), groups=groups, nchunk=nchunk,
                     split=split, per_split=per_split, ci_tile=ci_tile,
                     tx=tx, ty=ty, slices=slices, dense=True)


def pack_weight(weight: torch.Tensor, bn: int,
                chunk: int = CHUNK) -> torch.Tensor:
    """(Cout, Cin, 3, 3, 3) -> the wgmma kernel's layout (Cout_pad / bn,
    nchunk, 27, 2, bn, chunk / 2), zero-padded: element [cb, j, tap, g, c,
    e] is weight[cb * bn + c, chunk j + chunk / 2 g + e, tap]. One (cb, j,
    dz) slab of 9 taps is one contiguous stage of the kernel's weight ring,
    in wgmma's K-major core-matrix layout (8 output channels x 16 bytes of
    input channels, 128 bytes)."""
    cout, cin = weight.shape[:2]
    ncb, nchunk = _cdiv(cout, bn), _cdiv(cin, chunk)
    w = torch.zeros((ncb * bn, nchunk * chunk, 27), dtype=weight.dtype,
                    device=weight.device)
    w[:cout, :cin] = weight.reshape(cout, cin, 27)
    w = w.reshape(ncb, bn, nchunk, 2, chunk // 2, 27).permute(0, 2, 5, 3, 1,
                                                               4)
    return w.contiguous()


def pack_weight_s8(wq: torch.Tensor, bn: int) -> torch.Tensor:
    """The int8 kernel's layout: ``pack_weight`` of the int8 (Cout, Cin,
    3, 3, 3) ``wq`` with chunks of ``CHUNK_S8``, (Cout_pad / bn, nchunk,
    27, 2, bn, 16): element [cb, j, tap, g, c, e] is wq[cb * bn + c, 32 j +
    16 g + e, tap]; a (cb, j, dz) stage is 9 * 32 * bn bytes, as bfloat16's
    is."""
    return pack_weight(wq, bn, CHUNK_S8)


def unpack_weight(packed: torch.Tensor, cout: int, cin: int) -> torch.Tensor:
    """The inverse of ``pack_weight`` (and ``pack_weight_s8``): (Cout,
    Cin, 3, 3, 3)."""
    ncb, nchunk, _, _, bn, half = packed.shape
    w = packed.permute(0, 4, 1, 3, 5, 2).reshape(ncb * bn,
                                                 nchunk * 2 * half, 27)
    return w[:cout, :cin].reshape(cout, cin, 3, 3, 3)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to tf32 as ``cvt.rna.tf32.f32`` rounds it: to
    nearest, ties away from zero (half an ulp added to the magnitude's bit
    pattern), the low 13 bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(big, small) of float32 ``x``: big = tf32(x), small = tf32(x - big)
    (x - big is exact in float32). big + small is x within 2^-22 of |x|:
    the operands of the 3xTF32 products."""
    big = tf32_round(x)
    return big, tf32_round(x - big)


def pack_weight_tf32(weight: torch.Tensor, bn: int) -> torch.Tensor:
    """The float32 kernel's layout: ``pack_weight`` with chunks of
    ``CHUNK_F32`` of the tf32 big and small parts (``tf32_split``), side by
    side in each (Cout block, chunk, dz) stage: (Cout_pad / bn, nchunk, 3,
    2, 9, 2, bn, 4), element [cb, j, dz, p, t, g, c, e] part p of
    weight[cb * bn + c, 8 j + 4 g + e, 9 dz + t]. A stage is 2 * 9 * 32 *
    bn bytes, one bulk copy, and its small half lies 9 * 32 * bn bytes past
    its big half."""
    cout, cin = weight.shape[:2]
    ncb, nchunk = _cdiv(cout, bn), _cdiv(cin, CHUNK_F32)
    w = weight.new_zeros((2, ncb * bn, nchunk * CHUNK_F32, 27))
    for p, v in enumerate(tf32_split(weight.reshape(cout, cin, 27))):
        w[p, :cout, :cin] = v
    w = w.reshape(2, ncb, bn, nchunk, 2, CHUNK_F32 // 2, 3, 9)
    return w.permute(1, 3, 6, 0, 7, 4, 2, 5).contiguous()


def unpack_weight_tf32(packed: torch.Tensor, cout: int, cin: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The inverse of ``pack_weight_tf32``: the (big, small) parts, each
    (Cout, Cin, 3, 3, 3)."""
    ncb, nchunk, _, _, _, _, bn, half = packed.shape
    return tuple(unpack_weight(packed[:, :, :, p].reshape(
        ncb, nchunk, 27, 2, bn, half), cout, cin) for p in range(2))


# (id(weight), transposed) -> (weakref to the weight, key, packed weights)
_PACKED: dict = {}


def packed_weight(weight: torch.Tensor, dtype: torch.dtype,
                  device: torch.device, bn: int = 0,
                  transposed: bool = False) -> torch.Tensor:
    """``weight`` in the kernel's layout for ``dtype`` (``pack_weight``
    with Cout blocks of ``bn`` for bfloat16, ``pack_weight_s8`` with them
    for an int8 ``weight``, ``pack_weight_tf32`` for float32), on
    ``device``;
    with ``transposed``, the dgrad weights ``flip_weight(weight)``
    instead, kept beside the forward pack. The
    result is kept while the weight tensor lives and reused while its
    storage, version counter (bumped by every in-place update), dtype,
    device and ``bn`` stay the same. Inference tensors have no version
    counter: they are packed at every call."""
    try:
        key = (weight.data_ptr(), weight._version, dtype, device, bn)
    except RuntimeError:
        key = None
    slot = (id(weight), transposed)
    entry = _PACKED.get(slot)
    if (key is not None and entry is not None and entry[0]() is weight
            and entry[1] == key):
        return entry[2]
    w = weight.detach().to(device, dtype)
    if transposed:
        w = flip_weight(w)
    if dtype == torch.int8:
        packed = pack_weight_s8(w, bn)
    elif dtype == torch.bfloat16:
        packed = pack_weight(w, bn)
    else:
        packed = pack_weight_tf32(w, bn)
    if key is not None:
        _PACKED[slot] = (
            weakref.ref(weight, lambda _: _PACKED.pop(slot, None)), key,
            packed)
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


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check_parts(parts: Sequence[torch.Tensor],
                 dtypes: Tuple[torch.dtype, ...] = (torch.float32,
                                                    torch.bfloat16)) -> list:
    """The parts' channel counts, after checking that they are CUDA
    tensors of one of ``dtypes`` and (N, D, H, W) and contiguous."""
    if not parts or len(parts) > MAX_PARTS:
        raise ValueError(f"conv3x3 takes 1 to {MAX_PARTS} parts, got "
                         f"{len(parts)}")
    x0 = parts[0]
    _native.require_cuda(x0, "parts[0]")
    dt, dev = x0.dtype, x0.device
    if dt not in dtypes:
        raise TypeError(f"parts dtype {dt} not supported "
                        f"({', '.join(map(str, dtypes))})")
    if x0.dim() != 5:
        raise ValueError(f"parts must be (N, D, H, W, C), got "
                         f"{tuple(x0.shape)}")
    for i, p in enumerate(parts):
        if (p.dim() != 5 or p.shape[:4] != x0.shape[:4]
                or p.dtype != dt or p.device != dev):
            raise ValueError(f"part {i} {tuple(p.shape)} {p.dtype} on "
                             f"{p.device} does not match part 0 "
                             f"{tuple(x0.shape)} {dt} on {dev}")
        if not p.is_contiguous():
            raise ValueError(f"part {i} must be contiguous (NDHWC)")
    return [p.shape[4] for p in parts]


def _part_args(parts: Sequence[torch.Tensor], chans: Sequence[int]) -> tuple:
    """The C entry points' (p0..p3, c0..c3, nparts)."""
    pad = MAX_PARTS - len(parts)
    return (*[p.data_ptr() for p in parts], *[None] * pad, *chans,
            *[0] * pad, len(parts))


def _prologue_args(prologue: Optional[Prologue], n: int, cin: int,
                   dev: torch.device) -> tuple:
    """(scale, shift, const) as contiguous float32 rows (or None) and the
    prologue's slope (1: no activation)."""
    if prologue is None:
        return (None, None, None), 1.0
    scale, shift, const, slope = prologue
    pro = tuple(_f32_rows(v, n, cin, dev, name) for v, name in
                ((scale, "scale"), (shift, "shift"), (const, "const")))
    if pro[0] is None or pro[1] is None:
        raise ValueError("prologue needs scale and shift")
    return pro, 1.0 if slope is None else float(slope)


def _launch(parts: Sequence[torch.Tensor], weight: torch.Tensor,
            bias: Optional[torch.Tensor], prologue: Optional[Prologue],
            negative_slope: Optional[float], with_stats: bool,
            transposed: bool = False):
    """One launch of the forward kernel on CUDA parts; with
    ``transposed``, of the conv with ``flip_weight(weight)`` (dgrad)."""
    chans = _check_parts(parts)
    x0 = parts[0]
    dt, dev = x0.dtype, x0.device
    n, d, h, w = x0.shape[:4]
    cin = sum(chans)
    cout = weight.shape[1 if transposed else 0]
    want = (cin, cout) if transposed else (cout, cin)
    if tuple(weight.shape) != (*want, 3, 3, 3):
        raise ValueError(f"weight must be ({want[0]}, {want[1]}, 3, 3, 3) "
                         f"for parts of {chans} channels, got "
                         f"{tuple(weight.shape)}")
    if bias is not None:
        if tuple(bias.shape) != (cout,):
            raise ValueError(f"bias must be ({cout},), got "
                             f"{tuple(bias.shape)}")
        bias = bias.to(dev, torch.float32).contiguous()
    pro, pro_slope = _prologue_args(prologue, n, cin, dev)
    out = torch.empty((n, d, h, w, cout), dtype=dt, device=dev)
    plan = conv_plan(n, (d, h, w), chans, cout,
                     aligned=all(p.data_ptr() % 16 == 0 for p in parts),
                     chunk=CHUNK if dt == torch.bfloat16 else CHUNK_F32)
    stats = stats_part = None
    if with_stats:
        # each output brick's partial sums get a slot of their own, which a
        # second kernel adds up in order (reproducible, no float atomics)
        slots = stats_slots(plan)
        stats = torch.zeros((n, 2, cout), dtype=torch.float32, device=dev)
        stats_part = torch.empty(slots * 2 * cout, dtype=torch.float32,
                                 device=dev)
    common = _part_args(parts, chans)
    epilogue = (_ptr(bias), *map(_ptr, pro), pro_slope,
                1.0 if negative_slope is None else float(negative_slope),
                out.data_ptr(), _ptr(stats), _ptr(stats_part))
    wt = packed_weight(weight, dt, dev, plan.bn, transposed)
    n_partial, n_counter = plan.workspace()
    partial = counter = None
    if plan.split > 1:
        partial = torch.empty(n_partial, dtype=torch.float32, device=dev)
        counter = torch.zeros(n_counter, dtype=torch.int32, device=dev)
    err = _native.load().conv3x3_wgmma_forward(
        int(dt == torch.float32), *common, wt.data_ptr(), *epilogue,
        _ptr(partial), _ptr(counter), n, d, h, w, cout, plan.bn,
        plan.nchunk, plan.split, plan.per_split, int(plan.tma),
        _native.stream_ptr(dev))
    _native.check(err, "conv3x3_wgmma_forward")
    return (out, stats) if with_stats else out


def _forward(parts, weight, bias, prologue, negative_slope, with_stats):
    """The forward without autograd: the plain version for CPU parts, the
    kernel for CUDA parts."""
    if parts[0].device.type == "cpu":
        return conv3x3_plain(parts, weight, bias, prologue=prologue,
                             negative_slope=negative_slope,
                             with_stats=with_stats)
    out = _launch(parts, weight, bias, prologue, negative_slope, with_stats)
    conv3x3.launches += 1
    return out


def conv3x3_dgrad(g: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The conv's input gradient (N, D, H, W, Cin) from the gradient g at
    its pre-activation output: the plain version on the CPU, on CUDA the
    forward kernel with the flipped weights (no bias, no statistics)."""
    if g.device.type == "cpu":
        return conv3x3_dgrad_plain(g, weight)
    out = _launch([g], weight, None, None, None, False, transposed=True)
    conv3x3.dgrad_launches += 1
    return out


def conv3x3_wgrad(g: torch.Tensor, parts: Sequence[torch.Tensor],
                  prologue: Optional[Prologue] = None) -> torch.Tensor:
    """The conv's weight gradient (Cout, Cin, 3, 3, 3), float32 (float64
    for float64 on the CPU), from g (N, D, H, W, Cout) in the parts' dtype
    and the conv's input parts and prologue: the plain version on the CPU,
    on CUDA the kernel of ``csrc/conv3d_wgrad.cu``."""
    parts = list(parts)
    if g.device.type == "cpu":
        return conv3x3_wgrad_plain(g, parts, prologue)
    chans = _check_parts(parts)
    dt, dev = parts[0].dtype, parts[0].device
    n, d, h, w = parts[0].shape[:4]
    if (g.dim() != 5 or g.shape[:4] != parts[0].shape[:4] or g.dtype != dt
            or g.device != dev or not g.is_contiguous()):
        raise ValueError(f"g {tuple(g.shape)} {g.dtype} on {g.device} must "
                         f"be a contiguous ({n}, {d}, {h}, {w}, Cout) "
                         f"{dt} tensor on {dev}")
    cin, cout = sum(chans), g.shape[4]
    pro, pro_slope = _prologue_args(prologue, n, cin, dev)
    plan = wgrad_plan(n, (d, h, w), cin, cout, dt)
    out = torch.empty((cout, cin, 3, 3, 3), dtype=torch.float32, device=dev)
    partial = (torch.empty(plan.split * out.numel(), dtype=torch.float32,
                           device=dev) if plan.split > 1 else None)
    err = _native.load().conv3x3_wgrad(
        g.data_ptr(), *_part_args(parts, chans), *map(_ptr, pro), pro_slope,
        out.data_ptr(), _ptr(partial), n, d, h, w, cout, plan.split,
        plan.per_split, int(dt == torch.bfloat16), plan.tx, plan.ty,
        plan.slices, plan.ci_tile, _native.stream_ptr(dev))
    _native.check(err, "conv3x3_wgrad")
    conv3x3_wgrad.launches += 1
    return out


conv3x3_wgrad.launches = 0


class _Conv3x3(torch.autograd.Function):
    """``conv3x3`` with its gradients (module docstring). ``meta`` is
    (number of parts, prologue slope, prologue on, negative_slope,
    with_stats); the prologue's scale, shift and const are inputs of
    their own (None where absent)."""

    @staticmethod
    def forward(ctx, meta, weight, bias, scale, shift, const, *parts):
        _, pro_slope, has_pro, slope, with_stats = meta
        prologue = (scale, shift, const, pro_slope) if has_pro else None
        out = _forward(list(parts), weight, bias, prologue, slope,
                       with_stats)
        ctx.meta = meta
        ctx.save_for_backward(weight, bias, scale, shift, const,
                              out[0] if with_stats else out, *parts)
        ctx.set_materialize_grads(False)
        return out

    @staticmethod
    def backward(ctx, dy, dstats=None):
        nparts, pro_slope, has_pro, slope, _ = ctx.meta
        weight, bias, scale, shift, const, y, *parts = ctx.saved_tensors
        needs = ctx.needs_input_grad
        dt = y.dtype
        acc = _acc_dtype(dt)
        g = torch.zeros(y.shape, dtype=acc, device=y.device) \
            if dy is None else dy.to(acc, copy=True)
        if dstats is not None:
            ds = dstats.to(acc)[:, :, None, None, None, :]
            g.add_(ds[:, 0]).addcmul_(y, 2.0 * ds[:, 1])
        if slope is not None:
            g = torch.where(y > 0, g, g * slope)
        dbias = (g.sum((0, 1, 2, 3)).to(bias.dtype)
                 if bias is not None and needs[2] else None)
        g = g.to(dt)
        prologue = (scale, shift, const, pro_slope) if has_pro else None
        dweight = (conv3x3_wgrad(g, parts, prologue).to(weight.dtype)
                   if needs[1] else None)
        dparts = [None] * nparts
        dpro = [None, None, None]
        if any(needs[6:]) or (has_pro and any(needs[3:6])):
            du = conv3x3_dgrad(g, weight)
            sums = [], [], []            # da, db, dconst per part
            off = 0
            for i, p in enumerate(parts):
                c = p.shape[-1]
                dui = du[..., off:off + c]
                if has_pro:
                    dui = dui.to(acc)
                    a = scale[:, off:off + c].to(acc)[:, None, None, None]
                    xi = p.to(acc)
                    pre = xi * a + shift[:, off:off + c].to(acc)[
                        :, None, None, None]
                    t = (dui if pro_slope is None
                         else torch.where(pre > 0, dui, dui * pro_slope))
                    for k, v in enumerate((t * xi, t, dui)):
                        sums[k].append(v.sum((1, 2, 3)))
                    dui = t * a
                if needs[6 + i]:
                    dparts[i] = dui.to(p.dtype)
                off += c
            if has_pro:
                for k, v in enumerate((scale, shift, const)):
                    if v is not None and needs[3 + k]:
                        dpro[k] = torch.cat(sums[k], dim=1).to(v.dtype)
        return (None, dweight, dbias, *dpro, *dparts)


def conv3x3(parts: Sequence[torch.Tensor], weight: torch.Tensor,
            bias: Optional[torch.Tensor] = None, *,
            prologue: Optional[Prologue] = None,
            negative_slope: Optional[float] = None,
            with_stats: bool = False):
    """y, or (y, stats) with ``with_stats``. CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise. Where autograd needs
    a gradient the call goes through ``_Conv3x3``, whose backward launches
    ``conv3x3_dgrad`` and ``conv3x3_wgrad`` (their plain versions on the
    CPU)."""
    parts = list(parts)
    if not parts or len(parts) > MAX_PARTS:
        raise ValueError(f"conv3x3 takes 1 to {MAX_PARTS} parts, got "
                         f"{len(parts)}")
    pro = (None,) * 3 if prologue is None else tuple(prologue[:3])
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (*parts, weight, bias, *pro)):
        meta = (len(parts), None if prologue is None else prologue[3],
                prologue is not None, negative_slope, with_stats)
        return _Conv3x3.apply(meta, weight, bias, *pro, *parts)
    return _forward(parts, weight, bias, prologue, negative_slope,
                    with_stats)


conv3x3.launches = 0          # forward launches
conv3x3.dgrad_launches = 0    # launches of the forward kernel as dgrad


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


def batch_affine_from_stats(stats: torch.Tensor, gamma: torch.Tensor,
                            beta: torch.Tensor, count: int,
                            eps: float = EPS
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch norm (statistics over the samples and the ``count`` voxels of
    each) as one per-channel affine from the conv's (N, 2, C) (sum, sum of
    squares): the samples' sums added in float64 (a reduction without
    atomics: the same bits on every run), then the one-pass variance
    clamped at 0. Returns (a, b), both (C,) in the statistics' dtype, with
    ``y * a + b`` the normalised, scaled and shifted ``y``."""
    total = stats.double().sum(0) / (stats.shape[0] * count)
    mean = total[0]
    var = torch.clamp(total[1] - mean * mean, min=0.0)
    a = torch.rsqrt(var + eps) * gamma.double()
    return a.to(stats.dtype), (beta.double() - mean * a).to(stats.dtype)
