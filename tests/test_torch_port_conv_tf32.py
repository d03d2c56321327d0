"""PyTorch port, the float32 conv kernels' 3xTF32 arithmetic and layouts
(``ops/conv3d.py``: ``tf32_split``, ``pack_weight_tf32``, ``conv_plan`` in
float32, ``wgrad_plan`` in float32) on the CPU.

On the card every float32 conv runs on the tensor cores as 3xTF32: each
float32 value x is split into big = tf32(x) and small = tf32(x - big)
(round to nearest, ties away: ``cvt.rna.tf32.f32``), and each product is
big * big + big * small + small * big. Here the split is held to its
bounds, the sum of the three products is emulated in float64 over the
split weights and activations (prologue included) and held against
``conv3x3_plain`` and the JAX package's ``conv3d_same`` (interpret mode),
the split weight pack is read back at the byte offsets the forward kernel
reads it at, the float32 forward plan covers every voxel and (tap,
channel) once, and the weight-gradient kernel's chunk geometry and index
math (whole slices, the voxel table, the k8 padding) are emulated in
float64 against ``conv3x3_wgrad_plain``."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from diff_unet_tpu.ops.pallas_conv import conv3d_same
from diff_unet_tpu_torch.ops.conv3d import (
    BRICK,
    CHUNK_F32,
    _conv_input,
    SMS,
    WGRAD_F32_PATCH,
    WGRAD_F32_RING_BYTES,
    WGRAD_F32_ROWS,
    WGRAD_F32_SLICE,
    conv3x3,
    conv3x3_plain,
    conv3x3_wgrad_plain,
    conv_plan,
    flip_weight,
    pack_weight_tf32,
    packed_weight,
    tf32_round,
    tf32_split,
    unpack_weight_tf32,
    wgrad_f32_stage_bytes,
    wgrad_plan,
)
from tests.test_torch_port_conv import AMOS_CONVS
from tests.test_torch_port_swin import torch_threads  # noqa: F401

# HybridMIM pretraining's distinct convs (examples/pretrain_mim.py: batch 2
# of 64^3, features (64, 64, 128, 256, 512, 64)): (D, H, W), part
# channels, Cout
MIM_CONVS = [((64,) * 3, [1], 64), ((64,) * 3, [64], 64),
             ((32,) * 3, [64], 64), ((32,) * 3, [64, 64], 64),
             ((16,) * 3, [64], 128), ((16,) * 3, [128], 128),
             ((16,) * 3, [64, 64], 64), ((16,) * 3, [64], 64),
             ((8,) * 3, [128], 256), ((8,) * 3, [256], 256),
             ((8,) * 3, [128, 128], 128), ((8,) * 3, [128], 128),
             ((4,) * 3, [256], 512), ((4,) * 3, [512], 512),
             ((4,) * 3, [256, 256], 256), ((4,) * 3, [256], 256)]
MIM_N = 2


def _low13(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) & 0x1FFF


@pytest.mark.parametrize("scale", [1e-30, 1e-6, 1.0, 1e6, 1e30])
def test_split_is_big_plus_small_within_2_pow_minus_22(scale):
    """big and small are tf32 (low 13 bits 0), big is x rounded to
    nearest with ties away, and big + small is x within 2^-22 of |x|;
    zeros split exactly, subnormals within 2^-137 (tf32 keeps 10 bits of
    a subnormal's mantissa too: its quantum there is 2^-136)."""
    rng = np.random.default_rng(int(np.log10(scale) + 40))
    x = torch.from_numpy((rng.standard_normal(20000) * scale)
                         .astype(np.float32))
    sub = torch.tensor([0.0, -0.0, 1e-40, -3e-42, 1.4e-45, 1.1e-38],
                       dtype=torch.float32)
    x = torch.cat([x, sub])
    big, small = tf32_split(x)
    assert (_low13(big) == 0).all() and (_low13(small) == 0).all()
    err = (big.double() + small.double() - x.double()).abs()
    normal = x.abs() >= torch.finfo(torch.float32).tiny
    assert (err[normal] <= 2.0 ** -22 * x.double().abs()[normal]).all()
    assert (err[~normal] <= 2.0 ** -137).all()
    assert torch.equal(big[-6:-4] + small[-6:-4], x[-6:-4])      # zeros
    # round to nearest, ties away from zero, on the magnitude's bit pattern
    ulp = torch.ldexp(torch.ones_like(x, dtype=torch.float64),
                      torch.frexp(x.double())[1] - 11)
    assert ((big.double() - x.double()).abs()[normal]
            <= ulp[normal] / 2).all()
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 3 * 2.0 ** -11)],
                       dtype=torch.float32)
    assert tf32_round(tie).tolist() == [1.0 + 2.0 ** -10,
                                        -(1.0 + 2.0 ** -9)]


def _emulated_tf32x3(parts, w, b, prologue):
    """The float32 kernel's arithmetic in float64: u = the prologue in
    float32 (as the producer warps apply it), both u and w split, y = the
    conv of big * big + big * small + small * big, plus the bias."""
    u = torch.cat(parts, -1)
    if prologue is not None:
        a, s, c, slope = prologue
        u = torch.nn.functional.leaky_relu(
            u * a[:, None, None, None] + s[:, None, None, None], slope)
        u = u + c[:, None, None, None]
    ub, us = (v.double().permute(0, 4, 1, 2, 3) for v in tf32_split(u))
    wb, ws = (v.double() for v in tf32_split(w))

    def conv(x, k):
        return torch.nn.functional.conv3d(x, k, padding=1)

    y = conv(ub, wb) + conv(ub, ws) + conv(us, wb) + b.double()[:, None,
                                                                None, None]
    return y.permute(0, 2, 3, 4, 1)


@pytest.mark.parametrize("chans,cout,prologue", [([16], 8, True),
                                                 ([1, 15], 16, False),
                                                 ([8, 24], 8, True)])
def test_tf32x3_sum_matches_plain_within_1e_6(chans, cout, prologue):
    """The emulated 3xTF32 conv against ``conv3x3_plain`` on the same
    float32 inputs, within 1e-6 of max |y|: a hundredth of
    ``KERNEL_TOL[float32]``, before the card runs it."""
    rng = np.random.default_rng(sum(chans) + cout)
    n, dims, cin = 2, (6, 7, 9), sum(chans)

    def t(a):
        return torch.from_numpy(a.astype(np.float32))

    parts = [t(rng.standard_normal((n, *dims, c))) for c in chans]
    w = t(rng.standard_normal((cout, cin, 3, 3, 3)) / np.sqrt(27 * cin))
    b = t(0.1 * rng.standard_normal(cout))
    pro = None
    if prologue:
        pro = (t(1 + 0.3 * rng.standard_normal((n, cin))),
               t(0.3 * rng.standard_normal((n, cin))),
               t(0.2 * rng.standard_normal((n, cin))), 0.1)
    got = _emulated_tf32x3(parts, w, b, pro)
    # u as the kernel takes it: the prologue in float32 (conv3x3_plain's
    # rounding points); then the plain version's float64 conv of those
    # values, which a float32 CPU conv would blur by its own rounding
    u = _conv_input(parts, pro)
    want = conv3x3_plain([u.double()], w.double(), b.double())
    err = (got - want).abs().max().item()
    assert err <= 1e-6 * want.abs().max().item()
    # one TF32 pass would not hold it
    one = torch.nn.functional.conv3d(
        tf32_round(u).double().permute(0, 4, 1, 2, 3),
        tf32_round(w).double(), padding=1).permute(0, 2, 3, 4, 1)
    assert (one + b.double() - want).abs().max().item() > 10 * err


def test_tf32x3_sum_matches_jax_conv3d_same():
    """The emulated 3xTF32 conv against the JAX package's Pallas
    ``conv3d_same`` (interpret mode) at that kernel's own tolerance against
    lax, 2e-5."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, 8, 12, 4)).astype(np.float32)
    wj = (rng.standard_normal((3, 3, 3, 4, 6)) / np.sqrt(108)).astype(
        np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = conv3d_same(jnp.asarray(x), jnp.asarray(wj), h_blk=4)
    w = torch.from_numpy(np.ascontiguousarray(wj.transpose(4, 3, 0, 1, 2)))
    got = _emulated_tf32x3([torch.from_numpy(x)], w, torch.zeros(6), None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("cout,cin,bn,transposed", [
    (24, 40, 64, False), (64, 1, 64, False), (256, 512, 128, False),
    (130, 12, 128, True), (64, 128, 64, True)])
def test_split_pack_unpacks_to_the_weights(cout, cin, bn, transposed):
    """``packed_weight`` in float32 (forward, and the dgrad's flipped
    weights) is ``pack_weight_tf32``: its big and small halves unpack to
    ``tf32_split`` of the weights, and every element sits at the byte
    offset the forward kernel's descriptors read: stage ((cb * nchunk +
    j) * 3 + dz) of 2 * 9 * 32 * bn bytes, the small half 9 * 32 * bn
    bytes on, tap t at t * 2 * bn * 16, plane g at g * bn * 16, output
    channel c at c * 16, element e at 4 e."""
    w = torch.from_numpy(np.random.default_rng(cin).standard_normal(
        (cout, cin, 3, 3, 3)).astype(np.float32))
    packed = packed_weight(w, torch.float32, torch.device("cpu"), bn,
                           transposed)
    want = flip_weight(w) if transposed else w
    co_n, ci_n = want.shape[:2]
    nchunk = -(-ci_n // CHUNK_F32)
    assert packed.shape == (-(-co_n // bn), nchunk, 3, 2, 9, 2, bn, 4)
    assert torch.equal(packed, pack_weight_tf32(want, bn))
    big, small = unpack_weight_tf32(packed, co_n, ci_n)
    wb, ws = tf32_split(want)
    assert torch.equal(big, wb) and torch.equal(small, ws)
    flat = packed.reshape(-1)
    stage = 2 * 9 * 32 * bn // 4                  # floats
    rng = np.random.default_rng(0)
    for _ in range(200):
        co, ci, tap = (int(rng.integers(m)) for m in (co_n, ci_n, 27))
        cb, c = divmod(co, bn)
        j, r = divmod(ci, CHUNK_F32)
        dz, tt = divmod(tap, 9)
        for p, part in enumerate((wb, ws)):
            at = ((cb * nchunk + j) * 3 + dz) * stage + p * stage // 2 \
                + (tt * 2 * bn * 16 + (r // 4) * bn * 16 + c * 16) // 4 \
                + r % 4
            assert flat[at] == part.reshape(co_n, ci_n, 27)[co, ci, tap]
    # zero padding on both channel axes
    assert packed[:, :, :, 0].count_nonzero() == wb.count_nonzero()


def _plan_cases():
    cases = [(MIM_N, *c) for c in MIM_CONVS]
    # dgrad: Cout -> Cin on the gradient (one part)
    cases += [(MIM_N, dims, [cout], sum(chans))
              for dims, chans, cout in MIM_CONVS if chans != [1]]
    return cases + [(4, *c) for c in AMOS_CONVS]


@pytest.mark.parametrize("n,dims,chans,cout", _plan_cases())
def test_float32_plan_covers_voxels_and_taps_once(n, dims, chans, cout):
    """``conv_plan`` in float32 (chunks of 8 channels): every output voxel
    in exactly one brick of one sample, every (tap, input channel) in
    exactly one split, every Cout in one block of 64; the halo by TMA
    where every part's channels are multiples of 8; at 8^3 and 4^3
    (HybridMIM's deep levels) the split fills one wave of the card's 132
    SMs (one CTA an SM)."""
    plan = conv_plan(n, dims, chans, cout, chunk=CHUNK_F32)
    assert plan.chunk == CHUNK_F32 and plan.bn == 64
    assert plan.bn * plan.grid[1] >= cout
    assert plan.tma == all(c % CHUNK_F32 == 0 for c in chans)
    seen = np.zeros((n, *dims), np.int32)
    for i in range(plan.grid[0]):
        s, z0, y0, x0 = plan.brick(i)
        seen[s, z0:z0 + BRICK[0], y0:y0 + BRICK[1], x0:x0 + BRICK[2]] += 1
    assert (seen == 1).all()
    cin = sum(chans)
    taps = np.zeros(plan.nchunk * CHUNK_F32, np.int32)
    for s in range(plan.split):
        assert len(plan.chunks(s)) > 0
        for j in plan.chunks(s):
            taps[j * CHUNK_F32:(j + 1) * CHUNK_F32] += 1
    assert (taps[:cin] == 1).all() and plan.nchunk == -(-cin // CHUNK_F32)
    tiles = plan.grid[0] * plan.grid[1]
    # split only within one wave of the card
    assert tiles * plan.split <= SMS or plan.split == 1
    if dims[0] <= 8 and n == MIM_N:
        # HybridMIM's deep levels fill the wave: one more split would not
        # fit in it
        assert tiles * (plan.split + 1) > SMS or plan.split == plan.nchunk


def _wgrad_f32_emulated(plan, g, u):
    """dW as the float32 kernel forms it, in float64: for each z tap its
    dense chunks (as ``gchunk_at`` and ``slice_nz`` decode them), each
    chunk's g rows (K padded to 8 with zero rows) and u halo tiles (one
    (ty + 2) x (tx + 2) tile a slice, zeros outside the volume), and each
    k8 step's products at every (dy, dx) tap through the voxel table
    tab[k] = s uvs + (r / tx) ux + r % tx."""
    n, d, h, w, cout = g.shape
    cin = u.shape[-1]
    tx, ty, sl = plan.tx, plan.ty, plan.slices
    ux, kv = tx + 2, sl * ty * tx
    uvs, k8 = (ty + 2) * ux, -(-kv // 8) * 8
    per = ty * tx
    tab = np.zeros(k8, np.int64)
    for k in range(kv):
        s, r = divmod(k, per)
        tab[k] = s * uvs + r // tx * ux + r % tx
    nyt, nxt = -(-h // ty), -(-w // tx)
    dw = np.zeros((cout, cin, 27))
    for dz in (-1, 0, 1):
        nz = d - (dz != 0)
        for q in range(-(-n * nz // sl) * nyt * nxt):
            x0, y0 = q % nxt * tx, q // nxt % nyt * ty
            slice0 = q // (nxt * nyt) * sl
            gt = np.zeros((k8, cout))
            ut = np.zeros((sl * uvs, cin))
            for s in range(sl):
                nn, z = divmod(slice0 + s, nz)
                z += dz < 0
                if nn >= n:
                    continue
                for k in range(per):
                    y, x = y0 + k // tx, x0 + k % tx
                    if y < h and x < w:
                        gt[s * per + k] = g[nn, z, y, x]
                for v in range(uvs):
                    y, x = y0 - 1 + v // ux, x0 - 1 + v % ux
                    if 0 <= y < h and 0 <= x < w:
                        ut[s * uvs + v] = u[nn, z + dz, y, x]
            for k0 in range(0, k8, 8):
                rows = gt[k0:k0 + 8]
                for tap in range(9):
                    vox = tab[k0:k0 + 8] + tap // 3 * ux + tap % 3
                    dw[:, :, 9 * (dz + 1) + tap] += rows.T @ ut[vox]
    return dw


@pytest.mark.parametrize("n,dims,chans,cout", [
    (2, (4, 4, 4), [8], 16),         # eight whole 4 x 4 slices a chunk
    (2, (8, 8, 8), [5], 8),          # two 8 x 8 slices
    (3, (6, 6, 6), [3, 4], 8),       # three 6 x 6 slices, K 108 -> 112
    (1, (3, 12, 12), [4], 4),        # one 12 x 12 slice, K 144
    (1, (3, 20, 13), [6], 4),        # 16 x 8 patches, ragged y and x
])
def test_wgrad_f32_chunks_give_the_plain_weight_gradient(n, dims, chans,
                                                         cout):
    """The float32 plan's chunk geometry and the kernel's index math add
    up to ``conv3x3_wgrad_plain``'s dW, float64, within 1e-10 of its
    largest value."""
    rng = np.random.default_rng(sum(dims) + cout)
    parts = [torch.from_numpy(rng.standard_normal((n, *dims, c)))
             for c in chans]
    g = torch.from_numpy(rng.standard_normal((n, *dims, cout)))
    plan = wgrad_plan(n, dims, sum(chans), cout, torch.float32)
    got = _wgrad_f32_emulated(plan, g.numpy(),
                              torch.cat(parts, -1).numpy())
    want = conv3x3_wgrad_plain(g, parts).reshape(cout, sum(chans), 27)
    np.testing.assert_allclose(got, want.numpy(), rtol=0,
                               atol=1e-10 * want.abs().max().item())


@pytest.mark.parametrize("h,w", [(64, 64), (32, 32), (16, 16), (12, 12),
                                 (8, 8), (6, 6), (4, 4), (2, 2), (7, 9)])
def test_wgrad_f32_chunk_geometry(h, w):
    """Whole slices where a slice has at most WGRAD_F32_SLICE voxels (at
    8^3 two, at 4^3 eight: no K step is padding but the last), else
    patches of 8 x's by the WGRAD_F32_ROWS rows that pad h the least
    (WGRAD_F32_PATCH at 64^3); two stages fit the ring."""
    plan = wgrad_plan(2, (8, h, w), 64, 64, torch.float32)
    assert 2 * wgrad_f32_stage_bytes(plan.tx, plan.ty, plan.slices) \
        <= WGRAD_F32_RING_BYTES
    if h * w <= WGRAD_F32_SLICE:
        assert (plan.ty, plan.tx) == (h, w)
        assert plan.slices * h * w <= max(128, h * w)
        assert -(-plan.slices * h * w // 8) * 8 - plan.slices * h * w < 8
    else:
        # runs of 8 x, the rows that pad h the least (the most of those)
        assert (plan.tx, plan.slices) == (WGRAD_F32_PATCH[1], 1)
        pad = {t: -(-h // t) * t for t in WGRAD_F32_ROWS}
        assert pad[plan.ty] == min(pad.values())
        assert plan.ty == max(t for t in pad if pad[t] == pad[plan.ty])
    assert {(4, 4): 8, (8, 8): 2, (64, 64): 1}.get(
        (h, w), plan.slices) == plan.slices
    assert (h, w) != (64, 64) or (plan.ty, plan.tx) == WGRAD_F32_PATCH


def test_float32_conv_on_the_cpu_is_the_plain_version():
    """On CPU tensors ``conv3x3`` in float32 is ``conv3x3_plain``: the 3xTF32
    kernel runs only on CUDA tensors."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((1, 4, 4, 4, 8), np.float32))
    w = torch.from_numpy(rng.standard_normal((8, 8, 3, 3, 3), np.float32))
    assert torch.equal(conv3x3([x], w), conv3x3_plain([x], w))


def _slice_nz(i, nz, dz, d, n):
    """``csrc/conv3d_wgrad.cu:slice_nz`` for slice i of a z tap: the
    sample by a 32-bit multiply-high with the reciprocal its launcher
    computes (``magic``, wrapped to 32 bits), or i itself where the tap has
    one valid z a sample."""
    v = d - (dz != 0)
    mul = ((2 ** 32 + v - 1) // max(v, 1)) % 2 ** 32
    s = i if nz == 1 else (i * mul) >> 32
    return min(s, n), i - s * nz + (dz < 0)


@pytest.mark.parametrize("d", [1, 2, 3, 6, 13, 64, 96])
def test_wgrad_slice_decode_matches_the_dense_enumeration(d):
    """Both weight-gradient kernels decode valid slice i of z tap dz as
    sample i // (d - |dz|), z = i % (d - |dz|) (+ 1 for dz = -1): also
    where a tap has one valid z a sample (d = 2 at dz = +-1, d = 1 at dz =
    0), whose reciprocal does not fit 32 bits."""
    for n in (1, 2, 10):
        for dz in (-1, 0, 1):
            nz = d - (dz != 0)
            for i in range(n * nz):
                want = (i // nz, i % nz + (dz < 0))
                assert _slice_nz(i, nz, dz, d, n) == want

