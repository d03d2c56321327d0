"""PyTorch port, the 3x3x3 conv (``ops/conv3d.py``) and the DiffUNet blocks
against the JAX package.

``conv3x3_plain`` is held against each Pallas conv kernel it replaces, run
in interpret mode on the kernel's own layout (pack-2 via ``pack_w``) and
shapes, in float32: ``conv3d_same``, ``conv3x3_aug`` and
``conv3x3_packed_aug`` at 2e-5 (the kernels' own tolerance against lax);
``conv3x3_packed_aug_pipelined`` with two parts, the prologue and the
statistics at 5e-4 for the output (the JAX package's own fused tolerance:
its halo pad-value compensation rounds) and 1e-4 relative for the
statistics. The port's fused ``TwoConv`` is held against JAX ``TwoConv``
(1e-4, summation order only) and ``PallasFusedTwoConv`` (5e-4, as above);
``Down``, ``UpCat`` (odd skip shape, replicate pad) and ``ConvNormAct``
against their JAX modules at 1e-4."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from diff_unet_tpu.models.basic_unet import PallasFusedTwoConv
from diff_unet_tpu.ops import blocks as jb
from diff_unet_tpu.ops import packed as pk
from diff_unet_tpu.ops.pallas_aug_conv import conv3x3_aug
from diff_unet_tpu.ops.pallas_conv import conv3d_same
from diff_unet_tpu.ops.pallas_packed_conv import (
    conv3x3_packed_aug,
    conv3x3_packed_aug_pipelined,
    prologue_pad_value,
)
from diff_unet_tpu_torch.ops import blocks as tb
from diff_unet_tpu_torch.ops.conv3d import (
    BRICK,
    CHUNK,
    MIN_CTAS,
    conv3x3,
    conv3x3_plain,
    F32_TILE_ROWS,
    conv_plan,
    norm_affine_from_stats,
    pack_weight,
    pack_weight_f32,
    packed_weight,
    stats_slots,
    unpack_weight,
)
from diff_unet_tpu_torch.utils.weights import load_jax_params
from tests.test_torch_port_swin import random_flax_params

TIGHT = dict(rtol=2e-5, atol=2e-5)
FUSED = dict(rtol=5e-4, atol=5e-4)
BLOCK = dict(rtol=1e-4, atol=1e-4)


def _inputs(seed, shape, cin, cout):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*shape, cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, cin, cout))
         / np.sqrt(27 * cin)).astype(np.float32)
    b = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    return x, w, b


def _tw(w):
    """flax DHWIO kernel -> the port's (Cout, Cin, 3, 3, 3)."""
    return torch.from_numpy(np.ascontiguousarray(w.transpose(4, 3, 0, 1, 2)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("shape,cin,cout,h_blk", [
    ((2, 8, 8, 12), 4, 6, 4),
    ((1, 4, 4, 10), 3, 5, 2),        # odd W and channels
])
def test_plain_matches_pallas_conv3d_same(shape, cin, cout, h_blk):
    """Row 6: 27 tap matmuls over halo slabs, no bias."""
    x, w, _ = _inputs(0, shape, cin, cout)
    with pltpu.force_tpu_interpret_mode():
        want = conv3d_same(jnp.asarray(x), jnp.asarray(w), h_blk=h_blk)
    got = conv3x3_plain([_t(x)], _tw(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TIGHT)


@pytest.mark.parametrize("kernel", ["packed_aug", "aug"])
def test_plain_matches_pallas_pack2_conv_bias_lrelu(kernel):
    """Rows 3 and 5: pack-2 input, bias and LeakyReLU epilogue."""
    x, w, b = _inputs(1, (2, 8, 8, 16), 6, 8)
    fn = conv3x3_packed_aug if kernel == "packed_aug" else conv3x3_aug
    with pltpu.force_tpu_interpret_mode():
        want = fn(pk.pack_w(jnp.asarray(x), 2), jnp.asarray(w),
                  jnp.asarray(b), block_d=4, block_h=4, negative_slope=0.1)
    got = conv3x3_plain([_t(x)], _tw(w), _t(b), negative_slope=0.1)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(pk.unpack_w(want, 2)), **TIGHT)


def test_plain_matches_pallas_pipelined_parts_prologue_stats():
    """Row 4: two parts, per-sample prologue lrelu(a*x+b)+c (the TPU kernel
    makes the halo exact with ``prologue_pad_value``; the port masks) and
    the per-(sample, channel) sum / sum-of-squares epilogue."""
    rng = np.random.default_rng(2)
    n, ca, cb, cout, slope = 2, 4, 6, 8, 0.1
    xa = rng.standard_normal((n, 8, 8, 16, ca)).astype(np.float32)
    xb = rng.standard_normal((n, 8, 8, 16, cb)).astype(np.float32)
    _, w, b = _inputs(3, (1,), ca + cb, cout)
    scale = (1.0 + 0.3 * rng.standard_normal((n, ca + cb))).astype(np.float32)
    shift = (0.3 * rng.standard_normal((n, ca + cb))).astype(np.float32)
    const = (0.2 * rng.standard_normal((n, ca + cb))).astype(np.float32)
    ps, pb, pc = (jnp.tile(jnp.asarray(v), (1, 2))
                  for v in (scale, shift, const))
    pv = prologue_pad_value(ps, pb, const=pc, negative_slope=slope)
    with pltpu.force_tpu_interpret_mode():
        want, wst = conv3x3_packed_aug_pipelined(
            [pk.pack_w(jnp.asarray(xa), 2), pk.pack_w(jnp.asarray(xb), 2)],
            jnp.asarray(w), jnp.asarray(b), block_d=4, block_h=4,
            prologue_scale=ps, prologue_bias=pb, prologue_const=pc,
            prologue_negative_slope=slope, pad_value=pv, with_stats=True)
    got, gst = conv3x3_plain(
        [_t(xa), _t(xb)], _tw(w), _t(b),
        prologue=(_t(scale), _t(shift), _t(const), slope), with_stats=True)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(pk.unpack_w(want, 2)), **FUSED)
    wst = np.asarray(wst)
    wst = wst[..., :cout] + wst[..., cout:]          # merge the two W halves
    np.testing.assert_allclose(gst.numpy(), wst, rtol=1e-4,
                               atol=1e-4 * np.abs(wst).max())


def test_plain_parts_and_prologue_reduce_to_one_conv():
    """Splitting the input into parts changes nothing, and the halo reads 0
    after the prologue (an explicit zero-padded conv of the transformed
    input)."""
    x, w, b = _inputs(4, (1, 5, 6, 7), 5, 3)
    rng = np.random.default_rng(5)
    a, c = (torch.from_numpy(rng.standard_normal((1, 5)).astype(np.float32))
            for _ in range(2))
    whole = conv3x3_plain([_t(x)], _tw(w), _t(b))
    split = conv3x3_plain([_t(x[..., :2]), _t(x[..., 2:])], _tw(w), _t(b))
    np.testing.assert_array_equal(whole.numpy(), split.numpy())
    got = conv3x3_plain([_t(x)], _tw(w), _t(b), prologue=(a, c, None, 0.2))
    u = torch.nn.functional.leaky_relu(_t(x) * a[:, None, None, None]
                                       + c[:, None, None, None], 0.2)
    want = torch.nn.functional.conv3d(u.permute(0, 4, 1, 2, 3), _tw(w),
                                      _t(b), padding=1)
    np.testing.assert_allclose(got.numpy(),
                               want.permute(0, 2, 3, 4, 1).numpy(), **TIGHT)


def test_norm_affine_from_stats_matches_jax():
    rng = np.random.default_rng(6)
    y = (2.0 * rng.standard_normal((2, 4, 4, 8, 8)) + 0.5).astype(np.float32)
    gamma = (1.0 + 0.5 * rng.standard_normal(8)).astype(np.float32)
    beta = (0.2 * rng.standard_normal(8)).astype(np.float32)
    stats = np.stack([y.sum(axis=(1, 2, 3)), (y * y).sum(axis=(1, 2, 3))], 1)
    wa, wb = pk.norm_affine_from_stats(jnp.asarray(stats), jnp.asarray(gamma),
                                       jnp.asarray(beta), 1, 128)
    ga, gb = norm_affine_from_stats(_t(stats), _t(gamma), _t(beta), 128)
    np.testing.assert_allclose(ga.numpy(), np.asarray(wa), **TIGHT)
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), **TIGHT)


def test_conv3x3_wrapper_raises_off_cpu():
    """A tensor that is not on the CPU never takes the plain version: a
    non-CUDA device is refused, as is a bad part count."""
    x = torch.empty((1, 4, 4, 4, 2), device="meta")
    w = torch.zeros((3, 2, 3, 3, 3))
    with pytest.raises(ValueError, match="CUDA"):
        conv3x3([x], w)
    with pytest.raises(ValueError, match="parts"):
        conv3x3([], w)


# (spatial dims, part channels, Cout) of every distinct conv of DiffUNet at
# the AMOS ROI (96^3) and at the test sizes 32^3 and 32x32x22
AMOS_CONVS = [((96,) * 3, [1], 64), ((96,) * 3, [1, 15], 64),
              ((96,) * 3, [64], 64), ((96,) * 3, [64, 64], 64),
              ((48,) * 3, [64], 64), ((48,) * 3, [64, 64], 64),
              ((24,) * 3, [64], 128), ((24,) * 3, [128], 128),
              ((24,) * 3, [128, 128], 128), ((12,) * 3, [128], 256),
              ((12,) * 3, [256], 256), ((12,) * 3, [256, 256], 256),
              ((6,) * 3, [256], 512), ((6,) * 3, [512], 512)]
SMALL_CONVS = [(dims, chans, cout) for dims in ((32, 32, 32), (32, 32, 22))
               for chans, cout in (([1, 15], 8), ([8], 8), ([8, 8], 16),
                                   ([16], 32), ([64, 64], 64))]


@pytest.mark.parametrize("cout,cin,bn", [(24, 40, 64), (64, 16, 64),
                                         (256, 512, 128), (130, 1, 128)])
def test_pack_weight_unpacks_to_the_original(cout, cin, bn):
    w = torch.from_numpy(np.random.default_rng(cin).standard_normal(
        (cout, cin, 3, 3, 3)).astype(np.float32))
    packed = pack_weight(w, bn)
    nchunk = -(-cin // CHUNK)
    assert packed.shape == (-(-cout // bn), nchunk, 27, 2, bn, 8)
    assert torch.equal(unpack_weight(packed, cout, cin), w)
    # element [cb, j, tap, g, c, e] is w[cb * bn + c, 16 j + 8 g + e, tap]
    co, ci, tap = cout - 1, cin - 1, 26
    cb, c = divmod(co, bn)
    j, r = divmod(ci, CHUNK)
    assert packed[cb, j, tap, r // 8, c, r % 8] == w[co, ci, 2, 2, 2]
    # the zero padding of both channel axes
    assert packed.count_nonzero() == w.count_nonzero()
    f32 = pack_weight_f32(w)
    assert f32.shape[0] % 64 == 0 and f32.shape[1] % 32 == 0
    assert torch.equal(f32[:cout, :27 * cin].reshape(cout, 3, 3, 3, cin)
                       .permute(0, 4, 1, 2, 3), w)


@pytest.mark.parametrize("dims,chans,cout", AMOS_CONVS + SMALL_CONVS)
def test_conv_plan_covers_voxels_and_taps_once(dims, chans, cout):
    """Every output voxel in exactly one brick (of one sample), every
    (tap, input channel) in exactly one split, every Cout in one block."""
    n = 4
    plan = conv_plan(n, dims, chans, cout)
    assert plan.bn in (64, 128) and plan.bn * plan.grid[1] >= cout
    assert plan.tma == all(c % CHUNK == 0 for c in chans)
    seen = np.zeros((n, *dims), np.int32)
    for i in range(plan.grid[0]):
        s, z0, y0, x0 = plan.brick(i)
        seen[s, z0:z0 + BRICK[0], y0:y0 + BRICK[1], x0:x0 + BRICK[2]] += 1
    assert (seen == 1).all()
    cin = sum(chans)
    taps = np.zeros((27, plan.nchunk * CHUNK), np.int32)
    for s in range(plan.split):
        assert len(plan.chunks(s)) > 0           # no split is empty
        for j in plan.chunks(s):
            taps[:, j * CHUNK:(j + 1) * CHUNK] += 1
    assert (taps[:, :cin] == 1).all() and plan.nchunk * CHUNK - cin < CHUNK
    ctas = plan.grid[0] * plan.grid[1]
    assert (plan.split > 1) == (ctas < MIN_CTAS and plan.nchunk > 1)
    assert plan.workspace() == ((ctas * plan.split * 256 * plan.bn // 2,
                                 ctas) if plan.split > 1 else (0, 0))


@pytest.mark.parametrize("n,dims", [(10, (2, 2, 2)), (5, (3, 3, 3)),
                                    (2, (6, 7, 9)), (3, (4, 4, 4)),
                                    (4, (12, 12, 12)), (10, (6, 6, 6))])
def test_stats_slots_are_distinct_and_in_sample_order(n, dims):
    """The statistics' partial-sum slots: in float32 each (64-voxel tile,
    sample) segment gets slot tile + sample, distinct, within
    ``stats_slots``, and sample s's slots are the run the reducing kernel
    reads (tiles first..last of s, plus s); in bfloat16 one slot per brick,
    sample s's the run s * bricks .. (s + 1) * bricks - 1."""
    v = dims[0] * dims[1] * dims[2]
    rows = np.arange(n * v)
    segments = sorted(set(zip(rows // F32_TILE_ROWS, rows // v)))
    slots = [t + s for t, s in segments]
    assert len(set(slots)) == len(slots)
    assert max(slots) < stats_slots(n, dims)
    for s in range(n):
        first = s * v // F32_TILE_ROWS
        last = ((s + 1) * v - 1) // F32_TILE_ROWS
        assert [t + q for t, q in segments if q == s] == \
            list(range(first + s, last + s + 1))
    plan = conv_plan(n, dims, [64], 64)
    per = plan.grid[0] // n
    assert stats_slots(n, dims, plan) == n * per
    assert [plan.brick(i)[0] for i in range(plan.grid[0])] == \
        [i // per for i in range(plan.grid[0])]


def test_packed_weight_is_reused_until_the_weight_changes():
    w = torch.randn((64, 16, 3, 3, 3))
    cpu = torch.device("cpu")
    first = packed_weight(w, torch.bfloat16, cpu, 64)
    packs = packed_weight.packs
    assert packed_weight(w, torch.bfloat16, cpu, 64) is first
    assert packed_weight.packs == packs
    assert packed_weight(w, torch.float32, cpu) is not first   # dtype
    w.add_(1.0)                                                # version
    again = packed_weight(w, torch.bfloat16, cpu, 64)
    assert again is not first and packed_weight.packs == packs + 2
    assert torch.equal(unpack_weight(again, 64, 16), w.bfloat16())


@pytest.fixture(scope="module")
def twoconv_case():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 8, 8, 16, 6)).astype(np.float32)
    temb = (0.1 * rng.standard_normal((2, 512))).astype(np.float32)
    mod = jb.TwoConv(8)
    params = random_flax_params(mod, x, temb, seed=8)
    return x, temb, params


@pytest.mark.parametrize("use_temb", [True, False])
def test_twoconv_matches_jax_twoconv_and_fused(twoconv_case, use_temb):
    x, temb, params = twoconv_case
    if not use_temb:
        params = {"params": {k: v for k, v in params["params"].items()
                             if k != "temb_proj"}}
        temb = None
    want = jb.TwoConv(8, use_temb=use_temb).apply(params, x, temb)
    with pltpu.force_tpu_interpret_mode():
        fused = PallasFusedTwoConv(8, 6, use_temb=use_temb).apply(
            params, [pk.pack_w(jnp.asarray(x), 2)], temb)
    mod = load_jax_params(tb.TwoConv(6, 8, use_temb=use_temb), params)
    with torch.no_grad():
        got = mod([_t(x)], None if temb is None else _t(temb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(pk.unpack_w(fused, 2)), **FUSED)


def test_twoconv_two_parts_matches_jax():
    """[skip, up] parts against the JAX TwoConv of their concat and the
    fused Pallas module fed the two packed parts."""
    rng = np.random.default_rng(9)
    xa = rng.standard_normal((1, 8, 8, 16, 4)).astype(np.float32)
    xb = rng.standard_normal((1, 8, 8, 16, 6)).astype(np.float32)
    temb = (0.1 * rng.standard_normal((1, 512))).astype(np.float32)
    cat = np.concatenate([xa, xb], axis=-1)
    params = random_flax_params(jb.TwoConv(8), cat, temb, seed=10)
    want = jb.TwoConv(8).apply(params, cat, temb)
    with pltpu.force_tpu_interpret_mode():
        fused = PallasFusedTwoConv(8, 10).apply(
            params, [pk.pack_w(jnp.asarray(xa), 2),
                     pk.pack_w(jnp.asarray(xb), 2)], temb)
    mod = load_jax_params(tb.TwoConv(10, 8), params)
    with torch.no_grad():
        got = mod([_t(xa), _t(xb)], _t(temb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(pk.unpack_w(fused, 2)), **FUSED)


def test_conv_norm_act_matches_jax():
    x = np.random.default_rng(11).standard_normal(
        (2, 6, 5, 7, 3)).astype(np.float32)
    params = random_flax_params(jb.ConvNormAct(4), x, seed=12)
    want = jb.ConvNormAct(4).apply(params, x)
    mod = load_jax_params(tb.ConvNormAct(3, 4), params)
    with torch.no_grad():
        got = mod(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK)


def test_down_matches_jax():
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 8, 9, 8, 4)).astype(np.float32)  # odd H
    temb = (0.1 * rng.standard_normal((2, 512))).astype(np.float32)
    params = random_flax_params(jb.Down(6), x, temb, seed=14)
    want = jb.Down(6).apply(params, x, temb)
    mod = load_jax_params(tb.Down(4, 6), params)
    with torch.no_grad():
        got = mod(_t(x), _t(temb))
    assert got.shape == (2, 4, 4, 4, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK)


def test_upcat_odd_skip_replicate_pad_matches_jax():
    rng = np.random.default_rng(15)
    x = rng.standard_normal((1, 3, 4, 4, 8)).astype(np.float32)
    skip = rng.standard_normal((1, 7, 8, 9, 4)).astype(np.float32)
    temb = (0.1 * rng.standard_normal((1, 512))).astype(np.float32)
    jm = jb.UpCat(6, 4)
    params = random_flax_params(jm, x, skip, temb, seed=16)
    want = jm.apply(params, x, skip, temb)
    mod = load_jax_params(tb.UpCat(8, 4, 4, 6), params)
    with torch.no_grad():
        got = mod(_t(x), _t(skip), _t(temb))
    assert got.shape == (1, 7, 8, 9, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK)
