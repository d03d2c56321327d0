"""PyTorch port, the s8 conv's quantize on load and norm prologue on the
CPU (``ops/int8.py``: ``conv3x3_int8`` with float parts, its plain
version, ``pack_weight_s8``, the int8 ``conv_plan``; ``ops/blocks.py``: the
quantized ``TwoConv`` and ``UpCat`` routes). The plain versions are what
the kernel is held to on the card, so each is held here to the chain it
replaces, bit for bit: ``quantize_act`` then the int8 conv (and JAX's
``conv_int8(quantize_act(x, sa), kq)`` run eagerly), the tensor-code norm
chain of ``TwoConv._forward_int8`` before the prologue moved into the
conv, and the blocks' outputs through the old route (quantize in the
block, int8 parts to the conv)."""
import functools
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from diff_unet_tpu.ops import int8 as jq
from diff_unet_tpu_torch.ops import blocks
from diff_unet_tpu_torch.ops import int8 as tq
from diff_unet_tpu_torch.ops.blocks import TwoConv, UpCat, quant_act_scale, \
    quant_weights
from diff_unet_tpu_torch.ops.conv3d import BRICK, CHUNK_S8, conv_plan, \
    norm_affine_from_stats, pack_weight_s8, unpack_weight
from tests.test_torch_port_swin import torch_threads  # noqa: F401

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _np(seed, shape, scale=1.0, mean=0.0):
    return (mean + scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _int8(seed, shape):
    return np.random.default_rng(seed).integers(-127, 128, shape,
                                                dtype=np.int8)


def _split(x, chans):
    offs = np.cumsum([0] + list(chans))
    return [np.ascontiguousarray(x[..., a:b])
            for a, b in zip(offs[:-1], offs[1:])]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("chans", [[1], [15, 16], [5, 16, 1]],
                         ids=["1", "15+16", "5+16+1"])
def test_quantize_on_load_matches_quantize_act_and_jax(chans, dtype):
    """Float parts with ``sa`` equal ``quantize_act`` of each part followed
    by the int8 conv, bit for bit (the int32 sums, the rescaled output and
    its statistics), and JAX's ``conv_int8(quantize_act(x, sa), kq)`` run
    eagerly on the concat, exactly; exact .5 quotients planted."""
    dt = DTYPES[dtype]
    cin, cout = sum(chans), 7
    x = _np(1, (2, 3, 4, 5, cin), 3.0)
    sa = np.float32(np.abs(x).max() / 127.0)
    x.reshape(-1)[:30] = (np.arange(30) - 15 + 0.5) * sa
    k = _int8(2, (3, 3, 3, cin, cout))
    parts = [torch.from_numpy(p).to(dt) for p in _split(x, chans)]
    wq = torch.from_numpy(np.ascontiguousarray(k.transpose(4, 3, 0, 1, 2)))
    tsa = torch.tensor(sa)
    acc = tq.conv3x3_int8(parts, wq, tsa, None, None, torch.int32)
    assert acc.dtype == torch.int32
    want = tq.conv3x3_int8_plain([tq.quantize_act(p, tsa) for p in parts],
                                 wq)
    assert torch.equal(acc, want)
    xj = jnp.asarray(torch.cat(parts, -1).float().numpy()).astype(
        jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32)
    got_j = np.asarray(jq.conv_int8(jq.quantize_act(xj, jnp.asarray(sa)),
                                    jnp.asarray(k)))
    np.testing.assert_array_equal(acc.numpy(), got_j)
    sw, b = torch.from_numpy(_np(3, (cout,), 0.01) ** 2), \
        torch.from_numpy(_np(4, (cout,)))
    y, st = tq.conv3x3_int8(parts, wq, tsa, sw, b, dt, with_stats=True)
    y_old, st_old = tq.conv3x3_int8(
        [tq.quantize_act(p, tsa) for p in parts], wq, tsa, sw, b, dt,
        with_stats=True)
    assert torch.equal(y, y_old) and torch.equal(st, st_old)


def _old_chain(y, a, b, film, slope, dt):
    """``TwoConv._forward_int8``'s tensor chain before the prologue moved
    into the conv: the norm affine rounded to the compute dtype, LeakyReLU,
    the FiLM add."""
    u = F.leaky_relu(y * a.to(dt)[:, None, None, None]
                     + b.to(dt)[:, None, None, None], slope)
    if film is not None:
        u = u + film.to(dt)[:, None, None, None]
    return u


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("film", [True, False], ids=["film", "no film"])
def test_prologue_matches_twoconv_tensor_chain(dtype, film):
    """The conv with the norm prologue (a and b given in float32, rounded
    to the compute dtype by the wrapper) equals the old tensor chain, then
    ``quantize_act``, then the int8 conv, bit for bit: sums, rescaled
    output and statistics."""
    dt = DTYPES[dtype]
    n, cin, cout = 2, 16, 9
    y = torch.from_numpy(_np(5, (n, 4, 3, 5, cin), 2.0)).to(dt)
    a = torch.from_numpy(_np(6, (n, cin), 0.3, 1.0))
    b = torch.from_numpy(_np(7, (n, cin), 0.5))
    f = torch.from_numpy(_np(8, (n, cin), 0.4)) if film else None
    sa = torch.tensor(2.5 / 127)
    wq = torch.from_numpy(_int8(9, (cout, cin, 3, 3, 3)))
    pro = (a, b, f, 0.1)
    u = _old_chain(y, a, b, f, 0.1, dt)
    want = tq.conv3x3_int8_plain([tq.quantize_act(u, sa)], wq)
    got = tq.conv3x3_int8([y], wq, sa, None, None, torch.int32, prologue=pro)
    assert torch.equal(got, want)
    assert torch.equal(tq.quantize_input([y], sa, pro)[0],
                       tq.quantize_act(u, sa))
    sw = torch.from_numpy(_np(10, (cout,), 0.01) ** 2)
    bias = torch.from_numpy(_np(11, (cout,)))
    out, st = tq.conv3x3_int8([y], wq, sa, sw, bias, dt, with_stats=True,
                              prologue=pro)
    out_old, st_old = tq.conv3x3_int8([tq.quantize_act(u, sa)], wq, sa, sw,
                                      bias, dt, with_stats=True)
    assert torch.equal(out, out_old) and torch.equal(st, st_old)


def test_conv3x3_int8_refuses_what_the_kernel_cannot_take():
    """Float parts without ``sa``, integer parts other than int8 and a
    prologue on int8 parts raise; on the CPU float64 parts (which the
    kernel does not take) go through the plain version's
    ``quantize_input``."""
    wq = torch.from_numpy(_int8(14, (4, 3, 3, 3, 3)))
    x = torch.from_numpy(_np(15, (1, 2, 3, 2, 3)))
    sa = torch.tensor(0.01)
    with pytest.raises(TypeError):
        tq.conv3x3_int8([x], wq)
    with pytest.raises(TypeError):
        tq.conv3x3_int8([x.to(torch.int32)], wq, sa)
    assert torch.equal(
        tq.conv3x3_int8([x.double()], wq, sa),
        tq.conv3x3_int8_plain(tq.quantize_input([x.double()], sa), wq))
    with pytest.raises(ValueError):
        tq.conv3x3_int8([x.to(torch.int8)], wq, torch.tensor(0.1),
                        prologue=(torch.ones(1, 3), torch.zeros(1, 3), None,
                                  0.1))


@pytest.mark.parametrize("bn", [64, 128])
def test_pack_weight_s8_layout(bn):
    """Element [cb, j, tap, g, c, e] of ``pack_weight_s8`` is wq[cb * bn +
    c, 32 j + 16 g + e, tap], zero past Cout and Cin; a (cb, j, dz) stage
    of 9 taps is 9 * 32 * bn contiguous bytes; the unpack returns wq."""
    cout, cin = 70, 40
    wq = torch.from_numpy(_int8(12, (cout, cin, 3, 3, 3)))
    packed = pack_weight_s8(wq, bn)
    ncb, nchunk = -(-cout // bn), -(-cin // CHUNK_S8)
    assert packed.dtype == torch.int8 and packed.is_contiguous()
    assert tuple(packed.shape) == (ncb, nchunk, 27, 2, bn, 16)
    w = wq.reshape(cout, cin, 27).numpy()
    p = packed.numpy()
    rng = np.random.default_rng(13)
    for _ in range(400):
        cb, j, tap, g, c, e = (rng.integers(s) for s in p.shape)
        co, ci = cb * bn + c, 32 * j + 16 * g + e
        want = w[co, ci, tap] if co < cout and ci < cin else 0
        assert p[cb, j, tap, g, c, e] == want
    stage = packed[0, 0, 9:18].reshape(-1)
    assert stage.numel() == 9 * 32 * bn
    assert torch.equal(unpack_weight(packed, cout, cin), wq)


@pytest.mark.parametrize("n,dims,chans,cout,aligned", [
    (4, (9, 10, 17), [64], 64, True),
    (2, (6, 6, 6), [256, 256], 256, True),
    (1, (3, 5, 4), [1, 15], 64, True),
    (1, (4, 4, 4), [64, 16], 128, True),
    (2, (5, 8, 8), [96], 64, False),
], ids=["one part", "small grid split", "stems", "16-channel part",
        "unaligned"])
def test_int8_plan_covers_bricks_and_chunks(n, dims, chans, cout, aligned):
    """The int8 plan decodes its bricks, as the kernel does, onto every
    output voxel of every sample exactly once (for each Cout block of the
    grid); its splits partition the 32-channel chunks; TMA is chosen only
    where every part's channels are a multiple of 32 and the pointers are
    aligned."""
    plan = conv_plan(n, dims, chans, cout, aligned, CHUNK_S8)
    cin = sum(chans)
    assert plan.chunk == CHUNK_S8 and plan.nchunk == -(-cin // CHUNK_S8)
    assert plan.bn == (64 if cout <= 64 else 128)
    assert plan.grid[1] == -(-cout // plan.bn)
    seen = np.zeros((n, *dims), np.int32)
    for i in range(plan.grid[0]):
        s, z0, y0, x0 = plan.brick(i)
        seen[s, z0:z0 + BRICK[0], y0:y0 + BRICK[1], x0:x0 + BRICK[2]] += 1
    assert (seen == 1).all()
    runs = [list(plan.chunks(s)) for s in range(plan.split)]
    assert all(runs) and sum(runs, []) == list(range(plan.nchunk))
    assert plan.tma == (aligned and all(c % 32 == 0 for c in chans))
    if plan.split > 1:
        partial, counters = plan.workspace()
        assert counters == plan.grid[0] * plan.grid[1]
        assert partial == counters * plan.split * 256 * plan.bn // 2


def _old_conv_int8(conv, parts, dt):
    """``ConvNormAct.conv_int8`` before quantize on load: each part
    quantized in the block, int8 parts to the conv."""
    wq, sw = quant_weights(conv, "", conv.conv.weight, 0)
    sa = quant_act_scale(conv, "", parts)
    return tq.conv3x3_int8([tq.quantize_act(p, sa) for p in parts], wq, sa,
                           sw, conv.conv.bias, dt, with_stats=True)


def _old_forward_int8(self, parts, film, dt):
    """``TwoConv._forward_int8`` before the prologue moved into conv_1."""
    c0, c1 = self.conv_0, self.conv_1
    slope = self.negative_slope
    count = math.prod(parts[0].shape[1:4])

    def norm_act(conv, y, stats):
        a, b = norm_affine_from_stats(stats, conv.norm.weight,
                                      conv.norm.bias, count)
        return F.leaky_relu(y * a.to(dt)[:, None, None, None]
                            + b.to(dt)[:, None, None, None], slope)

    u = norm_act(c0, *_old_conv_int8(c0, parts, dt))
    if film is not None:
        u = u + film.to(dt)[:, None, None, None]
    return norm_act(c1, *_old_conv_int8(c1, [u], dt))


def _randomize(mod, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in mod.parameters():
            p.copy_(0.3 * torch.randn(p.shape, generator=g))


@pytest.mark.parametrize("scales", ["static", "dynamic"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("block", ["TwoConv", "UpCat"])
def test_block_routes_equal_the_old_route(block, dtype, scales,
                                          monkeypatch):
    """A quantized TwoConv (image + x_t float32 parts, FiLM) and UpCat
    (transposed conv, skip) give the same bits through the new route as
    through the old one, with recorded (static) and dynamic scales. The
    blocks call ``quantize_act`` only for the transposed conv's input; with
    a static scale conv_1 takes conv_0's output and the norm as its
    prologue (its input never materialized), with a dynamic one the
    materialized u."""
    dt = DTYPES[dtype]
    g = torch.Generator().manual_seed(20)
    temb = torch.randn((2, 512), generator=g)
    if block == "TwoConv":
        mod = TwoConv(1 + 3, 16, dtype=dt, quantize=True).eval()
        inputs = ([torch.randn((2, 5, 4, 6, 1), generator=g),
                   torch.randn((2, 5, 4, 6, 3), generator=g)], temb)
    else:
        mod = UpCat(32, 16, 16, 16, dtype=dt, quantize=True).eval()
        inputs = (torch.randn((2, 3, 2, 3, 32), generator=g).to(dt),
                  torch.randn((2, 6, 4, 6, 16), generator=g).to(dt), temb)
    _randomize(mod, 21)
    two = mod if block == "TwoConv" else mod.convs
    if scales == "static":
        for i, conv in enumerate((two.conv_0, two.conv_1)):
            conv.sa = torch.tensor(0.05 + 0.02 * i)
        if block == "UpCat":
            mod.up_sa = torch.tensor(0.03)
    quant_calls, convs = [], []
    real_q, real_conv = blocks.quantize_act, blocks.conv3x3_int8

    def counted_q(x, sa):
        quant_calls.append(x.shape)
        return real_q(x, sa)

    def seen_conv(parts, *args, **kw):
        convs.append((parts[0].dtype, kw.get("prologue") is not None))
        return real_conv(parts, *args, **kw)

    with torch.no_grad():
        monkeypatch.setattr(blocks, "quantize_act", counted_q)
        monkeypatch.setattr(blocks, "conv3x3_int8", seen_conv)
        new = mod(*inputs)
        monkeypatch.undo()
        assert len(quant_calls) == (1 if block == "UpCat" else 0)
        pdt = functools.reduce(torch.promote_types,
                               [p.dtype for p in inputs[0]]) \
            if block == "TwoConv" else dt
        assert convs == [(pdt, False), (dt, scales == "static")]
        monkeypatch.setattr(TwoConv, "_forward_int8", _old_forward_int8)
        old = mod(*inputs)
    assert new.dtype == old.dtype == dt
    assert torch.equal(new, old)
