"""PyTorch port, the conv's gradients (``ops/conv3d.py``: ``_Conv3x3``, the
dgrad and wgrad plain versions, the weight-gradient plan and the dgrad
weight pack) on the CPU.

The Function's backward (the statistics' and LeakyReLU's adjoints, the
dgrad, the wgrad, the prologue's adjoint and the split into parts) is held
against autograd through ``conv3x3_plain`` in float64, every input's
gradient within 1e-10 of its largest value: both are exact adjoints of one
function and differ only in summation order. On the card the same Function
launches the kernels (``tests/test_torch_port_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

from diff_unet_tpu_torch.ops.conv3d import (
    WGRAD_BF16_TILE,
    WGRAD_F32_RING_BYTES,
    WGRAD_F32_TILE,
    WGRAD_WORKSPACE,
    conv3x3,
    conv3x3_dgrad,
    conv3x3_dgrad_plain,
    conv3x3_plain,
    conv3x3_wgrad,
    conv3x3_wgrad_plain,
    flip_weight,
    packed_weight,
    unpack_weight,
    wgrad_f32_stage_bytes,
    wgrad_plan,
    wgrad_stage_bytes,
)
from tests.test_torch_port_conv import AMOS_CONVS, SMALL_CONVS
from tests.test_torch_port_swin import torch_threads  # noqa: F401

EXACT = 1e-10


def _case(seed, n, dims, chans, cout, prologue, const=True):
    """float64 parts, weight, bias and prologue rows; the parts and
    parameters require grad."""
    rng = np.random.default_rng(seed)
    cin = sum(chans)

    def t(a, grad=True):
        return torch.from_numpy(a).requires_grad_(grad)

    parts = [t(rng.standard_normal((n, *dims, c))) for c in chans]
    w = t(rng.standard_normal((cout, cin, 3, 3, 3)) / np.sqrt(27 * cin))
    b = t(0.1 * rng.standard_normal(cout))
    pro = None
    if prologue:
        pro = (t(1.0 + 0.3 * rng.standard_normal((n, cin))),
               t(0.3 * rng.standard_normal((n, cin))),
               t(0.2 * rng.standard_normal((n, cin))) if const else None,
               0.1)
    return parts, w, b, pro


CASES = {
    # (n, dims, part channels, Cout, prologue, const, LeakyReLU, stats,
    #  parts need grad)
    "one part": (2, (5, 6, 4), [5], 6, False, False, 0.1, True, True),
    "one part prologue": (2, (5, 6, 4), [5], 6, True, True, None, True,
                          True),
    "two parts": (2, (4, 5, 6), [3, 4], 5, False, False, None, True, True),
    "two parts prologue": (1, (4, 5, 6), [4, 6], 7, True, True, None, True,
                           True),
    "ragged 6x7x9": (1, (6, 7, 9), [8], 8, True, False, None, True, True),
    "no stats": (2, (4, 4, 5), [4], 3, True, True, 0.2, False, True),
    "stem part of 1 channel": (2, (6, 5, 4), [1, 3], 8, False, False, None,
                               True, False),
    # the layer-norm TwoConv's convs: bias only, g = dy
    "bias only": (2, (4, 5, 6), [3, 4], 5, False, False, None, False, True),
    # per-channel gamma / beta broadcast to (N, Cin) with a const, no
    # statistics, no activation
    "broadcast prologue": (2, (4, 5, 4), [6], 4, "broadcast", True, None,
                           False, True),
    # the batch-norm ConvBNReLU2's second conv: per-channel scale / shift
    # broadcast to (N, Cin), ReLU (slope 0), no const, and statistics
    # that count only through their sums over the samples
    "batch-norm prologue": (3, (4, 5, 4), [6], 5, "batch", False, None,
                            True, True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_function_gradients_match_autograd_through_plain(name):
    """Gradients of every input (parts, weight, bias, scale, shift, const)
    through y and the statistics, float64."""
    n, dims, chans, cout, pro_on, const, slope, stats, parts_grad = \
        CASES[name]
    parts, w, b, pro = _case(len(name), n, dims, chans, cout, pro_on, const)
    for p in parts:
        p.requires_grad_(parts_grad)
    rows = [v for v in (pro or ())[:3] if v is not None]
    if pro_on in ("broadcast", "batch"):
        # leaves of one row each, broadcast over the samples
        rows = [v[0].detach().requires_grad_() for v in rows]
        pro = (*[v.expand(n, -1) for v in rows],
               *[None] * (3 - len(rows)), 0.0 if pro_on == "batch" else 0.1)
    rng = np.random.default_rng(1)
    cot_y = torch.from_numpy(rng.standard_normal((n, *dims, cout)))
    cot_s = torch.from_numpy(rng.standard_normal((n, 2, cout)))
    if pro_on == "batch":
        cot_s = cot_s[:1].expand(n, -1, -1)
    inputs = [w, b] + rows
    inputs += [p for p in parts if p.requires_grad]
    kw = dict(prologue=pro, negative_slope=slope, with_stats=stats)

    def loss(fn):
        out = fn(parts, w, b, **kw)
        y, st = out if stats else (out, None)
        total = (y * cot_y).sum()
        if stats:
            total = total + (st * cot_s).sum()
        return total, y

    got_loss, y = loss(conv3x3)
    assert y.grad_fn is not None and "_Conv3x3" in type(y.grad_fn).__name__
    got = torch.autograd.grad(got_loss, inputs)
    want_loss, _ = loss(conv3x3_plain)
    want = torch.autograd.grad(want_loss, inputs)
    assert got_loss.item() == pytest.approx(want_loss.item(), rel=1e-12)
    for i, (g, ref) in enumerate(zip(got, want)):
        assert g.dtype == ref.dtype == torch.float64 and g.shape == ref.shape
        scale = ref.abs().max().item()
        assert scale > 0
        assert (g - ref).abs().max().item() <= EXACT * scale, i


def test_parts_without_grad_get_no_dgrad():
    """The stems' inputs (image; [image, x_t]) need no gradient: the
    backward then computes no dgrad, and the weight still gets its own."""
    parts, w, b, _ = _case(3, 1, (4, 4, 4), [1, 3], 4, False)
    for p in parts:
        p.requires_grad_(False)
    y, st = conv3x3(parts, w, b, with_stats=True)
    (y.sum() + st.sum()).backward()
    assert w.grad is not None and b.grad is not None
    assert all(p.grad is None for p in parts)


def test_no_function_without_grad():
    parts, w, b, _ = _case(4, 1, (4, 4, 4), [3], 4, False)
    with torch.no_grad():
        assert conv3x3(parts, w, b).grad_fn is None
    with torch.inference_mode():
        assert conv3x3([p.detach() for p in parts], w.detach()).grad_fn \
            is None


@pytest.mark.parametrize("dims", [(4, 5, 6), (6, 7, 9)])
def test_dgrad_plain_is_the_input_adjoint(dims):
    """``conv3x3_dgrad_plain(g, W)`` is ``conv3x3_plain`` of g with the
    flipped weights, and equals autograd's input gradient of the conv."""
    parts, w, _, _ = _case(5, 2, dims, [6], 4, False)
    rng = np.random.default_rng(6)
    g = torch.from_numpy(rng.standard_normal((2, *dims, 4)))
    flipped = flip_weight(w.detach())
    assert flipped.shape == (6, 4, 3, 3, 3)
    assert torch.equal(flipped[2, 1, 0, 1, 2], w.detach()[1, 2, 2, 1, 0])
    got = conv3x3_dgrad_plain(g, w.detach())
    assert torch.equal(got, conv3x3_plain([g], flipped))
    assert torch.equal(conv3x3_dgrad(g, w.detach()), got)   # CPU: plain
    y = conv3x3_plain(parts, w)
    (want,) = torch.autograd.grad(y, parts, g)
    assert (got - want).abs().max().item() <= \
        EXACT * want.abs().max().item()


@pytest.mark.parametrize("chans,prologue", [([5], False), ([2, 4], True),
                                            ([1, 15], False)])
def test_wgrad_plain_is_the_weight_adjoint(chans, prologue):
    """``conv3x3_wgrad_plain`` equals autograd's weight gradient through
    ``conv3x3_plain`` (with the prologue, the rounded u of the plain
    forward), float64."""
    dims = (4, 6, 5)
    parts, w, _, pro = _case(7, 2, dims, chans, 3, prologue)
    rng = np.random.default_rng(8)
    g = torch.from_numpy(rng.standard_normal((2, *dims, 3)))
    detached = None if pro is None else tuple(
        v.detach() for v in pro[:3]) + (pro[3],)
    got = conv3x3_wgrad_plain(g, [p.detach() for p in parts], detached)
    assert torch.equal(conv3x3_wgrad(g, [p.detach() for p in parts],
                                     detached), got)         # CPU: plain
    y = conv3x3_plain(parts, w, prologue=pro)
    (want,) = torch.autograd.grad(y, [w], g)
    assert got.shape == w.shape and got.dtype == torch.float64
    assert (got - want).abs().max().item() <= \
        EXACT * want.abs().max().item()


def test_wgrad_plain_rounds_like_the_forward_in_bf16():
    """bf16 parts: u is the prologue rounded to bf16, and the products sum
    in float32 (what the kernel is held to on the card)."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((1, 4, 4, 4, 8),
                                             np.float32)).bfloat16()
    g = torch.from_numpy(rng.standard_normal((1, 4, 4, 4, 8),
                                             np.float32)).bfloat16()
    a, b = (torch.from_numpy(rng.standard_normal((1, 8), np.float32))
            for _ in range(2))
    got = conv3x3_wgrad_plain(g, [x], (a, b, None, 0.1))
    u = torch.nn.functional.leaky_relu(
        x.float() * a[:, None, None, None] + b[:, None, None, None], 0.1)
    want = torch.nn.grad.conv3d_weight(
        u.bfloat16().float().permute(0, 4, 1, 2, 3), (8, 8, 3, 3, 3),
        g.float().permute(0, 4, 1, 2, 3), padding=1)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# the deep levels of the small DiffUNet of the card tests (32^3 patches)
TINY_CONVS = [((4,) * 3, [32], 64), ((2,) * 3, [64], 64),
              ((2,) * 3, [64, 64], 8)]
# HybridMIM pretraining's deep levels (batch 2 of 64^3): 8^3 and 4^3
MIM_DEEP_CONVS = [((8,) * 3, [128], 256), ((8,) * 3, [256], 256),
                  ((8,) * 3, [128, 128], 128), ((4,) * 3, [256], 512),
                  ((4,) * 3, [512], 512), ((4,) * 3, [256, 256], 256)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,dims,chans,cout",
                         [(10, *c) for c in AMOS_CONVS]
                         + [(1, *c) for c in SMALL_CONVS]
                         + [(2, *c) for c in TINY_CONVS + MIM_DEEP_CONVS])
def test_wgrad_plan_covers_every_chunk_and_weight_once(n, dims, chans,
                                                       cout, dtype):
    """For each z tap, every output voxel whose input slice z + dz lies in
    the volume in exactly one chunk (as the kernel decodes chunks) and the
    others in none; every chunk of the middle tap in exactly one split, no
    split empty; the tiles cover every (Cout, Cin, tap) once; the
    workspace stays within its bound; a bf16 chunk fits the kernel's ring
    three times; a float32 chunk (whole slices, or a patch of one) fits
    the kernel's two stages."""
    cin = sum(chans)
    plan = wgrad_plan(n, dims, cin, cout, dtype)
    d, h, w = dims
    assert plan.dense
    if dtype == torch.float32:
        assert plan.ci_tile == WGRAD_F32_TILE[1]
        assert 2 * wgrad_f32_stage_bytes(plan.tx, plan.ty, plan.slices) \
            <= WGRAD_F32_RING_BYTES
        assert plan.nchunk == -(-n * d // plan.slices) \
            * -(-h // plan.ty) * -(-w // plan.tx)
    else:
        assert plan.slices * plan.ty * plan.tx % 64 == 0
        stage = wgrad_stage_bytes(plan.tx, plan.ty, plan.slices,
                                  plan.ci_tile)
        assert 3 * stage <= 200 * 1024
        # runs of 8 x: at most 25% padding at widths under 16
        assert -(-w // plan.tx) * plan.tx <= max(w + 4, 8)
    seen = np.zeros(plan.nchunk, np.int32)
    for s in range(plan.split):
        assert len(plan.chunks(s)) > 0
        seen[plan.chunks(s)] += 1
    assert (seen == 1).all()
    nyt, nxt = -(-h // plan.ty), -(-w // plan.tx)
    for dz in (-1, 0, 1):
        cells = np.zeros((n, d, nyt, nxt), np.int32)
        q = 0
        while True:
            y0, x0, slices = plan.chunk(q, dz)
            if not slices and q >= plan.nchunk:
                break
            for sn, sz in slices:
                cells[sn, sz, y0 // plan.ty, x0 // plan.tx] += 1
            q += 1
        valid = np.zeros(d, bool)
        valid[max(0, -dz):d - max(0, dz)] = True
        assert (cells[:, valid] == 1).all() and (cells[:, ~valid] == 0).all()
    to, ti = ((WGRAD_F32_TILE if dtype == torch.float32
               else WGRAD_BF16_TILE)[0], plan.ci_tile)
    ncob, ncib = -(-cout // to), -(-cin // ti)
    assert plan.groups == ncob * ncib * 3
    cover = np.zeros((ncob * to, ncib * ti, 27), np.int32)
    for tile in range(plan.groups):          # decoded as the kernel does
        tz, rest = tile % 3, tile // 3
        cib, cob = rest % ncib, rest // ncib
        cover[cob * to:(cob + 1) * to, cib * ti:(cib + 1) * ti,
              9 * tz:9 * tz + 9] += 1
    assert (cover == 1).all()
    size = plan.split * cout * cin * 27 * 4
    assert plan.split == 1 or size <= WGRAD_WORKSPACE


def _wgrad_emulated(plan, g, u):
    """dW as the bf16 kernel forms it, in float64: each chunk's g tile
    (K voxels x Cout) and u halo tiles (one (ty + 2) x (tx + 2) tile a
    slice, slice tiles usl voxels apart, padding NaN so that a read past a
    tile shows), and each k16 step's two runs of 8 voxels at every (dy, dx)
    tap's start, as csrc/conv3d_wgrad.cu addresses them."""
    n, d, h, w, cout = g.shape
    cin = u.shape[-1]
    tx, ty, sl = plan.tx, plan.ty, plan.slices
    ux = tx + 2
    uvs = (ty + 2) * ux
    usl = -(-uvs // 8) * 8
    rps = 16 // tx
    sps = ty // rps
    kstride = 8 if tx == 16 else ux
    dw = np.zeros((cout, cin, 27))
    nyt, nxt = -(-h // ty), -(-w // tx)

    def at(a, nn, z, y, x):
        ok = nn < n and 0 <= z < d and 0 <= y < h and 0 <= x < w
        return a[nn, z, y, x] if ok else 0.0

    for dz in (-1, 0, 1):
        nz = d - abs(dz)
        for q in range(-(-n * nz // sl) * nyt * nxt):
            x0, y0 = q % nxt * tx, q // nxt % nyt * ty
            gt = np.zeros((sl * ty * tx, cout))
            ut = np.full((sl * usl, cin), np.nan)
            for s in range(sl):
                i = q // (nxt * nyt) * sl + s
                nn, z = i // nz, i % nz + (dz < 0)
                for r in range(ty):
                    for c in range(tx):
                        gt[(s * ty + r) * tx + c] = at(g, nn, z, y0 + r,
                                                       x0 + c)
                for v in range(uvs):
                    ut[s * usl + v] = at(u, nn, z + dz, y0 - 1 + v // ux,
                                         x0 - 1 + v % ux)
            for j in range(sl * ty * tx // 16):
                s = j // sps
                voff = s * usl + (j - s * sps) * rps * ux
                rows = gt[16 * j:16 * j + 16]
                for tap in range(9):
                    start = voff + tap // 3 * ux + tap % 3
                    vox = np.r_[start:start + 8,
                                start + kstride:start + kstride + 8]
                    dw[:, :, 9 * (dz + 1) + tap] += rows.T @ ut[vox]
    return dw


@pytest.mark.parametrize("n,dims,chans,cout", [
    (2, (6, 7, 9), [8], 16),         # tx 16, one ragged 8 x 16 tile
    (2, (6, 6, 6), [5], 8),          # tx 8, four whole 6 x 8 slices
    (2, (3, 7, 20), [3, 4], 8),      # tx 8, three whole slices, ragged x
    (1, (3, 20, 12), [6], 4),        # tx 16, 8-row tiles of a slice
    (1, (3, 30, 6), [4], 4),         # tx 8, 16-row tiles of a slice
])
def test_wgrad_dense_chunks_give_the_plain_weight_gradient(n, dims, chans,
                                                           cout):
    """The bf16 plan's chunk geometry and the kernel's index math (runs of
    8 x, tap offsets, halo zeros, slices of the valid z only, padded
    chunks) add up to ``conv3x3_wgrad_plain``'s dW, float64."""
    rng = np.random.default_rng(sum(dims))
    parts = [torch.from_numpy(rng.standard_normal((n, *dims, c)))
             for c in chans]
    g = torch.from_numpy(rng.standard_normal((n, *dims, cout)))
    plan = wgrad_plan(n, dims, sum(chans), cout, torch.bfloat16)
    got = _wgrad_emulated(plan, g.numpy(), torch.cat(parts, -1).numpy())
    want = conv3x3_wgrad_plain(g, parts).reshape(cout, sum(chans), 27)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want.numpy(), rtol=0,
                               atol=EXACT * want.abs().max().item())


def test_dgrad_pack_lives_beside_the_forward_pack():
    """The forward and dgrad packs of one weight are kept side by side
    (neither evicts the other) and both follow an in-place update."""
    w = torch.randn((64, 16, 3, 3, 3))
    cpu = torch.device("cpu")
    fwd = packed_weight(w, torch.bfloat16, cpu, 64)
    bwd = packed_weight(w, torch.bfloat16, cpu, 64, transposed=True)
    packs = packed_weight.packs
    assert packed_weight(w, torch.bfloat16, cpu, 64) is fwd
    assert packed_weight(w, torch.bfloat16, cpu, 64, transposed=True) is bwd
    assert packed_weight.packs == packs
    assert torch.equal(unpack_weight(bwd, 16, 64),
                       flip_weight(w).bfloat16())
    w.mul_(2.0)
    packed_weight(w, torch.bfloat16, cpu, 64)
    again = packed_weight(w, torch.bfloat16, cpu, 64, transposed=True)
    assert packed_weight.packs == packs + 2
    assert torch.equal(unpack_weight(again, 16, 64),
                       flip_weight(w).bfloat16())
