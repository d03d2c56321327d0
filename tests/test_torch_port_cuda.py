"""PyTorch port on a CUDA card: each kernel against its plain version,
forward and backward (the Swin kernels', the conv's dgrad and weight
gradient and its autograd Function), the wrappers' input checks, tiny
Predictors (DiffSwinUNETR, DiffUNet) and a small DiffUNet train step run
through their kernels.

Marked ``cuda`` and skipped where there is no card. This file imports no
jax (the card's machine has none); run it there without the repository's
conftest, which does:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py
"""
import numpy as np
import pytest
import torch

from diff_unet_tpu_torch.ops.conv3d import (
    GRAD_TOL,
    KERNEL_TOL,
    STATS_TOL,
    WGRAD_TOL,
    _no_tf32,
    conv3x3,
    conv3x3_dgrad,
    conv3x3_dgrad_plain,
    conv3x3_plain,
    conv3x3_wgrad,
    conv3x3_wgrad_plain,
    packed_weight,
)
from diff_unet_tpu_torch.ops.int8 import conv3x3_int8
from diff_unet_tpu_torch.ops.swin import window_region_ids
from diff_unet_tpu_torch.ops.window_partition import (
    partition_windows,
    partition_windows_plain,
    reverse_windows,
    reverse_windows_plain,
)
from diff_unet_tpu_torch.ops.window_attention import (
    window_attention,
    window_attention_plain,
)
from diff_unet_tpu_torch.ops.window_shift import (
    shift_windows,
    shift_windows_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("n,dh,shifted", [(343, 16, True), (216, 16, False),
                                          (64, 4, True), (27, 8, False),
                                          (343, 32, True)])
def test_window_attention_kernel_matches_plain(dev, dtype, tol, n, dh,
                                               shifted):
    g = torch.Generator(device=dev).manual_seed(n + dh)
    bw, h = 8, 3
    qkv = torch.randn((bw, n, 3, h, dh), generator=g, device=dev).to(dtype)
    bias = 0.5 * torch.randn((h, n, n), generator=g, device=dev)
    ids = None
    if shifted:
        side = round(n ** (1 / 3))
        ids = torch.from_numpy(window_region_ids(
            (2 * side,) * 3, (side,) * 3, (side // 2,) * 3)).to(dev)
    before = window_attention.launches
    got = window_attention(qkv, bias, ids)
    want = window_attention_plain(qkv, bias, ids)
    torch.cuda.synchronize()
    assert window_attention.launches == before + 1
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grid,c", [((2, 2, 2), 48), ((3, 2, 2), 3),
                                    ((1, 2, 3), 5)])
def test_shift_kernel_bit_exact(dev, dtype, grid, c):
    """Row widths of 6 and 10 bytes exercise the narrow-vector paths."""
    ws = (4, 4, 4)
    x = torch.randn((2 * int(np.prod(grid)), 64, c), device=dev).to(dtype)
    for ss in ((2, 2, 2), (-2, -2, -2), (0, 2, 0)):
        got = shift_windows(x, ws, ss, grid)
        assert torch.equal(got, shift_windows_plain(x, ws, ss, grid))
        assert torch.equal(shift_windows(got, ws, tuple(-s for s in ss),
                                          grid), x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,dims,c,ws", [
    (2, (12, 12, 12), 48, (7, 7, 7)), (1, (6, 6, 6), 384, (6, 6, 6)),
    (2, (10, 9, 13), 3, (4, 4, 4)), (1, (5, 7, 6), 5, (3, 3, 3)),
])
def test_partition_kernels_bit_exact_both_directions(dev, dtype, b, dims, c,
                                                     ws):
    """Pad + partition and reverse + crop against their plain versions, and
    each one's gradient (the other kernel) against autograd through the
    plain versions; 6- and 10-byte rows take the narrow-vector paths."""
    pad = tuple((s - d % s) % s for d, s in zip(dims, ws))
    padded = tuple(d + p for d, p in zip(dims, pad))
    g = torch.Generator(device=dev).manual_seed(c)
    x = torch.randn((b, *dims, c), generator=g, device=dev).to(dtype)
    before = (partition_windows.launches, reverse_windows.backward_launches)
    xg = x.clone().requires_grad_()
    wt = partition_windows(xg, ws, pad)
    assert torch.equal(wt, partition_windows_plain(x, ws, pad))
    cot = torch.randn(wt.shape, generator=g, device=dev).to(dtype)
    wt.backward(cot)
    xp = x.clone().requires_grad_()
    partition_windows_plain(xp, ws, pad).backward(cot)
    assert torch.equal(xg.grad, xp.grad)
    assert (partition_windows.launches,
            reverse_windows.backward_launches) == (before[0] + 1,
                                                   before[1] + 1)

    wg = wt.detach().clone().requires_grad_()
    back = reverse_windows(wg, ws, padded, dims)
    assert torch.equal(back, x)
    assert torch.equal(back, reverse_windows_plain(wt.detach(), ws, padded,
                                                   dims))
    cot = torch.randn(back.shape, generator=g, device=dev).to(dtype)
    back.backward(cot)
    wp = wt.detach().clone().requires_grad_()
    reverse_windows_plain(wp, ws, padded, dims).backward(cot)
    assert torch.equal(wg.grad, wp.grad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_shift_backward_bit_exact(dev, dtype):
    ws, grid, c = (7, 7, 7), (2, 2, 2), 96
    x = torch.randn((2 * 8, 343, c), device=dev).to(dtype)
    cot = torch.randn(x.shape, device=dev).to(dtype)
    for ss in ((3, 3, 3), (-3, -3, -3)):
        before = shift_windows.backward_launches
        xg = x.clone().requires_grad_()
        shift_windows(xg, ws, ss, grid).backward(cot)
        xp = x.clone().requires_grad_()
        shift_windows_plain(xp, ws, ss, grid).backward(cot)
        assert torch.equal(xg.grad, xp.grad)
        assert shift_windows.backward_launches == before + 1


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("n,shifted", [(343, True), (216, False)])
def test_window_attention_gradients_match_plain(dev, dtype, tol, n,
                                                shifted):
    """Gradients for qkv and the bias, kernel path against autograd through
    the plain version, within tol of each gradient's max |g|."""
    g = torch.Generator(device=dev).manual_seed(n)
    bw, h = 16, 3
    qkv = torch.randn((bw, n, 3, h, 16), generator=g, device=dev).to(dtype)
    bias = 0.5 * torch.randn((h, n, n), generator=g, device=dev)
    ids = (torch.from_numpy(window_region_ids((14, 14, 14), (7, 7, 7),
                                              (3, 3, 3))).to(dev)
           if shifted else None)
    cot = torch.randn((bw, n, h, 16), generator=g, device=dev).to(dtype)
    grads = []
    for fn in (window_attention, window_attention_plain):
        q = qkv.clone().requires_grad_()
        b = bias.clone().requires_grad_()
        fn(q, b, ids).backward(cot)
        grads.append((q.grad.float(), b.grad))
    for got, want in zip(*grads):
        scale = want.abs().max().item()
        assert (got - want).abs().max().item() <= tol * scale


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("n,dh,shifted,bw", [(343, 16, True, 16),
                                             (64, 4, True, 8),
                                             (27, 8, False, 200),
                                             (216, 32, False, 1),
                                             (8, 16, True, 8)])
def test_window_attention_backward_kernel_matches_plain(dev, dtype, tol, n,
                                                        dh, shifted, bw):
    """The backward kernel (every head dim the wrapper takes; one group,
    a window a group and runs of windows a group) against ``window_attention_backward_plain``,
    within tol of each gradient's max |g|, and its launch count."""
    from diff_unet_tpu_torch.ops import window_attention as wa

    g = torch.Generator(device=dev).manual_seed(n + dh)
    h = 3
    qkv = torch.randn((bw, n, 3, h, dh), generator=g, device=dev).to(dtype)
    bias = 0.5 * torch.randn((h, n, n), generator=g, device=dev)
    ids = None
    if shifted:
        side = round(n ** (1 / 3))
        ids = torch.from_numpy(window_region_ids(
            (2 * side,) * 3, (side,) * 3, (side // 2,) * 3)).to(dev)
    cot = torch.randn((bw, n, h, dh), generator=g, device=dev).to(dtype)
    _, lse = wa._forward(qkv, bias, ids, with_stats=True)
    before = window_attention.backward_launches
    got = wa._backward(qkv, bias, ids, lse, cot)
    want = wa.window_attention_backward_plain(qkv, bias, ids, cot)
    torch.cuda.synchronize()
    assert window_attention.backward_launches == before + 1
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    for a, w in zip(got, want):
        scale = w.float().abs().max().item()
        assert (a.float() - w.float()).abs().max().item() <= tol * scale


def test_wrappers_check_inputs(dev):
    qkv = torch.randn((2, 8, 3, 2, 4), device=dev, requires_grad=True)
    bias = torch.zeros((2, 8, 8), device=dev)
    assert window_attention(qkv, bias).grad_fn is not None
    with torch.no_grad():
        with pytest.raises(ValueError, match="geometry"):
            partition_windows(torch.zeros((1, 5, 5, 5, 4), device=dev),
                              (3, 3, 3), (2, 1, 1))
        with pytest.raises(ValueError, match="wt must be"):
            reverse_windows(torch.zeros((2, 27, 4), device=dev), (3, 3, 3),
                            (6, 6, 6), (5, 5, 5))
        with pytest.raises(ValueError, match="bias"):
            window_attention(qkv, bias.double())
        with pytest.raises(ValueError, match="head_dim"):
            window_attention(torch.zeros((2, 8, 3, 2, 6), device=dev),
                             torch.zeros((2, 8, 8), device=dev))
        with pytest.raises(ValueError, match="contiguous"):
            shift_windows(torch.zeros((8, 4, 8), device=dev).transpose(1, 2)
                          .contiguous().transpose(1, 2), (2, 2, 1),
                          (1, 1, 0), (2, 2, 2))


def test_predictor_serves_through_both_kernels(dev):
    """Window noise is drawn by a CUDA generator here, so the card is held
    against the CPU on one window with the same injected noise; whole
    volumes are checked for batching invariance on the card."""
    from diff_unet_tpu_torch.engine.engine import Predictor

    kw = dict(model_name="diff_swin_unetr", feature_size=12, image_size=32,
              spatial_size=32, sample_steps=2, use_amp=False, seed=1)
    g = torch.Generator().manual_seed(0)
    vol = torch.rand((40, 36, 20, 1), generator=g)
    window_attention.launches = shift_windows.launches = 0
    card = Predictor(device=dev, sw_batch_size=2, **kw)
    got, binary = card.infer(vol)
    assert window_attention.launches > 0 and shift_windows.launches > 0
    assert got.shape == binary.shape == (40, 36, 20, 13)
    one, _ = Predictor(device=dev, sw_batch_size=1, **kw).infer(vol)
    assert (one - got).abs().max().item() <= 1e-4

    win = torch.rand((1, 32, 32, 32, 1), generator=g)
    noise = torch.randn((1, 32, 32, 32, 13), generator=g)
    with torch.inference_mode():
        want = Predictor(device="cpu", **kw).seg.ddim_sample(win, noise=noise)
        on_card = card.seg.ddim_sample(win.to(dev), noise=noise.to(dev))
    assert (on_card.cpu() - want).abs().max().item() <= 1e-3


CONV_SMALL = [(2, 6, 7, 9), (1, 8, 8, 8)]
# (part channels, prologue: None / "const" / "no const", statistics, shape,
# Cout): the switches at two small shapes, then the bf16 kernel's edges:
# ragged bricks, split chunks, Cin 512, four parts, the stems at N = 4
CONV_KERNEL_CASES = [
    (chans, prologue, stats, shape, 24)
    for shape in CONV_SMALL
    for chans, prologue, stats in [
        ([1], None, True), ([1, 15], None, True), ([64], "const", True),
        ([64, 64], None, True), ([64], None, False), ([3, 5], "const", False)]
] + [
    ([64], "const", True, (2, 6, 6, 6), 64),
    ([64], "const", True, (1, 12, 12, 12), 128),
    ([32], "no const", True, (1, 32, 32, 22), 64),
    ([512], "const", True, (1, 6, 6, 6), 256),
    ([16, 16, 32, 16], None, True, (1, 8, 8, 8), 64),
    ([1], None, True, (4, 16, 16, 16), 64),
    ([1, 15], None, True, (4, 16, 16, 16), 64),
    # the MSD denoiser stem: image and 2 classes (4-byte bf16 rows)
    ([1, 2], None, True, (4, 16, 16, 16), 64),
    ([1, 2], None, True, (2, 13, 11, 21), 64),
    ([256, 256], None, True, (2, 12, 12, 12), 256),
    # many samples of a few voxels: a brick a sample, mostly masked
    ([8], "const", True, (10, 2, 2, 2), 16),
    ([8], None, True, (5, 3, 3, 3), 16),
    # HybridMIM pretraining (batch 2 of 64^3): the stem and L0 conv_1, the
    # decoder's two-part convs and the split chunks at 8^3 and 4^3
    ([1], None, True, (2, 64, 64, 64), 64),
    ([64], "const", True, (2, 64, 64, 64), 64),
    ([128, 128], None, True, (2, 8, 8, 8), 128),
    ([256], "const", True, (2, 8, 8, 8), 256),
    ([512], "const", True, (2, 4, 4, 4), 512),
    ([256, 256], None, True, (2, 4, 4, 4), 256),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chans,prologue,stats,shape,cout",
                         CONV_KERNEL_CASES)
def test_conv3x3_kernel_matches_plain(dev, dtype, chans, prologue, stats,
                                      shape, cout):
    """Odd W, parts that split the channels, the prologue and statistics
    on and off; bias and LeakyReLU epilogue on the one-part cases; ragged
    bricks (6^3, 12^3, 6x7x9, 32x32x22), shapes that split the channel
    chunks across CTAs, several chunks and four TMA-mapped parts; run
    twice, bit-identical (no float atomics in the statistics or the split
    chunks' sums)."""
    g = torch.Generator(device=dev).manual_seed(sum(chans) + shape[1])
    n, cin = shape[0], sum(chans)
    parts = [torch.randn((*shape, c), generator=g, device=dev).to(dtype)
             for c in chans]
    w = torch.randn((cout, cin, 3, 3, 3), generator=g, device=dev) \
        / (27 * cin) ** 0.5
    b = 0.1 * torch.randn((cout,), generator=g, device=dev)
    pro = None
    if prologue:
        pro = (1 + 0.3 * torch.randn((n, cin), generator=g, device=dev),
               0.3 * torch.randn((n, cin), generator=g, device=dev),
               0.2 * torch.randn((n, cin), generator=g, device=dev)
               if prologue == "const" else None, 0.1)
    slope = 0.1 if len(chans) == 1 else None
    before = conv3x3.launches
    got, again = (conv3x3(parts, w, b, prologue=pro, negative_slope=slope,
                          with_stats=stats) for _ in range(2))
    want = conv3x3_plain(parts, w, b, prologue=pro, negative_slope=slope,
                         with_stats=stats)
    torch.cuda.synchronize()
    assert conv3x3.launches == before + 2
    for first, second in zip(*((got, again) if stats else ([got],
                                                           [again]))):
        assert torch.equal(first, second)
    if stats:
        (got, gst), (want, wst) = got, want
        scale = wst.abs().max().item()
        assert (gst - wst).abs().max().item() <= STATS_TOL * scale
    assert got.dtype == dtype and got.shape == (*shape, cout)
    scale = max(1.0, want.float().abs().max().item())
    err = (got.float() - want.float()).abs().max().item()
    assert err <= KERNEL_TOL[dtype] * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3x3_reuses_packed_weights(dev, dtype):
    """A second call with the same weight packs nothing; an in-place
    update of the weight re-packs it, and the output follows it."""
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((1, 8, 8, 8, 16), generator=g, device=dev).to(dtype)
    w = torch.randn((64, 16, 3, 3, 3), generator=g, device=dev) / 12.0
    first = conv3x3([x], w)
    packs = packed_weight.packs
    assert torch.equal(conv3x3([x], w), first)
    assert packed_weight.packs == packs
    w.mul_(-1.0)
    second = conv3x3([x], w)
    torch.cuda.synchronize()
    assert packed_weight.packs == packs + 1
    assert torch.equal(second, -first)


def test_conv3x3_checks_inputs(dev):
    x = torch.zeros((1, 4, 4, 4, 8), device=dev)
    w = torch.zeros((8, 8, 3, 3, 3), device=dev)
    # a weight that needs a gradient goes through the autograd Function
    assert conv3x3([x], w.requires_grad_()).grad_fn is not None
    with torch.no_grad():
        w = w.detach()
        with pytest.raises(ValueError, match="g "):
            conv3x3_wgrad(torch.zeros((1, 4, 4, 5, 8), device=dev), [x])
        with pytest.raises(ValueError, match="weight"):
            conv3x3_dgrad(torch.zeros((1, 4, 4, 4, 6), device=dev), w)
        with pytest.raises(TypeError, match="dtype"):
            conv3x3([x.half()], w)
        with pytest.raises(ValueError, match="contiguous"):
            conv3x3([x.transpose(1, 2)], w)
        with pytest.raises(ValueError, match="weight"):
            conv3x3([x, x], w)
        with pytest.raises(ValueError, match="does not match"):
            conv3x3([x, x.bfloat16()], torch.zeros((8, 16, 3, 3, 3),
                                                    device=dev))
        with pytest.raises(ValueError, match="prologue"):
            conv3x3([x], w, prologue=(torch.ones(2, 8), torch.ones(2, 8),
                                      None, 0.1))


def test_conv3x3_int8_refuses_float64_parts(dev):
    """The s8 kernel quantizes bf16 and float32 parts on load: float64
    parts on the card raise (on the CPU the plain version takes them)."""
    wq = torch.zeros((4, 3, 3, 3, 3), dtype=torch.int8, device=dev)
    x = torch.zeros((1, 2, 2, 2, 3), dtype=torch.float64, device=dev)
    before = conv3x3_int8.launches
    with pytest.raises(TypeError):
        conv3x3_int8([x], wq, torch.tensor(0.1, device=dev))
    assert conv3x3_int8.launches == before


def test_diff_unet_predictor_serves_through_the_conv_kernel(dev):
    """Every 3x3x3 conv of a tiny DiffUNet goes through the kernel: 10 in
    the encoder and 18 per denoiser step, per window batch. The card is
    held against the CPU on one window with the same injected noise."""
    from diff_unet_tpu_torch.engine.engine import Predictor

    kw = dict(model_name="diff_unet", features=(8, 8, 16, 32, 64, 8),
              image_size=32, spatial_size=32, sample_steps=2, use_amp=False,
              seed=1)
    g = torch.Generator().manual_seed(0)
    vol = torch.rand((32, 36, 32, 1), generator=g)
    card = Predictor(device=dev, sw_batch_size=2, **kw)
    conv3x3.launches = 0
    got, binary = card.infer(vol)        # 2 windows: one batch of 2
    assert conv3x3.launches == 10 + 18 * 2
    assert got.shape == binary.shape == (32, 36, 32, 13)
    assert torch.isfinite(got).all()

    win = torch.rand((1, 32, 32, 32, 1), generator=g)
    noise = torch.randn((1, 32, 32, 32, 13), generator=g)
    with torch.inference_mode():
        want = Predictor(device="cpu", **kw).seg.ddim_sample(win, noise=noise)
        on_card = card.seg.ddim_sample(win.to(dev), noise=noise.to(dev))
    assert (on_card.cpu() - want).abs().max().item() <= 1e-3


# (parts of the conv input, Cout, (N, D, H, W), prologue) of the backward
# card tests: gathered (Cin 8, the stems) and TMA-mapped parts, ragged
# bricks and chunks, split chunks and split voxels; for the bf16 weight
# gradient every chunk geometry (8 x 16 tiles, whole 16-wide slices, four
# 8-wide slices a chunk, ragged runs), both instances (Cin 16 for the
# stems), four parts with one of 5 channels, and g gathered (Cout 5)
CONV_GRAD_CASES = [
    ([8], 8, (1, 32, 32, 22), True),
    ([1, 15], 64, (2, 16, 16, 16), False),
    ([64], 64, (2, 12, 12, 12), True),
    ([64, 64], 64, (1, 16, 16, 16), False),
    ([8], 16, (1, 6, 7, 9), True),
    ([256], 512, (2, 6, 6, 6), True),
    ([128], 256, (3, 12, 12, 12), True),
    ([8, 16, 5, 3], 24, (1, 9, 10, 22), True),
    ([1, 15], 64, (2, 13, 11, 21), False),
    ([20], 5, (1, 5, 7, 11), True),
    ([1, 2], 64, (4, 16, 16, 16), False),        # the MSD denoiser stem
    ([1, 2], 64, (2, 13, 11, 21), False),
    # HybridMIM pretraining's shapes (batch 2): 64^3 and 32^3 (16 x 8
    # patches), 8^3 and 4^3 (whole slices, split chunks)
    ([64], 64, (2, 64, 64, 64), True),
    ([64, 64], 64, (2, 32, 32, 32), False),
    ([256], 256, (2, 8, 8, 8), True),
    ([128, 128], 128, (2, 8, 8, 8), False),
    ([512], 512, (2, 4, 4, 4), True),
    ([256], 512, (2, 4, 4, 4), False),
    # a 2-deep volume: one valid z a sample at the z taps +-1
    ([64], 64, (3, 2, 2, 2), True),
]


def _grad_inputs(dev, dtype, chans, cout, shape, prologue, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed + sum(chans) + cout)
    n, cin = shape[0], sum(chans)
    parts = [torch.randn((*shape, c), generator=g, device=dev).to(dtype)
             for c in chans]
    w = torch.randn((cout, cin, 3, 3, 3), generator=g, device=dev) \
        / (27 * cin) ** 0.5
    b = 0.1 * torch.randn((cout,), generator=g, device=dev)
    pro = None
    if prologue:
        pro = (1 + 0.3 * torch.randn((n, cin), generator=g, device=dev),
               0.3 * torch.randn((n, cin), generator=g, device=dev),
               0.2 * torch.randn((n, cin), generator=g, device=dev), 0.1)
    gy = torch.randn((*shape, cout), generator=g, device=dev).to(dtype)
    return parts, w, b, pro, gy


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chans,cout,shape,prologue", CONV_GRAD_CASES)
def test_conv3x3_dgrad_kernel_matches_plain(dev, dtype, chans, cout, shape,
                                            prologue):
    """dgrad: the forward kernel with the flipped weights, Cout -> Cin."""
    parts, w, _, _, gy = _grad_inputs(dev, dtype, chans, cout, shape, False)
    before = (conv3x3.launches, conv3x3.dgrad_launches)
    got = conv3x3_dgrad(gy, w)
    want = conv3x3_dgrad_plain(gy, w)
    torch.cuda.synchronize()
    assert (conv3x3.launches, conv3x3.dgrad_launches) == (
        before[0], before[1] + 1)
    assert got.dtype == dtype and got.shape == (*shape, sum(chans))
    scale = max(1.0, want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= \
        KERNEL_TOL[dtype] * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chans,cout,shape,prologue", CONV_GRAD_CASES)
def test_conv3x3_wgrad_kernel_matches_plain(dev, dtype, chans, cout, shape,
                                            prologue):
    """wgrad: the new kernel, the prologue on its load, against cuDNN's
    weight gradient of the rounded input; run twice, bit-identical (the
    split partials are summed in a fixed order)."""
    parts, _, _, pro, gy = _grad_inputs(dev, dtype, chans, cout, shape,
                                        prologue)
    before = conv3x3_wgrad.launches
    got = conv3x3_wgrad(gy, parts, pro)
    again = conv3x3_wgrad(gy, parts, pro)
    want = conv3x3_wgrad_plain(gy, parts, pro)
    torch.cuda.synchronize()
    assert conv3x3_wgrad.launches == before + 2
    assert got.dtype == torch.float32 and got.shape == (cout, sum(chans), 3,
                                                        3, 3)
    assert torch.equal(got, again)
    err = (got - want).abs().max().item()
    assert err <= WGRAD_TOL[dtype] * want.abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chans,cout,shape,prologue", [CONV_GRAD_CASES[0],
                                                       CONV_GRAD_CASES[3]])
def test_conv3x3_function_gradients_match_plain(dev, dtype, chans, cout,
                                                shape, prologue):
    """The whole backward on the card (the kernels and the adjoint chain)
    against autograd through the plain version, through y and the
    statistics. cuDNN's backward of the plain version runs with TF32 off,
    as its forward does: in TF32 the reference itself errs by ~1e-3."""
    parts, w, b, pro, gy = _grad_inputs(dev, dtype, chans, cout, shape,
                                        prologue)
    cs = torch.randn((shape[0], 2, cout), device=dev)
    leaves = [w, b] + [v for v in (pro or ())[:3]] + parts
    grads = []
    for fn in (conv3x3, conv3x3_plain):
        inputs = [v.detach().clone().requires_grad_() for v in leaves]
        w_, b_ = inputs[:2]
        pro_ = (*inputs[2:5], 0.1) if pro else None
        parts_ = inputs[5 if pro else 2:]
        with _no_tf32():
            y, st = fn(parts_, w_, b_, prologue=pro_, with_stats=True)
            grads.append(torch.autograd.grad(
                (y.float() * gy.float()).sum() + (st * cs).sum(), inputs))
    torch.cuda.synchronize()
    for got, want in zip(*grads):
        scale = want.float().abs().max().item()
        assert (got.float() - want.float()).abs().max().item() <= \
            GRAD_TOL[dtype] * scale


def test_diff_unet_train_step_runs_the_conv_kernels_both_ways(dev):
    """A small DiffUNet train step: 28 forward, 26 dgrad (not the stems)
    and 28 wgrad launches, one forward and one dgrad pack per conv and
    step once the weights move, finite loss."""
    from diff_unet_tpu_torch.api import DiffusionSegmenter
    from diff_unet_tpu_torch.engine.train import TrainStep, make_optimizer
    from diff_unet_tpu_torch.losses.losses import CompositeLoss
    from diff_unet_tpu_torch.models.diff_unet import DiffUNet
    from diff_unet_tpu_torch.utils.weights import init_random

    model = init_random(DiffUNet(3, features=(8, 8, 16, 32, 64, 8),
                                 dtype=torch.bfloat16), 0).to(dev)
    opt, schedule = make_optimizer(model.parameters(), lr=1e-3)
    step = TrainStep(DiffusionSegmenter(model, 3),
                     CompositeLoss("mse,bce,dice", 3), opt, schedule)
    g = torch.Generator(device=dev).manual_seed(0)
    image = torch.rand((2, 32, 32, 32, 1), generator=g, device=dev)
    labels = (torch.rand((2, 32, 32, 32, 3), generator=g, device=dev)
              > 0.5).float()
    step(image, labels, generator=g)
    conv3x3.launches = conv3x3.dgrad_launches = conv3x3_wgrad.launches = 0
    packs = packed_weight.packs
    m = step(image, labels, generator=g)
    torch.cuda.synchronize()
    assert (conv3x3.launches, conv3x3.dgrad_launches,
            conv3x3_wgrad.launches) == (28, 26, 28)
    assert packed_weight.packs - packs == 28 + 26
    assert torch.isfinite(m["loss"]) and m["grad_norm"].item() > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_diff_unet_train_step_is_reproducible(dev, dtype):
    """The same small DiffUNet train step twice from the same start gives
    the same loss, gradients and parameters, bit for bit: no float atomics
    on the path (the conv's statistics and split sums are added in a fixed
    order, the weight gradient's split partials too)."""
    from diff_unet_tpu_torch.api import DiffusionSegmenter
    from diff_unet_tpu_torch.engine.train import TrainStep, make_optimizer
    from diff_unet_tpu_torch.losses.losses import CompositeLoss
    from diff_unet_tpu_torch.models.diff_unet import DiffUNet
    from diff_unet_tpu_torch.utils.weights import init_random

    g = torch.Generator(device=dev).manual_seed(0)
    image = torch.rand((2, 32, 32, 32, 1), generator=g, device=dev)
    labels = (torch.rand((2, 32, 32, 32, 3), generator=g, device=dev)
              > 0.5).float()
    t = torch.tensor([17, 640], device=dev)
    noise = torch.randn((2, 32, 32, 32, 3), generator=g, device=dev)
    runs = []
    for _ in range(2):
        model = init_random(DiffUNet(3, features=(8, 8, 16, 32, 64, 8),
                                     dtype=dtype), 0).to(dev)
        opt, schedule = make_optimizer(model.parameters(), lr=1e-3)
        step = TrainStep(DiffusionSegmenter(model, 3),
                         CompositeLoss("mse,bce,dice", 3), opt, schedule)
        m = step(image, labels, t=t, noise=noise)
        runs.append([m["loss"]] + [p.grad.clone() for p in model.parameters()]
                    + [p.detach().clone() for p in model.parameters()])
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_loss_aware_update_on_the_card_matches_the_cpu(dev):
    """The sampler's ring update with repeated timesteps gives the CPU's
    bits on the card (every duplicate writes its last sample's row)."""
    from diff_unet_tpu_torch.diffusion import resample

    g = torch.Generator().manual_seed(0)
    states = [resample.init_loss_aware(50, 4, torch.device("cpu")),
              resample.init_loss_aware(50, 4, dev)]
    for _ in range(30):
        t = torch.randint(0, 50, (10,), generator=g)
        t[3] = t[7] = t[1]
        losses = torch.rand(10, generator=g)
        states = [resample.update_loss_aware(states[0], t, losses),
                  resample.update_loss_aware(states[1], t.to(dev),
                                             losses.to(dev))]
    assert torch.equal(states[1].losses.cpu(), states[0].losses)
    assert torch.equal(states[1].counts.cpu(), states[0].counts)
