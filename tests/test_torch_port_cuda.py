"""PyTorch port on a CUDA card: each kernel against its plain version, the
wrappers' input checks, and tiny Predictors (DiffSwinUNETR, DiffUNet) run
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
    KERNEL_TOL,
    STATS_TOL,
    conv3x3,
    conv3x3_plain,
)
from diff_unet_tpu_torch.ops.swin import window_region_ids
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


def test_wrappers_check_inputs(dev):
    qkv = torch.randn((2, 8, 3, 2, 4), device=dev, requires_grad=True)
    bias = torch.zeros((2, 8, 8), device=dev)
    with pytest.raises(RuntimeError, match="forward-only"):
        window_attention(qkv, bias)
    with torch.no_grad():
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chans,prologue,stats", [
    ([1], False, True), ([1, 15], False, True), ([64], True, True),
    ([64, 64], False, True), ([64], False, False), ([3, 5], True, False),
])
@pytest.mark.parametrize("shape", [(2, 6, 7, 9), (1, 8, 8, 8)])
def test_conv3x3_kernel_matches_plain(dev, dtype, chans, prologue, stats,
                                      shape):
    """Odd W, parts that split the channels, the prologue and statistics
    on and off; bias and LeakyReLU epilogue on the one-part cases."""
    g = torch.Generator(device=dev).manual_seed(sum(chans) + shape[1])
    n, cin, cout = shape[0], sum(chans), 24
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
    slope = 0.1 if len(chans) == 1 else None
    before = conv3x3.launches
    got = conv3x3(parts, w, b, prologue=pro, negative_slope=slope,
                  with_stats=stats)
    want = conv3x3_plain(parts, w, b, prologue=pro, negative_slope=slope,
                         with_stats=stats)
    torch.cuda.synchronize()
    assert conv3x3.launches == before + 1
    if stats:
        (got, gst), (want, wst) = got, want
        scale = wst.abs().max().item()
        assert (gst - wst).abs().max().item() <= STATS_TOL * scale
    assert got.dtype == dtype and got.shape == (*shape, cout)
    scale = max(1.0, want.float().abs().max().item())
    err = (got.float() - want.float()).abs().max().item()
    assert err <= KERNEL_TOL[dtype] * scale


def test_conv3x3_checks_inputs(dev):
    x = torch.zeros((1, 4, 4, 4, 8), device=dev)
    w = torch.zeros((8, 8, 3, 3, 3), device=dev)
    with pytest.raises(RuntimeError, match="forward-only"):
        conv3x3([x], w.requires_grad_())
    with torch.no_grad():
        w = w.detach()
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
