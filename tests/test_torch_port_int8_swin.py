"""PyTorch port, W8A8 int8 serving of DiffSwinUNETR against the JAX package
on the CPU (``quantize=True`` UNETR blocks of
``diff_unet_tpu/models/swin_unetr.py`` at ``pack=1``): the quantized
``UnetResBlock`` and ``UnetrUpBlock`` bit for bit in their int8 inputs, the
1x1 int8 conv's int32 sums exactly, the whole DiffSwinUNETR (feature 12,
32^3, 3 classes) weights-only and with JAX's calibrated scales carried by
``load_jax_quant``, the port's calibrated scales against JAX's from the
same x_T, and the engine's keys. The JAX side runs its UNETR blocks op by
op, not under ``jit`` (which fuses the float32 rescale and rounds it
otherwise), and in float64 where the port can run float64 too; its Swin
ViT, which has no int8 op, runs under ``nn.jit`` (the same bits as op by
op in float64, and a third of the first run's compile time)."""
import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from diff_unet_tpu.api import DiffusionSegmenter as JSeg
from diff_unet_tpu.engine.quantize import _partition as jquant_partition
from diff_unet_tpu.engine.quantize import \
    quantize_inference_params as jquantize
from diff_unet_tpu.models import swin_unetr as jsw
from diff_unet_tpu.ops import int8 as jq
from diff_unet_tpu.ops import swin as jswin
from diff_unet_tpu_torch.api import DiffusionSegmenter as TSeg
from diff_unet_tpu_torch.engine.engine import Predictor, Tester
from diff_unet_tpu_torch.engine.quantize import quantize_inference_params
from diff_unet_tpu_torch.models import swin_unetr as tsw
from diff_unet_tpu_torch.ops import blocks
from diff_unet_tpu_torch.ops import int8 as tq
from diff_unet_tpu_torch.ops.blocks import quant_sites
from diff_unet_tpu_torch.predict import predict_volume
from diff_unet_tpu_torch.utils.weights import load_jax_params, \
    load_jax_quant
from tests.test_torch_port_int8 import _int8, _np
from tests.test_torch_port_swin import random_flax_params
from tests.test_torch_port_swin import torch_threads  # noqa: F401
from tests.test_torch_port_tester import COMMON, workspace  # noqa: F401

FS, S, C = 12, 32, 3
# a quantized block in float64 against JAX's, as a fraction of max |y|,
# with the same int8 values on both sides: both rescale in float32, and
# the float64 norms between differ in summation order (norm3's statistics
# are float32 on the port's side, 1e-7 of its output)
BLOCK_TOL = 1e-5
# the whole DiffSwinUNETR: the port runs float32 (its Swin cannot run
# float64) against JAX's float64, so the Swin's outputs, which feed every
# block but the encoder1s, differ by float32 rounding, and an activation
# within it of a .5 quotient lands one int8 step (1/127 of its tensor's
# range) apart; such flips pass on through the blocks and gather in the
# decoder's conv2s (measured: 2.3e-2 of the int8 inputs differ and the
# logits 3.9e-2 of max |y| apart weights only, 1.1e-2 and 3.2e-2
# calibrated; the encoder1s', which read the image, differ only where
# float32 and float64 divide a .5 quotient apart). The bounds leave about
# twice that; a misquantized conv flips about half of its own inputs
MODEL_FLIPS = 5e-2
MODEL_TOL = 8e-2
# JAX's calibrated scales against the port's from the same x_T (float32 on
# both sides): a conv that sees the image only within 1e-6; the others see
# the Swin's outputs or x_t, whose float32 rounding differs between the
# packages, and int8 flips move the denoiser's scales further (random
# weights, DDIM-2; held as the DiffUNet test holds them)
SCALE_TOL = {"image": 1e-6, "other": 5e-2}
N_SITES = 35                       # 28 convs 3x3x3 and 7 convs 1x1x1


def _up(a):
    a = np.asarray(a)
    return a.astype(np.float64) if a.dtype == np.float32 else a


_JIT_SWIN = nn.jit(jswin.SwinTransformer)


def _jax_apply(module, variables, *args, method=None):
    """``module.apply`` in float64 (params promoted; a recorded ``quant``
    collection keeps its float32 scales), op by op but for the Swin ViT,
    with the int8 input of every conv in call order; with ``mutable``
    quant, also the recorded collection."""
    seen = []
    conv = jq.conv_int8

    def rec_conv(xq, kq, **kw):
        seen.append(np.asarray(xq))
        return conv(xq, kq, **kw)

    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jq, "conv_int8", rec_conv)
        mp.setattr(jsw, "SwinTransformer", _JIT_SWIN)
        v = {"params": jax.tree_util.tree_map(_up, variables["params"])}
        if "quant" in variables:
            v["quant"] = jax.tree_util.tree_map(np.asarray,
                                                variables["quant"])
        out, rec = module.apply(v, *[_up(a) for a in args], method=method,
                                mutable=["quant"])
        quant = jax.tree_util.tree_map(np.asarray, dict(rec.get("quant",
                                                                {})))
        return np.asarray(out), seen, quant


def _port_apply(fn, *args):
    """``fn(*args)`` without autograd and the int8 input of every conv
    (the parts' concat for the 3x3x3 conv), in call order."""
    seen = []
    conv3, conv1 = blocks.conv3x3_int8, blocks.conv1x1_int8

    def rec_conv3(parts, wq, sa, *a, **kw):
        xq = (parts if parts[0].dtype == torch.int8
              else tq.quantize_input(parts, sa, kw.get("prologue")))
        seen.append(torch.cat(xq, -1).numpy())
        return conv3(parts, wq, sa, *a, **kw)

    def rec_conv1(xq, *a, **kw):
        seen.append(xq.numpy())
        return conv1(xq, *a, **kw)

    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(blocks, "conv3x3_int8", rec_conv3)
        mp.setattr(blocks, "conv1x1_int8", rec_conv1)
        out = fn(*args)
    return out.numpy(), seen


def _flips(got_q, want_q):
    assert len(got_q) == len(want_q)
    for g, w in zip(got_q, want_q):
        assert g.shape == w.shape and g.dtype == w.dtype == np.int8
    return sum(int(np.count_nonzero(g != w)) for g, w in zip(got_q, want_q))


# (kind, Cin, Cout, timed): a residual block without conv3, with conv3
# (timed, and un-timed as the encoder's one-channel stem), an UpBlock
BLOCKS = [("res", 12, 12, False), ("res", 5, 12, True), ("res", 1, 12, False),
          ("up", 24, 12, True)]


@pytest.mark.parametrize("scales", ["dynamic", "recorded"])
@pytest.mark.parametrize("kind,cin,cout,timed", BLOCKS,
                         ids=["no conv3", "conv3 timed", "stem conv3",
                              "up block"])
def test_quantized_block_matches_jax(kind, cin, cout, timed, scales):
    """A quantized UnetResBlock / UnetrUpBlock in float64 against JAX's
    (two different samples of 8^3): every int8 conv input equal (0 flips)
    and the output within BLOCK_TOL of max |y|, with dynamic scales and
    with the int8 state JAX records on another input (static scales other
    than this input's), carried by ``load_jax_quant``. Where the block has
    a 1x1 projection, its input is quantized once for conv1 and conv3."""
    temb = _np(3, (2, 512)) if timed else None
    if kind == "res":
        x = _np(1, (2, 8, 8, 8, cin), 1.5)
        args = (x,) if temb is None else (x, temb)
        jm = jsw.UnetResBlock(cout, time_conditioned=timed, quantize=True)
        jf = jsw.UnetResBlock(cout, time_conditioned=timed)
        tm = tsw.UnetResBlock(cin, cout, timed, quantize=True)
    else:
        x = _np(1, (2, 4, 4, 4, cin), 1.5)
        skip = _np(2, (2, 8, 8, 8, cout))
        args = (x, skip, temb)
        jm = jsw.UnetrUpBlock(cout, quantize=True)
        jf = jsw.UnetrUpBlock(cout)
        tm = tsw.UnetrUpBlock(cin, cout, quantize=True)
    params = random_flax_params(jf, *args, seed=4)
    load_jax_params(tm, params).eval()
    variables = dict(params)
    if scales == "recorded":
        other = tuple(None if a is None else 1.3 * _np(9 + i, a.shape)
                      for i, a in enumerate(args))
        _, _, rec = _jax_apply(jm, params, *other)
        variables["quant"] = rec
        load_jax_quant(tm, rec)
        assert all(getattr(o, p + "sa") is not None
                   for o, p, *_ in quant_sites(tm))
    want, want_q, _ = _jax_apply(jm, variables, *args)
    got, got_q = _port_apply(tm, *[None if a is None else
                                   torch.from_numpy(a).double()
                                   for a in args])
    assert len(got_q) == (2 if cin == cout else 3)
    assert _flips(got_q, want_q) == 0
    assert np.abs(got - want).max() <= BLOCK_TOL * np.abs(want).max()
    if cin != cout:
        # one quantization for conv1 and conv3: the same int8 tensor
        assert np.array_equal(got_q[0], got_q[2])


@pytest.mark.parametrize("cin", [1, 15, 24])
def test_conv1x1_int8_matches_jax(cin):
    """``conv1x1_int8``'s int32 sums equal ``conv_int8`` with a 1x1x1 kernel
    exactly (the stems' Cin 1 and 15, and 24), and its rescaled output
    equals JAX's ``rescale`` bit for bit."""
    cout = 12
    x = _int8(12, (2, 3, 4, 5, cin))
    k = _int8(13, (1, 1, 1, cin, cout))
    want = np.asarray(jq.conv_int8(jnp.asarray(x), jnp.asarray(k)))
    wq = torch.from_numpy(np.ascontiguousarray(k.transpose(4, 3, 0, 1, 2)))
    acc = tq.conv1x1_int8(torch.from_numpy(x), wq)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), want)
    sa, sw, b = np.float32(0.017), _np(14, (cout,), 0.01) ** 2, _np(15,
                                                                   (cout,))
    y_j = np.asarray(jq.rescale(jnp.asarray(want), jnp.asarray(sa),
                                jnp.asarray(sw), jnp.asarray(b),
                                jnp.float32))
    y = tq.conv1x1_int8(torch.from_numpy(x), wq, torch.tensor(sa),
                        torch.from_numpy(sw), torch.from_numpy(b),
                        torch.float32)
    np.testing.assert_array_equal(y.numpy(), y_j)


def test_load_jax_quant_refuses_a_shared_scale_that_differs():
    """conv3 reads conv1's input, so a block takes one scale for both:
    ``load_jax_quant`` stores JAX's ``conv3_sa`` as the tensor of
    ``conv1_sa`` when the two are equal, and refuses a tree where they
    differ."""
    block = tsw.UnetResBlock(5, 12, quantize=True)
    quant = {f"{p}_wq": (_int8(20 + i, shape), np.full((12,), 1e-3,
                                                       np.float32))
             for i, (p, shape) in enumerate((
                 ("conv1", (3, 3, 3, 5, 12)), ("conv2", (3, 3, 3, 12, 12)),
                 ("conv3", (1, 1, 1, 5, 12))))}
    quant.update(conv1_sa=np.float32(0.02), conv2_sa=np.float32(0.03),
                 conv3_sa=np.float32(0.02))
    load_jax_quant(block, quant)
    assert block.conv3_sa is block.conv1_sa
    with pytest.raises(ValueError, match="conv3_sa"):
        load_jax_quant(block, {**quant, "conv3_sa": np.float32(0.021)})


def _tmodel():
    return tsw.DiffSwinUNETR(C, image_size=(S,) * 3, feature_size=FS,
                             quantize=True)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    image = rng.standard_normal((2, S, S, S, 1)).astype(np.float32)
    x = rng.standard_normal((2, S, S, S, C)).astype(np.float32)
    t = np.array([3, 640], np.int32)
    kw = dict(out_channels=C, image_size=(S,) * 3, feature_size=FS)
    jm = jsw.DiffSwinUNETR(quantize=True, **kw)
    params = random_flax_params(jsw.DiffSwinUNETR(**kw), image, x, t, seed=1)
    tm = load_jax_params(_tmodel(), params).eval()
    return jm, params, tm, image, x, t


@pytest.fixture(scope="module")
def jax_calibrated(pair):
    """JAX's ``quantize_inference_params`` over DDIM-2 on one window batch
    (one sample) from ``key(3)``: (variables, the batch). The parameters go
    in as JAX arrays: its Swin indexes its bias table with a JAX array,
    which a numpy table refuses under ``jit``."""
    jm, params, _, image, _, _ = pair
    jvars = jquantize(JSeg(jm, C, sample_steps=2),
                      jax.tree_util.tree_map(jnp.asarray, params),
                      calibration_images=[jnp.asarray(image[:1])],
                      rng=jax.random.key(3))
    return jvars, image[:1]


@pytest.mark.parametrize("scales", ["weights only", "calibrated"])
def test_diff_swin_unetr_int8_denoise_matches_jax(pair, jax_calibrated,
                                                  scales):
    """DiffSwinUNETR(quantize=True).denoise (float32) against JAX's pack=1
    model (float64) with JAX's recorded ``quant`` collection carried by
    ``load_jax_quant``: its kernels only (dynamic scales), and kernels with
    scales calibrated over DDIM-2. 35 int8 convs, each input in call order;
    the share of differing int8 inputs within MODEL_FLIPS and the logits
    within MODEL_TOL of max |y|. Weights-only, the port's own recorded
    kernels give the same bits, and ``load_jax_quant`` refuses a tree with
    an extra or a missing entry."""
    jm, params, tm, image, x, t = pair
    jvars = jax_calibrated[0]
    if scales == "weights only":
        jvars = {**jvars, "quant": jquant_partition(
            dict(jvars["quant"]), lambda k: k.endswith("wq"))}
    quant = jax.tree_util.tree_map(np.asarray, dict(jvars["quant"]))
    want, want_q, _ = _jax_apply(jm, jvars, image, x, t, method="denoise")
    load_jax_quant(tm, quant)
    sites = list(quant_sites(tm))
    assert len(sites) == N_SITES
    assert sum(o.conv3 is not None for o, p, *_ in sites
               if p == "conv3_") == 7
    assert all(getattr(o, p + "sa") is not None
               for o, p, *_ in sites) == (scales == "calibrated")
    args = [torch.from_numpy(image), torch.from_numpy(x),
            torch.from_numpy(t).long()]
    got, got_q = _port_apply(tm.denoise, *args)
    assert len(got_q) == len(want_q) == N_SITES
    share = _flips(got_q, want_q) / sum(w.size for w in want_q)
    dist = np.abs(got - want).max() / np.abs(want).max()
    assert share <= MODEL_FLIPS and dist <= MODEL_TOL, (share, dist)
    if scales == "weights only":
        extra = {**quant, "model": {**quant["model"], "nowhere": {
            "conv1_sa": np.float32(1.0)}}}
        missing = {**quant, "model": {k: v for k, v in quant["model"].items()
                                      if k != "decoder3"}}
        for bad in (extra, missing):
            with pytest.raises(KeyError):
                load_jax_quant(tm, bad)
        # the port's own kernels: JAX's int8 values; JAX's jit divides the
        # scales by 127 as a product with its reciprocal, an ulp away
        loaded = {(id(o), p): (getattr(o, p + "wq"), getattr(o, p + "sw"))
                  for o, p, *_ in sites}
        quantize_inference_params(tm)
        for o, p, *_ in sites:
            wq, sw = loaded[(id(o), p)]
            assert torch.equal(getattr(o, p + "wq"), wq)
            torch.testing.assert_close(getattr(o, p + "sw"), sw, rtol=2e-7,
                                       atol=0)
        own, own_q = _port_apply(tm.denoise, *args)
        assert _flips(own_q, got_q) == 0
        assert np.abs(own - got).max() <= 1e-5 * np.abs(got).max()


def _scales(tm):
    names = {id(m): n for n, m in tm.named_modules()}
    return {(names[id(o)], p): float(getattr(o, p + "sa"))
            for o, p, *_ in quant_sites(tm)}


def test_calibrated_scales_match_jax(pair, jax_calibrated):
    """``quantize_inference_params`` fed JAX's own x_T (``normal(fold_in(
    key, 0))``) records JAX's scales (float32 on both sides, DDIM-2, one
    window batch): the encoder1s' convs that read the image alone within
    SCALE_TOL["image"], the others within SCALE_TOL["other"]; conv1 and
    conv3 of a block record one scale, as one tensor."""
    _, params, _, _, _, _ = pair
    jvars, image = jax_calibrated
    noise = [torch.from_numpy(np.asarray(jax.random.normal(
        jax.random.fold_in(jax.random.key(3), 0), (1, S, S, S, C),
        jnp.float32)))]
    tm = load_jax_params(_tmodel(), params).eval()
    quantize_inference_params(TSeg(tm, C, sample_steps=2),
                              [torch.from_numpy(image)], noise=noise)
    got = _scales(tm)
    assert len(got) == N_SITES
    for o, p, *_ in quant_sites(tm):
        if p == "conv3_":
            assert o.conv3_sa is o.conv1_sa
    for (scope, prefix), sa in got.items():
        node = dict(jvars["quant"])
        for k in scope.split("."):
            node = node[k]
        want = float(np.asarray(node[prefix + "sa"]))
        image_only = (scope == "embed_model.encoder1.layer"
                      and prefix != "conv2_")
        rel = SCALE_TOL["image" if image_only else "other"]
        assert sa == pytest.approx(want, rel=rel), (scope, prefix)


def test_engine_keys(workspace, tmp_path, monkeypatch):  # noqa: F811
    """``model_name: diff_swin_unetr`` with ``quantize``: the model builds
    with its 35 int8 convs; the Predictor records kernels at build and
    ``predict_volume`` calibrates on the first volume under
    ``quant_calibrate``; ``Tester(quantize=True, quant_calibrate=1)``
    calibrates on its first case and runs; with static scales
    ``continuous=2`` gives the serial dices."""
    _, data, classes = workspace
    monkeypatch.chdir(tmp_path)
    kw = dict(COMMON, image_size=S, spatial_size=S, feature_size=FS,
              model_name="diff_swin_unetr", classes=str(classes),
              quantize=True, quant_calibrate=1)
    pred = Predictor(**kw)
    assert len(list(quant_sites(pred.module))) == N_SITES
    block = pred.module.model.decoder1.conv_block
    assert block.conv3_wq is not None and block.conv1_sa is None
    labels = predict_volume(pred, data / "img_0.nii.gz")
    assert pred._act_calibrated and block.conv3_sa is block.conv1_sa
    assert labels.dtype == np.int16 and set(np.unique(labels)) <= {0, 1, 2}
    tester = Tester(data_path=str(data), log_dir="q", save_volumes=False,
                    **kw)
    assert tester._act_calibrated
    assert tester.module.model.encoder10.layer.conv2_sa is not None
    dices = np.asarray(tester.test()["dices"])
    assert dices.shape == (4, 2) and np.all((dices >= 0) & (dices <= 1))
    cont = Tester(data_path=str(data), log_dir="qc", save_volumes=False,
                  continuous=2, **kw)
    np.testing.assert_array_equal(np.asarray(cont.test()["dices"]), dices)
