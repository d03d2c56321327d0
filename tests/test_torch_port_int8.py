"""PyTorch port, W8A8 int8 serving against the JAX package on the CPU
(``diff_unet_tpu/ops/int8.py``, ``engine/quantize.py``, the quantized
``ConvNormAct`` / ``UpCat``): the quantizers bit for bit (bf16's
``quantize_act`` with its off-by-one count stated), the int8 conv and
transposed conv's int32 sums exactly, the quantized DiffUNet (features
(8, 8, 16, 32, 64, 8), 16^3) against JAX's ``pack=1`` model in float64,
weights-only and with JAX's recorded scales carried by ``load_jax_quant``,
the port's calibrated scales against JAX's from the same x_T, offline
against in-graph quantization, and the engine's keys."""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diff_unet_tpu.api import DiffusionSegmenter as JSeg
from diff_unet_tpu.engine.quantize import _partition as jquant_partition
from diff_unet_tpu.engine.quantize import \
    quantize_inference_params as jquantize
from diff_unet_tpu.models.diff_unet import DiffUNet as JModel
from diff_unet_tpu.ops import int8 as jq
from diff_unet_tpu_torch.api import DiffusionSegmenter as TSeg
from diff_unet_tpu_torch.engine import checkpoint as ckpt
from diff_unet_tpu_torch.engine.engine import Predictor, Tester, Trainer
from diff_unet_tpu_torch.engine.quantize import quantize_inference_params
from diff_unet_tpu_torch.models.diff_unet import DiffUNet as TModel
from diff_unet_tpu_torch.models.model_hub import create_model
from diff_unet_tpu_torch.ops import blocks
from diff_unet_tpu_torch.ops import int8 as tq
from diff_unet_tpu_torch.ops.blocks import quant_sites
from diff_unet_tpu_torch.predict import predict_volume
from diff_unet_tpu_torch.utils.weights import load_jax_params, \
    load_jax_quant
from tests.test_torch_port_swin import random_flax_params
from tests.test_torch_port_swin import torch_threads  # noqa: F401
from tests.test_torch_port_tester import COMMON, workspace  # noqa: F401

FEATURES = (8, 8, 16, 32, 64, 8)
C = 3
S = 16
# the quantized DiffUNet in float64 against JAX's, as a fraction of max |y|,
# with the same int8 values on both sides: both rescale in float32 (2^-24
# relative per conv), and the float64 norms between differ in summation
# order only
DENOISE_TOL = 1e-5


def _np(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _int8(seed, shape):
    return np.random.default_rng(seed).integers(-127, 128, shape,
                                                dtype=np.int8)


@pytest.mark.parametrize("layout", ["conv", "deconv"])
def test_quantize_kernel_matches_jax(layout):
    """Per-Cout scales and int8 kernels equal JAX's bit for bit, in the
    conv's and the transposed conv's layouts (one all-zero channel takes
    the 1e-12 floor)."""
    k = _np(0, (3, 3, 3, 5, 7) if layout == "conv" else (2, 2, 2, 6, 4))
    k[..., 1] = 0.0
    jk, jsw = jq.quantize_kernel(jnp.asarray(k))
    if layout == "conv":
        w, axis = torch.from_numpy(k.transpose(4, 3, 0, 1, 2).copy()), 0
        back = (4, 3, 0, 1, 2)
    else:
        w, axis = torch.from_numpy(k.transpose(3, 4, 0, 1, 2).copy()), 1
        back = (3, 4, 0, 1, 2)
    kq, sw = tq.quantize_kernel(w, axis)
    assert kq.dtype == torch.int8 and sw.dtype == torch.float32
    np.testing.assert_array_equal(sw.numpy(), np.asarray(jsw))
    np.testing.assert_array_equal(kq.numpy(),
                                  np.asarray(jk).transpose(back))


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
def test_act_scale_and_quantize_act_match_jax(dtype):
    """act_scale over all parts (one scale for a concat) and quantize_act,
    with exact .5 quotients planted: equal bit for bit in float32 and
    float64. In bf16 the port rounds x / sa to bf16 before the round, as
    written; XLA on the CPU keeps the quotient in float32, so values whose
    float32 quotient is not a bf16 value may round differently: counted,
    each off by one."""
    x = _np(1, (2, 5, 4, 3, 6), 3.0)
    sa_j = jq.act_scale(jnp.asarray(x))
    x.reshape(-1)[:40] = (np.arange(40) - 20 + 0.5) * float(sa_j)
    parts = [x[..., :2], x[..., 2:]]
    with jax.enable_x64(dtype == "float64"):
        xj = jnp.asarray(x).astype(dtype)
        sa_j = jq.act_scale(xj)
        want = np.asarray(jq.quantize_act(xj, sa_j))
    tdt = getattr(torch, dtype)
    tparts = [torch.from_numpy(np.ascontiguousarray(p)).to(tdt)
              for p in parts]
    sa = tq.act_scale(tparts)
    assert sa.dtype == torch.float32
    assert float(sa) == float(np.asarray(sa_j))
    got = torch.cat([tq.quantize_act(p, sa) for p in tparts], -1).numpy()
    diff = got.astype(np.int32) - want.astype(np.int32)
    if dtype == "bfloat16":
        assert np.abs(diff).max() <= 1
        assert np.count_nonzero(diff) <= diff.size // 100, \
            np.count_nonzero(diff)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("chans,shape", [([5], (2, 5, 6, 7)),
                                         ([1, 4], (1, 3, 4, 5)),
                                         ([16, 16, 3], (2, 4, 3, 5))],
                         ids=["one part", "stem parts", "three parts"])
def test_conv3x3_int8_matches_jax(chans, shape):
    """int32 sums equal ``conv_int8`` of the concat exactly, on odd shapes
    and multi-part inputs; the rescaled output equals JAX's ``rescale``
    bit for bit, and its statistics are those of the float32 values."""
    cin, cout = sum(chans), 9
    x = _int8(2, (*shape, cin))
    k = _int8(3, (3, 3, 3, cin, cout))
    want = np.asarray(jq.conv_int8(jnp.asarray(x), jnp.asarray(k)))
    offs = np.cumsum([0] + chans)
    parts = [torch.from_numpy(np.ascontiguousarray(x[..., a:b]))
             for a, b in zip(offs[:-1], offs[1:])]
    wq = torch.from_numpy(np.ascontiguousarray(k.transpose(4, 3, 0, 1, 2)))
    acc = tq.conv3x3_int8(parts, wq)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), want)
    sa, sw, b = np.float32(0.013), _np(4, (cout,), 0.01) ** 2, _np(5, (cout,))
    y_j = np.asarray(jq.rescale(jnp.asarray(want), jnp.asarray(sa),
                                jnp.asarray(sw), jnp.asarray(b),
                                jnp.float32))
    y, stats = tq.conv3x3_int8(parts, wq, torch.tensor(sa),
                               torch.from_numpy(sw), torch.from_numpy(b),
                               torch.float32, with_stats=True)
    np.testing.assert_array_equal(y.numpy(), y_j)
    y64 = y_j.astype(np.float64)
    np.testing.assert_allclose(
        stats.numpy(), np.stack([y64.sum((1, 2, 3)),
                                 (y64 * y64).sum((1, 2, 3))], 1),
        rtol=1e-5, atol=1e-5)


def test_deconv2_int8_matches_jax():
    """The k2 s2 transposed conv's int32 sums equal ``deconv2_int8`` with
    flax's no-mirror kernel exactly (the port's kernel is the flipped
    (Cin, Cout, 2, 2, 2), as ``load_jax_quant`` carries it)."""
    x = _int8(6, (2, 3, 2, 5, 7))
    k = _int8(7, (2, 2, 2, 7, 5))
    want = np.asarray(jq.deconv2_int8(jnp.asarray(x), jnp.asarray(k),
                                      (2, 2, 2)))
    wq = torch.from_numpy(np.ascontiguousarray(
        k[::-1, ::-1, ::-1].transpose(3, 4, 0, 1, 2)))
    got = tq.deconv2_int8(torch.from_numpy(x), wq)
    assert got.dtype == torch.int32 and got.shape == (2, 6, 4, 10, 5)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    image = rng.standard_normal((2, S, S, S, 1)).astype(np.float32)
    x = rng.standard_normal((2, S, S, S, C)).astype(np.float32)
    t = np.array([3, 640], np.int32)
    jm = JModel(out_channels=C, features=FEATURES, quantize=True)
    params = random_flax_params(JModel(out_channels=C, features=FEATURES),
                                image, x, t, seed=1)
    tm = load_jax_params(TModel(C, features=FEATURES, quantize=True),
                         params).eval()
    return jm, params, tm, image, x, t


@pytest.fixture(scope="module")
def jax_calibrated(pair):
    """JAX's ``quantize_inference_params`` over DDIM-2 on two window
    batches (one sample each) from ``key(3)``: (variables, the batches)."""
    jm, params, _, image, _, _ = pair
    images = [image[:1], image[1:]]
    jvars = jquantize(JSeg(jm, C, sample_steps=2), params,
                      calibration_images=[jnp.asarray(i) for i in images],
                      rng=jax.random.key(3))
    return jvars, images


def _jax_denoise(jm, variables, image, x, t):
    """JAX's denoise in float64 (params promoted; a recorded ``quant``
    collection keeps its float32 scales), op by op, with the int8 input of
    every conv and transposed conv in call order. Op by op, because jit
    fuses the float32 rescale and rounds it otherwise (3.5e-7 of max |y|
    at the first conv here), which the int8 rounding turns into flips
    (0.11 of max |y| at the output): the written semantics round each
    operation on its own, as the port does."""
    def up(a):
        a = np.asarray(a)
        return a.astype(np.float64) if a.dtype == np.float32 else a

    seen = []
    conv, deconv = jq.conv_int8, jq.deconv2_int8

    def rec_conv(xq, kq, **kw):
        seen.append(np.asarray(xq))
        return conv(xq, kq, **kw)

    def rec_deconv(xq, kq, strides):
        seen.append(np.asarray(xq))
        return deconv(xq, kq, strides)

    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jq, "conv_int8", rec_conv)
        mp.setattr(jq, "deconv2_int8", rec_deconv)
        v = {"params": jax.tree_util.tree_map(up, variables["params"])}
        if "quant" in variables:
            v["quant"] = jax.tree_util.tree_map(np.asarray,
                                                variables["quant"])
        out = jm.apply(v, up(image), up(x), t, method="denoise")
        return np.asarray(out), seen


def _port_denoise(tm, image, x, t):
    """The port's denoise in float64 and the int8 input of every conv (its
    parts' concat) and transposed conv, in call order."""
    seen = []
    conv, deconv = blocks.conv3x3_int8, blocks.deconv2_int8

    def rec_conv(parts, *a, **kw):
        seen.append(torch.cat(parts, -1).numpy())
        return conv(parts, *a, **kw)

    def rec_deconv(xq, *a, **kw):
        seen.append(xq.numpy())
        return deconv(xq, *a, **kw)

    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(blocks, "conv3x3_int8", rec_conv)
        mp.setattr(blocks, "deconv2_int8", rec_deconv)
        out = tm.denoise(torch.from_numpy(image).double(),
                         torch.from_numpy(x).double(),
                         torch.from_numpy(t).long())
    return out.numpy(), seen


@pytest.mark.parametrize("scales", ["weights only", "calibrated"])
def test_diff_unet_int8_denoise_matches_jax(pair, jax_calibrated, scales):
    """DiffUNet(quantize=True).denoise in float64 against JAX's pack=1
    model with JAX's recorded ``quant`` collection carried by
    ``load_jax_quant``: its kernels only (dynamic scales), and kernels with
    scales calibrated over DDIM-2 on two windows. Every int8 conv input
    equals JAX's (0 flips over 28 convs and 4 transposed convs) and the
    logits agree within ``DENOISE_TOL`` of max |y|. Weights-only, the
    port's own recorded kernels and in-graph quantization give the same
    bits, and ``load_jax_quant`` refuses a tree with an extra or a missing
    entry."""
    jm, params, tm, image, x, t = pair
    jvars = jax_calibrated[0]
    if scales == "weights only":
        # what quantize_inference_params records without calibration: the
        # same kernels, no scales
        jvars = {**jvars, "quant": jquant_partition(
            dict(jvars["quant"]), lambda k: k.endswith("wq"))}
    want, want_q = _jax_denoise(jm, jvars, image, x, t)
    load_jax_quant(tm, jax.tree_util.tree_map(np.asarray,
                                              dict(jvars["quant"])))
    sites = list(quant_sites(tm))
    assert len(sites) == 2 * 5 + 2 * 9 + 4      # encoder, denoiser, UpCats
    assert all(getattr(o, p + "sa") is not None
               for o, p, *_ in sites) == (scales == "calibrated")
    got, got_q = _port_denoise(tm, image, x, t)
    assert len(got_q) == len(want_q) == 32
    flips = sum(int(np.count_nonzero(g != w)) for g, w in zip(got_q, want_q))
    assert flips == 0, flips
    assert np.abs(got - want).max() <= DENOISE_TOL * np.abs(want).max()
    if scales == "weights only":
        quant = jax.tree_util.tree_map(np.asarray, dict(jvars["quant"]))
        extra = {**quant, "model": {**quant["model"], "nowhere": {
            "sa": np.float32(1.0)}}}
        missing = {**quant, "model": {k: v for k, v in quant["model"].items()
                                      if k != "upcat_1"}}
        for bad in (extra, missing):
            with pytest.raises(KeyError):
                load_jax_quant(tm, bad)
        quantize_inference_params(tm)          # the port's own kernels
        assert np.array_equal(_port_denoise(tm, image, x, t)[0], got)
        for owner, prefix, *_ in sites:
            setattr(owner, prefix + "wq", None)
            setattr(owner, prefix + "sw", None)
        assert np.array_equal(_port_denoise(tm, image, x, t)[0], got)


def _scales(tm):
    names = {id(m): n for n, m in tm.named_modules()}
    return {(names[id(o)], p): float(getattr(o, p + "sa"))
            for o, p, *_ in quant_sites(tm)}


def test_calibrated_scales_match_jax(pair, jax_calibrated):
    """``quantize_inference_params`` with calibration windows records, per
    conv, the max dynamic scale over the respaced DDIM trajectory of every
    window batch; fed JAX's own x_T (``normal(fold_in(key, i))``) it
    records JAX's scales (float32 on both sides, DDIM-2, two batches).
    The encoder's scales see the image only: within 1e-5. The denoiser's
    see x_t, whose float32 rounding differs between the packages after the
    first step; int8 rounding turns that into flips, and the scales of
    random weights then move by up to 2.6e-2 (measured): held at 5e-2.
    Calibrating on both batches keeps each conv's larger scale of the two,
    exactly."""
    _, params, _, _, _, _ = pair
    jvars, images = jax_calibrated
    key = jax.random.key(3)
    noise = [torch.from_numpy(np.asarray(jax.random.normal(
        jax.random.fold_in(key, i), (1, S, S, S, C), jnp.float32)))
        for i in range(len(images))]
    tm = load_jax_params(TModel(C, features=FEATURES, quantize=True),
                         params).eval()
    seg = TSeg(tm, C, sample_steps=2)
    got = {}
    for batches, nz in (([0], noise[:1]), ([1], noise[1:]),
                        ([0, 1], noise)):
        quantize_inference_params(
            seg, [torch.from_numpy(images[i]) for i in batches], noise=nz)
        got[tuple(batches)] = _scales(tm)
    both = got[(0, 1)]
    assert len(both) == 32
    for site, sa in both.items():
        assert sa == max(got[(0,)][site], got[(1,)][site]), site
        node = dict(jvars["quant"])
        for k in site[0].split("."):
            node = node[k]
        want = float(np.asarray(node[site[1] + "sa"]))
        rel = 1e-5 if site[0].startswith("embed_model") else 5e-2
        assert sa == pytest.approx(want, rel=rel), site


def test_offline_equals_in_graph_and_checkpoints_stay_clean(tmp_path):
    """Recorded kernels give the bits of in-graph quantization; no int8
    buffer reaches a state dict or a saved checkpoint, which a float model
    loads as it is."""
    m = create_model("diff_unet", out_channels=2, features=FEATURES,
                     quantize=True).eval()
    image, x = torch.from_numpy(_np(8, (1, S, S, S, 1))), \
        torch.from_numpy(_np(9, (1, S, S, S, 2)))
    t = torch.tensor([500])
    with torch.no_grad():
        before = m.denoise(image, x, t)
        quantize_inference_params(m)
        after = m.denoise(image, x, t)
    assert torch.equal(before, after)
    assert m.model.conv_0.conv_0.wq.dtype == torch.int8
    keys = set(m.state_dict())
    assert not any(k.rsplit(".", 1)[-1] in ("wq", "sw", "sa", "up_wq",
                                            "up_sw", "up_sa") for k in keys)
    ckpt.save_checkpoint(tmp_path / "q.pt", m)
    f = create_model("diff_unet", out_channels=2, features=FEATURES)
    ckpt.load_params(f, tmp_path / "q.pt")
    assert set(f.state_dict()) == keys


def test_engine_keys(workspace, tmp_path, monkeypatch):  # noqa: F811
    """quantize raises in training and for the other families, and builds
    DiffSwinUNETR with its 35 int8 convs; the Predictor records kernels at
    build and ``predict_volume`` calibrates on
    the first volume under ``quant_calibrate``; ``Tester(quantize=True,
    quant_calibrate=1)`` calibrates on its first case and runs; with
    static scales ``continuous=2`` gives the serial dices."""
    root, data, classes = workspace
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="inference-only"):
        Trainer(data_path=str(data), classes=str(classes), quantize=True,
                **COMMON)
    for name in ("smooth_diff_unet", "attention_diff_unet", "swin_unetr"):
        with pytest.raises(ValueError, match="only supported for diff_unet"):
            create_model(name, out_channels=2, quantize=True)
    swin = create_model("diff_swin_unetr", out_channels=2, image_size=32,
                        spatial_size=32, feature_size=12, quantize=True)
    assert len(list(quant_sites(swin))) == 28 + 7     # 3x3x3 and 1x1x1
    kw = dict(COMMON, classes=str(classes), model_path=str(root / "epoch_4"))
    pred = Predictor(quantize=True, quant_calibrate=2, **kw)
    conv = pred.module.model.conv_0.conv_0
    assert conv.wq is not None and conv.sa is None
    image = data / "img_0.nii.gz"
    labels = predict_volume(pred, image)
    assert pred._act_calibrated and conv.sa is not None
    assert labels.dtype == np.int16 and set(np.unique(labels)) <= {0, 1, 2}
    tester = Tester(data_path=str(data), classes=str(classes),
                    model_path=str(root / "epoch_4"), log_dir="q",
                    save_volumes=False, quantize=True, quant_calibrate=1,
                    **COMMON)
    assert tester._act_calibrated
    assert tester.module.model.upcat_1.up_sa is not None
    dices = np.asarray(tester.test()["dices"])
    assert dices.shape == (4, 2) and np.all((dices >= 0) & (dices <= 1))
    cont = Tester(data_path=str(data), classes=str(classes),
                  model_path=str(root / "epoch_4"), log_dir="qc",
                  save_volumes=False, quantize=True, quant_calibrate=1,
                  continuous=2, **COMMON)
    np.testing.assert_array_equal(np.asarray(cont.test()["dices"]), dices)
