"""PyTorch port, AttentionDiffUNet against the JAX package on the CPU, at
features (4, 8, 16, 32, 64) on 16^3 windows with batches of 2 to 4
different samples (a batch of one cannot tell batch statistics from
instance statistics):

- ``BatchStatsNorm`` against flax's (float64, 1e-6 of max |y|; float32 on
  maps whose mean is 10x their spread, 1e-5), and the batch-norm affine
  taken from float32 (sum, sum of squares) over the samples in that
  regime (1e-4);
- the nearest 2x upsample against ``jax.image.resize`` (exact);
- ``ConvBNReLU2``, ``UpConv`` and ``AttentionCatLayer`` against flax's in
  float64 (1e-4 of max |y|), and each fused block against the composition
  of its unfused modules, output and gradients (1e-9; 1e-6 where the
  instance-norm TwoConv rounds its prologue rows to float32);
- embed + denoise in float64 (1e-4 of max |y|), where changing one sample
  of the batch moves both packages' outputs for the others;
- one DDIM-10 window batch of 4 whose last window duplicates window 0, as
  the sliding window's masked tail batch does, against
  ``DiffusionSegmenter.ddim_sample`` (1e-4 of max);
- the ``Predictor``'s window batches against the JAX inferer's geometry,
  dummy windows included; the spatial-size rule; the factory at the AMOS
  widths (47,754,859 parameters, 40 3x3x3 convs); a ``Trainer`` step,
  ``.pt`` and JAX ``.npz`` round trips through ``Predictor`` and
  ``Tester``; ``pretrained_path`` raising as in JAX.

The train step against ``jax.value_and_grad`` is a case of
``tests/test_torch_port_train.py``; the conv Function's gradient with the
batch-norm prologue a case of ``tests/test_torch_port_conv_backward.py``.
"""
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax

from diff_unet_tpu.api import DiffusionSegmenter as JSeg
from diff_unet_tpu.engine import sliding_window as jsw
from diff_unet_tpu.models import attention_diff_unet as ja
from diff_unet_tpu.ops.blocks import BatchStatsNorm as JBatchStatsNorm
from diff_unet_tpu.utils import torch_import as jimport
from diff_unet_tpu_torch.api import DiffusionSegmenter as TSeg
from diff_unet_tpu_torch.data.synthetic import SyntheticSegmentation
from diff_unet_tpu_torch.engine import checkpoint as ckpt
from diff_unet_tpu_torch.engine.engine import Predictor, Trainer
from diff_unet_tpu_torch.engine.engine import Tester as PortTester
from diff_unet_tpu_torch.models import attention_diff_unet as ta
from diff_unet_tpu_torch.models.model_hub import create_model
from diff_unet_tpu_torch.ops.blocks import BatchStatsNorm, Conv, swish
from diff_unet_tpu_torch.ops.conv3d import batch_affine_from_stats
from diff_unet_tpu_torch.utils.weights import export_jax_params, \
    init_random, load_jax_params
from tests.test_pretrained_and_smoothing import _fake_encoder_state_dict
from tests.test_torch_port_data import CASES, write_nifti_set
from tests.test_torch_port_models import jax_f64
from tests.test_torch_port_swin import random_flax_params
from tests.test_torch_port_swin import torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
FEATURES = (4, 8, 16, 32, 64)
S, C = 16, 3
# fused against unfused, both float64: the same function, the variance
# one-pass from float64 sums against two-pass; AttentionCatLayer's TwoConv
# takes its FiLM add and norm affine as the conv's float32 prologue rows
FUSED_TOL = {"ConvBNReLU2": 1e-9, "UpConv": 1e-9, "AttentionCatLayer": 1e-6}


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("case", ["float64", "float32, mean 10x spread"])
def test_batch_stats_norm_matches_flax(case):
    """Statistics over the samples and the voxels. float64: flax casts to
    float32 inside (even under x64), so 1e-6 of max |y|. float32 on maps
    whose per-channel mean is 10x their spread (the regime of a one-pass
    variance): the port's two-pass norm within 1e-5 of max |y|; the fused
    path's affine from float32 (sum, sum of squares) per sample, added over
    the samples in float64, within 1e-4 (its one-pass variance loses
    ~2 digits to the 100x larger E[x^2])."""
    rng = np.random.default_rng(5)
    c = 6
    params = {"params": {"scale": 1 + 0.2 * rng.standard_normal(c),
                         "bias": 0.1 * rng.standard_normal(c)}}
    x = rng.standard_normal((3, 5, 6, 7, c))
    if case == "float64":
        want = jax_f64(JBatchStatsNorm().apply, params, x)
        tdt, tol = torch.float64, 1e-6
    else:
        x = (10.0 + x).astype(np.float32)
        params = jax.tree_util.tree_map(np.float32, params)
        want = np.asarray(jax.jit(JBatchStatsNorm().apply)(params, x))
        tdt, tol = torch.float32, 1e-5
    ref = np.abs(want).max()
    norm = load_jax_params(BatchStatsNorm(c), params).to(tdt)
    got = norm(_t(x)).detach().numpy()
    assert got.dtype == x.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * ref)
    xt = _t(x)
    stats = torch.stack([xt.sum((1, 2, 3)), (xt * xt).sum((1, 2, 3))], 1)
    a, b = batch_affine_from_stats(stats, norm.weight, norm.bias, 5 * 6 * 7)
    assert a.dtype == b.dtype == stats.dtype and a.shape == (c,)
    fused = (xt * a + b).detach().numpy()
    np.testing.assert_allclose(fused, want, rtol=0,
                               atol=(tol if case == "float64" else 1e-4)
                               * ref)


def test_upsample_matches_jax_resize_exactly():
    x = np.random.default_rng(0).standard_normal((2, 3, 4, 5, 2)).astype(
        np.float32)
    want = np.asarray(jax.image.resize(x, (2, 6, 8, 10, 2), "nearest"))
    got = ta.upsample_nearest2(_t(x)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, x.repeat(2, 1).repeat(2, 2)
                                  .repeat(2, 3))


def _unfused_cbr2(m, parts):
    x = torch.cat(parts, -1)
    for i in range(2):
        x = F.relu(getattr(m, f"norm_{i}")(getattr(m, f"conv_{i}")(x)))
    return x


def _unfused_up(m, x):
    return F.relu(m.norm(m.conv(ta.upsample_nearest2(x))))


def _unfused_cat(m, x, x_e, temb):
    """AttentionCatLayer from its modules: the unfused ConvBNReLU2 and
    UpConv, and the TwoConv as its ConvNormAct composition."""
    g = _unfused_up(m.up, x)
    psi = torch.sigmoid(m.psi_norm(m.psi(F.relu(
        m.w_g_norm(m.w_g(g)) + m.w_x_norm(m.w_x(x_e))))))
    y = _unfused_cbr2(m.out, [x_e * psi, g])
    tc = m.convs
    h = tc.conv_0(torch.cat([x_e, y], -1))
    h = h + tc.temb_proj(swish(temb))[:, None, None, None]
    return tc.conv_1(h)


def _block_case(name):
    """(flax module, its inputs, port module, unfused composition)."""
    rng = np.random.default_rng(len(name))
    n = 3
    if name == "ConvBNReLU2":
        parts = [rng.standard_normal((n, 4, 6, 8, c)) for c in (3, 2)]
        return (ja.ConvBNReLU2(5), [np.concatenate(parts, -1)],
                ta.ConvBNReLU2(5, 5), [[_t(p) for p in parts]],
                _unfused_cbr2)
    if name == "UpConv":
        x = rng.standard_normal((n, 2, 3, 4, 6))
        return ja.UpConv(4), [x], ta.UpConv(6, 4), [_t(x)], _unfused_up
    x = rng.standard_normal((n, 2, 2, 4, 8))
    x_e = rng.standard_normal((n, 4, 4, 8, 4))
    temb = rng.standard_normal((n, 512))
    return (ja.AttentionCatLayer(8, 4, 4), [x, x_e, temb],
            ta.AttentionCatLayer(8, 4, 4), [_t(x), _t(x_e), _t(temb)],
            _unfused_cat)


@pytest.mark.parametrize("name", ["ConvBNReLU2", "UpConv",
                                  "AttentionCatLayer"])
def test_blocks_match_flax_and_their_unfused_composition(name):
    """float64 on both sides, 3 different samples: the fused block (the
    conv's plain version with statistics and prologue, as on the card
    with the kernel) against flax within 1e-4 of max |y|, and against
    the composition of its own modules, output and every gradient, within
    FUSED_TOL of each one's max."""
    jmod, jargs, tmod, targs, unfused = _block_case(name)
    params = random_flax_params(jmod, *jargs, seed=3)
    want = jax_f64(jmod.apply, params, *jargs)
    tmod = load_jax_params(tmod, params).double()
    leaves = list(tmod.parameters())
    x0 = targs[0][0] if name == "ConvBNReLU2" else targs[0]
    x0.requires_grad_()
    got = tmod(*targs)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    ref = unfused(tmod, *targs)
    tol = FUSED_TOL[name]
    assert (got - ref).abs().max() <= tol * ref.abs().max()
    cot = torch.from_numpy(np.random.default_rng(9).standard_normal(
        tuple(got.shape)))
    g_got = torch.autograd.grad((got * cot).sum(), [x0, *leaves])
    g_ref = torch.autograd.grad((ref * cot).sum(), [x0, *leaves])
    scale = max(g.abs().max().item() for g in g_ref)
    for (k, _), a, b in zip([("input", 0), *tmod.named_parameters()],
                            g_got, g_ref):
        assert (a - b).abs().max().item() <= tol * scale, k


@pytest.fixture(scope="module")
def pair():
    """The JAX model and its parameter tree, the port's float64 model from
    the same tree, and 3 different samples."""
    rng = np.random.default_rng(0)
    image = rng.standard_normal((3, S, S, S, 1)).astype(np.float32)
    x = rng.standard_normal((3, S, S, S, C)).astype(np.float32)
    t = np.array([3, 640, 999], np.int32)
    jm = ja.AttentionDiffUNet(out_channels=C, features=FEATURES)
    params = random_flax_params(jm, image, x, t, seed=1)
    tm = load_jax_params(create_model(
        "attention_diff_unet", out_channels=C, features=FEATURES),
        params).double().eval()
    return jm, params, tm, image, x, t


def test_embed_and_denoise_match_jax_float64(pair):
    """Each encoder level and the logits within 1e-4 of their largest
    value; then sample 2 is replaced, and the logits of samples 0 and 1
    move in both packages (the batch statistics) by far more than that,
    while the two still agree. The JAX tree round-trips."""
    jm, params, tm, image, x, t = pair

    def both(p, a, b, c):
        return (jm.apply(p, a, method="embed"),
                jm.apply(p, a, b, c, method="denoise"))

    rng = np.random.default_rng(4)
    image2, x2 = image.copy(), x.copy()
    image2[2] = rng.standard_normal(image2[2].shape)
    x2[2] = rng.standard_normal(x2[2].shape)
    outs = []
    for im, xx in ((image, x), (image2, x2)):
        want_emb, want = jax_f64(both, params, im, xx, t)
        with torch.no_grad():
            emb = tm.embed(_t(im).double())
            got = tm.denoise(_t(im).double(), _t(xx).double(),
                             _t(t).long())
        assert [tuple(e.shape) for e in emb] == [
            (3, S >> i, S >> i, S >> i, FEATURES[i]) for i in range(5)]
        for g, w in zip([*emb, got], [*want_emb, want]):
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=1e-4 * np.abs(w).max())
        outs.append((got.numpy(), want))
    (got1, want1), (got2, want2) = outs
    scale = np.abs(want1).max()
    for a, b in ((got1, got2), (want1, want2)):
        assert np.abs(a[:2] - b[:2]).max() > 1e-2 * scale
    tree = export_jax_params(tm)
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(params)


def test_ddim_window_batch_with_a_dummy_window_matches_jax(pair):
    """A window batch of 4 whose last window is a copy of window 0 (image
    and noise), as the sliding window's masked tail batch holds: the port's
    ``ddim_sample`` (float64) against the JAX
    ``DiffusionSegmenter.ddim_sample`` with the same numpy noise, within
    1e-4 of max. The JAX loop keeps its state in float32 whatever the
    model's dtype, so the JAX side runs in float32; the copy's logits
    equal window 0's."""
    jm, params, tm, _, _, _ = pair
    rng = np.random.default_rng(6)
    image = rng.standard_normal((4, S, S, S, 1)).astype(np.float32)
    noise = rng.standard_normal((4, S, S, S, C)).astype(np.float32)
    image[3], noise[3] = image[0], noise[0]
    jseg = JSeg(jm, C)
    want = np.asarray(jax.jit(lambda p, im, nz: jseg.ddim_sample(
        p, im, jax.random.key(0), noise=nz))(params, image, noise))
    with torch.no_grad():
        got = TSeg(tm, C).ddim_sample(_t(image).double(),
                                      noise=_t(noise).double()).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    np.testing.assert_allclose(got[3], got[0], rtol=0,
                               atol=1e-12 * np.abs(got).max())


def _kw(**extra):
    return dict(model_name="attention_diff_unet", features=FEATURES,
                image_size=S, spatial_size=S, use_amp=False, device="cpu",
                classes=str(ROOT / "cfg/msd/classes.yaml"), **extra)


def test_predictor_hands_the_denoiser_jax_window_batches():
    """``infer`` on volumes whose windows end in a masked tail batch (6
    windows at sw 4: 4, then 2 and two dummy copies of the window at
    (0, 0, 0)) and in a chain (5 windows: 4, then 1): every batch the
    encoder sees is the volume's windows at the JAX inferer's starts for
    that batch, in order."""
    pred = Predictor.from_config(ROOT / "cfg/amos/test.yaml",
                                 model_path=None, sample_steps=2,
                                 sw_batch_size=4, **_kw())
    seen = []
    hook = pred.module.embed_model.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].clone()))
    rng = np.random.default_rng(2)
    batches = {}
    for shape in ((S, 28, 40), (S, S, 64)):
        vol = _t(rng.random((*shape, 1)).astype(np.float32))
        seen.clear()
        pred.infer(vol)
        groups = jsw.SlidingWindowInferer((S,) * 3, 4, 0.25)._geometry(shape)
        want = [b.tolist() for starts, _ in groups for b in starts]
        assert len(seen) == len(want)
        for batch, starts in zip(seen, want):
            assert len(batch) == len(starts)
            for window, (d, h, w) in zip(batch, starts):
                assert torch.equal(window, vol[d:d + S, h:h + S, w:w + S])
        batches[shape] = want
    hook.remove()
    assert batches[(S, 28, 40)][1] == [[0, 12, 12], [0, 12, 24], [0, 0, 0],
                                       [0, 0, 0]]
    assert [len(b) for b in batches[(S, S, 64)]] == [4, 1]


def test_spatial_sizes_must_halve_evenly():
    """16x16x24 with five levels: the JAX model fails at the gate's add
    (the upsampled map is a voxel short); the port raises ValueError
    naming the rule."""
    image = np.zeros((1, 16, 16, 24, 1), np.float32)
    x = np.zeros((1, 16, 16, 24, C), np.float32)
    t = np.zeros((1,), np.int32)
    jm = ja.AttentionDiffUNet(out_channels=C, features=FEATURES)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax.eval_shape(lambda: jm.init(jax.random.key(0), image, x, t))
    tm = create_model("attention_diff_unet", out_channels=C,
                      features=FEATURES)
    with pytest.raises(ValueError, match="multiples of 2\\^4 = 16"):
        tm.embed(_t(image))
    with pytest.raises(ValueError, match="multiples of 2\\^4 = 16"):
        tm.model(_t(x), _t(t).long())


def test_factory_at_the_amos_widths_and_seeded_init():
    """47,754,859 parameters at 15 classes, 40 3x3x3 convs (10 in the
    encoder, 30 in the denoiser); the seed fixes every tensor; norm scales
    1 and biases 0."""
    with torch.device("meta"):
        full = create_model("attention_diff_unet", out_channels=15)
    assert sum(p.numel() for p in full.parameters()) == 47_754_859
    convs = [n for n, m in full.named_modules()
             if isinstance(m, Conv) and m.weight.shape[2] == 3]
    assert len(convs) == 40
    assert sum(n.startswith("embed_model.") for n in convs) == 10
    m1, m2 = (init_random(create_model(
        "attention_diff_unet", out_channels=C, features=FEATURES), 7)
        for _ in range(2))
    for (k, a), (_, b) in zip(m1.state_dict().items(),
                              m2.state_dict().items()):
        assert torch.equal(a, b), k
    norm = m1.model.up_0.w_g_norm
    assert torch.equal(norm.weight, torch.ones(16))
    assert torch.equal(norm.bias, torch.zeros(16))


def test_trainer_predictor_tester_and_checkpoints(tmp_path, monkeypatch):
    """The AMOS train config's Trainer takes two steps of batch 2 that move
    every parameter and saves a ``.pt``; a Predictor from the AMOS test
    config loads it bit for bit and serves a volume; a Tester loads the
    same weights from a JAX ``.npz`` and scores a NIfTI case."""
    monkeypatch.chdir(tmp_path)
    data = SyntheticSegmentation((S, S, S), num_labels=3, batch_size=2,
                                 batches=2)
    trainer = Trainer.from_config(ROOT / "cfg/amos/train.yaml",
                                  train_data=data, batch_size=2,
                                  max_epochs=1, lr=1e-3, scheduler=None,
                                  **_kw())
    assert isinstance(trainer.module, ta.AttentionDiffUNet)
    before = {k: v.clone() for k, v in trainer.module.named_parameters()}
    trainer.train()
    assert len(trainer.history) == 2
    assert all(np.isfinite(h["loss"]) and h["grad_norm"] > 0
               for h in trainer.history)
    still = [k for k, v in trainer.module.named_parameters()
             if torch.equal(before[k], v)]
    assert not still
    pt = tmp_path / "w" / "epoch_1.pt"
    trainer.save_model(pt)

    pred = Predictor.from_config(ROOT / "cfg/amos/test.yaml",
                                 model_path=str(pt.with_suffix("")),
                                 sw_batch_size=2, sample_steps=2, **_kw())
    for (k, a), (_, b) in zip(trainer.module.state_dict().items(),
                              pred.module.state_dict().items()):
        assert torch.equal(a, b), k
    vol = _t(np.random.default_rng(3).random((S, S + 8, S, 1)).astype(
        np.float32))
    logits, binary = pred.infer(vol)
    assert logits.shape == binary.shape == (S, S + 8, S, 2)
    assert torch.isfinite(logits).all()
    assert set(torch.unique(binary).tolist()) <= {0.0, 1.0}

    ckpt.save_jax_npz(tmp_path / "w.npz", export_jax_params(trainer.module))
    data_dir = write_nifti_set(tmp_path / "data", cases=CASES[:1])
    tester = PortTester(model_path=str(tmp_path / "w.npz"),
                        data_path=str(data_dir), sample_steps=2,
                        num_workers=0, sw_batch_size=2, **_kw())
    for (k, a), (_, b) in zip(trainer.module.state_dict().items(),
                              tester.module.state_dict().items()):
        assert torch.equal(a, b), k
    dices = np.asarray(tester.test()["dices"])
    assert dices.shape == (1, 2) and np.isfinite(dices).all()


def test_pretrained_path_raises_like_jax(tmp_path, monkeypatch):
    """A MONAI ``encoder.pt`` has no mapping onto the attention encoder:
    the JAX import raises NotImplementedError, and so does the port's
    Trainer."""
    monkeypatch.chdir(tmp_path)
    path = tmp_path / "encoder.pt"
    torch.save(_fake_encoder_state_dict(), path)
    with pytest.raises(NotImplementedError, match="attention_diff_unet"):
        jimport.load_pretrained_encoder(path, {"params": {}},
                                        "attention_diff_unet")
    data = SyntheticSegmentation((S, S, S), num_labels=3, batch_size=1,
                                 batches=1)
    with pytest.raises(NotImplementedError, match="attention_diff_unet"):
        Trainer.from_config(ROOT / "cfg/amos/train.yaml", train_data=data,
                            batch_size=1, pretrained_path=str(path),
                            **_kw())
