"""PyTorch port, SmoothDiffUNet against the JAX package on the CPU:
``SmoothLayer`` (the JAX golden values, and the flax module on a
non-cubic shape in float64 and bfloat16), ``FFParser`` (1e-6), the
denoiser's layer norm against flax's ``nn.LayerNorm`` (epsilon 1e-6 on
small-variance maps in float64; the one-pass variance on large-mean maps
in float32, flax run op by op), embed + denoise at features (4, 4, 8, 16,
32, 4) on 16x32x32 windows (``spatial_size`` 16 != ``image_size`` 32)
with both sides in float64, within 1e-4 of the largest output; the
factory, a ``Trainer`` step, a ``Predictor`` window batch, a ``.pt`` and
a JAX ``.npz`` round trip, and the ``pretrained_path`` graft, which keeps
the smoothing weights. The train step against ``jax.value_and_grad`` is a
case of ``tests/test_torch_port_train.py``."""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen as fnn

from diff_unet_tpu.models import smooth_diff_unet as jsm
from diff_unet_tpu.utils import torch_import as jimport
from diff_unet_tpu_torch.data.synthetic import SyntheticSegmentation
from diff_unet_tpu_torch.engine import checkpoint as ckpt
from diff_unet_tpu_torch.engine.engine import Predictor, Trainer
from diff_unet_tpu_torch.engine.engine import Tester as PortTester
from diff_unet_tpu_torch.models import smooth_diff_unet as tsm
from diff_unet_tpu_torch.models.model_hub import create_model
from diff_unet_tpu_torch.ops.blocks import ChannelLayerNorm, LayerNorm
from diff_unet_tpu_torch.utils import pretrained as tpre
from diff_unet_tpu_torch.utils.weights import export_jax_params, \
    init_random, load_jax_params
from tests.test_pretrained_and_smoothing import _fake_encoder_state_dict
from tests.test_torch_port_data import CASES, write_nifti_set
from tests.test_torch_port_models import jax_f64
from tests.test_torch_port_swin import random_flax_params
from tests.test_torch_port_swin import torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
FEATURES = (4, 4, 8, 16, 32, 4)
D, HW, C = 16, 32, 3          # spatial_size, image_size, classes


def test_smooth_layer_laplacian_golden():
    """The JAX package's golden values (tests/test_models_families.py):
    a unit impulse with unit weights."""
    layer = tsm.SmoothLayer((3, 3, 3), 1)
    with torch.no_grad():
        layer.weights.fill_(1.0)
    x = torch.zeros(1, 3, 3, 3, 1)
    x[0, 1, 1, 1, 0] = 1.0
    out = layer(x)
    assert out[0, 1, 1, 1, 0].item() == pytest.approx(-5.0)
    assert out[0, 0, 1, 1, 0].item() == pytest.approx(1.0)
    assert out[0, 0, 0, 0, 0].item() == pytest.approx(0.0)


@pytest.mark.parametrize("dtype", ["float64", "bfloat16"])
def test_smooth_layer_matches_jax_non_cubic(dtype):
    """(D, H, W) = (4, 6, 5): a transposed weight or a rolled boundary
    would show. bfloat16: the Laplacian in x's dtype with the weights
    rounded to it, as in JAX (both round after each op: 0 tolerance)."""
    rng = np.random.default_rng(0)
    shape, c = (4, 6, 5), 3
    x = rng.standard_normal((2, *shape, c))
    params = {"params": {"weights": (0.5 * rng.standard_normal(
        (*shape, c))).astype(np.float32)}}
    layer = jsm.SmoothLayer(shape)
    got = load_jax_params(tsm.SmoothLayer(shape, c), params)
    if dtype == "float64":
        want = jax_f64(layer.apply, params, x)
        out = got.double()(torch.from_numpy(x)).detach().numpy()
        np.testing.assert_allclose(out, want, rtol=1e-12, atol=1e-12)
        return
    want = np.asarray(layer.apply(params, jnp.asarray(
        x, jnp.bfloat16)).astype(jnp.float32))
    out = got(torch.from_numpy(x).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().detach().numpy(), want)


def test_ffparser_matches_jax():
    rng = np.random.default_rng(1)
    shape, c = (3, 8, 6), 2
    x = rng.standard_normal((2, *shape, c)).astype(np.float32)
    mod = jsm.FFParser(shape)
    params = jax.tree_util.tree_map(
        lambda s: (0.3 * rng.standard_normal(s.shape)).astype(np.float32),
        jax.eval_shape(lambda: mod.init(jax.random.key(0), x)))
    want = np.asarray(jax.jit(mod.apply)(params, x))
    got = load_jax_params(tsm.FFParser(shape, c), params)
    out = got(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(out, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
    fresh = init_random(tsm.FFParser(shape, c), 0)
    assert abs(fresh.weight_real.std().item() - 0.02) < 0.005


@pytest.mark.parametrize("case", ["epsilon 1e-6, float64",
                                  "one-pass variance, float32"])
def test_channel_layer_norm_is_flax_default(case):
    """flax ``nn.LayerNorm()``: epsilon 1e-6 (maps of variance ~1e-6) and
    the one-pass variance E[x^2] - E[x]^2 (maps of mean 100 and spread
    1e-2, where it differs from the two-pass variance by ~90% of the
    output; flax op by op, whose roundings the port repeats). The Swin
    ``LayerNorm`` (epsilon 1e-5, two-pass) fails both."""
    rng = np.random.default_rng(2)
    c = 8
    params = {"params": {"scale": 1 + 0.2 * rng.standard_normal(c),
                         "bias": 0.1 * rng.standard_normal(c)}}
    if case.startswith("epsilon"):
        x = 1e-3 * rng.standard_normal((2, 3, 4, 5, c))
        want = jax_f64(fnn.LayerNorm().apply, params, x)
        tdt = torch.float64
    else:
        x = (100.0 + 1e-2 * rng.standard_normal((2, 3, 4, 5, c))
             ).astype(np.float32)
        params = jax.tree_util.tree_map(np.float32, params)
        with jax.disable_jit():
            want = np.asarray(fnn.LayerNorm().apply(params, x))
        tdt = torch.float32
    tol = 1e-6 * np.abs(want).max()
    got = load_jax_params(ChannelLayerNorm(c), params).to(tdt)
    np.testing.assert_allclose(got(torch.from_numpy(x)).detach().numpy(),
                               want, rtol=0, atol=tol)
    swin = load_jax_params(LayerNorm(c), params)
    other = swin(torch.from_numpy(x).float()).detach().numpy()
    assert np.abs(other - want).max() > 100 * tol


@pytest.fixture(scope="module")
def pair():
    """The JAX model and its float64 parameter tree, the port's float64
    model from the same tree, and the inputs."""
    rng = np.random.default_rng(0)
    image = rng.standard_normal((2, D, HW, HW, 1)).astype(np.float32)
    x = rng.standard_normal((2, D, HW, HW, C)).astype(np.float32)
    t = np.array([3, 640], np.int32)
    jm = jsm.SmoothDiffUNet(out_channels=C, image_size=HW, spatial_size=D,
                            features=FEATURES)
    params = random_flax_params(jm, image, x, t, seed=1)
    tm = load_jax_params(create_model(
        "smooth_diff_unet", out_channels=C, image_size=HW, spatial_size=D,
        features=FEATURES), params).double().eval()
    return jm, params, tm, image, x, t


def test_embed_and_denoise_match_jax_float64(pair):
    """Each encoder level (unsmoothed, as JAX returns them) and the
    denoiser's logits within 1e-4 of their largest value."""
    jm, params, tm, image, x, t = pair

    def both(p, a, b, c):
        return (jm.apply(p, a, method="embed"),
                jm.apply(p, a, b, c, method="denoise"))

    want_emb, want = jax_f64(both, params, image, x, t)
    with torch.no_grad():
        im = torch.from_numpy(image).double()
        emb = tm.embed(im)
        got = tm.denoise(im, torch.from_numpy(x).double(),
                         torch.from_numpy(t).long())
    assert [tuple(e.shape) for e in emb] == [
        (2, D >> i, HW >> i, HW >> i, FEATURES[i]) for i in range(5)]
    for g, w in zip(emb, want_emb):
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    # the JAX tree round-trips, smoothing weights as they are (D, H, W, C)
    tree = export_jax_params(tm)["params"]
    for i in range(4):
        np.testing.assert_array_equal(
            tree["embed_model"][f"smooth_{i}"]["weights"],
            params["params"]["embed_model"][f"smooth_{i}"]["weights"])
        assert tree["embed_model"][f"smooth_{i}"]["weights"].shape == (
            D >> i, HW >> i, HW >> i, FEATURES[i])


def test_factory_and_seeded_init():
    """0.5 * N(0, 1) smoothing weights from the seed; the AMOS widths'
    smoothing weights (96^3 * 64 + 48^3 * 64 + 24^3 * 128 + 12^3 * 256);
    the factory builds attention_diff_unet too."""
    m1, m2 = (init_random(create_model(
        "smooth_diff_unet", out_channels=C, image_size=HW, spatial_size=D,
        features=FEATURES), 7) for _ in range(2))
    for (k, a), (_, b) in zip(m1.state_dict().items(),
                              m2.state_dict().items()):
        assert torch.equal(a, b), k
    w = m1.embed_model.smooth_0.weights
    assert abs(w.std().item() - 0.5) < 0.02 and abs(w.mean().item()) < 0.02
    assert m1.model.conv_0.conv_0.norm.__class__ is ChannelLayerNorm
    assert m1.embed_model.conv_0.conv_0.norm.__class__ is not \
        ChannelLayerNorm
    with torch.device("meta"):
        full = create_model("smooth_diff_unet", out_channels=15)
    smooth = sum(p.numel() for n, p in full.named_parameters()
                 if ".smooth_" in n)
    assert smooth == 96 ** 3 * 64 + 48 ** 3 * 64 + 24 ** 3 * 128 + \
        12 ** 3 * 256
    assert type(create_model("attention_diff_unet", out_channels=2,
                             features=(4, 8, 16, 32, 64))
                ).__name__ == "AttentionDiffUNet"


def _kw(**extra):
    return dict(model_name="smooth_diff_unet", features=FEATURES,
                image_size=HW, spatial_size=D, use_amp=False, device="cpu",
                classes=str(ROOT / "cfg/msd/classes.yaml"), **extra)


def test_trainer_predictor_and_checkpoints(tmp_path, monkeypatch):
    """The AMOS train config's Trainer takes a step that moves every
    parameter (the smoothing weights included) and saves a ``.pt``; a
    Predictor from the AMOS test config loads it bit for bit and serves
    a non-grid volume; a Tester loads the same weights from a JAX ``.npz``
    and scores a NIfTI case."""
    monkeypatch.chdir(tmp_path)
    data = SyntheticSegmentation((D, HW, HW), num_labels=3, batch_size=2,
                                 batches=2)
    trainer = Trainer.from_config(ROOT / "cfg/amos/train.yaml",
                                  train_data=data, batch_size=2,
                                  max_epochs=1, lr=1e-3,
                                  scheduler=None, **_kw())
    assert isinstance(trainer.module, tsm.SmoothDiffUNet)
    before = {k: v.clone() for k, v in trainer.module.named_parameters()}
    trainer.train()
    assert len(trainer.history) == 2
    assert all(np.isfinite(h["loss"]) and h["grad_norm"] > 0
               for h in trainer.history)
    moved = [k for k, v in trainer.module.named_parameters()
             if not torch.equal(before[k], v)]
    assert len(moved) == len(before)
    pt = tmp_path / "w" / "epoch_1.pt"
    trainer.save_model(pt)

    pred = Predictor.from_config(ROOT / "cfg/amos/test.yaml",
                                 model_path=str(pt.with_suffix("")),
                                 sw_batch_size=2, sample_steps=2,
                                 **_kw())
    for (k, a), (_, b) in zip(trainer.module.state_dict().items(),
                              pred.module.state_dict().items()):
        assert torch.equal(a, b), k
    vol = torch.from_numpy(np.random.default_rng(3).random(
        (D, HW + 8, HW, 1)).astype(np.float32))
    logits, binary = pred.infer(vol)
    assert logits.shape == binary.shape == (D, HW + 8, HW, 2)
    assert torch.isfinite(logits).all()
    assert set(torch.unique(binary).tolist()) <= {0.0, 1.0}

    ckpt.save_jax_npz(tmp_path / "w.npz", export_jax_params(trainer.module))
    data_dir = write_nifti_set(tmp_path / "data", cases=CASES[:1])
    tester = PortTester(model_path=str(tmp_path / "w.npz"),
                    data_path=str(data_dir), sample_steps=2, num_workers=0,
                    sw_batch_size=2, **_kw())
    for (k, a), (_, b) in zip(trainer.module.state_dict().items(),
                              tester.module.state_dict().items()):
        assert torch.equal(a, b), k
    dices = np.asarray(tester.test()["dices"])
    assert dices.shape == (1, 2) and np.isfinite(dices).all()


def test_pretrained_graft_keeps_smoothing(tmp_path, monkeypatch):
    """``encoder.pt`` fills the BasicUNet part of the smoothing encoder as
    the JAX package's graft does (0 tolerance) and leaves ``smooth_i`` and
    the denoiser as they were; the Trainer's ``pretrained_path`` does the
    same to its seeded weights."""
    monkeypatch.chdir(tmp_path)
    sd = _fake_encoder_state_dict(FEATURES)
    path = tmp_path / "encoder.pt"
    torch.save(sd, path)
    jm = jsm.SmoothDiffUNet(out_channels=C, image_size=HW, spatial_size=D,
                            features=FEATURES)
    params = random_flax_params(
        jm, np.zeros((1, D, HW, HW, 1), np.float32),
        np.zeros((1, D, HW, HW, C), np.float32), np.zeros((1,), np.int32),
        seed=2)

    def port(tree):
        return load_jax_params(create_model(
            "smooth_diff_unet", out_channels=C, image_size=HW,
            spatial_size=D, features=FEATURES), tree)

    want = port(jimport.load_pretrained_encoder(path, params,
                                                "smooth_diff_unet"))
    before = port(params)
    got = tpre.load_pretrained_encoder(path, port(params),
                                       "smooth_diff_unet")
    for (k, a), (_, b) in zip(got.state_dict().items(),
                              want.state_dict().items()):
        assert torch.equal(a, b), k
    assert torch.equal(got.embed_model.conv_0.conv_0.conv.weight,
                       sd["conv_0.conv_0.conv.weight"])
    for i in range(4):
        name = f"embed_model.smooth_{i}.weights"
        assert torch.equal(got.get_parameter(name),
                           before.get_parameter(name))
    # the Trainer's pretrained_path: the same graft over its seeded weights
    data = SyntheticSegmentation((D, HW, HW), num_labels=3, batch_size=1,
                                 batches=1)
    trainer = Trainer.from_config(
        ROOT / "cfg/amos/train.yaml", train_data=data, batch_size=1,
        pretrained_path=str(path), log_dir=str(tmp_path / "logs"), **_kw())
    seeded = init_random(create_model(
        "smooth_diff_unet", out_channels=2, image_size=HW, spatial_size=D,
        features=FEATURES), trainer.seed)
    want = tpre.load_pretrained_encoder(path, seeded, "smooth_diff_unet")
    for (k, a), (_, b) in zip(trainer.module.state_dict().items(),
                              want.state_dict().items()):
        assert torch.equal(a, b), k
