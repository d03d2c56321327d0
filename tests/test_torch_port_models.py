"""PyTorch port, DiffSwinUNETR end to end against the JAX package (feature
12, 32^3, 3 classes): encoder, ``denoise``, and the DDIM-10 ``ddim_sample``
with injected noise; plus the weight bridge's failure modes and the model
factory.

The port runs in fp32 and is held at 1e-4 (1e-3 for the DDIM-10 sum). The
JAX side runs in float64 on the same (float32-valued) inputs and
parameters: its fp32 one-pass InstanceNorm statistics over 32^3 maps are
themselves ~1e-3 off a float64 evaluation on the CPU (the port's ~2e-5),
which would hide the comparison."""
import numpy as np
import pytest
import torch

import jax

from diff_unet_tpu.api import DiffusionSegmenter as JSeg
from diff_unet_tpu.diffusion import sampling as js
from diff_unet_tpu.models.swin_unetr import DiffSwinUNETR as JModel
from diff_unet_tpu.models.swin_unetr import SwinUNETREncoder as JEncoder
from diff_unet_tpu_torch.api import DiffusionSegmenter as TSeg
from diff_unet_tpu_torch.models.model_hub import create_model
from diff_unet_tpu_torch.models.swin_unetr import DiffSwinUNETR as TModel
from diff_unet_tpu_torch.utils.weights import init_random, load_jax_params
from tests.test_torch_port_swin import random_flax_params

S, C, FS = 32, 3, 12
TOL = dict(rtol=1e-4, atol=1e-4)


def jax_f64(fn, *args):
    """Run ``fn`` under jit in float64 with float arrays (and parameter
    trees) promoted; returns numpy."""
    def up(a):
        a = np.asarray(a)
        return a.astype(np.float64) if a.dtype == np.float32 else a

    with jax.enable_x64(True):
        args = jax.tree_util.tree_map(up, args)
        out = jax.jit(fn)(*args)
        return jax.tree_util.tree_map(np.asarray, out)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    image = rng.standard_normal((2, S, S, S, 1)).astype(np.float32)
    x = rng.standard_normal((2, S, S, S, C)).astype(np.float32)
    t = np.array([3, 640], np.int32)
    jm = JModel(out_channels=C, image_size=(S,) * 3, feature_size=FS)
    params = random_flax_params(jm, image, x, t, seed=1)
    tm = load_jax_params(TModel(C, image_size=(S,) * 3, feature_size=FS),
                         params).eval()
    return jm, params, tm, image, x, t


def test_encoder_matches(pair):
    jm, params, tm, image, _, _ = pair
    enc = JEncoder(feature_size=FS)
    want = jax_f64(enc.apply, {"params": params["params"]["embed_model"]},
                   image)
    with torch.no_grad():
        got = tm.embed(torch.from_numpy(image))
    for g, w in zip(got[0], want[0]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_denoise_matches(pair):
    """Full DiffSwinUNETR.denoise: encoder + time-conditioned denoiser."""
    jm, params, tm, image, x, t = pair
    want = jax_f64(lambda p, a, b, c: jm.apply(p, a, b, c, method="denoise"),
                   params, image, x, t)
    with torch.no_grad():
        got = tm.denoise(torch.from_numpy(image), torch.from_numpy(x),
                         torch.from_numpy(t).long())
    assert got.shape == (2, S, S, S, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ddim_sample_matches_with_noise(pair):
    """DDIM-10 pred_xstart sum from the same x_T, at 1e-3. The JAX side is
    ``DiffusionSegmenter.ddim_sample``'s unpacked path (embed once, then
    ``ddim_sample_loop`` over ``denoise_with_embeddings``) with a float64
    loop state; its W-folding of the loop state is a layout change only."""
    jm, params, tm, image, _, _ = pair
    noise = np.random.default_rng(2).standard_normal(
        (2, S, S, S, C)).astype(np.float32)
    jseg = JSeg(jm, C)

    def jax_ddim(p, im, nz):
        emb = jm.apply(p, im, method="embed")

        def denoise_fn(x, t):
            return jm.apply(p, x, t, emb, im,
                            method="denoise_with_embeddings")

        return js.ddim_sample_loop(
            denoise_fn, jseg.sample_schedule, nz.shape, jax.random.key(0),
            noise=nz, dtype=nz.dtype).pred_xstart_sum

    want = jax_f64(jax_ddim, params, image, noise)
    with torch.no_grad():
        got = TSeg(tm, C).ddim_sample(torch.from_numpy(image),
                                      noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-3, atol=1e-3)


def test_load_jax_params_fails_loudly(pair):
    _, params, _, _, _, _ = pair
    tree = jax.tree_util.tree_map(np.asarray, params["params"])
    fresh = TModel(C, image_size=(S,) * 3, feature_size=FS)
    extra = dict(tree, stray={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match="stray"):
        load_jax_params(fresh, extra)
    missing = {k: v for k, v in tree.items() if k != "model"}
    with pytest.raises(KeyError, match="missing"):
        load_jax_params(fresh, missing)
    wrong = TModel(C + 1, image_size=(S,) * 3, feature_size=FS)
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(wrong, tree)


def test_create_model_and_seeded_init():
    m1 = init_random(create_model("diff_swin_unetr", out_channels=2,
                                  image_size=32, spatial_size=32,
                                  feature_size=12), 7)
    m2 = init_random(create_model("diff_swin_unetr", out_channels=2,
                                  image_size=32, spatial_size=32,
                                  feature_size=12), 7)
    for (k, a), (_, b) in zip(m1.state_dict().items(),
                              m2.state_dict().items()):
        assert torch.equal(a, b), k
    assert isinstance(m1, TModel)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        create_model("smooth_diff_unet", out_channels=2)
    with pytest.raises(ValueError):
        create_model("nope", out_channels=2)
    with pytest.raises(ValueError, match="2\\^5"):
        create_model("diff_swin_unetr", out_channels=2, image_size=40)


def test_create_model_attention_unet_raises_like_jax():
    """``attention_unet`` is a listed name with no model in the reference:
    both factories raise ValueError for it."""
    from diff_unet_tpu.models.model_hub import create_model as jcreate

    with pytest.raises(ValueError, match="Invalid model type") as want:
        jcreate("attention_unet", out_channels=2)
    with pytest.raises(ValueError, match="Invalid model type") as got:
        create_model("attention_unet", out_channels=2)
    assert got.type is want.type
