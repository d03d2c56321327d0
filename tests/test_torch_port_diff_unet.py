"""PyTorch port, DiffUNet end to end against the JAX package (features
(8, 8, 16, 32, 64, 8), 3 classes, at 32^3 and at 32x32x22, where the
UpCat stages replicate-pad): encoder, ``denoise`` and the DDIM-10
``ddim_sample`` with injected noise; the model factory, and the
Predictor on the CPU (features (4, 4, 8, 16, 32, 4), 16^3 ROI).

The port runs in fp32 and is held at 1e-4 (1e-3 for the DDIM-10 sum); the
JAX side runs in float64 on the same (float32-valued) inputs and
parameters, as ``tests/test_torch_port_models.py`` does for DiffSwinUNETR
(JAX's fp32 one-pass instance-norm statistics would hide the
comparison)."""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from diff_unet_tpu.api import DiffusionSegmenter as JSeg
from diff_unet_tpu.diffusion import sampling as js
from diff_unet_tpu.models.basic_unet import BasicUNetEncoder as JEncoder
from diff_unet_tpu.models.diff_unet import DiffUNet as JModel
from diff_unet_tpu_torch.api import DiffusionSegmenter as TSeg
from diff_unet_tpu_torch.engine.engine import Predictor
from diff_unet_tpu_torch.engine import sliding_window as tsw
from diff_unet_tpu_torch.models.diff_unet import DiffUNet as TModel
from diff_unet_tpu_torch.models.model_hub import create_model
from diff_unet_tpu_torch.utils.weights import init_random, load_jax_params
from tests.test_torch_port_models import jax_f64
from tests.test_torch_port_swin import random_flax_params
from tests.test_torch_port_swin import torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
FEATURES = (8, 8, 16, 32, 64, 8)
C = 3
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", params=[(32, 32, 32), (32, 32, 22)],
                ids=["32^3", "32x32x22"])
def pair(request):
    shape = request.param
    rng = np.random.default_rng(0)
    image = rng.standard_normal((2, *shape, 1)).astype(np.float32)
    x = rng.standard_normal((2, *shape, C)).astype(np.float32)
    t = np.array([3, 640], np.int32)
    jm = JModel(out_channels=C, features=FEATURES)
    params = random_flax_params(jm, image, x, t, seed=1)
    tm = load_jax_params(TModel(C, features=FEATURES), params).eval()
    return jm, params, tm, image, x, t


def test_encoder_matches(pair):
    _, params, tm, image, _, _ = pair
    want = jax_f64(JEncoder(features=FEATURES).apply,
                   {"params": params["params"]["embed_model"]}, image)
    with torch.no_grad():
        got = tm.embed(torch.from_numpy(image))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_denoise_matches(pair):
    """Full DiffUNet.denoise: encoder + time-conditioned denoiser."""
    jm, params, tm, image, x, t = pair
    want = jax_f64(lambda p, a, b, c: jm.apply(p, a, b, c, method="denoise"),
                   params, image, x, t)
    with torch.no_grad():
        got = tm.denoise(torch.from_numpy(image), torch.from_numpy(x),
                         torch.from_numpy(t).long())
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ddim_sample_matches_with_noise(pair):
    """DDIM-10 pred_xstart sum from the same x_T, at 1e-3, against the JAX
    package's unpacked path (embed once, then ``ddim_sample_loop`` over
    ``denoise_with_embeddings``) with a float64 loop state."""
    jm, params, tm, image, x, _ = pair
    noise = np.random.default_rng(2).standard_normal(x.shape).astype(
        np.float32)
    jseg = JSeg(jm, C)

    def jax_ddim(p, im, nz):
        emb = jm.apply(p, im, method="embed")

        def denoise_fn(xt, t):
            return jm.apply(p, xt, t, emb, im,
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


def test_create_model_diff_unet_features_and_seeded_init():
    m1 = init_random(create_model("diff_unet", out_channels=2,
                                  features=FEATURES), 7)
    m2 = init_random(create_model("diff_unet", out_channels=2,
                                  features=list(FEATURES)), 7)
    for (k, a), (_, b) in zip(m1.state_dict().items(),
                              m2.state_dict().items()):
        assert torch.equal(a, b), k
    assert isinstance(m1, TModel)
    assert m1.model.upcat_4.convs.conv_0.conv.weight.shape == \
        (FEATURES[3], FEATURES[3] + FEATURES[4] // 2, 3, 3, 3)
    full = create_model("diff_unet", out_channels=15)
    assert full.model.conv_0.conv_0.conv.weight.shape == (64, 16, 3, 3, 3)
    assert full.embed_model.down_4.convs.conv_1.conv.weight.shape == \
        (512, 512, 3, 3, 3)


def _predictor(sw_batch_size):
    return Predictor(model_name="diff_unet", features=(4, 4, 8, 16, 32, 4),
                     image_size=16, spatial_size=16, sample_steps=2,
                     classes=str(ROOT / "cfg/amos/classes.yaml"),
                     sw_batch_size=sw_batch_size, use_amp=False, seed=5,
                     device="cpu")


def test_predictor_invariant_to_window_batching_and_crops_back():
    """sw_batch_size 1 and 4 give the same stitched logits (noise is keyed
    on window starts); a non-grid volume (one axis below the ROI) comes
    back at its own shape and equals the un-bucketed sliding window."""
    vol = torch.from_numpy(np.random.default_rng(1).random(
        (20, 18, 10, 1)).astype(np.float32))
    p1, p4 = _predictor(1), _predictor(4)
    assert p4.num_classes == 15
    l1, b1 = p1.infer(vol)
    l4, b4 = p4.serve([vol])[0]
    assert l1.shape == b1.shape == (20, 18, 10, 15)
    assert torch.isfinite(l1).all()
    assert set(torch.unique(b4).tolist()) <= {0.0, 1.0}
    # 1e-4: the CPU's conv kernels round differently at batch 1 and 4
    np.testing.assert_allclose(l1.numpy(), l4.numpy(), rtol=1e-4, atol=1e-4)
    with torch.inference_mode():
        direct = p4._inferer(
            tsw.make_ddim_window_predictor(p4.seg, p4.seed), vol,
            out_channels=15)
    np.testing.assert_allclose(l4.numpy(), direct.numpy(), rtol=1e-6,
                               atol=1e-6)
