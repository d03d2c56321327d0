"""PyTorch port, the plain Swin-UNETR baseline against the JAX package on
the CPU: the forward of ``SwinUNETR`` (feature 8, heads (1, 2, 2, 4),
32^3; the port in float32, whose norms keep float32 statistics) against
the flax module in float64, within 1e-6 of the largest output; the model
types and
``create_model``; and at 32^3 (feature 6, the recipe's heads) a
``Trainer`` built from
``cfg/btcv/train.yaml`` with ``model_name=swin_unetr`` (the plain branch:
one forward a step, no q_sample) and a ``Predictor`` from
``cfg/btcv/test.yaml`` (one forward per window batch, no DDIM loop)."""
from pathlib import Path

import numpy as np
import pytest
import torch

from diff_unet_tpu.models import model_hub as jhub
from diff_unet_tpu.models.swin_unetr import SwinUNETR as JSwinUNETR
from diff_unet_tpu_torch.api import DiffusionSegmenter, PlainSegmenter
from diff_unet_tpu_torch.data.synthetic import SyntheticSegmentation, \
    synthetic_ct
from diff_unet_tpu_torch.engine.engine import Predictor, Trainer
from diff_unet_tpu_torch.models import model_hub as thub
from diff_unet_tpu_torch.models.swin_unetr import SwinUNETR
from diff_unet_tpu_torch.utils.weights import load_jax_params
from tests.test_torch_port_models import jax_f64
from tests.test_torch_port_swin import random_flax_params
from tests.test_torch_port_swin import torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
S, FS, HEADS = 32, 8, (1, 2, 2, 4)


def test_swin_unetr_forward_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, S, S, S, 1)).astype(np.float32)
    jm = JSwinUNETR(out_channels=3, image_size=(S,) * 3, feature_size=FS,
                    num_heads=HEADS)
    params = random_flax_params(jm, x, seed=1)
    want = jax_f64(jm.apply, params, x)
    tm = load_jax_params(SwinUNETR(3, image_size=(S,) * 3, feature_size=FS,
                                   num_heads=HEADS), params).eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == (2, S, S, S, 3)
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("name", thub.MODEL_NAMES)
def test_model_types_match_jax(name):
    assert thub.get_model_type(name).value == jhub.get_model_type(name).value
    with pytest.raises(ValueError):
        thub.get_model_type("nope")
    if name == "swin_unetr":
        m = thub.create_model(name, out_channels=2, image_size=S,
                              spatial_size=S, feature_size=6)
        assert isinstance(m, SwinUNETR)
        with pytest.raises(ValueError, match="2\\^5"):
            thub.create_model(name, out_channels=2, image_size=40)


def test_swin_unetr_trains_and_serves_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    kw = dict(model_name="swin_unetr", device="cpu", feature_size=6,
              image_size=S, spatial_size=S, use_amp=False,
              classes=str(ROOT / "cfg/btcv/classes.yaml"))
    data = SyntheticSegmentation((S,) * 3, num_labels=14, batches=2)
    trainer = Trainer.from_config(ROOT / "cfg/btcv/train.yaml",
                                  train_data=data, max_epochs=1, **kw)
    assert isinstance(trainer.seg, PlainSegmenter)
    assert trainer.train_step.model_type == "segmentation"
    calls = []
    trainer.module.register_forward_hook(lambda *a: calls.append(1))
    before = {k: v.clone() for k, v in trainer.module.named_parameters()}
    trainer.train()
    assert len(calls) == 2                    # one forward a step
    assert [h["lr"] for h in trainer.history] == pytest.approx(
        [0.0, 2e-4 / 200], rel=1e-12, abs=0)
    assert all(np.isfinite(h["loss"]) and h["grad_norm"] > 0
               for h in trainer.history)
    assert any(not torch.equal(before[k], v)
               for k, v in trainer.module.named_parameters())
    trainer.save_model(tmp_path / "w" / "epoch_1.pt")

    pred = Predictor.from_config(ROOT / "cfg/btcv/test.yaml",
                                 model_path=str(tmp_path / "w" / "epoch_1"),
                                 sw_batch_size=2, **kw)
    assert isinstance(pred.seg, PlainSegmenter) and pred.epoch == 1
    calls.clear()
    pred.module.register_forward_hook(lambda *a: calls.append(1))
    shape = (40, 36, 32)
    logits, binary = pred.infer(synthetic_ct(shape, 0, torch.device("cpu")))
    assert logits.shape == binary.shape == (*shape, 13)
    assert torch.isfinite(logits).all()
    assert set(binary.unique().tolist()) <= {0.0, 1.0}
    assert torch.equal(binary, (torch.sigmoid(logits) > 0.5).float())
    groups = pred._inferer._geometry(tuple(max(r, s) for r, s in
                                           zip(pred._inferer.roi, shape)))
    assert len(calls) == sum(len(starts) for starts, _ in groups)
    diff = Predictor.from_config(ROOT / "cfg/btcv/test.yaml",
                                 model_path=None,
                                 **{**kw, "model_name": "diff_swin_unetr"})
    assert isinstance(diff.seg, DiffusionSegmenter)
