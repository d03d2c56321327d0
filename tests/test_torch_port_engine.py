"""PyTorch port, serving path: sliding-window geometry and stitching against
the JAX package, the Predictor's window-batching invariance and crop-back,
the flat config reader, and that the package never imports jax."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diff_unet_tpu.engine import sliding_window as jsw
from diff_unet_tpu.utils.config import load_config
from diff_unet_tpu_torch.engine import sliding_window as tsw
from diff_unet_tpu_torch.engine.engine import Predictor
from diff_unet_tpu_torch.utils.config import load_flat_yaml

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("vol,roi,sw,overlap", [
    ((96, 192, 192), (96, 96, 96), 2, 0.25),
    ((80, 160, 176), (96, 96, 96), 2, 0.25),
    ((40, 40, 40), (16, 16, 16), 3, 0.25),
    ((50, 33, 17), (16, 16, 16), 8, 0.5),
])
def test_window_geometry_matches(vol, roi, sw, overlap):
    for s, r in zip(vol, roi):
        assert tsw.window_starts(s, r, overlap) == \
            jsw.window_starts(s, r, overlap)
    assert tsw.bucket_shape(vol, roi, overlap) == \
        jsw.bucket_shape(vol, roi, overlap)
    padded = tuple(max(r, s) for r, s in zip(roi, vol))
    want = jsw.SlidingWindowInferer(roi, sw, overlap)._geometry(padded)
    got = tsw.SlidingWindowInferer(roi, sw, overlap)._geometry(padded)
    assert len(got) == len(want)
    for (gs, gv), (ws, wv) in zip(got, want):
        np.testing.assert_array_equal(gs, ws)
        np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(tsw.gaussian_importance(roi),
                                  jsw.gaussian_importance(roi))


@pytest.mark.parametrize("mode,vol", [("constant", (40, 36, 20)),
                                      ("gaussian", (24, 30, 24))])
def test_stitching_matches_jax(mode, vol):
    """A predictor whose output depends on the whole window (centred by the
    window mean), so overlapping windows disagree and the stitching
    weights matter; the 20-voxel axis is padded up to the ROI."""
    x = np.random.default_rng(0).random((*vol, 2)).astype(np.float32)
    kw = dict(roi=(16, 16, 16), sw_batch_size=3, overlap=0.25, mode=mode)

    def jpred(w, keys):
        return w * 2.0 - jnp.mean(w, axis=(1, 2, 3, 4), keepdims=True)

    def tpred(w, starts):
        return w * 2.0 - w.mean(dim=(1, 2, 3, 4), keepdim=True)

    want = jax.jit(lambda v: jsw.SlidingWindowInferer(**kw)(
        jpred, v, out_channels=2))(x)
    got = tsw.SlidingWindowInferer(**kw)(tpred, torch.from_numpy(x),
                                         out_channels=2)
    assert got.shape == vol + (2,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_window_seed_depends_only_on_seed_and_start():
    a = tsw.window_seed(123, (0, 24, 8))
    assert a == tsw.window_seed(123, np.array([0, 24, 8], np.int32))
    seeds = {tsw.window_seed(s, st) for s in (0, 1)
             for st in [(0, 0, 0), (0, 0, 8), (0, 8, 0), (8, 0, 0)]}
    assert len(seeds) == 8
    assert all(0 <= v < 2 ** 63 for v in seeds)


def _predictor(sw_batch_size):
    return Predictor(model_name="diff_swin_unetr", feature_size=12,
                     image_size=32, spatial_size=32, sample_steps=2,
                     classes=str(ROOT / "cfg/btcv/classes.yaml"),
                     sw_batch_size=sw_batch_size, use_amp=False, seed=5,
                     device="cpu")


def test_predictor_invariant_to_window_batching_and_crops_back():
    """sw_batch_size 1 and 2 give the same stitched logits (noise is keyed
    on window starts); a non-grid volume (one axis below the ROI) comes
    back at its own shape and equals the un-bucketed sliding window."""
    vol = torch.from_numpy(np.random.default_rng(1).random(
        (40, 36, 20, 1)).astype(np.float32))
    p1, p2 = _predictor(1), _predictor(2)
    l1, b1 = p1.infer(vol)
    l2, b2 = p2.serve([vol])[0]
    assert l1.shape == b1.shape == (40, 36, 20, 13)
    assert torch.isfinite(l1).all()
    assert set(torch.unique(b2).tolist()) <= {0.0, 1.0}
    # 1e-4: the CPU's conv kernels round differently at batch 1 and 2
    np.testing.assert_allclose(l1.numpy(), l2.numpy(), rtol=1e-4, atol=1e-4)
    with torch.inference_mode():
        direct = p2._inferer(
            tsw.make_ddim_window_predictor(p2.seg, p2.seed), vol,
            out_channels=13)
    np.testing.assert_allclose(l2.numpy(), direct.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_predictor_config_handling():
    with pytest.warns(UserWarning, match="quantise"):
        p = Predictor(model_name="diff_swin_unetr", feature_size=12,
                      image_size=32, spatial_size=32, use_amp=False,
                      device="cpu", quantise=True, data_name="btcv")
    assert p.num_classes == 13 and p.dtype is None
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Predictor(model_path="weights/epoch_1", device="cpu")
    with pytest.raises(ValueError, match="pack"):
        Predictor(pack=2, device="cpu")


def test_predictor_without_a_card_raises_unless_asked_for_cpu():
    """The default device is the card; there is no silent CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    kw = dict(model_name="diff_unet", features=(8, 8, 16, 32, 64, 8),
              image_size=32, spatial_size=32, use_amp=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor(**kw)
    with pytest.raises(RuntimeError, match="cuda"):
        Predictor(device="cuda:0", **kw)
    assert Predictor(device="cpu", **kw).device.type == "cpu"


def test_predictor_passes_features_through():
    p = Predictor(model_name="diff_unet", features=[8, 8, 16, 32, 64, 8],
                  image_size=32, spatial_size=32, use_amp=False,
                  device="cpu")
    assert p.module.model.down_4.convs.conv_1.conv.weight.shape[0] == 64
    assert p.module.model.final_conv.weight.shape[:2] == (13, 8)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in (ROOT / "cfg").glob("*/*.yaml")))
def test_flat_yaml_reader_matches_jax_config(path):
    got = dict(load_flat_yaml(ROOT / path))
    if path.endswith("classes.yaml"):
        import yaml
        want = yaml.safe_load((ROOT / path).read_text())
    else:
        want = {k: v for k, v in load_config(ROOT / path).items()
                if not k.startswith("__")}
    assert got == want


def test_package_imports_without_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import diff_unet_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'optax', 'diff_unet_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_engines_default_to_diff_unet_like_jax():
    """Without ``model_name`` both engines build DiffUNet, the JAX
    ``Engine``'s default."""
    import inspect

    from diff_unet_tpu.engine.engine import Engine as JEngine
    from diff_unet_tpu_torch.engine.engine import Engine, Trainer
    from diff_unet_tpu_torch.models.diff_unet import DiffUNet

    want = inspect.signature(JEngine).parameters["model_name"].default
    assert want == "diff_unet"
    for cls in (Engine, Trainer):
        assert inspect.signature(cls).parameters[
            "model_name"].default == want
    p = Predictor(features=(8, 8, 16, 32, 64, 8), image_size=32,
                  spatial_size=32, use_amp=False, device="cpu")
    assert p.model_name == "diff_unet" and isinstance(p.module, DiffUNet)
