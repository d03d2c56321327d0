"""PyTorch port, serving path: sliding-window geometry and stitching against
the JAX package, the Predictor's window-batching invariance and crop-back,
the flat config reader, and that the package never imports jax."""
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diff_unet_tpu.engine import sliding_window as jsw
from diff_unet_tpu.utils.config import load_config
from diff_unet_tpu_torch.engine import checkpoint as ckpt
from diff_unet_tpu_torch.engine import sliding_window as tsw
from diff_unet_tpu_torch.engine.engine import Predictor
from diff_unet_tpu_torch.utils.config import load_flat_yaml
from diff_unet_tpu_torch.utils.weights import export_jax_params
from tests.test_torch_port_swin import torch_threads  # noqa: F401

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


# the smallest DiffUNet: the properties below are the engine's, not a
# model's
TINY = dict(model_name="diff_unet", features=(4, 4, 8, 16, 32, 4),
            image_size=16, spatial_size=16, use_amp=False, device="cpu")


def _predictor(sw_batch_size):
    return Predictor(sample_steps=2, sw_batch_size=sw_batch_size, seed=5,
                     classes=str(ROOT / "cfg/btcv/classes.yaml"), **TINY)


def test_predictor_invariant_to_window_batching_and_crops_back():
    """sw_batch_size 1 and 2 give the same stitched logits (noise is keyed
    on window starts); a non-grid volume (one axis below the ROI) comes
    back at its own shape and equals the un-bucketed sliding window."""
    vol = torch.from_numpy(np.random.default_rng(1).random(
        (20, 18, 10, 1)).astype(np.float32))
    p1, p2 = _predictor(1), _predictor(2)
    l1, b1 = p1.infer(vol)
    l2, b2 = p2.serve([vol])[0]
    assert l1.shape == b1.shape == (20, 18, 10, 13)
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


def test_predictor_config_handling(tmp_path):
    """Unknown keys warn; the serving keys that the port once ignored
    (``use_ema``, ``epoch``, ``save_volumes``, ``continuous``) now act or
    raise; ``quant_calibrate`` stays ignored while ``quantize`` is off."""
    with pytest.warns(UserWarning, match="quantise"):
        p = Predictor(quantise=True, data_name="btcv", quant_calibrate=4,
                      **TINY)
    assert p.num_classes == 13 and p.dtype is None
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    kw = dict(TINY)
    del kw["model_name"]
    with pytest.raises(FileNotFoundError, match="epoch_1"):
        Predictor(model_path=str(tmp_path / "weights/epoch_1"), **kw)
    with pytest.raises(ValueError, match="pack"):
        Predictor(pack=2, device="cpu")
    # epoch: the fallback for a checkpoint without one
    assert Predictor(epoch=7, **kw).epoch == 7
    ckpt.save_jax_npz(tmp_path / "w.npz",
                      export_jax_params(Predictor(seed=3, **kw).module))
    loaded = Predictor(model_path=str(tmp_path / "w"), epoch=7, **kw)
    assert loaded.epoch == 7
    # use_ema: the EMA tree, which this checkpoint and random weights lack
    with pytest.raises(ValueError, match="ema_params"):
        Predictor(model_path=str(tmp_path / "w"), use_ema=True, **kw)
    with pytest.raises(ValueError, match="ema_params"):
        Predictor(use_ema=True, **kw)
    # continuous and save_volumes are the Tester's: given to a Predictor
    # they warn, and the Predictor built from a test config drops them
    with pytest.warns(UserWarning, match="continuous"):
        Predictor(continuous=2, **kw)
    with pytest.warns(UserWarning, match="save_volumes"):
        Predictor(save_volumes=True, **kw)
    cfg = tmp_path / "test.yaml"
    cfg.write_text((ROOT / "cfg/amos/test.yaml").read_text().replace(
        "continuous: 0", "continuous: 2"))
    assert load_flat_yaml(cfg)["save_volumes"] is True
    assert load_flat_yaml(cfg)["continuous"] == 2
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        Predictor.from_config(cfg, model_path=None, **kw)


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


def test_config_overrides_match_jax(tmp_path):
    """``load_config`` / ``parse_args`` coerce ``key=value`` overrides as
    the JAX package's do (null, booleans, ints, scientific floats, flow
    lists, strings)."""
    from diff_unet_tpu.utils.config import parse_args as jparse_args
    from diff_unet_tpu_torch.utils.config import engine_kwargs, \
        load_config as tload_config, parse_args

    cfg = tmp_path / "c.yaml"
    cfg.write_text("lr: 5e-4\nmodel_name: diff_unet\nscheduler: true\n")
    overrides = ["lr=1e-3", "max_epochs=10", "features=[4, 4, 8]",
                 "model_path=null", "use_amp=false", "device=cpu",
                 "log_dir=run-1"]
    want = {k: v for k, v in load_config(cfg, overrides).items()
            if not k.startswith("__")}
    got = tload_config(cfg, overrides)
    assert got["__config_path__"] == str(cfg)
    assert engine_kwargs(got) == want
    assert parse_args(["--config", str(cfg), *overrides], quiet=True) == \
        got
    assert jparse_args(["--config", str(cfg), "lr=2e-3"],
                       quiet=True).lr == parse_args(
        ["--config", str(cfg), "lr=2e-3"], quiet=True)["lr"] == 2e-3
    with pytest.raises(ValueError, match="key=value"):
        tload_config(cfg, ["lr"])
