"""PyTorch port, checkpoints: the JAX package writes a real Orbax
checkpoint of ``create_train_state`` (DiffUNet as its Trainer builds it,
pack 2, with ``ema_rate`` set) at a small size; the README's conversion
lines turn it into ``.npz``; the port loads it, and ``export_jax_params``
gives back exactly the JAX params, and with ``use_ema`` exactly the
``ema_params``. Also: a checkpoint without EMA raises under ``use_ema``,
the metadata epoch is carried across, a bare Orbax directory raises with
the conversion in its message, ``model_path`` resolves ``.../epoch_n`` to
``.pt`` or ``.npz``, and the port's ``.pt`` round-trips."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from diff_unet_tpu.api import DiffusionSegmenter as JSeg
from diff_unet_tpu.engine import checkpoint as jckpt
from diff_unet_tpu.engine.train import create_train_state, make_optimizer
from diff_unet_tpu.models.model_hub import create_model as jcreate_model
from diff_unet_tpu_torch.engine import checkpoint as tckpt
from diff_unet_tpu_torch.engine.engine import Predictor
from diff_unet_tpu_torch.models.model_hub import create_model
from diff_unet_tpu_torch.utils.weights import export_jax_params, \
    init_random
from tests.test_torch_port_swin import torch_threads  # noqa: F401

FEATURES = (4, 4, 8, 16, 32, 4)
S, C = 16, 2
KW = dict(features=FEATURES, image_size=S, spatial_size=S, use_amp=False,
          device="cpu")


def _tree_equal(got, want, where=""):
    assert got.keys() == want.keys(), where
    for k in want:
        if isinstance(want[k], dict):
            _tree_equal(got[k], want[k], f"{where}/{k}")
        else:
            np.testing.assert_array_equal(
                np.asarray(got[k]), np.asarray(want[k]), err_msg=where)


def _convert(path: Path) -> Path:
    """The README's conversion, run where jax and orbax are installed."""
    import orbax.checkpoint as ocp
    from diff_unet_tpu_torch.engine.checkpoint import save_jax_npz

    path = Path(path).absolute()
    raw = ocp.StandardCheckpointer().restore(path)
    meta_file = path.parent / (path.name + ".meta.json")
    meta = json.loads(meta_file.read_text()) if meta_file.exists() else None
    save_jax_npz(f"{path}.npz", raw["params"], raw.get("ema_params"), meta)
    return Path(f"{path}.npz")


@pytest.fixture(scope="module")
def orbax_ckpt(tmp_path_factory):
    """An Orbax checkpoint of the JAX TrainState with EMA parameters that
    differ from the parameters, and one without EMA."""
    root = tmp_path_factory.mktemp("orbax")
    module = jcreate_model("diff_unet", out_channels=C, image_size=S,
                           spatial_size=S, features=FEATURES, pack=2)
    seg = JSeg(module=module, num_classes=C, timesteps=100, sample_steps=2)
    state = create_train_state(seg, jax.random.key(0), (1, S, S, S, 1),
                               make_optimizer(), ema_rate=0.5)
    state = state.replace(ema_params=jax.tree_util.tree_map(
        lambda p: p * 0.5 + 0.25, state.params))
    meta = {"epoch": 7, "loss": 0.5, "noise_ratio": 0.5, "global_step": 14,
            "best_mean_dice": 0.25, "project_name": "p", "id": 0}
    jckpt.save_checkpoint(root / "epoch_7", state, meta)
    plain = state.replace(ema_params=None)
    jckpt.save_checkpoint(root / "epoch_8", plain, dict(meta, epoch=8))
    params = jax.tree_util.tree_map(np.asarray, state.params)
    ema = jax.tree_util.tree_map(np.asarray, state.ema_params)
    return root, params, ema


def test_orbax_checkpoint_converts_and_loads_exactly(orbax_ckpt, tmp_path):
    root, params, ema = orbax_ckpt
    with pytest.raises(ValueError, match="save_jax_npz"):
        tckpt.resolve_model_path(root / "epoch_7")
    npz = _convert(root / "epoch_7")
    assert tckpt.resolve_model_path(root / "epoch_7") == npz
    p = Predictor(model_path=str(root / "epoch_7"), **_classes(tmp_path),
                  **KW)
    _tree_equal(export_jax_params(p.module), params)
    assert p.epoch == 7
    pe = Predictor(model_path=str(npz), use_ema=True, **_classes(tmp_path),
                   **KW)
    _tree_equal(export_jax_params(pe.module), ema)
    # without EMA: use_ema raises; the metadata epoch beats the fallback
    _convert(root / "epoch_8")
    with pytest.raises(ValueError, match="ema_params"):
        Predictor(model_path=str(root / "epoch_8"), use_ema=True,
                  **_classes(tmp_path), **KW)
    p8 = Predictor(model_path=str(root / "epoch_8"), epoch=3,
                   **_classes(tmp_path), **KW)
    assert p8.epoch == 8
    _tree_equal(export_jax_params(p8.module), params)


def _classes(tmp_path):
    path = tmp_path / "classes.yaml"
    path.write_text("0: background\n1: a\n2: b\n")
    return {"classes": str(path)}


def test_npz_without_meta_and_resolution(tmp_path):
    module = init_random(create_model("diff_unet", out_channels=C,
                                      features=FEATURES), 3)
    tree = export_jax_params(module)
    tckpt.save_jax_npz(tmp_path / "w.npz", tree)
    params, ema, meta = tckpt.read_jax_npz(tmp_path / "w.npz")
    assert ema is None and meta == {}
    _tree_equal(params, tree)
    # epoch falls back to the config's when the file carries none
    p = Predictor(model_path=str(tmp_path / "w.npz"), epoch=5,
                  **_classes(tmp_path), **KW)
    assert p.epoch == 5
    _tree_equal(export_jax_params(p.module), tree)
    with pytest.raises(FileNotFoundError):
        tckpt.resolve_model_path(tmp_path / "missing")
    # .pt wins over .npz for a bare epoch path
    (tmp_path / "epoch_2.npz").write_bytes(b"")
    tckpt.save_checkpoint(tmp_path / "epoch_2.pt", module, meta={"epoch": 2})
    assert tckpt.resolve_model_path(tmp_path / "epoch_2").suffix == ".pt"
    assert tckpt.latest_checkpoint(tmp_path).name.startswith("epoch_2.")
    assert tckpt.latest_checkpoint(tmp_path / "none") is None


def test_pt_round_trip(tmp_path):
    module = init_random(create_model("diff_unet", out_channels=C,
                                      features=FEATURES), 4)
    opt = torch.optim.AdamW(module.parameters(), lr=1e-3)
    for p in module.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    gen = torch.Generator().manual_seed(9)
    torch.rand(5, generator=gen)
    meta = {"epoch": 3, "loss": 0.125, "noise_ratio": 0.5, "global_step": 6,
            "best_mean_dice": 0.0, "project_name": None, "id": 0}
    tckpt.save_checkpoint(tmp_path / "epoch_3.pt", module, opt, 6, gen, meta)
    state = tckpt.load_training_state(tmp_path / "epoch_3")
    assert state["count"] == 6 and state["meta"] == meta
    assert state["generator_device"] == "cpu"
    g2 = torch.Generator()
    g2.set_state(state["generator"])
    assert torch.equal(torch.rand(5, generator=g2), torch.rand(5, generator=gen))
    other = create_model("diff_unet", out_channels=C, features=FEATURES)
    got_meta = tckpt.load_params(other, tmp_path / "epoch_3")
    assert got_meta == meta
    for (k, a), (_, b) in zip(module.state_dict().items(),
                              other.state_dict().items()):
        assert torch.equal(a, b), k
    opt2 = torch.optim.AdamW(other.parameters(), lr=1e-3)
    opt2.load_state_dict(state["optimizer"])
    for a, b in zip(opt.state.values(), opt2.state.values()):
        assert all(torch.equal(a[k], b[k]) for k in a)
    with pytest.raises(ValueError, match="ema_params"):
        tckpt.load_params(other, tmp_path / "epoch_3.pt", use_ema=True)
    with pytest.raises(ValueError, match="parameters only"):
        tckpt.save_jax_npz(tmp_path / "p.npz", export_jax_params(module))
        tckpt.load_training_state(tmp_path / "p.npz")
