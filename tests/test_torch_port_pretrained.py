"""PyTorch port, pretrained weights against the JAX package on the CPU: a
MONAI-named ``encoder.pt`` (BasicUNetEncoder, built as the JAX package's
own test builds it) and a ``swinvit.pt`` grafted by
``diff_unet_tpu.utils.torch_import.load_pretrained_encoder`` and by the
port's ``utils/pretrained.py`` give the same parameters (0 tolerance);
the ``Trainer``'s ``pretrained_path``; and ``LearnableLabelSmoothing``
against the flax module (1e-6)."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diff_unet_tpu.data import label_smoothing as jls
from diff_unet_tpu.models.diff_unet import DiffUNet as JDiffUNet
from diff_unet_tpu.models.swin_unetr import DiffSwinUNETR as JSwin
from diff_unet_tpu.utils import torch_import as jimport
from diff_unet_tpu_torch.data import label_smoothing as tls
from diff_unet_tpu_torch.data.synthetic import SyntheticSegmentation
from diff_unet_tpu_torch.engine.checkpoint import save_jax_npz
from diff_unet_tpu_torch.engine.engine import Trainer
from diff_unet_tpu_torch.models.diff_unet import DiffUNet as TDiffUNet
from diff_unet_tpu_torch.models.swin_unetr import DiffSwinUNETR as TSwin
from diff_unet_tpu_torch.models.swin_unetr import SwinUNETR
from diff_unet_tpu_torch.utils import pretrained as tpre
from diff_unet_tpu_torch.utils.weights import export_jax_params, \
    load_jax_params
from tests.test_pretrained_and_smoothing import _fake_encoder_state_dict
from tests.test_torch_port_swin import random_flax_params
from tests.test_torch_port_swin import torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
FEATURES = (4, 4, 8, 16, 32, 4)
S, C = 16, 2


def _equal_modules(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def _swinvit_state_dict(swin, seed=0):
    """A swinvit.pt state dict (MONAI names, ``module.`` prefix, MLP as
    linear1/linear2) with the shapes of the port's ``swin``."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for name, p in swin.named_parameters():
        name = re.sub(r"layers(\d)\.blocks_(\d+)\.", r"layers\1.0.blocks.\2.",
                      name)
        name = re.sub(r"layers(\d)\.downsample\.", r"layers\1.0.downsample.",
                      name)
        name = name.replace("mlp.fc1", "mlp.linear1").replace("mlp.fc2",
                                                              "mlp.linear2")
        sd["module." + name] = torch.randn(p.shape, generator=g)
    return sd


def test_encoder_pt_graft_matches_jax(tmp_path):
    sd = _fake_encoder_state_dict(FEATURES)
    path = tmp_path / "encoder.pt"
    torch.save(sd, path)
    jm = JDiffUNet(out_channels=C, features=FEATURES)
    image = np.zeros((1, S, S, S, 1), np.float32)
    params = random_flax_params(jm, image, np.zeros((1, S, S, S, C),
                                                    np.float32),
                                np.zeros((1,), np.int32), seed=2)
    want = load_jax_params(TDiffUNet(C, features=FEATURES),
                           jimport.load_pretrained_encoder(path, params,
                                                           "diff_unet"))
    got = tpre.load_pretrained_encoder(
        path, load_jax_params(TDiffUNet(C, features=FEATURES), params),
        "diff_unet")
    _equal_modules(got, want)
    assert torch.equal(got.embed_model.conv_0.conv_0.conv.weight,
                       sd["conv_0.conv_0.conv.weight"])
    # the denoiser keeps its weights
    before = load_jax_params(TDiffUNet(C, features=FEATURES), params)
    _equal_modules(got.model, before.model)


def test_swinvit_pt_graft_matches_jax(tmp_path):
    size, fs = (32, 32, 32), 12
    jm = JSwin(out_channels=3, image_size=size, feature_size=fs)
    params = random_flax_params(
        jm, np.zeros((1, *size, 1), np.float32),
        np.zeros((1, *size, 3), np.float32), np.zeros((1,), np.int32),
        seed=3)
    port = load_jax_params(TSwin(3, image_size=size, feature_size=fs),
                           params)
    sd = _swinvit_state_dict(port.embed_model.swinViT)
    path = tmp_path / "swinvit.pt"
    torch.save({"state_dict": sd}, path)
    want = load_jax_params(TSwin(3, image_size=size, feature_size=fs),
                           jimport.load_pretrained_encoder(
                               path, params, "diff_swin_unetr"))
    got = tpre.load_pretrained_encoder(path, port, "diff_swin_unetr")
    _equal_modules(got, want)
    assert torch.equal(
        got.embed_model.swinViT.layers2.blocks_1.mlp.fc1.weight,
        sd["module.layers2.0.blocks.1.mlp.linear1.weight"])
    # the plain baseline takes swinvit.pt into its own Swin ViT
    plain = SwinUNETR(3, image_size=size, feature_size=fs)
    tpre.load_pretrained_encoder(path, plain, "swin_unetr")
    _equal_modules(plain.swinViT, got.embed_model.swinViT)
    sd["module.patch_embed.proj.bias"] = torch.zeros(fs + 1)
    torch.save(sd, path)
    with pytest.raises(ValueError, match="patch_embed.proj.bias"):
        tpre.load_pretrained_encoder(path, plain, "swin_unetr")


def test_trainer_pretrained_path(tmp_path, monkeypatch):
    """``pretrained_path`` grafts encoder.pt before training (the EMA tree
    starts from the grafted weights); a JAX encoder ``.npz`` grafts too;
    an Orbax directory raises with the conversion advice."""
    monkeypatch.chdir(tmp_path)
    sd = _fake_encoder_state_dict(FEATURES)
    torch.save(sd, tmp_path / "encoder.pt")
    data = SyntheticSegmentation((S,) * 3, num_labels=3, batch_size=1,
                                 batches=1)
    kw = dict(train_data=data, device="cpu", features=FEATURES,
              image_size=S, spatial_size=S, use_amp=False, batch_size=1,
              max_epochs=1, classes=str(ROOT / "cfg/msd/classes.yaml"))
    cfg = ROOT / "cfg/msd/train.yaml"
    trainer = Trainer.from_config(cfg, pretrained_path=str(
        tmp_path / "encoder.pt"), ema_rate=0.999, **kw)
    enc = trainer.module.embed_model
    assert torch.equal(enc.down_4.convs.conv_1.norm.weight,
                       sd["down.3.convs.conv_1.adn.N.weight"])
    names = [n for n, _ in trainer.module.named_parameters()]
    for n, e in zip(names, trainer.train_step.ema):
        assert torch.equal(e, trainer.module.get_parameter(n)), n
    trainer.train()
    assert np.isfinite(trainer.history[0]["loss"])
    tree = export_jax_params(enc)
    save_jax_npz(tmp_path / "enc.npz", tree)
    other = Trainer.from_config(cfg, pretrained_path=str(
        tmp_path / "enc.npz"), **kw)
    _equal_modules(other.module.embed_model, enc)
    (tmp_path / "orbax").mkdir()
    with pytest.raises(ValueError, match="Orbax"):
        Trainer.from_config(cfg, pretrained_path=str(tmp_path / "orbax"),
                            **kw)


def test_learnable_label_smoothing_matches_flax():
    rng = np.random.default_rng(4)
    c = 4
    labels = np.eye(c, dtype=np.float32)[rng.integers(0, c, (2, 5, 6, 7))]
    dist = (5 * rng.random((2, 5, 6, 7, c))).astype(np.float32)
    jm = jls.LearnableLabelSmoothing(num_classes=c)
    params = jm.init(jax.random.key(0), labels, dist)
    p = params["params"]
    assert np.allclose(p["alpha"], 0.3) and np.allclose(p["beta"], 1.0)
    tm = tls.LearnableLabelSmoothing(c)
    assert torch.allclose(tm.alpha, torch.full((c,), 0.3))
    assert torch.equal(tm.beta, torch.ones(c))
    alpha = (0.3 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    beta = (1.0 + 0.2 * rng.standard_normal(c)).astype(np.float32)
    with torch.no_grad():
        tm.alpha.copy_(torch.from_numpy(alpha))
        tm.beta.copy_(torch.from_numpy(beta))
    jp = {"params": {"alpha": jnp.asarray(alpha), "beta": jnp.asarray(beta)}}

    def f(q):
        return jnp.sum(jnp.square(jm.apply(q, labels, dist)))

    want, grads = jax.value_and_grad(f)(jp)
    out = tm(torch.from_numpy(labels), torch.from_numpy(dist))
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jm.apply(jp, labels, dist)),
                               rtol=1e-6, atol=1e-6)
    (out ** 2).sum().backward()
    for name in ("alpha", "beta"):
        np.testing.assert_allclose(getattr(tm, name).grad.numpy(),
                                   np.asarray(grads["params"][name]),
                                   rtol=1e-5)
