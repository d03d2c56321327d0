"""PyTorch port, the training path against the JAX package: the losses
(1e-6), label smoothing and label conversion (exact), the warmup-cosine
schedule (1e-7), two AdamW updates against ``optax.adamw`` (1e-6), one
train step of DiffSwinUNETR (feature 12, 32^3), of DiffUNet (features
(8, 8, 16, 32, 64, 8), 32^3, every conv through the conv's autograd
Function), of SmoothDiffUNet (features (4, 4, 8, 16, 32, 4), 16x32x32)
and of AttentionDiffUNet (features (4, 8, 16, 32, 64), 16^3, a batch of
2) against ``jax.value_and_grad`` in float64 with injected t and noise
(loss and gradients 1e-4), and the Trainers built from
``cfg/btcv/train.yaml`` and ``cfg/amos/train.yaml`` on synthetic
batches."""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import linen as fnn

from diff_unet_tpu.api import DiffusionSegmenter as JSeg
from diff_unet_tpu.data import label_smoothing as jls
from diff_unet_tpu.diffusion import gaussian as jg
from diff_unet_tpu.engine import engine as jengine
from diff_unet_tpu.engine import train as jtrain
from diff_unet_tpu.losses.losses import CompositeLoss as JLoss
from diff_unet_tpu.models import attention_diff_unet as jatt
from diff_unet_tpu.models.attention_diff_unet import \
    AttentionDiffUNet as JAttention
from diff_unet_tpu.models.diff_unet import DiffUNet as JDiffUNet
from diff_unet_tpu.models.smooth_diff_unet import SmoothDiffUNet as JSmooth
from diff_unet_tpu.models.swin_unetr import DiffSwinUNETR as JModel
from diff_unet_tpu_torch.api import DiffusionSegmenter as TSeg
from diff_unet_tpu_torch.data import label_smoothing as tls
from diff_unet_tpu_torch.data.synthetic import SyntheticSegmentation, \
    synthetic_pair
from diff_unet_tpu_torch.engine import engine as tengine
from diff_unet_tpu_torch.engine import train as ttrain
from diff_unet_tpu_torch.losses.losses import CompositeLoss as TLoss
from diff_unet_tpu_torch.models.attention_diff_unet import \
    AttentionDiffUNet as TAttention
from diff_unet_tpu_torch.models.diff_unet import DiffUNet as TDiffUNet
from diff_unet_tpu_torch.models.smooth_diff_unet import \
    SmoothDiffUNet as TSmooth
from diff_unet_tpu_torch.models.swin_unetr import DiffSwinUNETR as TModel
from diff_unet_tpu_torch.utils.weights import export_jax_params, \
    load_jax_params
from tests.test_torch_port_models import jax_f64
from tests.test_torch_port_swin import random_flax_params
from tests.test_torch_port_swin import torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
S, C, FS = 32, 3, 12
FEATURES = (8, 8, 16, 32, 64, 8)


class BatchStatsNorm64(jatt.BatchStatsNorm):
    """The JAX package's ``BatchStatsNorm`` with its statistics and affine
    in x's dtype (at least float32) where it casts x to float32 whatever
    its dtype: the same operations in the same order, so that a float64
    run is float64 throughout."""

    @fnn.compact
    def __call__(self, x):
        c = x.shape[-1]
        scale = self.param("scale", fnn.initializers.ones, (c,))
        bias = self.param("bias", fnn.initializers.zeros, (c,))
        axes = tuple(range(x.ndim - 1))
        xf = x.astype(jnp.promote_types(x.dtype, jnp.float32))
        mean = jnp.mean(xf, axis=axes, keepdims=True)
        var = jnp.mean(jnp.square(xf - mean), axis=axes, keepdims=True)
        y = (xf - mean) * jax.lax.rsqrt(var + self.epsilon)
        y = y * scale.astype(xf.dtype) + bias.astype(xf.dtype)
        return y.astype(self.dtype or x.dtype)


def _models(name):
    """The JAX module, a constructor of the port's module, small widths,
    and the patch shape: 32^3, 16x32x32 for SmoothDiffUNet (whose
    smoothing weights take D from ``spatial_size``, H and W from
    ``image_size``), 16^3 for AttentionDiffUNet."""
    if name == "diff_unet":
        return (JDiffUNet(out_channels=C, features=FEATURES),
                lambda: TDiffUNet(C, features=FEATURES), (S,) * 3)
    if name == "smooth_diff_unet":
        fea, d = (4, 4, 8, 16, 32, 4), S // 2
        return (JSmooth(out_channels=C, image_size=S, spatial_size=d,
                        features=fea),
                lambda: TSmooth(C, image_size=S, spatial_size=d,
                                features=fea), (d, S, S))
    if name == "attention_diff_unet":
        fea = (4, 8, 16, 32, 64)
        return (JAttention(out_channels=C, features=fea),
                lambda: TAttention(C, features=fea), (S // 2,) * 3)
    return (JModel(out_channels=C, image_size=(S,) * 3, feature_size=FS),
            lambda: TModel(C, image_size=(S,) * 3, feature_size=FS),
            (S,) * 3)


@pytest.mark.parametrize("losses", ["mse", "bce", "dice", "mse,bce,dice"])
@pytest.mark.parametrize("combine", ["sum", "mean", "log"])
def test_losses_match(losses, combine):
    rng = np.random.default_rng(0)
    preds = (3 * rng.standard_normal((2, 6, 5, 4, C))).astype(np.float32)
    labels = rng.random((2, 6, 5, 4, C)).astype(np.float32)
    want = JLoss(losses, C, combine, fold=1)(jnp.asarray(preds),
                                             jnp.asarray(labels))
    got = TLoss(losses, C, combine)(torch.from_numpy(preds),
                                    torch.from_numpy(labels))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-6)


def test_unported_losses_raise_naming_roadmap():
    """Every name of the registry is ported (tests/test_torch_port_losses.py
    holds them against the JAX package); a name outside it raises as the
    JAX package's does."""
    assert TLoss("mse,focal,boundary", C).names == ["mse", "focal",
                                                    "boundary"]
    with pytest.raises(NotImplementedError, match="not listed"):
        TLoss("mse,tversky", C)
    with pytest.raises(ValueError, match="channels"):
        TLoss("mse", C)(torch.zeros(1, 2, 2, 2, C + 1),
                        torch.zeros(1, 2, 2, 2, C + 1))


def test_label_smoothing_and_conversion_exact():
    _, label = synthetic_pair((12, 10, 8), 5, seed=3)
    for kind in ("rational", "exponential", "damped_sine"):
        np.testing.assert_array_equal(
            tls.smooth_labels(label, 5, 0.2, 1.0, 0.05, kind),
            jls.smooth_labels(label, 5, 0.2, 1.0, 0.05, kind))
    ids = [1, 3, 4]
    want = jengine.convert_labels(jnp.asarray(label[None]), ids)
    got = tengine.convert_labels(torch.from_numpy(label[None]), ids)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_warmup_cosine_schedule_matches():
    args = (2e-4, 100, 20000, 6)                  # BTCV recipe, 6 steps/epoch
    want = jtrain.linear_warmup_cosine(*args)
    got = ttrain.linear_warmup_cosine(*args)
    for step in (0, 1, 2, 599, 600, 601, 5000, 119999, 120000, 130000):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-7,
                                   atol=1e-12)
    assert got(0) == 0.0 and got(600) == 2e-4


@pytest.mark.parametrize("scheduler", [None, "warmup_cosine"])
def test_two_adamw_updates_match_optax(scheduler):
    """Update k uses schedule(k): with 1 step per epoch and 1 warmup epoch
    the first update has lr 0 and the second the full lr."""
    rng = np.random.default_rng(1)
    tree = {"w": rng.standard_normal((4, 3)).astype(np.float32),
            "b": rng.standard_normal((3,)).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in tree.items()} for _ in range(2)]
    kw = dict(lr=2e-4, weight_decay=1e-4, scheduler=scheduler,
              warmup_epochs=1, max_epochs=10, steps_per_epoch=1)
    tx = jtrain.make_optimizer(**kw)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    state = tx.init(params)
    for g in grads:
        updates, state = tx.update(g, state, params)
        params = optax.apply_updates(params, updates)

    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in tree.items()}
    opt, schedule = ttrain.make_optimizer(tparams.values(), **kw)
    lrs = []
    for count, g in enumerate(grads):
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        lrs.append(ttrain.apply_update(opt, schedule, count))
    assert lrs == ([2e-4, 2e-4] if scheduler is None else [0.0, 2e-4])
    for k, p in tparams.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("model", ["diff_swin_unetr", "diff_unet",
                                   "smooth_diff_unet",
                                   "attention_diff_unet"])
def test_train_step_matches_jax_value_and_grad(model, monkeypatch):
    """fp32 port against float64 JAX: the same params, t and noise; the
    loss at 1e-4, each gradient at 1e-4 of the model's largest gradient
    (fp32 rounding leaves ~4e-6 of it; a tensor's own scale is no
    yardstick where its exact gradient is ~0, as for a conv bias before an
    instance norm), and the parameters after one AdamW update within 2 lr
    (Adam's first update is lr * sign(g) where |g| is far above eps, so a
    gradient that is ~0 in float64 may flip it). DiffUNet's gradients
    come through the conv's Function (dgrad, wgrad, the statistics' and
    the prologue's adjoints), the JAX ones through flax ``nn.Conv``; its
    port side runs in float64, which the Function's plain backward keeps:
    the model's 2^3 instance norms amplify float32 rounding to the size of
    the tolerance itself. SmoothDiffUNet runs in float64 too: its
    denoiser's layer norms through the port's own Function, its smoothing
    weights through autograd. AttentionDiffUNet runs in float64 on a
    batch of 2 different samples (its batch norms' statistics span the
    batch); a conv bias before a batch norm has an exact gradient of 0,
    judged on the model's scale as the instance norms' are. Its JAX side
    takes ``BatchStatsNorm64``: the JAX norm casts to float32 even in a
    float64 run, and a conv's weight gradient before a batch norm (the
    sum of g times inputs of large mean, where g sums to 0) turns that
    rounding into ~4e-4 of the model's largest gradient."""
    monkeypatch.setattr(jatt, "BatchStatsNorm", BatchStatsNorm64)
    jm, build, shape = _models(model)
    n = 2 if model == "attention_diff_unet" else 1
    rng = np.random.default_rng(0)
    image = rng.random((n, *shape, 1)).astype(np.float32)
    labels = np.eye(C, dtype=np.float32)[rng.integers(0, C, (n, *shape))]
    noise = rng.standard_normal(labels.shape).astype(np.float32)
    t = np.array([417, 80][:n], np.int32)
    params = random_flax_params(jm, image, labels, t, seed=1)
    crit = JLoss("mse,bce,dice", C, "sum", fold=1)
    sched = JSeg(module=jm, num_classes=C).train_schedule

    def loss_fn(p, image, labels, t, noise):
        x_t = jg.q_sample(sched, labels * 2.0 - 1.0, t, noise)
        preds = jm.apply(p, image, x_t, t, method="denoise")
        return crit(preds, labels)

    want_loss, want_grads = jax_f64(jax.value_and_grad(loss_fn), params,
                                    image, labels, t, noise)

    lr = 2e-4
    dtype = torch.float32 if model == "diff_swin_unetr" else torch.float64
    tm = load_jax_params(build(), params).to(dtype)
    opt, schedule = ttrain.make_optimizer(tm.parameters(), lr=lr,
                                          weight_decay=1e-4)
    step = ttrain.TrainStep(TSeg(tm, C), TLoss("mse,bce,dice", C), opt,
                            schedule)
    metrics = step(torch.from_numpy(image).to(dtype),
                   torch.from_numpy(labels).to(dtype),
                   t=torch.from_numpy(t).long(),
                   noise=torch.from_numpy(noise).to(dtype))
    np.testing.assert_allclose(metrics["loss"].item(), float(want_loss),
                               rtol=1e-4)
    got = dict(jax.tree_util.tree_leaves_with_path(
        export_jax_params(tm, grads=True)))
    want = dict(jax.tree_util.tree_leaves_with_path(want_grads))
    assert got.keys() == want.keys()
    scale = max(float(np.abs(w).max()) for w in want.values())
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=jax.tree_util.keystr(k))
    norm = np.sqrt(sum(float(np.sum(np.square(w))) for w in want.values()))
    np.testing.assert_allclose(metrics["grad_norm"].item(), norm, rtol=1e-4)

    # optax.adamw's first update in closed form (bias-corrected moments are
    # g and g^2): p - lr * (g / (|g| + eps) + wd * p)
    moved = dict(jax.tree_util.tree_leaves_with_path(export_jax_params(tm)))
    for k, p in jax.tree_util.tree_leaves_with_path(params):
        w = want[k]
        after = p - lr * (w / (np.abs(w) + 1e-8) + 1e-4 * p)
        np.testing.assert_allclose(moved[k], after, rtol=0, atol=2 * lr,
                                   err_msg=jax.tree_util.keystr(k))


def test_trainer_runs_btcv_recipe_on_synthetic_batches(tmp_path,
                                                      monkeypatch):
    """``Trainer.from_config`` at a small width (feature 6) on the CPU:
    label smoothing over 14 values without background, warmup-cosine lr
    (0 at the first update), finite losses, validation without a
    validation set and the keys it cannot honour raise."""
    monkeypatch.chdir(tmp_path)      # the trainer's logs land in the cwd
    cfg = ROOT / "cfg/btcv/train.yaml"
    kw = dict(device="cpu", feature_size=6, image_size=S, spatial_size=S,
              classes=str(ROOT / "cfg/btcv/classes.yaml"), use_amp=False)
    data = SyntheticSegmentation((S, S, S), num_labels=14, batches=2)
    trainer = tengine.Trainer.from_config(cfg, train_data=data,
                                          max_epochs=1, **kw)
    image, labels = trainer.batches[0]
    assert trainer.num_classes == 13 and labels.shape == (1, S, S, S, 13)
    assert trainer.module.training
    before = {k: v.clone() for k, v in trainer.module.named_parameters()}
    trainer.train()
    assert [h["lr"] for h in trainer.history] == pytest.approx(
        [0.0, 2e-4 / 200], rel=1e-12, abs=0)
    assert all(np.isfinite(h["loss"]) and h["grad_norm"] > 0
               for h in trainer.history)
    assert any(not torch.equal(before[k], v)
               for k, v in trainer.module.named_parameters())
    trainer.max_epochs, trainer.val_freq = 2, 2
    with pytest.raises(ValueError, match="validation"):
        trainer.train()
    # the same recipe trains DiffUNet (the engines' default model; its
    # smallest widths on 16^3)
    unet = tengine.Trainer.from_config(
        cfg, max_epochs=1, train_data=SyntheticSegmentation(
            (16,) * 3, num_labels=14, batches=2),
        **{**kw, "model_name": "diff_unet", "features": (4, 4, 8, 16, 32, 4),
           "image_size": 16, "spatial_size": 16})
    assert isinstance(unet.module, TDiffUNet)
    unet.train()
    assert len(unet.history) == 2 and np.isfinite(unet.history[-1]["loss"])
    # the recipe takes every family (swin_unetr trains:
    # tests/test_torch_port_swin_unetr.py; smooth_diff_unet:
    # tests/test_torch_port_smooth.py; attention_diff_unet:
    # tests/test_torch_port_attention_diff_unet.py)
    att = tengine.Trainer.from_config(
        cfg, train_data=data, max_epochs=1,
        **{**kw, "model_name": "attention_diff_unet",
           "features": (4, 8, 16, 32, 64)})
    assert isinstance(att.module, TAttention) and att.module.training
    with pytest.raises(ValueError, match="train_data"):
        tengine.Trainer.from_config(cfg, **{**kw, "data_path": None})
    # the JAX Trainer's keys (tests/test_torch_port_train_extras.py)
    seg, crit = trainer.seg, trainer.criterion
    opt, schedule = ttrain.make_optimizer(trainer.module.parameters())
    step = ttrain.TrainStep(seg, crit, opt, schedule, ema_rate=0.999,
                            t_sampler="loss_aware", accum_steps=2)
    assert len(step.ema) == len(step.params)
    assert step.sampler_state.losses.shape == (seg.timesteps, 10)
    with pytest.raises(ValueError, match="t_sampler"):
        ttrain.TrainStep(seg, crit, opt, schedule, t_sampler="second")


def test_trainer_runs_amos_recipe_on_synthetic_batches(tmp_path,
                                                      monkeypatch):
    """``Trainer.from_config("cfg/amos/train.yaml")`` at a small width on
    the CPU: DiffUNet (the config's model), 15 classes from the 16-entry
    AMOS class table without background, one-hot labels (no smoothing),
    lr 5e-4 with 100 warmup epochs (0 at the first update), mse + bce +
    dice; finite losses, gradients and moved parameters."""
    monkeypatch.chdir(tmp_path)      # the trainer's logs land in the cwd
    cfg = ROOT / "cfg/amos/train.yaml"
    data = SyntheticSegmentation((S, S, S), num_labels=16, batch_size=2,
                                 batches=2)
    trainer = tengine.Trainer.from_config(
        cfg, train_data=data, device="cpu", features=FEATURES,
        image_size=S, spatial_size=S, use_amp=False, batch_size=2,
        max_epochs=1, classes=str(ROOT / "cfg/amos/classes.yaml"))
    assert trainer.model_name == "diff_unet"
    assert isinstance(trainer.module, TDiffUNet)
    assert trainer.num_classes == 15 and not trainer.label_smoothing
    image, labels = trainer.batches[0]
    assert image.shape == (2, S, S, S, 1) and labels.shape == (2, S, S, S, 15)
    assert set(labels.unique().tolist()) == {0.0, 1.0}
    before = {k: v.clone() for k, v in trainer.module.named_parameters()}
    trainer.train()
    assert [h["lr"] for h in trainer.history] == pytest.approx(
        [0.0, 5e-4 / 200], rel=1e-12, abs=0)
    assert all(np.isfinite(h["loss"]) and h["grad_norm"] > 0
               for h in trainer.history)
    moved = [k for k, v in trainer.module.named_parameters()
             if not torch.equal(before[k], v)]
    assert len(moved) == len(before)
