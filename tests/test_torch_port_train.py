"""PyTorch port, the training path against the JAX package: the losses
(1e-6), label smoothing and label conversion (exact), the warmup-cosine
schedule (1e-7), two AdamW updates against ``optax.adamw`` (1e-6), one
train step of DiffSwinUNETR (feature 12, 32^3) and of DiffUNet (features
(8, 8, 16, 32, 64, 8), 32^3, every conv through the conv's autograd
Function) against ``jax.value_and_grad`` in float64 with injected t and
noise (loss and gradients 1e-4), and the Trainers built from
``cfg/btcv/train.yaml`` and ``cfg/amos/train.yaml`` on synthetic
batches."""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from diff_unet_tpu.api import DiffusionSegmenter as JSeg
from diff_unet_tpu.data import label_smoothing as jls
from diff_unet_tpu.diffusion import gaussian as jg
from diff_unet_tpu.engine import engine as jengine
from diff_unet_tpu.engine import train as jtrain
from diff_unet_tpu.losses.losses import CompositeLoss as JLoss
from diff_unet_tpu.models.diff_unet import DiffUNet as JDiffUNet
from diff_unet_tpu.models.swin_unetr import DiffSwinUNETR as JModel
from diff_unet_tpu_torch.api import DiffusionSegmenter as TSeg
from diff_unet_tpu_torch.data import label_smoothing as tls
from diff_unet_tpu_torch.data.synthetic import SyntheticSegmentation, \
    synthetic_pair
from diff_unet_tpu_torch.engine import engine as tengine
from diff_unet_tpu_torch.engine import train as ttrain
from diff_unet_tpu_torch.losses.losses import CompositeLoss as TLoss
from diff_unet_tpu_torch.models.diff_unet import DiffUNet as TDiffUNet
from diff_unet_tpu_torch.models.swin_unetr import DiffSwinUNETR as TModel
from diff_unet_tpu_torch.utils.weights import export_jax_params, \
    load_jax_params
from tests.test_torch_port_models import jax_f64
from tests.test_torch_port_swin import random_flax_params

ROOT = Path(__file__).resolve().parents[1]
S, C, FS = 32, 3, 12
FEATURES = (8, 8, 16, 32, 64, 8)


def _models(name):
    """The JAX module and a constructor of the port's module, small
    widths."""
    if name == "diff_unet":
        return (JDiffUNet(out_channels=C, features=FEATURES),
                lambda: TDiffUNet(C, features=FEATURES))
    return (JModel(out_channels=C, image_size=(S,) * 3, feature_size=FS),
            lambda: TModel(C, image_size=(S,) * 3, feature_size=FS))


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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TLoss("mse,focal", C)
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


@pytest.mark.parametrize("model", ["diff_swin_unetr", "diff_unet"])
def test_train_step_matches_jax_value_and_grad(model):
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
    the tolerance itself."""
    rng = np.random.default_rng(0)
    image = rng.random((1, S, S, S, 1)).astype(np.float32)
    labels = np.eye(C, dtype=np.float32)[rng.integers(0, C, (1, S, S, S))]
    noise = rng.standard_normal(labels.shape).astype(np.float32)
    t = np.array([417], np.int32)
    jm, build = _models(model)
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
    dtype = torch.float64 if model == "diff_unet" else torch.float32
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


def test_trainer_runs_btcv_recipe_on_synthetic_batches():
    """``Trainer.from_config`` at a small width (feature 6) on the CPU:
    label smoothing over 14 values without background, warmup-cosine lr
    (0 at the first update), finite losses, and the keys it cannot honour
    raise."""
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
    with pytest.raises(NotImplementedError, match="validation"):
        trainer.train()
    # the same recipe trains DiffUNet (the engines' default model)
    unet = tengine.Trainer.from_config(
        cfg, train_data=data, max_epochs=1,
        **{**kw, "model_name": "diff_unet", "features": FEATURES})
    assert isinstance(unet.module, TDiffUNet)
    unet.train()
    assert len(unet.history) == 2 and np.isfinite(unet.history[-1]["loss"])
    with pytest.raises(NotImplementedError, match="swin_unetr"):
        tengine.Trainer.from_config(cfg, train_data=data,
                                    **{**kw, "model_name": "swin_unetr"})
    with pytest.raises(ValueError, match="train_data"):
        tengine.Trainer.from_config(cfg, **kw)
    seg, crit = trainer.seg, trainer.criterion
    opt, schedule = ttrain.make_optimizer(trainer.module.parameters())
    with pytest.raises(NotImplementedError, match="EMA"):
        ttrain.TrainStep(seg, crit, opt, schedule, ema_rate=0.999)
    with pytest.raises(NotImplementedError, match="loss_aware"):
        ttrain.TrainStep(seg, crit, opt, schedule, t_sampler="loss_aware")
    with pytest.raises(NotImplementedError, match="accum_steps"):
        ttrain.make_optimizer(trainer.module.parameters(), accum_steps=2)


def test_trainer_runs_amos_recipe_on_synthetic_batches():
    """``Trainer.from_config("cfg/amos/train.yaml")`` at a small width on
    the CPU: DiffUNet (the config's model), 15 classes from the 16-entry
    AMOS class table without background, one-hot labels (no smoothing),
    lr 5e-4 with 100 warmup epochs (0 at the first update), mse + bce +
    dice; finite losses, gradients and moved parameters."""
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
