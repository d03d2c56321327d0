"""PyTorch port, the rest of the training path against the JAX package on
the CPU: ``update_ema`` (float32, 1e-7); the loss-aware sampler's
weights before and after warm-up, the weights of drawn timesteps and the
ring update with a repeated t (counts exact, ring at 0 tolerance);
gradient accumulation against ``optax.MultiSteps(optax.adamw)`` fed the
same gradient sequence (1e-6, the schedule's count pinned: warmup lasts
k times as many calls); a DiffUNet ``TrainStep`` with ``ema_rate``,
``accum_steps`` and ``t_sampler="loss_aware"`` against ``make_train_step``
at 16^3, features (4, 4, 8, 16, 32, 4), float64, with the JAX step's own
t and noise (loss and sampler ring 1e-6, gradients 1e-4); a small MSD
``Trainer`` with the three keys, saved and resumed bit for bit, scored by
``Tester(use_ema=True)`` on its ``.pt``; and ``python -m
diff_unet_tpu_torch.train`` on the MSD config."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from diff_unet_tpu.api import DiffusionSegmenter as JSeg
from diff_unet_tpu.diffusion import resample as jres
from diff_unet_tpu.engine import ema as jema
from diff_unet_tpu.engine import train as jtrain
from diff_unet_tpu.losses.losses import CompositeLoss as JLoss
from diff_unet_tpu.models.diff_unet import DiffUNet as JDiffUNet
from diff_unet_tpu_torch.api import DiffusionSegmenter as TSeg
from diff_unet_tpu_torch.api import PlainSegmenter
from diff_unet_tpu_torch.data.synthetic import SyntheticSegmentation
from diff_unet_tpu_torch.diffusion import resample as tres
from diff_unet_tpu_torch.engine import checkpoint as tckpt
from diff_unet_tpu_torch.engine import ema as tema
from diff_unet_tpu_torch.engine import train as ttrain
from diff_unet_tpu_torch.engine.engine import Tester as PortTester
from diff_unet_tpu_torch.engine.engine import Trainer
from diff_unet_tpu_torch.losses.losses import CompositeLoss as TLoss
from diff_unet_tpu_torch.models.diff_unet import DiffUNet as TDiffUNet
from diff_unet_tpu_torch.utils.weights import export_jax_params, \
    load_jax_params
from tests.test_torch_port_data import write_nifti_set
from tests.test_torch_port_swin import random_flax_params
from tests.test_torch_port_swin import torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
S, C, B = 16, 2, 2
FEATURES = (4, 4, 8, 16, 32, 4)
LOSSES = "mse,bce,dice,focal"


def test_update_ema_matches_jax():
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((5, 3)).astype(np.float32),
            "b": rng.standard_normal((7,)).astype(np.float32)}
    params = [{k: rng.standard_normal(v.shape).astype(np.float32)
               for k, v in tree.items()} for _ in range(3)]
    for rate in (0.9999, 0.99):
        want = jema.init_ema(jax.tree_util.tree_map(jnp.asarray, tree))
        got = tema.init_ema([torch.from_numpy(tree[k]) for k in tree])
        tracker = tema.EmaTracker([torch.from_numpy(tree[k]) for k in tree],
                                  rates=(rate, 0.5))
        for p in params:
            want = jema.update_ema(want, p, rate)
            tema.update_ema(got, [torch.from_numpy(p[k]) for k in tree],
                            rate)
            tracker.update([torch.from_numpy(p[k]) for k in tree])
        for k, e, f in zip(tree, got, tracker.get(rate)):
            assert e.dtype == torch.float32 and torch.equal(e, f)
            np.testing.assert_allclose(e.numpy(), np.asarray(want[k]),
                                       rtol=1e-7, atol=0)
        assert len(tracker.get(0.5)) == 2 and tracker.get() is tracker.ema[0]


def _states(t_count, rng, fill):
    """A JAX and a port sampler state holding the same ring and counts."""
    losses = rng.random((t_count, 10)).astype(np.float32)
    counts = np.asarray(fill, np.int32)
    j = jres.LossAwareState(jnp.asarray(losses), jnp.asarray(counts))
    t = tres.LossAwareState(torch.from_numpy(losses),
                            torch.from_numpy(counts))
    return j, t


def test_loss_aware_sampler_matches_jax():
    rng = np.random.default_rng(1)
    t_count = 6
    for fill in ([10] * 5 + [9], [10] * 6, [12, 10, 10, 11, 10, 10]):
        js, ts = _states(t_count, rng, fill)
        want = np.asarray(jres.loss_aware_weights(js))
        got = tres.loss_aware_weights(ts).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6)
        warmed = min(fill) >= 10
        assert np.allclose(got, 1 / t_count) != warmed
        # the importance weights of the JAX draw
        t, w = jres.sample_loss_aware(js, jax.random.key(3), 16)
        np.testing.assert_allclose(
            tres.weights_for(ts, torch.from_numpy(np.array(t))).numpy(),
            np.asarray(w), rtol=1e-6)
        g = torch.Generator().manual_seed(0)
        t2, w2 = tres.sample_loss_aware(ts, g, 64)
        assert t2.shape == (64,) and 0 <= int(t2.min()) <= int(t2.max()) < 6
        assert torch.equal(w2, tres.weights_for(ts, t2))
    # the ring update: empty, filling and full rows, and a repeated t whose
    # last sample in batch order wins while its count rises once
    state = jres.init_loss_aware(t_count, history=3)
    tstate = tres.init_loss_aware(t_count, history=3)
    batches = [([0, 1, 1, 2], [0.5, 1.0, 2.0, 3.0]),
               ([1, 1, 1, 5], [4.0, 5.0, 6.0, 7.0]),
               ([1, 0, 1, 0], [8.0, 9.0, 10.0, 11.0]),
               ([1, 3, 3, 1], [12.0, 13.0, 14.0, 15.0])]
    for t, losses in batches:
        state = jres.update_loss_aware(state, jnp.asarray(t),
                                       jnp.asarray(losses, jnp.float32))
        tstate = tres.update_loss_aware(tstate, torch.tensor(t),
                                        torch.tensor(losses))
        np.testing.assert_array_equal(tstate.losses.numpy(),
                                      np.asarray(state.losses))
        np.testing.assert_array_equal(tstate.counts.numpy(),
                                      np.asarray(state.counts))
    assert tstate.counts.tolist() == [2, 3, 1, 1, 0, 1]
    assert tstate.losses[1].tolist() == [6.0, 10.0, 15.0]


class _Linear:
    """A plain 'model' whose loss is sum_i <p_i, G_i>: its gradient is the
    injected G, so TrainStep meets a given gradient sequence."""

    def __init__(self, params):
        self.params = params
        self.g = None

    def __call__(self, image):
        return sum((p * g).sum() for p, g in zip(self.params, self.g)
                   ).reshape(1, 1, 1, 1, 1)


def test_accumulation_matches_optax_multisteps():
    rng = np.random.default_rng(2)
    tree = {"w": rng.standard_normal((4, 3)).astype(np.float32),
            "b": rng.standard_normal((3,)).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in tree.items()} for _ in range(6)]
    k_steps = 2
    kw = dict(lr=1e-2, weight_decay=1e-2, scheduler="warmup_cosine",
              warmup_epochs=1, max_epochs=10, steps_per_epoch=2)
    tx = jtrain.make_optimizer(accum_steps=k_steps, **kw)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    opt_state = tx.init(params)
    tparams = [torch.nn.Parameter(torch.from_numpy(tree[k].copy()))
               for k in tree]
    model = _Linear(tparams)
    opt, schedule = ttrain.make_optimizer(tparams, **kw)
    step = ttrain.TrainStep(PlainSegmenter(model, 1),
                            lambda p, lab, d: p.sum(), opt, schedule,
                            accum_steps=k_steps)
    lrs = []
    for i, g in enumerate(grads):
        updates, opt_state = tx.update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
        model.g = [torch.from_numpy(g[k]) for k in tree]
        m = step(torch.zeros(1), torch.zeros(1))
        lrs.append((m["updated"], m["lr"]))
        # the schedule's count: once per update, the same as optax's
        assert step.count == int(opt_state.gradient_step) == (i + 1) // 2
        assert step.micro == int(opt_state.mini_step)
        for k, p in zip(tree, tparams):
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(params[k]), rtol=1e-6,
                                       atol=1e-7)
            if not m["updated"]:
                np.testing.assert_allclose(
                    p.grad.numpy(), np.asarray(opt_state.acc_grads[k]),
                    rtol=1e-6, atol=1e-7)
    # steps_per_epoch counts calls, the count updates: warmup takes k times
    # as many epochs (lr 0, then half, then full at the third update)
    assert lrs == [(False, 0.0), (True, 0.0), (False, 5e-3), (True, 5e-3),
                   (False, 1e-2), (True, 1e-2)]
    with pytest.raises(ValueError, match="accum_steps"):
        ttrain.TrainStep(PlainSegmenter(model, 1), None, opt, schedule,
                         accum_steps=0)
    with pytest.raises(ValueError, match="timesteps"):
        ttrain.TrainStep(PlainSegmenter(model, 1), None, opt, schedule,
                         t_sampler="loss_aware")
    with pytest.raises(ValueError, match="t_sampler"):
        ttrain.TrainStep(PlainSegmenter(model, 1), None, opt, schedule,
                         t_sampler="importance")


def test_train_step_with_all_keys_matches_jax():
    """Four calls (two updates) of the three keys together: the JAX
    step's t (loss-aware draw) and noise are recomputed from its key and
    injected. Loss, the sampler's ring and counts at 1e-6; the grad norm
    and the accumulated gradient at 1e-4 (of the norm; of the largest
    gradient): the JAX step's own jitted and eager gradients differ by
    3.4e-5 of the norm at the fourth call (the 1^3 level's instance norms
    are degenerate), while the port agrees with the eager one to 2e-7;
    the parameters and EMA tree within Adam's sign tolerance (2 lr an
    update, times 1 - rate for the EMA): a gradient at rounding noise (a
    conv bias before an instance norm) may take the other sign."""
    rng = np.random.default_rng(0)
    lr, rate, k_steps = 2e-3, 0.9999, 2
    jm = JDiffUNet(out_channels=C, features=FEATURES)
    images = rng.random((4, B, S, S, S, 1))
    labels = np.eye(C)[rng.integers(0, C, (4, B, S, S, S))]
    labels[..., 1] *= rng.random((4, B, 1, 1, 1)) > 0.5   # empty classes
    t0 = np.zeros((B,), np.int32)
    params = random_flax_params(jm, images[0].astype(np.float32),
                                labels[0].astype(np.float32), t0, seed=1)
    okw = dict(lr=lr, weight_decay=1e-4, scheduler="warmup_cosine",
               warmup_epochs=1, max_epochs=10, steps_per_epoch=2)
    key = jax.random.key(5)
    with jax.enable_x64(True):
        seg = JSeg(module=jm, num_classes=C)
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     params)
        tx = jtrain.make_optimizer(accum_steps=k_steps, **okw)
        state = jtrain.TrainState.create(
            apply_fn=jm.apply, params=p64, tx=tx,
            ema_params=jax.tree_util.tree_map(jnp.copy, p64),
            sampler_state=jres.init_loss_aware(seg.timesteps))
        jstep = jtrain.make_train_step(seg, JLoss(LOSSES, C, fold=1),
                                       donate=False, ema_rate=rate,
                                       t_sampler="loss_aware")
        draws, records = [], []
        for i in range(4):
            t_rng, n_rng = jax.random.split(jax.random.fold_in(key, i))
            t, _ = jres.sample_loss_aware(state.sampler_state, t_rng, B)
            noise = jax.random.normal(n_rng, labels[i].shape, jnp.float64)
            draws.append((np.asarray(t), np.asarray(noise)))
            state, metrics = jstep(state, {"image": jnp.asarray(images[i]),
                                           "label": jnp.asarray(labels[i])},
                                   key)
            records.append(jax.tree_util.tree_map(np.asarray, (
                metrics, state.params, state.ema_params, state.sampler_state,
                state.opt_state.acc_grads)))

    tm = load_jax_params(TDiffUNet(C, features=FEATURES), params).double()
    opt, schedule = ttrain.make_optimizer(tm.parameters(), **okw)
    step = ttrain.TrainStep(TSeg(tm, C), TLoss(LOSSES, C), opt, schedule,
                            ema_rate=rate, t_sampler="loss_aware",
                            accum_steps=k_steps)
    names = [n for n, _ in tm.named_parameters()]
    for i, ((t, noise), (m, jp, je, js, jacc)) in enumerate(
            zip(draws, records)):
        got = step(torch.from_numpy(images[i]), torch.from_numpy(labels[i]),
                   t=torch.from_numpy(np.array(t)).long(),
                   noise=torch.from_numpy(np.array(noise)))
        assert got["updated"] == (i % 2 == 1) and step.count == (i + 1) // 2
        np.testing.assert_allclose(got["loss"].item(), m["loss"], rtol=1e-6)
        np.testing.assert_allclose(got["grad_norm"].item(), m["grad_norm"],
                                   rtol=1e-4)
        np.testing.assert_array_equal(step.sampler_state.counts.numpy(),
                                      js.counts)
        np.testing.assert_allclose(step.sampler_state.losses.numpy(),
                                   js.losses, rtol=1e-6, atol=0)
        updates = step.count
        trees = [(export_jax_params(tm), jp, 2 * lr * updates)]
        with torch.no_grad():
            shadow = TDiffUNet(C, features=FEATURES).double()
            for p, e in zip(shadow.parameters(), step.ema):
                p.copy_(e)
        trees.append((export_jax_params(shadow), je,
                      2 * lr * updates * (1 - rate) + 1e-12))
        if not got["updated"]:
            for p, g in zip(tm.parameters(), step.params):
                p.grad = g.grad
            acc = jax.tree_util.tree_leaves(jacc)
            scale = max(float(np.abs(a).max()) for a in acc)
            trees.append((export_jax_params(tm, grads=True),
                          {"params": jacc["params"]}, 1e-4 * scale))
        for mine, theirs, atol in trees:
            want = dict(jax.tree_util.tree_leaves_with_path(theirs))
            have = dict(jax.tree_util.tree_leaves_with_path(mine))
            assert have.keys() == want.keys()
            for k, w in want.items():
                np.testing.assert_allclose(have[k], w, rtol=1e-6, atol=atol,
                                           err_msg=jax.tree_util.keystr(k))
    assert len(names) == len(step.ema)


@pytest.fixture(scope="module")
def msd_set(tmp_path_factory):
    """A Decathlon set of 2 NIfTI cases with the MSD task's 3 label
    values."""
    return write_nifti_set(tmp_path_factory.mktemp("msd"))


MSD_SMALL = dict(device="cpu", features=FEATURES, image_size=S,
                 spatial_size=S, use_amp=False, timesteps=100,
                 sample_steps=2, sw_batch_size=2,
                 classes=str(ROOT / "cfg/msd/classes.yaml"))


def test_trainer_keys_resume_bit_for_bit_and_tester_use_ema(
        msd_set, tmp_path, monkeypatch):
    """``cfg/msd/train.yaml`` (focal among its losses) with ema_rate,
    accum_steps 2 and the loss-aware sampler, 3 calls an epoch, so each
    epoch's checkpoint holds half an accumulation; 2 epochs straight,
    then resumed from epoch_1.pt: the same parameters, EMA tree, sampler
    state and accumulated gradient, bit for bit. Then the Tester scores
    the EMA tree of epoch_2.pt, which ``export_npz`` also writes as the
    JAX ``.npz``'s ema_params."""
    monkeypatch.chdir(tmp_path)
    cfg = ROOT / "cfg/msd/train.yaml"
    data = SyntheticSegmentation((S,) * 3, num_labels=3, batch_size=2,
                                 batches=3, seed=4)
    kw = dict(train_data=data, batch_size=2, max_epochs=2, save_freq=1,
              val_freq=100, ema_rate=0.99, accum_steps=2,
              t_sampler="loss_aware", **MSD_SMALL)
    straight = Trainer.from_config(cfg, log_dir="a", **kw)
    assert straight.criterion.names == ["mse", "bce", "dice", "focal"]
    straight.train()
    # the lr of each call's pending update: updates 0, 1, 2 on calls 2, 4, 6
    assert [h["lr"] > 0 for h in straight.history] == [False] * 2 + [True] * 4
    resumed = Trainer.from_config(
        cfg, log_dir="b", model_path="logs/a/weights/epoch_1", **kw)
    assert resumed.train_step.micro == 1 and resumed.start_epoch == 1
    resumed.train()
    a, b = straight.train_step, resumed.train_step
    assert a.count == b.count == 3 and a.micro == b.micro == 0
    for x, y in zip(straight.module.parameters(), resumed.module.parameters()):
        assert torch.equal(x, y) and torch.equal(x.grad, y.grad)
    for x, y in zip(a.ema, b.ema):
        assert torch.equal(x, y)
    assert torch.equal(a.sampler_state.losses, b.sampler_state.losses)
    assert torch.equal(a.sampler_state.counts, b.sampler_state.counts)
    assert int(a.sampler_state.counts.sum()) > 0

    tester = PortTester.from_config(
        ROOT / "cfg/msd/test.yaml", data_path=str(msd_set), use_ema=True,
        model_path="logs/a/weights/epoch_2", log_dir="t", **MSD_SMALL)
    for p, e in zip(tester.module.parameters(), a.ema):
        assert torch.equal(p, e)
    results = tester.test()
    d = np.asarray(results["dices"])
    assert d.shape == (len(tester.dataloader["val"]), 2)
    assert np.all((d >= 0) & (d <= 1))
    tckpt.export_npz("logs/a/weights/epoch_2.pt", "e.npz", tester.module)
    params, ema, meta = tckpt.read_jax_npz("e.npz")
    assert meta["epoch"] == 2
    want = export_jax_params(tester.module)
    jax.tree_util.tree_map(np.testing.assert_array_equal, ema, want)
    with pytest.raises(AssertionError):
        jax.tree_util.tree_map(np.testing.assert_array_equal, params, want)


def test_msd_entry_point_trains_on_the_cpu(msd_set, tmp_path):
    # the child's torch threads: this process's share of the cores
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               OMP_NUM_THREADS=str(torch.get_num_threads()))
    out = subprocess.run(
        [sys.executable, "-m", "diff_unet_tpu_torch.train", "--config",
         str(ROOT / "cfg/msd/train.yaml"), f"data_path={msd_set}",
         f"classes={ROOT / 'cfg/msd/classes.yaml'}", "device=cpu",
         "image_size=16", "spatial_size=16", "batch_size=2",
         "features=[4, 4, 8, 16, 32, 4]", "use_amp=false", "max_epochs=1",
         "val_freq=1", "save_freq=1", "sw_batch_size=2", "timesteps=100",
         "sample_steps=2", "log_dir=msd"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "mean_dice :" in out.stdout
    assert (tmp_path / "logs/msd/weights/epoch_1.pt").exists()
