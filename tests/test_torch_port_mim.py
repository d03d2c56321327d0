"""PyTorch port, HybridMIM pretraining against the JAX package on the CPU.

The six ``ops/mim.py`` functions with JAX's uniform draws pinned (exact);
``mask_region_labels`` exactly; ``HybridMIMBasicUNet`` at features (4, 4,
8, 16, 32, 4) on a batch of 2 at 32^3 with ``mask_patch`` 8 (the JAX
tests' size), both packages in float64 with the JAX model's own masks
injected into the port: every output within 1e-4 of its largest value
(``pretrained`` True and False); ``hybrid_mim_loss`` and its four terms
within 1e-4 relative, and every parameter's gradient within 1e-4 of the
largest gradient (the JAX loss casts to float32, so its gradients carry
float32 rounding); one step's parameters against ``optax.adamw(1e-3)``
on the port's gradients within 1e-6 of the lr; the second view's projection carries no gradient;
an odd patch grid raises; the saved encoder grafts into ``diff_unet``
through ``Trainer(pretrained_path=...)`` bit for bit; and
``python -m diff_unet_tpu_torch.pretrain_mim`` in a CPU subprocess.
"""
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

from diff_unet_tpu.models import hybrid_mim as jmim
from diff_unet_tpu.ops import mim as jops
from diff_unet_tpu_torch.data.synthetic import SyntheticSegmentation
from diff_unet_tpu_torch.engine.checkpoint import read_jax_npz
from diff_unet_tpu_torch.engine.engine import Trainer
from diff_unet_tpu_torch.models import hybrid_mim as tmim
from diff_unet_tpu_torch.models.basic_unet import BasicUNetEncoder
from diff_unet_tpu_torch.ops import mim as tops
from diff_unet_tpu_torch.pretrain_mim import build, pretrain, save_encoder
from diff_unet_tpu_torch.utils.weights import export_jax_params, \
    load_jax_params
from tests.test_torch_port_models import jax_f64
from tests.test_torch_port_swin import random_flax_params
from tests.test_torch_port_swin import torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
FEATS = (4, 4, 8, 16, 32, 4)
B, S, P, RATIO, LR = 2, 32, 8, 0.4, 1e-3
TOL = 1e-4                     # of the largest output or gradient
HEADS = ("pred_mask_region", "pred_mask_region_position",
         "contrast_learning_head")


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def test_patchify_round_trip_matches_jax():
    x = np.random.default_rng(0).standard_normal(
        (2, 8, 12, 4, 3)).astype(np.float32)
    want = np.asarray(jops.patchify(jnp.asarray(x), 4))
    got = tops.patchify(_t(x), 4)
    np.testing.assert_array_equal(got.numpy(), want)
    back = tops.unpatchify(got, (2, 3, 1), 4, 3)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jops.unpatchify(jnp.asarray(want),
                                                 (2, 3, 1), 4, 3)))
    np.testing.assert_array_equal(back.numpy(), x)


def test_random_masking_and_block_mask_match_jax_draws():
    """JAX's uniform draws pinned: kept tokens, mask and restore ids, and
    the voxel keep grid, exactly."""
    tokens = np.random.default_rng(1).standard_normal(
        (3, 27, 5)).astype(np.float32)
    key = jax.random.key(5)
    kept, mask, restore = jops.random_masking(jnp.asarray(tokens), key, 0.6)
    noise = np.asarray(jax.random.uniform(key, (3, 27)))
    got = tops.random_masking(_t(tokens), mask_ratio=0.6, noise=_t(noise))
    for g, w in zip(got, (kept, mask, restore)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    shape = (16, 24, 8)
    want = np.asarray(jops.block_mask(shape, key, 8, 0.5))
    cells = np.asarray(jax.random.uniform(key, (2 * 3 * 1,)))
    got = tops.block_mask(shape, patch=8, mask_ratio=0.5, noise=_t(cells))
    assert got.shape == shape
    np.testing.assert_array_equal(got.numpy(), want)
    # drawn from a generator: a 0/1 grid constant on each patch
    g = torch.Generator().manual_seed(0)
    drawn = tops.block_mask(shape, g, 8, 0.5)
    assert set(torch.unique(drawn).tolist()) <= {0.0, 1.0}
    assert torch.equal(drawn, tops.block_mask(
        shape, patch=8, mask_ratio=0.5,
        noise=drawn[::8, ::8, ::8].reshape(-1)))


def test_region_mask_labels_and_random_patch_match_jax():
    mask = (np.random.default_rng(2).random((2, 64)) > 0.5).astype(
        np.float32)
    want = np.asarray(jops.region_mask_labels(jnp.asarray(mask), 2))
    got = tops.region_mask_labels(_t(mask), 2).numpy()
    np.testing.assert_array_equal(got, want)
    # the same support on each axis (origin 0 where the patch is larger)
    vol, patch = (10, 5, 4), (8, 8, 2)
    g = torch.Generator().manual_seed(3)
    port = {tops.random_patch(vol, g, patch) for _ in range(60)}
    keys = jax.random.split(jax.random.key(3), 60)
    ref = {jops.random_patch(vol, k, patch) for k in keys}
    for axis in range(3):
        assert {o[axis] for o in port} == {o[axis] for o in ref} == set(
            range(max(vol[axis] - patch[axis], 0) + 1))


def test_mask_region_labels_exact():
    """A 4^3 patch grid in 2^3 regions: counts and the position flags in
    JAX's (rd, rh, rw) region and (sd, sh, sw) position order."""
    keep = (np.random.default_rng(4).random((2, 4, 4, 4)) > 0.4).astype(
        np.float32)
    wc, wp = jmim.mask_region_labels(jnp.asarray(keep), 2)
    gc, gp = tmim.mask_region_labels(_t(keep), 2)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    assert gc.dtype == torch.int64 and int(gc.max()) <= 8


@pytest.fixture(scope="module")
def run():
    """One JAX evaluation in float64 (jit): the outputs, loss, terms and
    gradients of the pretraining forward, the two views' masks it drew
    and the decoder-only forward; and the
    port's float64 model from the same tree, its forward with those masks
    injected and one ``MimPretrainStep``."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, S, S, S, 1)).astype(np.float32)
    key = np.asarray(jax.random.PRNGKey(3))
    jm = jmim.HybridMIMBasicUNet(features=FEATS, mask_patch=P)
    params = random_flax_params(jm, x, key, seed=1)

    def jax_side(params, x, key):
        def loss_fn(p):
            out = jm.apply(p, x, rng=key)
            loss, terms = jmim.hybrid_mim_loss(out)
            return loss, (terms, out)

        (loss, (terms, out)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        keeps = [jax.vmap(lambda k: jops.block_mask((S,) * 3, k, P, RATIO))(
            jax.random.split(r, B)) for r in jax.random.split(key)]
        plain = jmim.HybridMIMBasicUNet(features=FEATS, mask_patch=P,
                                        pretrained=False)
        sub = {"params": {k: v for k, v in params["params"].items()
                          if k not in HEADS}}
        return loss, terms, out, grads, keeps, plain.apply(sub, x)

    loss, terms, out, grads, keeps, plain = jax_f64(jax_side, params, x,
                                                    key)
    masks = tuple(_t(k) for k in keeps)
    tm = load_jax_params(tmim.HybridMIMBasicUNet(features=FEATS,
                                                 mask_patch=P),
                         params).double()
    xt = _t(x, torch.float64)
    got = tm(xt, masks=masks)
    no_grad_2 = not got["contrast_pred_2"].requires_grad
    got = {k: v.detach() for k, v in got.items()}
    tm.pretrained = False
    with torch.no_grad():
        got_plain = tm(xt)
    tm.pretrained = True
    before = {n: p.detach().numpy().copy() for n, p in tm.named_parameters()}
    metrics = tmim.MimPretrainStep(tm, lr=LR)(xt, masks=masks)
    return dict(loss=loss, terms=terms, out=out, grads=grads, plain=plain,
                got=got, got_plain=got_plain, no_grad_2=no_grad_2,
                metrics=metrics, before=before,
                port_grads=export_jax_params(tm, grads=True),
                step=[(n, p.grad.numpy(), p.detach().numpy())
                      for n, p in tm.named_parameters()])


def test_forward_matches_jax_float64(run):
    """``pretrained=True`` with the JAX model's masks injected, and
    ``pretrained=False`` (the decoder on the unmasked input)."""
    want, got = run["out"], run["got"]
    assert set(got) == set(want)
    assert got["logits"].shape == (B, 16, 16, 16, 1)
    assert got["pred_mask_region"].shape == (B, 8, 9)
    np.testing.assert_array_equal(got["mask"].numpy(), want["mask"])
    np.testing.assert_array_equal(got["mask_labels"].numpy(),
                                  want["mask_labels"])
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w, rtol=TOL,
                                   atol=TOL * np.abs(w).max(), err_msg=k)
    w = run["plain"]
    assert run["got_plain"].shape == w.shape
    np.testing.assert_allclose(run["got_plain"].numpy(), w, rtol=TOL,
                               atol=TOL * np.abs(w).max())


def test_loss_and_gradients_match_jax(run):
    m = run["metrics"]
    np.testing.assert_allclose(m["loss"].item(), run["loss"], rtol=TOL)
    for k, w in run["terms"].items():
        np.testing.assert_allclose(m[k].item(), w, rtol=TOL, err_msg=k)
    want = jax.tree_util.tree_leaves_with_path(run["grads"])
    got = run["port_grads"]
    gmax = max(np.abs(w).max() for _, w in want)
    norm = np.sqrt(sum(np.sum(np.square(w)) for _, w in want))
    np.testing.assert_allclose(m["grad_norm"].item(), norm, rtol=TOL)
    for path, w in want:
        g = got
        for p in path:
            g = g[p.key]
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL * gmax,
                                   err_msg=jax.tree_util.keystr(path))


def test_step_matches_optax_adamw(run):
    """One step's parameters against optax.adamw(1e-3) (betas (0.9,
    0.999), eps 1e-8, weight decay 1e-4 on every parameter) given the
    port's gradients (elementwise, so in the port's layout), all in
    float64, within 1e-6 of the lr. The optimizer is held apart
    from the gradients: Adam's first update lr * g / (|g| + eps) turns the
    JAX loss's float32 rounding of a gradient near eps into up to 4e-3 lr
    (2 of the 12288 contrast-head weights from the JAX gradients)."""
    names = [n for n, _, _ in run["step"]]
    with jax.enable_x64(True):
        p0 = {n: run["before"][n] for n in names}
        g = {n: grad for n, grad, _ in run["step"]}
        tx = optax.adamw(LR)
        updates, _ = tx.update(g, tx.init(p0), p0)
        want = optax.apply_updates(p0, updates)
    for n, _, got in run["step"]:
        assert np.abs(got - p0[n]).max() > 0, n
        np.testing.assert_allclose(got, want[n], rtol=0, atol=1e-6 * LR,
                                   err_msg=n)


def test_view_2_carries_no_gradient_and_drawn_masks_differ(run):
    """The second view's projection is computed under no_grad (head
    included); drawn masks differ per sample and per view."""
    assert run["no_grad_2"]
    m = tmim.HybridMIMBasicUNet(features=FEATS, mask_patch=P)
    x = torch.randn(B, S, S, S, 1, generator=torch.Generator().manual_seed(1))
    out = m(x, torch.Generator().manual_seed(2))
    assert out["contrast_pred_1"].requires_grad
    assert not out["contrast_pred_2"].requires_grad
    assert out["contrast_pred_2"].grad_fn is None
    assert not torch.equal(out["mask"][0], out["mask"][1])
    assert not torch.allclose(out["contrast_pred_1"],
                              out["contrast_pred_2"])


def test_odd_patch_grid_raises():
    m = tmim.HybridMIMBasicUNet(features=FEATS, mask_patch=P)
    x = torch.zeros(1, 24, 24, 24, 1)                  # a 3^3 patch grid
    with pytest.raises(ValueError, match="even patch grid"):
        m(x, torch.Generator().manual_seed(0))


def test_pretrain_save_and_graft_bit_for_bit(tmp_path, monkeypatch):
    """Two pretraining steps, the encoder saved as a JAX ``.npz``, then
    ``Trainer(pretrained_path=...)`` (the AMOS train config) grafts it into
    ``embed_model`` bit for bit and takes a finite step."""
    monkeypatch.chdir(tmp_path)
    model, step = build(FEATS, device="cpu")
    hist = pretrain(step, 2, 1, S, log=None)
    assert all(torch.isfinite(h["loss"]) for h in hist)
    save_encoder(model, tmp_path / "enc.npz")
    params, _, _ = read_jax_npz(tmp_path / "enc.npz")
    assert set(params) == set(tmim.ENCODER_KEYS)
    data = SyntheticSegmentation((16,) * 3, num_labels=3, batch_size=1,
                                 batches=1)
    trainer = Trainer.from_config(
        ROOT / "cfg/amos/train.yaml", train_data=data, device="cpu",
        features=FEATS, image_size=16, spatial_size=16, use_amp=False,
        batch_size=1, max_epochs=1,
        classes=str(ROOT / "cfg/msd/classes.yaml"),
        pretrained_path=str(tmp_path / "enc.npz"))
    enc = trainer.module.embed_model
    names = [n for n, _ in enc.named_parameters()]
    assert len(names) == 40
    for n in names:
        assert torch.equal(enc.get_parameter(n), model.get_parameter(n)), n
    trainer.train()
    assert np.isfinite(trainer.history[0]["loss"])


def test_entry_point_on_the_cpu(tmp_path):
    # the child's torch threads: this process's share of the cores
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               OMP_NUM_THREADS=str(torch.get_num_threads()))
    out_path = tmp_path / "enc.npz"
    out = subprocess.run(
        [sys.executable, "-m", "diff_unet_tpu_torch.pretrain_mim",
         "--steps", "2", "--batch", "1", "--size", str(S), "--features",
         *map(str, FEATS), "--device", "cpu", "--out", str(out_path)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.splitlines()
    assert [ln.split(":")[0] for ln in lines[:2]] == ["step 0", "step 1"]
    assert all(k in lines[0] for k in ("loss=", "recon=", "count_ce=",
                                       "pos_bce=", "contrast="))
    assert lines[2].startswith("2 steps in ")
    assert lines[3] == (f"encoder subtree saved to {out_path}; finetune "
                        f"with Trainer(pretrained_path={str(out_path)!r})")
    params, _, _ = read_jax_npz(out_path)
    load_jax_params(BasicUNetEncoder(FEATS), params)
