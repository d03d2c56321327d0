"""PyTorch port, the whole loss registry against the JAX package on the
CPU: each of the 14 names, value and gradient with respect to the logits
(``jax.value_and_grad`` against autograd), in float64 at 1e-10 relative
(gradients at 1e-10 of max(max |g|, 1/N), N the element count: a mean
loss's gradient scale). ``hausdorff_er`` casts (preds - labels)^2 to
float32 in both packages, so it is held at 1e-5. Shapes (2, 8, 8, 8, C),
C 2 and 4, three labellings each: every class present, one class empty,
every voxel background (no foreground channel set). ``boundary`` takes
each package's signed distance maps of the labels, which agree at 1e-6
(float32); ``CompositeLoss`` over all names with each ``combine``."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diff_unet_tpu.losses import edt as jedt
from diff_unet_tpu.losses import losses as jl
from diff_unet_tpu_torch.losses import edt as tedt
from diff_unet_tpu_torch.losses import losses as tl
from tests.test_torch_port_swin import torch_threads  # noqa: F401

SHAPE = (2, 8, 8, 8)
F32_NAMES = ("hausdorff_er",)


def _labellings(c, seed=0):
    """Every class present; class c-1 empty; every voxel background."""
    rng = np.random.default_rng(seed)
    full = np.eye(c)[rng.integers(0, c, SHAPE)]
    empty = full.copy()
    empty[..., -1] = 0.0
    return [full, empty, np.zeros(SHAPE + (c,))]


def _dist_maps(jax_side, labels):
    fn = jedt.signed_distance_maps if jax_side else tedt.signed_distance_maps
    return np.stack([np.moveaxis(fn(np.moveaxis(lab, -1, 0)), 0, -1)
                     for lab in labels]).astype(np.float64)


def _jax_fn(name):
    if name == "boundary":
        return lambda p, lab, d: jl.boundary_loss(p, d)
    if name == "generalized_wasserstein_dice":
        return lambda p, lab, d: jl.generalized_wasserstein_dice_loss(
            p, jnp.argmax(lab, -1))
    return lambda p, lab, d: jl._SIMPLE[name](p, lab)


def _torch_fn(name):
    if name == "boundary":
        return lambda p, lab, d: tl.boundary_loss(p, d)
    if name == "generalized_wasserstein_dice":
        return lambda p, lab, d: tl.generalized_wasserstein_dice_loss(
            p, torch.argmax(lab, -1))
    return lambda p, lab, d: tl._LOSSES[name](p, lab)


def _port_value_and_grad(fn, preds, labels, dist):
    p = torch.from_numpy(preds).requires_grad_()
    value = fn(p, torch.from_numpy(labels), torch.from_numpy(dist))
    grad = (torch.autograd.grad(value, p)[0] if value.requires_grad
            else None)             # argmax-only losses carry no gradient
    return value.item(), (np.zeros_like(preds) if grad is None
                          else grad.numpy())


def _check(got, want, rtol, n):
    (gv, gg), (wv, wg) = got, want
    np.testing.assert_allclose(gv, float(wv), rtol=rtol, atol=rtol * 1e-3)
    wg = np.asarray(wg)
    scale = max(float(np.abs(wg).max()), 1.0 / n)
    np.testing.assert_allclose(gg, wg, rtol=rtol, atol=rtol * scale)


def test_registry_names_match_jax():
    assert set(tl.LOSS_NAMES) == set(jl._SIMPLE) | {
        "boundary", "generalized_wasserstein_dice"}
    assert len(tl.LOSS_NAMES) == 14


@pytest.mark.parametrize("c", [2, 4])
@pytest.mark.parametrize("name", sorted(tl.LOSS_NAMES))
def test_loss_value_and_gradient_match_jax(name, c):
    rng = np.random.default_rng(c)
    preds = 2.0 * rng.standard_normal(SHAPE + (c,))
    rtol = 1e-5 if name in F32_NAMES else 1e-10
    jfn = _jax_fn(name)
    with jax.enable_x64(True):
        want_fn = jax.jit(jax.value_and_grad(jfn))
        for labels in _labellings(c):
            dist = (_dist_maps(True, labels) if name == "boundary"
                    else np.zeros_like(labels))
            want = want_fn(jnp.asarray(preds), jnp.asarray(labels),
                           jnp.asarray(dist))
            if name == "boundary":
                dist = _dist_maps(False, labels)
            got = _port_value_and_grad(_torch_fn(name), preds, labels, dist)
            _check(got, want, rtol, preds.size)


def test_signed_distance_maps_match_jax():
    for labels in _labellings(4, seed=3):
        for lab in labels:
            onehot = np.moveaxis(lab, -1, 0)
            want = jedt.signed_distance_maps(onehot)
            got = tedt.signed_distance_maps(onehot)
            assert got.dtype == np.float32 and got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    batch = _labellings(2)[1]
    np.testing.assert_array_equal(
        tedt.batch_dist_maps(batch),
        np.stack([np.moveaxis(tedt.one_hot_to_dist(np.moveaxis(b, -1, 0)),
                              0, -1) for b in batch]))


@pytest.mark.parametrize("combine", ["sum", "mean", "log"])
def test_composite_loss_over_all_names_matches_jax(combine):
    c = 4
    names = ",".join(sorted(tl.LOSS_NAMES))
    rng = np.random.default_rng(7)
    preds = 2.0 * rng.standard_normal(SHAPE + (c,))
    labels = _labellings(c, seed=7)[1]
    jloss = jl.CompositeLoss(names, c, combine, fold=1)
    with jax.enable_x64(True):
        want = jax.jit(jax.value_and_grad(jloss))(
            jnp.asarray(preds), jnp.asarray(labels),
            jnp.asarray(_dist_maps(True, labels)))
    got = _port_value_and_grad(tl.CompositeLoss(names, c, combine), preds,
                               labels, _dist_maps(False, labels))
    # hausdorff_er's float32 term bounds the agreement of the sum
    _check(got, want, 1e-6, preds.size)


def test_composite_loss_needs_dist_maps_for_boundary():
    loss = tl.CompositeLoss("mse,boundary", 2)
    assert loss.needs_dist_maps
    assert not tl.CompositeLoss("mse,focal", 2).needs_dist_maps
    x = torch.zeros(1, 2, 2, 2, 2)
    with pytest.raises(ValueError, match="dist_maps"):
        loss(x, x)
    assert torch.isfinite(loss(x, x, x))
