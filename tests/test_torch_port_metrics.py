"""PyTorch port, the metrics against the JAX package: the device metrics
(``dice_coeff``, ``dice_per_class``, ``validation_dice``, ``iou``) on
random, empty and full masks to 1e-6; every ``ALL_METRICS`` name, NaN for
NaN; HD95, HD and the average surface distances to 1e-5 relative; and the
built distance transform (``ops/edt.py``) against
``scipy.ndimage.distance_transform_edt`` to 1e-5 absolute."""
import numpy as np
import pytest
import torch
from scipy import ndimage

import jax.numpy as jnp

from diff_unet_tpu.metrics import metrics as jm
from diff_unet_tpu_torch.metrics import metrics as tm
from diff_unet_tpu_torch.ops import edt
from tests.test_torch_port_swin import torch_threads  # noqa: F401

SHAPE = (14, 12, 10)


def _masks(kind: str, seed: int = 0, c: int = 4):
    """(outputs, labels) one-hot-like float masks (..., C) of a kind."""
    rng = np.random.default_rng(seed)
    out = (rng.random((*SHAPE, c)) < 0.3).astype(np.float32)
    lab = (rng.random((*SHAPE, c)) < 0.3).astype(np.float32)
    if kind == "empty_label":        # channel 1 predicted, label empty
        lab[..., 1] = 0
    elif kind == "empty_both":
        out[..., 2] = lab[..., 2] = 0
    elif kind == "full":
        out[..., 0] = lab[..., 0] = 1
        out[..., 3] = 0
    return out, lab


@pytest.mark.parametrize("kind", ["random", "empty_label", "empty_both",
                                  "full"])
@pytest.mark.parametrize("dtype", [np.float32, np.bool_])
def test_device_metrics_match(kind, dtype):
    out, lab = (a.astype(dtype) for a in _masks(kind))
    to, tl = torch.from_numpy(out), torch.from_numpy(lab)
    jo, jl = jnp.asarray(out), jnp.asarray(lab)
    for name in ("dice_per_class", "validation_dice"):
        got = getattr(tm, name)(to, tl)
        want = np.asarray(getattr(jm, name)(jo, jl))
        assert got.shape == want.shape == (out.shape[-1],)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    for c in range(out.shape[-1]):
        for name in ("dice_coeff", "iou"):
            got = getattr(tm, name)(to[..., c], tl[..., c])
            want = float(getattr(jm, name)(jo[..., c], jl[..., c]))
            assert abs(float(got) - want) <= 1e-6, (name, c)
    if kind == "empty_label":
        assert float(tm.validation_dice(to, tl)[1]) == 1.0


def _registry_pairs():
    rng = np.random.default_rng(3)
    a = rng.random(SHAPE) < 0.4
    b = ndimage.binary_dilation(a) & (rng.random(SHAPE) < 0.9)
    empty = np.zeros(SHAPE, bool)
    full = np.ones(SHAPE, bool)
    return {"random": (a, b), "empty_test": (empty, b),
            "empty_ref": (a, empty), "both_empty": (empty, empty),
            "full_ref": (a, full), "full_test": (full, b)}


@pytest.mark.parametrize("name", sorted(jm.ALL_METRICS))
def test_all_metrics_registry_matches(name):
    assert sorted(tm.ALL_METRICS) == sorted(jm.ALL_METRICS)
    for case, (t, r) in _registry_pairs().items():
        for nan_for in (True, False):
            kw = dict(test=t, reference=r, nan_for_nonexisting=nan_for)
            if "Distance" in name:
                kw["voxel_spacing"] = (1.5, 1.0, 2.0)
            got = tm.ALL_METRICS[name](**kw)
            want = jm.ALL_METRICS[name](**kw)
            if np.isnan(want):
                assert np.isnan(got), (case, nan_for, got)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-5,
                                           err_msg=f"{case} {nan_for}")


@pytest.mark.parametrize("spacing", [None, (1.5, 1.5, 2.0), (0.7, 2.0, 1.1)])
@pytest.mark.parametrize("seed", [0, 1])
def test_surface_distances_match(spacing, seed):
    rng = np.random.default_rng(seed)
    shape = (20, 18, 16)
    a = ndimage.binary_dilation(rng.random(shape) < 0.02, iterations=2)
    b = ndimage.binary_dilation(rng.random(shape) < 0.02, iterations=2)
    for fn in ("hausdorff_distance", "hausdorff_distance_95",
               "average_surface_distance",
               "average_symmetric_surface_distance"):
        got = getattr(tm, fn)(a, b, spacing)
        want = getattr(jm, fn)(a, b, spacing)
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=fn)
    assert np.isnan(tm.hausdorff_distance_95(a, np.zeros(shape, bool)))
    cm = tm.ConfusionMatrix(a, b)
    assert cm.get_matrix() == jm.ConfusionMatrix(a, b).get_matrix()
    assert cm.get_existence() == jm.ConfusionMatrix(a, b).get_existence()


@pytest.mark.parametrize("spacing", [None, (1.0, 1.0, 1.0), (1.5, 1.5, 2.0),
                                     (0.8, 2.5, 1.3)])
@pytest.mark.parametrize("shape", [(24, 24, 24), (7, 31, 13), (1, 9, 40)])
def test_edt_matches_scipy(spacing, shape):
    rng = np.random.default_rng(sum(shape))
    mask = rng.random(shape) > 0.05
    got = edt.distance_transform_edt(mask, spacing)
    want = ndimage.distance_transform_edt(mask, sampling=spacing)
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="3D"):
        edt.distance_transform_edt(mask[0])
