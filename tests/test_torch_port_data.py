"""PyTorch port, the NIfTI data path against the JAX package, all at
tolerance 0 (the smoothed labels at 1e-6): the NIfTI codec both ways,
``to_ras``, ``deterministic_preprocess``, ``resampled_affine`` and
``train_augment`` on one seeded generator, the Decathlon datalist, the
``DataLoader``'s validation and training batches over a synthetic NIfTI
set at the same seed and epoch, and ``LabelSmoothingCacheDataset``."""
import json
from pathlib import Path

import numpy as np
import pytest

from diff_unet_tpu.data import dataset as jds
from diff_unet_tpu.data import label_smoothing as jls
from diff_unet_tpu.data import nifti as jnifti
from diff_unet_tpu.data import transforms as jT
from diff_unet_tpu.data.datalist import load_decathlon_datalist as jdatalist
from diff_unet_tpu_torch.data import dataset as tds
from diff_unet_tpu_torch.data import label_smoothing as tls
from diff_unet_tpu_torch.data import nifti as tnifti
from diff_unet_tpu_torch.data import transforms as tT
from diff_unet_tpu_torch.data.datalist import \
    load_decathlon_datalist as tdatalist
from tests.test_torch_port_swin import torch_threads  # noqa: F401

# (shape, voxel spacing, axis flips) of the synthetic cases: one already at
# the target spacing, two resampled, one stored left-right and
# superior-inferior flipped, one thinner than a 16^3 ROI on its last axis
CASES = [((24, 24, 24), (1.5, 1.5, 2.0), (1, 1, 1)),
         ((20, 26, 18), (1.2, 1.8, 2.5), (-1, 1, -1)),
         ((22, 24, 12), (1.5, 1.5, 2.0), (1, 1, 1)),
         ((18, 20, 16), (2.0, 1.0, 1.5), (1, -1, 1))]


def synthetic_case(shape, seed, num_labels=3):
    """int16 CT in [-300, 400) HU with a body (the rest air at -1000) and
    one box per organ label; the label map of the boxes."""
    rng = np.random.default_rng(seed)
    img = rng.integers(-300, 400, shape).astype(np.int16)
    img[:2] = -1000                       # air outside the body
    lab = np.zeros(shape, np.int16)
    for c in range(1, num_labels):
        lo = rng.integers(2, [max(3, s // 2) for s in shape])
        hi = np.minimum(lo + rng.integers(3, 8, 3), shape)
        lab[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = c
        img[lab == c] = 60 * c
    return img, lab


def write_nifti_set(root: Path, cases=CASES, num_labels: int = 3,
                    writer=tnifti.write_nifti) -> Path:
    """A Decathlon set of ``cases`` under ``root``: every case is listed in
    both the training and the validation list."""
    root.mkdir(parents=True, exist_ok=True)
    items = []
    for i, (shape, spacing, flips) in enumerate(cases):
        img, lab = synthetic_case(shape, i, num_labels)
        affine = np.diag([s * f for s, f in zip(spacing, flips)] + [1.0])
        affine[:3, 3] = [-10.0 * i, 5.0, 2.5 * i]
        writer(root / f"img_{i}.nii.gz", img, affine)
        writer(root / f"lab_{i}.nii.gz", lab, affine)
        items.append({"image": f"img_{i}.nii.gz", "label": f"lab_{i}.nii.gz"})
    (root / "dataset.json").write_text(json.dumps(
        {"training": items, "validation": items,
         "test": [it["image"] for it in items]}))
    return root


@pytest.fixture(scope="module")
def nifti_set(tmp_path_factory):
    return write_nifti_set(tmp_path_factory.mktemp("nifti"))


def _rotated_affine():
    a = np.eye(4)
    th = 0.3
    a[:3, :3] = np.array([[0.0, np.cos(th), -np.sin(th)],
                          [0.0, np.sin(th), np.cos(th)],
                          [-1.0, 0.0, 0.0]]) * [1.2, 0.8, 2.5]
    a[:3, 3] = [12.5, -40.0, 7.0]
    return a


@pytest.mark.parametrize("dtype", [np.int16, np.float32, np.uint8])
@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
def test_nifti_codecs_read_each_other(tmp_path, dtype, suffix):
    data = (np.random.default_rng(0).random((7, 5, 3)) * 100).astype(dtype)
    affine = _rotated_affine()
    for i, (write, read) in enumerate([
            (jnifti.write_nifti, tnifti.read_nifti),
            (tnifti.write_nifti, jnifti.read_nifti)]):
        path = tmp_path / f"v{i}{suffix}"
        write(path, data, affine)
        img = read(path)
        assert img.data.dtype == data.dtype
        np.testing.assert_array_equal(img.data, data)
        np.testing.assert_array_equal(img.affine,
                                      affine.astype(np.float32))
        np.testing.assert_array_equal(img.spacing,
                                      jnifti.read_nifti(path).spacing)


def test_to_ras_and_preprocess_match(nifti_set):
    for i in range(len(CASES)):
        for name in ("img", "lab"):
            path = nifti_set / f"{name}_{i}.nii.gz"
            want = jnifti.to_ras(jnifti.read_nifti(path))
            got = tnifti.to_ras(tnifti.read_nifti(path))
            np.testing.assert_array_equal(got.data, want.data)
            np.testing.assert_array_equal(got.affine, want.affine)
            assert tnifti.orientation_codes(got.affine) == \
                jnifti.orientation_codes(want.affine) == ("R", "A", "S")
        img = tnifti.to_ras(tnifti.read_nifti(nifti_set / f"img_{i}.nii.gz"))
        lab = tnifti.to_ras(tnifti.read_nifti(nifti_set / f"lab_{i}.nii.gz"))
        for crop_fg in (True, False):
            want = jT.deterministic_preprocess(
                np.asarray(img.data, np.float32), img.spacing, lab.data,
                crop_fg=crop_fg)
            got = tT.deterministic_preprocess(
                np.asarray(img.data, np.float32), img.spacing, lab.data,
                crop_fg=crop_fg)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and g.shape == w.shape
                np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(
            tT.resampled_affine(img.affine, img.spacing, (1.5, 1.5, 2.0)),
            jT.resampled_affine(img.affine, img.spacing, (1.5, 1.5, 2.0)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_train_augment_matches_on_one_generator(seed):
    rng = np.random.default_rng(100 + seed)
    image = rng.random((20, 18, 26)).astype(np.float32)
    label = (rng.random((20, 18, 26)) * 3).astype(np.int16)
    got = tT.train_augment(image, label, np.random.default_rng(seed),
                           spatial_size=(16, 16, 16), num_samples=3)
    want = jT.train_augment(image, label, np.random.default_rng(seed),
                            spatial_size=(16, 16, 16), num_samples=3)
    assert len(got) == len(want) == 3
    for (gi, gl), (wi, wl) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)


@pytest.mark.parametrize("key", ["training", "validation", "test"])
def test_datalist_matches(nifti_set, key):
    got = tdatalist(nifti_set / "dataset.json", True, key)
    assert got == jdatalist(nifti_set / "dataset.json", True, key)
    assert all(Path(it["image"]).is_absolute() for it in got)
    with pytest.raises(ValueError, match="not specified"):
        tdatalist(nifti_set / "dataset.json", True, "missing")


@pytest.mark.parametrize("epoch", [0, 3])
def test_loader_batches_match(nifti_set, epoch):
    """Validation volumes and training crops (batch 2, last partial batch
    dropped) at the same seed and epoch."""
    for mode, key in (("val", "validation"), ("train", "training")):
        items = tdatalist(nifti_set / "dataset.json", True, key)
        loaders = [mod.DataLoader(
            mod.CacheDataset(items, mode=mode, num_workers=2),
            batch_size=2 if mode == "train" else 1,
            spatial_size=(16, 16, 16), seed=7, drop_last=mode == "train")
            for mod in (tds, jds)]
        for ld in loaders:
            ld.set_epoch(epoch)
        got, want = (list(ld) for ld in loaders)
        assert len(got) == len(want) == len(loaders[0])
        assert len(got) == (len(CASES) if mode == "val" else 2)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in g:
                if k == "filename":
                    assert g[k] == w[k]
                    continue
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])


def test_label_smoothing_cache_dataset_matches(nifti_set):
    items = tdatalist(nifti_set / "dataset.json", True, "training")[:2]
    kw = dict(num_classes=3, smoothing_alpha=0.2, smoothing_order=1.0,
              num_workers=2)
    got = tls.LabelSmoothingCacheDataset(items, **kw)
    want = jls.LabelSmoothingCacheDataset(items, **kw)
    for i in range(len(items)):
        g, w = got[i], want[i]
        assert g["label"].shape == w["label"].shape
        assert g["label"].shape[-1] == 3 and g["label"].dtype == np.float32
        np.testing.assert_array_equal(g["image"], w["image"])
        np.testing.assert_allclose(g["label"], w["label"], rtol=0,
                                   atol=1e-6)
    loader = tds.DataLoader(got, batch_size=2, spatial_size=(16, 16, 16),
                            seed=1, drop_last=True)
    batch = next(iter(loader))
    assert batch["label"].shape == (2, 16, 16, 16, 3)
