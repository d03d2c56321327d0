"""PyTorch port, the evaluation path on the CPU at a small size (16^3 ROI,
features (4, 4, 8, 16, 32, 4), DDIM-2): the ``Tester`` end to end on a
synthetic NIfTI set (one case thinner than the ROI) from a checkpoint
saved with ``save_jax_npz``; each case's dices, HD95s and IoUs equal the
JAX package's functions applied to the port's own outputs and labels (the
random streams of the two packages cannot be matched, so the outputs
themselves are the port's); ``results.pkl`` holds numpy arrays of the
keys, lengths, dtypes and shapes the JAX Tester's holds; ``continuous``
is stored; and ``python -m diff_unet_tpu_torch.test`` and ``.predict`` in a
subprocess with ``device=cpu`` (the labelmap holds only class ids, and its
affine is the one ``predict.py`` computes)."""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from diff_unet_tpu.data.nifti import read_nifti as jread_nifti
from diff_unet_tpu.metrics import metrics as jm
from diff_unet_tpu_torch.data.nifti import read_nifti
from diff_unet_tpu_torch.engine.checkpoint import save_jax_npz
from diff_unet_tpu_torch.engine.engine import Tester as PortTester
from diff_unet_tpu_torch.models.model_hub import create_model
from diff_unet_tpu_torch.utils.vis import render_results
from diff_unet_tpu_torch.utils.weights import export_jax_params, \
    init_random
from tests.test_torch_port_data import write_nifti_set
from tests.test_torch_port_swin import torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
FEATURES = (4, 4, 8, 16, 32, 4)
COMMON = dict(image_size=16, spatial_size=16, batch_size=2, sw_batch_size=2,
              overlap=0.25, timesteps=100, sample_steps=2,
              features=FEATURES, num_workers=2, use_amp=False, device="cpu")


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """A NIfTI set of 4 cases and 2 organ classes, and an .npz checkpoint
    of seeded weights."""
    root = tmp_path_factory.mktemp("tester")
    data = write_nifti_set(root / "data")
    classes = root / "classes.yaml"
    classes.write_text("0: background\n1: organ_a\n2: organ_b\n")
    module = init_random(create_model("diff_unet", out_channels=2,
                                      features=FEATURES), 11)
    save_jax_npz(root / "epoch_4.npz", export_jax_params(module),
                 meta={"epoch": 4})
    return root, data, classes


def _no_tensors(obj):
    if isinstance(obj, dict):
        return all(_no_tensors(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return all(_no_tensors(v) for v in obj)
    return not isinstance(obj, torch.Tensor)


def test_tester_end_to_end(workspace, tmp_path, monkeypatch):
    root, data, classes = workspace
    monkeypatch.chdir(tmp_path)
    tester = PortTester(model_name="diff_unet", data_path=str(data),
                    classes=str(classes), model_path=str(root / "epoch_4"),
                    log_dir="t", **COMMON)
    assert tester.epoch == 4 and tester.num_classes == 2
    results = tester.test()
    n = 4
    for key in ("dices", "hd95s", "ious", "filenames", "images", "outputs",
                "labels"):
        assert len(results[key]) == n, key
    d = np.asarray(results["dices"])
    assert d.shape == (n, 2) and np.all((d >= 0) & (d <= 1))
    assert results["images"][0].dtype == np.float16
    assert results["outputs"][0].dtype == np.bool_
    assert results["labels"][0].dtype == np.bool_
    shapes = [r.shape for r in results["outputs"]]
    assert any(min(s[:3]) < 16 for s in shapes)   # thinner than the ROI
    for img, out, lab in zip(results["images"], results["outputs"],
                             results["labels"]):
        assert out.shape == lab.shape == img.shape + (2,)
    with open(tmp_path / "logs/t/results.pkl", "rb") as f:
        saved = pickle.load(f)
    assert _no_tensors(saved) and saved.keys() == results.keys()
    np.testing.assert_array_equal(np.asarray(saved["dices"]), d)
    # the metrics are the JAX Tester's functions of the port's outputs
    for i, (out, lab) in enumerate(zip(results["outputs"],
                                       results["labels"])):
        want = np.asarray(jm.validation_dice(jnp.asarray(out),
                                             jnp.asarray(lab)))
        np.testing.assert_allclose(results["dices"][i], want, rtol=0,
                                   atol=1e-6)
        for c in range(2):
            o, g = out[..., c], lab[..., c]
            hd = (jm.hausdorff_distance_95(o, g) if o.any() and g.any()
                  else float("nan"))
            np.testing.assert_allclose(results["hd95s"][i][c], hd,
                                       rtol=1e-5)
            assert results["ious"][i][c] == pytest.approx(
                jm.jaccard(o, g, nan_for_nonexisting=False), abs=1e-12)
    assert len(tester.case_seconds) == n
    assert set(tester.case_seconds[0]) == {
        "inference", "dice_device", "hd95_iou_host", "recording"}
    cases = (tmp_path / "t/cases.jsonl").read_text().splitlines()
    assert len(cases) == n
    assert isinstance(render_results(tmp_path / "logs/t/results.pkl",
                                     tmp_path / "vis", 2), int)

    lite = PortTester(model_name="diff_unet", data_path=str(data),
                  classes=str(classes), model_path=str(root / "epoch_4"),
                  log_dir="t-lite", save_volumes=False, **COMMON).test()
    assert lite["images"] == [] and lite["outputs"] == []
    np.testing.assert_array_equal(np.asarray(lite["dices"]), d)


def test_tester_config_keys(workspace, tmp_path, monkeypatch):
    root, data, classes = workspace
    kw = dict(data_path=str(data), classes=str(classes), **COMMON)
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    with pytest.raises(ValueError, match="data_path"):
        PortTester(**{**kw, "data_path": None})
    with pytest.raises(ValueError, match="ema_params"):
        PortTester(model_path=str(root / "epoch_4"), use_ema=True, **kw)
    # a construction that fails writes no log directory
    assert not any(cwd.iterdir())
    # continuous: the Tester stores it (tests/test_torch_port_serving.py
    # serves with it)
    assert PortTester(continuous=1, **kw).continuous == 1


def _run(module, args, cwd):
    # the child's torch threads: this process's share of the cores
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               OMP_NUM_THREADS=str(torch.get_num_threads()))
    out = subprocess.run(
        [sys.executable, "-m", module, "--config",
         str(ROOT / "cfg/amos/test.yaml"), *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def test_entry_points_run_on_the_cpu(workspace, tmp_path):
    root, data, classes = workspace
    common = [f"data_path={data}", f"model_path={root / 'epoch_4'}",
              f"classes={classes}", "device=cpu", "image_size=16",
              "spatial_size=16", "sw_batch_size=2", "timesteps=100",
              "sample_steps=2", "features=[4, 4, 8, 16, 32, 4]",
              "use_amp=false"]
    stdout = _run("diff_unet_tpu_torch.test", [*common, "log_dir=cli"],
                  tmp_path)
    assert "mean dice :" in stdout
    assert (tmp_path / "logs/cli/results.pkl").exists()

    src = data / "img_1.nii.gz"      # flipped, resampled on the way in
    out_path = tmp_path / "seg.nii.gz"
    _run("diff_unet_tpu_torch.predict",
         [*common, f"input={src}", f"output={out_path}"], tmp_path)
    seg = read_nifti(out_path)
    assert seg.data.dtype == np.int16
    assert set(np.unique(seg.data)) <= {0, 1, 2}
    from predict import _load_preprocessed
    vol, affine = _load_preprocessed(src)
    assert seg.data.shape == vol.shape[:3]
    np.testing.assert_array_equal(seg.affine, affine.astype(np.float32))
    np.testing.assert_array_equal(jread_nifti(out_path).data, seg.data)
