"""PyTorch port, cross-volume continuous window batching
(``engine/serving.py``) against the JAX ``ContinuousBatchingInferer`` on
the CPU at a 16^3 ROI:

- ``_po2_chain`` equals JAX's for n 0-40 and unit 1-16;
- over a mixed-shape stream (4, 8 and 1 windows, and a volume thinner
  than the ROI) at unit 8 and 4, each side's injected predictor receives
  the same batches, window for window, and the stitched logits agree
  within 1e-5 (constant and gaussian blending) with a predictor that
  subtracts its batch's mean, so that batch composition shows;
- a generator is pulled lazily and gives the list's answers, seeds reach
  the predictor per window, and ``on_result`` streams;
- ``Engine.serve_volumes`` equals ``infer`` per volume for DiffUNet
  (float32) and rebuilds its inferer when ``sw_batch_size`` changes;
- ``Tester(continuous=2)`` scores three NIfTI cases as the serial
  ``Tester`` does;
- AttentionDiffUNet (batch statistics at eval) served continuously
  equals the JAX continuous answer with noise injected as a function of
  each window's voxels (the port in float64, JAX's DDIM loop in float32;
  1e-4 of max |y|), and differs from the serial answer;
- ``predict.main`` with three inputs writes the labelmaps of three
  single-input runs.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diff_unet_tpu.api import DiffusionSegmenter as JSeg
from diff_unet_tpu.diffusion import sampling as jsampling
from diff_unet_tpu.engine import serving as jsv
from diff_unet_tpu.models import attention_diff_unet as ja
from diff_unet_tpu_torch import predict as tpredict
from diff_unet_tpu_torch.api import DiffusionSegmenter as TSeg
from diff_unet_tpu_torch.data.nifti import read_nifti
from diff_unet_tpu_torch.engine import serving as tsv
from diff_unet_tpu_torch.engine import sliding_window as tsw
from diff_unet_tpu_torch.engine.engine import Predictor
from diff_unet_tpu_torch.engine.engine import Tester as PortTester
from diff_unet_tpu_torch.models.model_hub import create_model
from diff_unet_tpu_torch.utils.weights import load_jax_params
from tests.test_torch_port_data import CASES, write_nifti_set
from tests.test_torch_port_swin import random_flax_params
from tests.test_torch_port_train import BatchStatsNorm64
from tests.test_torch_port_swin import torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
ROI = (16, 16, 16)
# 4, 8, 1 and 1 windows of the 16^3 ROI; the last is thinner than it
SHAPES = [(20, 20, 16), (20, 20, 20), (16, 16, 16), (12, 16, 10)]
TINY = dict(model_name="diff_unet", features=(4, 4, 8, 16, 32, 4),
            image_size=16, spatial_size=16, sample_steps=2, use_amp=False,
            device="cpu", seed=5)


class _Seg:
    """What an inferer reads of a segmenter when its predictor is given."""
    num_classes = 2


def _volumes(seed, shapes=SHAPES, channels=2):
    rng = np.random.default_rng(seed)
    return [rng.random((*s, channels)).astype(np.float32) for s in shapes]


def test_po2_chain_matches_jax():
    for unit in range(1, 17):
        for n in range(41):
            assert tsv._po2_chain(n, unit) == jsv._po2_chain(n, unit)


@pytest.mark.parametrize("unit,mode", [(8, "constant"), (4, "gaussian")])
def test_batches_and_stitch_match_jax(unit, mode):
    """Both sides see the same windows in the same batches (unit 8: 8, 4
    and 2, the first mixing two volumes; unit 4: 4, 4, 4, 2), as ``plan``
    predicts; the logits agree within 1e-5 and so do the binaries wherever
    the logit is not within 1e-5 of 0."""
    vols = _volumes(0)
    seen = {"jax": [], "port": []}

    def jpred(params, w, keys):
        seen["jax"].append(np.asarray(w))
        return w * 2.0 - jnp.mean(w)

    jcb = jsv.ContinuousBatchingInferer(_Seg(), roi=ROI, unit=unit,
                                        mode=mode)
    jcb._predict = jpred        # not jitted, so that it sees each batch
    want = jcb.serve(None, [jnp.asarray(v) for v in vols],
                     jax.random.key(0))

    def tpred(w, starts, seeds):
        seen["port"].append(w.numpy().copy())
        return w * 2.0 - w.mean()

    tcb = tsv.ContinuousBatchingInferer(_Seg(), roi=ROI, unit=unit,
                                        mode=mode, predictor=tpred)
    got = tcb.serve([torch.from_numpy(v) for v in vols], seed=0)
    sizes = [len(b) for b in tcb.plan(SHAPES)]
    assert sizes == {8: [8, 4, 2], 4: [4, 4, 4, 2]}[unit]
    assert [len(b) for b in seen["port"]] == sizes
    assert len(seen["jax"]) == len(sizes)
    for a, b in zip(seen["port"], seen["jax"]):
        np.testing.assert_array_equal(a, b)
    for v, (gl, gb), (wl, wb) in zip(vols, got, want):
        assert gl.shape == gb.shape == v.shape
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=1e-5,
                                   atol=1e-5)
        sure = np.abs(np.asarray(wl)) > 1e-5
        np.testing.assert_array_equal(gb.numpy()[sure],
                                      np.asarray(wb)[sure])


def test_generator_is_pulled_lazily_seeds_reach_windows_and_streams():
    """A generator gives the list's answers; a volume is pulled only when
    fewer than ``unit`` windows are pending (2 volumes before the first
    batch of 8, all 4 before the second); each window's seed is its
    volume's: ``volume_seed(seed, i)`` by default, else ``seeds``'s;
    ``on_result`` receives every volume and the list keeps None."""
    vols = [torch.from_numpy(v) for v in _volumes(1)]
    pulled, calls = [], []

    def tpred(w, starts, seeds):
        calls.append((len(pulled), list(seeds)))
        return w * 2.0 - w.mean()

    cb = tsv.ContinuousBatchingInferer(_Seg(), roi=ROI, unit=8,
                                       predictor=tpred)
    ref = cb.serve(vols, seed=7)
    want_seeds = [s for i, v in enumerate(vols)
                  for s in [tsw.volume_seed(7, i)] * len(cb.starts(v.shape))]
    assert [s for _, seeds in calls for s in seeds] == want_seeds
    assert len(set(want_seeds)) == len(vols)

    def stream():
        for i, v in enumerate(vols):
            pulled.append(i)
            yield v

    calls.clear()
    streamed = {}
    out = cb.serve(stream(), seed=7, seeds=lambda i: 100 + i,
                   on_result=lambda i, lg, bn: streamed.setdefault(i, (lg,
                                                                       bn)))
    assert [n for n, _ in calls] == [2, 4, 4]
    assert [s for _, seeds in calls for s in seeds] == \
        [100 + i for i, v in enumerate(vols) for _ in cb.starts(v.shape)]
    assert out == [None] * len(vols) and sorted(streamed) == [0, 1, 2, 3]
    for i, (lg, bn) in enumerate(ref):
        assert torch.equal(streamed[i][0], lg)
        assert torch.equal(streamed[i][1], bn)


def test_engine_serve_volumes_matches_infer_and_rebuilds():
    """DiffUNet, float32: with the engine seed for every volume each
    answer equals ``infer``'s within 1e-4 (a batch of 1 rounds the CPU's
    convs otherwise than a batch of 2; the noise is the same); the
    inferer is kept while the config holds and rebuilt when
    ``sw_batch_size`` changes."""
    pred = Predictor(sw_batch_size=2, **TINY)
    # 1, 8 and 4 windows: batches of 2 that mix volumes, then a tail of 1
    vols = [torch.from_numpy(v) for v in _volumes(
        2, [(16, 16, 16), (20, 20, 20), (18, 19, 10)], channels=1)]
    served = pred.serve_volumes(vols, seeds=[pred.seed] * len(vols))
    assert [len(b) for b in pred._continuous.plan(
        [v.shape[:3] for v in vols])] == [2] * 6 + [1]
    for vol, (logits, binary) in zip(vols, served):
        want, want_bin = pred.infer(vol)
        assert logits.shape == binary.shape == want.shape
        np.testing.assert_allclose(logits.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-4)
        assert torch.equal(binary, (torch.sigmoid(logits) > 0.5).float())
    first = pred._continuous
    assert first.unit == 2
    pred.serve_volumes(vols[:1])
    assert pred._continuous is first
    pred.sw_batch_size = 4
    pred.serve_volumes(vols[:1])
    assert pred._continuous is not first and pred._continuous.unit == 4


def test_tester_continuous_matches_serial(tmp_path, monkeypatch):
    """Three NIfTI cases, two groups (2 + 1): the same dices, HD95s and
    IoUs as the serial Tester (1e-4), each case's inference seconds the
    group's shared out by windows."""
    data = write_nifti_set(tmp_path / "data", CASES[:3])
    classes = tmp_path / "classes.yaml"
    classes.write_text("0: background\n1: organ_a\n2: organ_b\n")
    monkeypatch.chdir(tmp_path)
    common = dict(data_path=str(data), classes=str(classes),
                  sw_batch_size=2, save_volumes=False, num_workers=1, **TINY)
    serial = PortTester(log_dir="serial", **common).test()
    tester = PortTester(log_dir="cont", continuous=2, **common)
    assert tester.continuous == 2
    cont = tester.test()
    assert cont["filenames"] == serial["filenames"]
    for key in ("dices", "ious", "hd95s"):
        np.testing.assert_allclose(np.asarray(cont[key], np.float64),
                                   np.asarray(serial[key], np.float64),
                                   rtol=1e-4, atol=1e-4, equal_nan=True)
    ds = tester.dataloader["val"].dataset
    windows = [len(tester._continuous.starts(ds[i]["image"].shape[:3]))
               for i in range(2)]
    secs = [s["inference"] for s in tester.case_seconds]
    assert len(secs) == 3
    assert secs[0] / secs[1] == pytest.approx(windows[0] / windows[1])


def test_attention_diff_unet_continuous_matches_jax_and_not_serial(
        monkeypatch):
    """AttentionDiffUNet (features (4, 8, 16, 32, 64), DDIM-2) over a
    2-window and a 6-window volume at unit 4: batches 4 and 4, the first
    mixing the volumes. The noise is sin(3.1 w + 0.7 c) of each window's
    voxels w for class c, the same function on both sides. Both sides
    run in float64: the JAX model with ``BatchStatsNorm64`` (the JAX norm
    casts to float32 in any run) and its DDIM loop as
    ``DiffusionSegmenter.ddim_sample`` runs it, with a float64 state (that
    method fixes it to float32); each stitch accumulates in float32. The
    port's answer equals JAX's within 1e-4 of max |y|; the serial
    inferer's batch for the first volume (its 2 windows and 2 dummy
    copies of the first) moves that volume's answer by more than 1e-3 of
    max |y|."""
    monkeypatch.setattr(ja, "BatchStatsNorm", BatchStatsNorm64)
    c, features = 3, (4, 8, 16, 32, 64)
    rng = np.random.default_rng(0)
    jm = ja.AttentionDiffUNet(out_channels=c, features=features)
    params = random_flax_params(
        jm, rng.standard_normal((2, *ROI, 1)).astype(np.float32),
        rng.standard_normal((2, *ROI, c)).astype(np.float32),
        np.array([3, 640], np.int32), seed=1)
    tm = load_jax_params(create_model(
        "attention_diff_unet", out_channels=c, features=features),
        params).double().eval()
    jseg, tseg = JSeg(jm, c, sample_steps=2), TSeg(tm, c, sample_steps=2)
    phase = np.arange(1, c + 1)

    @jax.jit
    def ddim64(p, w):
        emb = jm.apply(p, w, method="embed")
        return jsampling.ddim_sample_loop(
            lambda x, t: jm.apply(p, x, t, emb, w,
                                  method="denoise_with_embeddings"),
            jseg.sample_schedule, (*w.shape[:-1], c), jax.random.key(0),
            noise=jnp.sin(3.1 * w + 0.7 * phase),
            dtype=w.dtype).pred_xstart_sum

    def jpred(p, w, keys):
        with jax.enable_x64(True):
            out = ddim64(p, np.asarray(w, np.float64))
        return jnp.asarray(np.asarray(out, np.float32))

    def tpred(w, starts, seeds=None):
        w = w.double()
        return tseg.ddim_sample(w, noise=torch.sin(
            3.1 * w + 0.7 * torch.from_numpy(phase)))

    vols = _volumes(3, [(16, 16, 28), (16, 28, 40)], channels=1)
    jcb = jsv.ContinuousBatchingInferer(jseg, roi=ROI, unit=4)
    jcb._predict = jpred        # float64 inside, as the port's
    want = jcb.serve(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64), params),
        [jnp.asarray(v) for v in vols], jax.random.key(0))
    want = [np.asarray(w) for w, _ in want]
    tcb = tsv.ContinuousBatchingInferer(tseg, roi=ROI, unit=4,
                                        predictor=tpred)
    assert [len(b) for b in tcb.plan([v.shape[:3] for v in vols])] == [4, 4]
    got = tcb.serve([torch.from_numpy(v) for v in vols], seed=0)
    scale = max(float(np.abs(w).max()) for w in want)
    for (g, _), w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * scale)
    with torch.no_grad():
        serial = tsw.SlidingWindowInferer(ROI, 4, 0.25)(
            tpred, torch.from_numpy(vols[0]), out_channels=c)
    assert float((serial - got[0][0]).abs().max()) > 1e-3 * scale


def test_predict_main_with_several_inputs_equals_single_runs(tmp_path,
                                                             monkeypatch):
    """Three CTs at the target spacing (no resample), 3, 3 and 2 windows
    at sw 2: every batch on both paths holds 2 windows (the CPU's convs
    round a batch of 1 otherwise), so the labelmaps written by one run
    over the three equal those of three single-input runs exactly."""
    from diff_unet_tpu_torch.data.nifti import write_nifti

    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(4)
    paths = []
    for i, shape in enumerate([(16, 16, 40), (40, 16, 16), (16, 28, 16)]):
        img = rng.integers(-300, 400, shape).astype(np.int16)
        paths.append(tmp_path / f"ct_{i}.nii.gz")
        write_nifti(paths[-1], img, np.diag([1.5, 1.5, 2.0, 1.0]))
    common = ["--config", str(ROOT / "cfg/amos/test.yaml"), "model_path=null",
              "device=cpu", "image_size=16", "spatial_size=16",
              "sw_batch_size=2", "sample_steps=2",
              "features=[4, 4, 8, 16, 32, 4]", "use_amp=false", "seed=5",
              f"classes={ROOT / 'cfg/amos/classes.yaml'}"]
    many = tpredict.main([*common, "input=" + ",".join(map(str, paths)),
                          f"output={tmp_path / 'many'}"])
    assert len(many) == 3
    for p, labels in zip(paths, many):
        one, = tpredict.main([*common, f"input={p}",
                              f"output={tmp_path / 'one.nii.gz'}"])
        np.testing.assert_array_equal(labels, one)
        written = read_nifti(tmp_path / "many" / tpredict._output_name(
            str(p)))
        np.testing.assert_array_equal(written.data, one)
        assert labels.shape == read_nifti(p).data.shape
