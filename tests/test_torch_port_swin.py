"""PyTorch port, Swin modules against the JAX package (fp32, 1e-4): the
same flax parameters (random, from numpy) are carried into the port by
``utils.weights.load_jax_params``; the JAX side runs both its standard and
its transposed window-resident block layout.

``torch_threads`` (imported by every CPU test file of the port) sizes
torch's intra-op thread pool to the test process's share of the cores."""
import os

import numpy as np
import pytest
import torch

import jax

from diff_unet_tpu.ops import swin as jsw
from diff_unet_tpu_torch.ops import swin as tsw
from diff_unet_tpu_torch.utils.weights import load_jax_params

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """Torch's intra-op threads for one test module: the cores over the
    pytest-xdist workers that run side by side (each would otherwise start
    a thread for every core, and their spinning pools contend for them);
    all cores without xdist. Restored after the module."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    before = torch.get_num_threads()
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // workers))
    yield
    torch.set_num_threads(before)


def random_flax_params(module, *args, seed=0):
    """Param tree of ``module`` (shapes by tracing only) filled from numpy:
    fan-in-scaled kernels, non-trivial norm scales, biases and bias
    tables."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.key(0), *args))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            a = rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name == "scale":
            a = 1.0 + 0.2 * rng.standard_normal(s.shape)
        elif name == "relative_position_bias_table":
            a = 0.5 * rng.standard_normal(s.shape)
        else:
            a = 0.1 * rng.standard_normal(s.shape)
        return np.asarray(a, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _np(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("n,with_ids", [(64, True), (64, False), (27, False)])
def test_window_attention_matches(transposed, n, with_ids):
    """n = 27 is a clamped 3^3 window of a 4^3 table: rpi[:n, :n]."""
    jm = jsw.WindowAttention(16, 2, (4, 4, 4))
    x = _np(0, (4, n, 16))
    ids = (np.random.default_rng(1).integers(0, 3, (2, n)).astype(np.int32)
           if with_ids else None)
    params = random_flax_params(jm, x, seed=2)
    if transposed:
        xt = np.pad(x.transpose(0, 2, 1), [(0, 0), (0, 0), (0, 128 - n)])
        want = jm.apply(params, xt, region_ids=ids, transposed=True,
                        n_valid=n)
        want = np.asarray(want)[..., :n].transpose(0, 2, 1)
    else:
        want = np.asarray(jm.apply(params, x, region_ids=ids))
    tm = load_jax_params(tsw.WindowAttention(16, 2, (4, 4, 4)), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x),
                 None if ids is None else torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("shift", [False, True])
def test_swin_block_matches(transposed, shift):
    """Spatial padding (10 % 4 != 0) with and without the shift."""
    ss = (2, 2, 2) if shift else (0, 0, 0)
    jm = jsw.SwinTransformerBlock(16, 2, (4, 4, 4), ss)
    x = _np(3, (2, 10, 10, 10, 16))
    params = random_flax_params(jm, x, seed=4)
    with jsw.use_transposed_blocks(transposed):
        want = np.asarray(jm.apply(params, x))
    tm = load_jax_params(tsw.SwinTransformerBlock(16, 2, (4, 4, 4), ss),
                         params)
    with torch.no_grad():
        got = tsw.window_resident(torch.from_numpy(x), [tm], tm.window_size,
                                  [tm.shift_size]).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("shape", [(1, 10, 8, 12, 16), (2, 6, 9, 8, 16)])
def test_basic_layer_matches(transposed, shape):
    """Window-resident stage with merge; (6, 9, 8) clamps D to a 6-token
    window with zero shift while H and W pad to 14 and keep theirs."""
    window = (4, 4, 4) if shape[1] == 10 else (7, 7, 7)
    jm = jsw.BasicLayer(dim=16, depth=2, num_heads=2, window_size=window)
    x = _np(5, shape)
    params = random_flax_params(jm, x, seed=6)
    with jsw.use_transposed_blocks(transposed):
        want = np.asarray(jm.apply(params, x))
    tm = load_jax_params(tsw.BasicLayer(16, 2, 2, window), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("transposed", [False, True])
def test_swin_transformer_matches(transposed):
    """4-stage time-conditioned stack; the last stage clamps its window."""
    kw = dict(depths=(2, 2, 2, 2), num_heads=(1, 2, 2, 4),
              window_size=(3, 3, 3))
    jm = jsw.SwinTransformer(embed_dim=8, time_conditioned=True, **kw)
    x = _np(7, (1, 32, 32, 32, 2))
    temb = _np(8, (1, 512))
    params = random_flax_params(jm, x, temb, seed=9)
    with jsw.use_transposed_blocks(transposed):
        want = jax.jit(jm.apply)(params, x, temb)
    tm = load_jax_params(tsw.SwinTransformer(2, 8, time_conditioned=True,
                                             **kw), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(temb))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_patch_merging_keeps_duplicated_slice_quirk():
    jm = jsw.PatchMerging(8)
    x = _np(10, (1, 5, 6, 7, 8))           # odd dims pad
    params = random_flax_params(jm, x, seed=11)
    want = np.asarray(jm.apply(params, x))
    tm = load_jax_params(tsw.PatchMerging(8), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert tsw.PatchMerging.IDX[2] == tsw.PatchMerging.IDX[5]
