"""PyTorch port, the Swin kernels' gradients on their plain path against the
JAX package: window partition with the padding fused and its inverse with
the crop fused (exact, forward and ``jax.vjp``, against ``window_partition``
of the padded volume and the transposed ``window_partition_t``), the window
shift's backward (exact, against the Pallas kernel's ``custom_vjp`` in
interpret mode) and the window attention's backward (1e-4, against
``jax.vjp`` of the Pallas kernel's ``custom_vjp`` in interpret mode)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from diff_unet_tpu.ops import pallas_attention as jpa
from diff_unet_tpu.ops import pallas_shift as jps
from diff_unet_tpu.ops import swin as jsw
from diff_unet_tpu_torch.ops import window_partition as twp
from diff_unet_tpu_torch.ops.window_attention import window_attention
from diff_unet_tpu_torch.ops.window_shift import shift_windows
from tests.test_torch_port_swin import torch_threads  # noqa: F401

# (B, D, H, W, C, window): the four Swin stages of a 96^3 ROI with narrow C
# (48^3 pads to 49^3, 24^3 to 28^3, 12^3 to 14^3, 6^3 clamps the window to
# 6), and one odd shape padded differently on each axis
GEOMETRIES = [
    (1, 48, 48, 48, 2, (7, 7, 7)),
    (2, 24, 24, 24, 3, (7, 7, 7)),
    (2, 12, 12, 12, 4, (7, 7, 7)),
    (2, 6, 6, 6, 5, (6, 6, 6)),
    (2, 10, 9, 13, 3, (4, 4, 4)),
]


def _pad(dims, ws):
    return tuple((s - d % s) % s for d, s in zip(dims, ws))


def _jax_partition(x, ws, pad):
    return jsw.window_partition(
        jnp.pad(x, [(0, 0)] + [(0, p) for p in pad] + [(0, 0)]), ws)


def _jax_reverse(wt, ws, b, padded, valid):
    x = jsw.window_reverse(wt, ws, (b, *padded))
    return x[:, :valid[0], :valid[1], :valid[2]]


@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_partition_and_reverse_exact_with_gradients(geometry):
    b, d, h, w, c, ws = geometry
    dims = (d, h, w)
    pad = _pad(dims, ws)
    padded = tuple(a + p for a, p in zip(dims, pad))
    n = int(np.prod(ws))
    rng = np.random.default_rng(d + c)
    x = rng.standard_normal((b, *dims, c)).astype(np.float32)

    xt = torch.from_numpy(x).requires_grad_()
    wt = twp.partition_windows(xt, ws, pad)
    want = np.array(_jax_partition(x, ws, pad))
    np.testing.assert_array_equal(wt.detach().numpy(), want)
    # the TPU kernel's transposed layout holds the same rows
    xp = jnp.pad(x, [(0, 0)] + [(0, p) for p in pad] + [(0, 0)])
    np.testing.assert_array_equal(
        wt.detach().numpy(),
        np.asarray(jsw.window_partition_t(xp, ws, n)).transpose(0, 2, 1))

    g = rng.standard_normal(want.shape).astype(np.float32)
    wt.backward(torch.from_numpy(g))
    _, vjp = jax.vjp(lambda a: _jax_partition(a, ws, pad), x)
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(vjp(g)[0]))

    wt2 = torch.from_numpy(want).requires_grad_()
    back = twp.reverse_windows(wt2, ws, padded, dims)
    np.testing.assert_array_equal(back.detach().numpy(), x)
    np.testing.assert_array_equal(
        back.detach().numpy(),
        np.asarray(jsw.window_reverse_t(jnp.asarray(want).transpose(0, 2, 1),
                                        ws, (b, *padded)))[:, :d, :h, :w])
    gx = rng.standard_normal(x.shape).astype(np.float32)
    back.backward(torch.from_numpy(gx))
    _, vjp = jax.vjp(lambda a: _jax_reverse(a, ws, b, padded, dims), want)
    np.testing.assert_array_equal(wt2.grad.numpy(), np.asarray(vjp(gx)[0]))


def test_partition_rejects_bad_geometry_and_counts_nothing_on_cpu():
    before = (twp.partition_windows.launches,
              twp.reverse_windows.backward_launches)
    x = torch.zeros((1, 5, 5, 5, 2), requires_grad=True)
    twp.partition_windows(x, (3, 3, 3), (1, 1, 1)).sum().backward()
    assert (twp.partition_windows.launches,
            twp.reverse_windows.backward_launches) == before
    with pytest.raises(ValueError, match="geometry"):
        twp._grid((3, 3, 3), (7, 6, 6), (5, 5, 5))


@pytest.mark.parametrize("ss", [(2, 2, 2), (0, 2, 2)])
def test_shift_backward_matches_pallas_vjp_exact(ss):
    """The JAX package's custom_vjp runs its kernel with -ss on the
    cotangent; the port's backward runs its shift with -ss."""
    ws, grid, b, c = (4, 4, 4), (3, 2, 2), 2, 8
    bw = b * int(np.prod(grid))
    rng = np.random.default_rng(7)
    x = rng.standard_normal((bw, 64, c)).astype(np.float32)
    g = rng.standard_normal((bw, 64, c)).astype(np.float32)

    def to_t(a):
        return jnp.pad(jnp.asarray(a).transpose(0, 2, 1),
                       [(0, 0), (0, 0), (0, 64)])

    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda a: jps.shift_windows_t(
            a, ws, ss, grid, b, use_pallas=True), to_t(x))
        want = np.asarray(vjp(to_t(g))[0])[..., :64].transpose(0, 2, 1)
    xt = torch.from_numpy(x).requires_grad_()
    shift_windows(xt, ws, ss, grid).backward(torch.from_numpy(g))
    np.testing.assert_array_equal(xt.grad.numpy(), want)


@pytest.mark.parametrize("n,with_ids", [(64, True), (27, False)])
def test_attention_backward_matches_pallas_vjp(n, with_ids):
    """Gradients for qkv and the (H, N, N) bias; the JAX side pads tokens
    to 128 lanes, the port does not."""
    bw, h, dh, nw = 4, 2, 8, 2
    rng = np.random.default_rng(n)
    qkv = rng.standard_normal((bw, n, 3, h, dh)).astype(np.float32)
    bias = (0.3 * rng.standard_normal((h, n, n))).astype(np.float32)
    ids = (rng.integers(0, 4, size=(nw, n)).astype(np.int32)
           if with_ids else None)
    g = rng.standard_normal((bw, n, h, dh)).astype(np.float32)

    npad = 128
    qkvt = jnp.pad(jnp.asarray(qkv.transpose(0, 2, 3, 4, 1)),
                   [(0, 0)] * 4 + [(0, npad - n)])
    bp = jnp.pad(jnp.asarray(bias), [(0, 0), (0, npad - n), (0, npad - n)])
    gt = jnp.pad(jnp.asarray(g.transpose(0, 2, 3, 1)),
                 [(0, 0)] * 3 + [(0, npad - n)])
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(lambda a, bb: jpa.fused_window_attention_qkv(
            a, bb, n, ids, n_windows=nw), qkvt, bp)
        dqkvt, dbias = vjp(gt)
    want_qkv = np.asarray(dqkvt)[..., :n].transpose(0, 4, 1, 2, 3)
    want_bias = np.asarray(dbias)[:, :n, :n]

    tq = torch.from_numpy(qkv).requires_grad_()
    tb = torch.from_numpy(bias).requires_grad_()
    got = window_attention(tq, tb, None if ids is None
                           else torch.from_numpy(ids))
    np.testing.assert_allclose(
        got.detach().numpy(),
        np.asarray(out)[..., :n].transpose(0, 3, 1, 2), rtol=1e-4, atol=1e-4)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(tq.grad.numpy(), want_qkv, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tb.grad.numpy(), want_bias, rtol=1e-4,
                               atol=1e-4)


def test_swin_stage_trains_after_serving_on_the_same_geometry():
    """The per-geometry device tables (region ids, valid mask, bias index)
    cached while serving under inference mode must serve autograd too."""
    from diff_unet_tpu_torch.ops.swin import BasicLayer

    layer = BasicLayer(8, 2, 2, (4, 4, 4))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 6, 6, 10, 8)).astype(np.float32))
    with torch.inference_mode():
        served = layer(x)
    trained = layer(x)
    trained.sum().backward()
    np.testing.assert_array_equal(trained.detach().numpy(), served.numpy())
    assert all(p.grad is not None for p in layer.parameters())
