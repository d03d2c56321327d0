"""PyTorch port, kernels' plain versions and the Swin geometry against the
JAX package: window shift (exact, against the Pallas kernel in interpret
mode and its routing matrices), window attention (against the Pallas kernel
in interpret mode and its jnp reference), and the static geometry helpers
(exact)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from diff_unet_tpu.ops import pallas_attention as jpa
from diff_unet_tpu.ops import pallas_shift as jps
from diff_unet_tpu.ops import swin as jsw
from diff_unet_tpu_torch.ops import swin as tsw
from diff_unet_tpu_torch.ops import window_attention as twa
from diff_unet_tpu_torch.ops import window_partition as twp
from diff_unet_tpu_torch.ops import window_shift as tws
from tests.test_torch_port_swin import torch_threads  # noqa: F401


@pytest.mark.parametrize("dims,ws,ss", [
    ((14, 14, 14), (7, 7, 7), (3, 3, 3)),
    ((6, 8, 12), (6, 4, 4), (0, 2, 2)),
    ((8, 8, 8), (4, 4, 4), (2, 2, 2)),
])
def test_geometry_helpers_exact(dims, ws, ss):
    np.testing.assert_array_equal(tsw.window_region_ids(dims, ws, ss),
                                  jsw.window_region_ids(dims, ws, ss))
    np.testing.assert_array_equal(tsw.relative_position_index(ws),
                                  jsw.relative_position_index(ws))
    valid = tuple(d - 1 for d in dims)
    n = int(np.prod(ws))
    np.testing.assert_array_equal(
        tsw.window_valid_mask(dims, valid, ws, ss),
        jsw.window_valid_mask(dims, valid, ws, ss, n))
    assert tsw.window_valid_mask(dims, dims, ws, ss) is None
    for d in [(6, 9, 12), (5, 5, 8)]:
        assert tsw.get_window_size(d, (7, 7, 7), (3, 3, 3)) == \
            jsw.get_window_size(d, (7, 7, 7), (3, 3, 3))
        assert tsw.get_window_size(d, (7, 7, 7)) == \
            jsw.get_window_size(d, (7, 7, 7))
    x = np.random.default_rng(0).standard_normal((2, *dims, 3)).astype(
        np.float32)
    wt = twp.window_partition(torch.from_numpy(x), ws)
    np.testing.assert_array_equal(wt.numpy(),
                                  np.asarray(jsw.window_partition(x, ws)))
    np.testing.assert_array_equal(
        twp.window_reverse(wt, ws, (2, *dims)).numpy(), x)


@pytest.mark.parametrize("ws,ss,grid", [
    ((4, 4, 4), (2, 2, 2), (3, 2, 2)),
    ((7, 7, 7), (3, 3, 3), (2, 2, 2)),
    ((4, 4, 4), (0, 2, 2), (2, 3, 2)),
])
def test_shift_table_matches_routing_matrices(ws, ss, grid):
    """table[w*N + n] must name the token that routing matrix k routes to
    shifted token n of window w, in neighbour window (w + k*step) mod g."""
    n_tok = int(np.prod(ws))
    for s in (ss, tuple(-v for v in ss)):
        table = tws.shift_table(ws, s, grid)
        p = jps._routing_matrices(ws, s, n_tok)           # (8, N, N)
        steps = [jps._neighbor_step(v) for v in s]
        for w in range(int(np.prod(grid))):
            a = np.unravel_index(w, grid)
            for n in range(n_tok):
                k, m = np.argwhere(p[:, :, n] == 1.0)[0]
                kk = ((k >> 2) & 1, (k >> 1) & 1, k & 1)
                nbr = [(a[i] + kk[i] * steps[i]) % grid[i] for i in range(3)]
                src = np.ravel_multi_index(nbr, grid) * n_tok + m
                assert table[w * n_tok + n] == src


@pytest.mark.parametrize("ss", [(2, 2, 2), (-2, -2, -2), (0, 2, 0)])
def test_shift_plain_matches_pallas_kernel_exact(ss):
    ws, grid, b, c = (4, 4, 4), (3, 2, 2), 2, 8
    bw = b * int(np.prod(grid))
    x = np.random.default_rng(1).standard_normal((bw, 64, c)).astype(
        np.float32)
    xt = np.pad(x.transpose(0, 2, 1), [(0, 0), (0, 0), (0, 64)])
    with pltpu.force_tpu_interpret_mode():
        want = jps.shift_windows_t(jnp.asarray(xt), ws, ss, grid, b,
                                   use_pallas=True)
    want = np.asarray(want)[..., :64].transpose(0, 2, 1)
    got = tws.shift_windows(torch.from_numpy(x), ws, ss, grid)
    np.testing.assert_array_equal(got.numpy(), want)
    # the table-driven gather (the CUDA kernel's algorithm) agrees exactly
    table = torch.from_numpy(tws.shift_table(ws, ss, grid)).long()
    gathered = torch.from_numpy(x).view(b, -1, c)[:, table].view(bw, 64, c)
    assert torch.equal(gathered, got)


def _attn_inputs(bw, h, n, dh, seed, with_ids, n_windows):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((bw, n, 3, h, dh)).astype(np.float32)
    bias = (0.3 * rng.standard_normal((h, n, n))).astype(np.float32)
    ids = (rng.integers(0, 4, size=(n_windows, n)).astype(np.int32)
           if with_ids else None)
    return qkv, bias, ids


@pytest.mark.parametrize("n,with_ids", [(343, False), (343, True),
                                        (216, False), (64, True)])
def test_window_attention_plain_matches_pallas_and_reference(n, with_ids):
    bw, h, dh, nw = 4, 2, 8, 2
    qkv, bias, ids = _attn_inputs(bw, h, n, dh, n, with_ids, nw)
    got = twa.window_attention(
        torch.from_numpy(qkv), torch.from_numpy(bias),
        None if ids is None else torch.from_numpy(ids)).numpy()
    q, k, v = (jnp.asarray(qkv[:, :, i].transpose(0, 2, 1, 3))
               for i in range(3))
    mask = jpa._dense_mask(ids) if with_ids else None
    ref = jpa.reference_window_attention(q, k, v, jnp.asarray(bias), n,
                                         mask, n_windows=nw)
    ref = np.asarray(ref).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    npad = -(-n // 128) * 128
    pad = [(0, 0), (0, 0), (0, npad - n), (0, 0)]
    qp, kp, vp = (jnp.pad(a, pad) for a in (q, k, v))
    bp = jnp.pad(jnp.asarray(bias), [(0, 0), (0, npad - n), (0, npad - n)])
    with pltpu.force_tpu_interpret_mode():
        ker = jpa.fused_window_attention(qp, kp, vp, bp, n, ids,
                                         n_windows=nw)
    ker = np.asarray(ker)[:, :, :n].transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got, ker, rtol=1e-4, atol=1e-4)


def test_window_attention_plain_bf16_rounds_like_reference():
    """bf16: q scaled in bf16, p cast to bf16 before P.V (reference
    numerics), so the plain version agrees with jnp to bf16 resolution."""
    qkv, bias, ids = _attn_inputs(2, 2, 64, 8, 3, True, 1)
    got = twa.window_attention_plain(
        torch.from_numpy(qkv).bfloat16(), torch.from_numpy(bias),
        torch.from_numpy(ids)).float().numpy()
    q, k, v = (jnp.asarray(qkv[:, :, i].transpose(0, 2, 1, 3),
                           jnp.bfloat16) for i in range(3))
    ref = jpa.reference_window_attention(q, k, v, jnp.asarray(bias), 64,
                                         jpa._dense_mask(ids), n_windows=1)
    ref = np.asarray(ref.astype(jnp.float32)).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-2)


def test_kernel_wrappers_reject_non_cpu_non_cuda_and_count_nothing_on_cpu():
    qkv, bias, _ = _attn_inputs(2, 2, 8, 4, 0, False, 1)
    before = (twa.window_attention.launches, tws.shift_windows.launches)
    twa.window_attention(torch.from_numpy(qkv), torch.from_numpy(bias))
    tws.shift_windows(torch.zeros(8, 8, 4), (2, 2, 2), (1, 1, 1), (2, 2, 2))
    assert (twa.window_attention.launches,
            tws.shift_windows.launches) == before
    meta = torch.zeros((2, 8, 3, 2, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        twa.window_attention(meta, torch.zeros((2, 8, 8), device="meta"))
