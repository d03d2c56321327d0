"""PyTorch port, the window attention's plain backward and row statistics:
``window_attention_backward_plain`` (the formulas the backward kernel
follows) against autograd through ``window_attention_plain`` (float64 at
1e-10, fp32 at 1e-4, bf16 at 3e-2 of each gradient's max |g|) and against
``jax.vjp`` of the Pallas kernel's ``custom_vjp`` in interpret mode (fp32,
1e-4); the plain row log-sum-exp against ``torch.logsumexp``; and no kernel
launch counted on the CPU."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from diff_unet_tpu.ops import pallas_attention as jpa
from diff_unet_tpu_torch.ops import window_attention as twa
from tests.test_torch_port_swin import torch_threads  # noqa: F401


def _inputs(bw, n, h, dh, nw, with_ids, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((bw, n, 3, h, dh))
    bias = 0.3 * rng.standard_normal((h, n, n))
    ids = (rng.integers(0, 4, size=(nw, n)).astype(np.int32)
           if with_ids else None)
    g = rng.standard_normal((bw, n, h, dh))
    return qkv, bias, ids, g


def _autograd(qkv, bias, ids, g):
    q = qkv.clone().requires_grad_()
    b = bias.clone().requires_grad_()
    out = twa.window_attention_plain(q, b, ids)
    return torch.autograd.grad(out, (q, b), g)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("n,dh,with_ids", [(64, 16, True), (27, 8, False),
                                           (8, 16, True)])
def test_backward_plain_matches_autograd(dtype, tol, n, dh, with_ids):
    qkv, bias, ids, g = _inputs(4, n, 2, dh, 2, with_ids, n + dh)
    bias_dt = torch.float64 if dtype == torch.float64 else torch.float32
    qkv, g = (torch.from_numpy(a).to(dtype) for a in (qkv, g))
    bias = torch.from_numpy(bias).to(bias_dt)
    ids = None if ids is None else torch.from_numpy(ids)
    got = twa.window_attention_backward_plain(qkv, bias, ids, g)
    want = _autograd(qkv, bias, ids, g)
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and a.shape == w.shape
        torch.testing.assert_close(a, w, rtol=tol, atol=tol)


@pytest.mark.parametrize("n,dh", [(64, 16), (27, 8)])
def test_backward_plain_bf16_matches_autograd(n, dh):
    """bf16 rounds dP, dq, dk and dv where autograd through the plain
    version rounds them; the f32 bias gradient stays f32."""
    qkv, bias, ids, g = _inputs(4, n, 2, dh, 2, True, 3 * n)
    qkv, g = (torch.from_numpy(a).float().bfloat16() for a in (qkv, g))
    bias = torch.from_numpy(bias).float()
    ids = torch.from_numpy(ids)
    got = twa.window_attention_backward_plain(qkv, bias, ids, g)
    want = _autograd(qkv, bias, ids, g)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    for a, w in zip(got, want):
        scale = w.float().abs().max().item()
        assert (a.float() - w.float()).abs().max().item() <= 3e-2 * scale


@pytest.mark.parametrize("n,with_ids", [(64, True), (64, False),
                                        (27, True), (27, False)])
def test_backward_plain_matches_pallas_vjp(n, with_ids):
    """The JAX side pads tokens to 128 lanes (kernel layout), the port
    does not; fp32 on both sides from the same numpy inputs."""
    bw, h, dh, nw = 4, 2, 8, 2
    qkv, bias, ids, g = _inputs(bw, n, h, dh, nw, with_ids, 7 * n)
    qkv, bias, g = (a.astype(np.float32) for a in (qkv, bias, g))
    npad = 128
    qkvt = jnp.pad(jnp.asarray(qkv.transpose(0, 2, 3, 4, 1)),
                   [(0, 0)] * 4 + [(0, npad - n)])
    bp = jnp.pad(jnp.asarray(bias), [(0, 0), (0, npad - n), (0, npad - n)])
    gt = jnp.pad(jnp.asarray(g.transpose(0, 2, 3, 1)),
                 [(0, 0)] * 3 + [(0, npad - n)])
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda a, bb: jpa.fused_window_attention_qkv(
            a, bb, n, ids, n_windows=nw), qkvt, bp)
        dqkvt, dbias = vjp(gt)
    want_qkv = np.asarray(dqkvt)[..., :n].transpose(0, 4, 1, 2, 3)
    want_bias = np.asarray(dbias)[:, :n, :n]
    dqkv, db = twa.window_attention_backward_plain(
        torch.from_numpy(qkv), torch.from_numpy(bias),
        None if ids is None else torch.from_numpy(ids), torch.from_numpy(g))
    np.testing.assert_allclose(dqkv.numpy(), want_qkv, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(db.numpy(), want_bias, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_ids", [True, False])
def test_row_statistics_match_logsumexp(dtype, with_ids):
    """The plain row log-sum-exp (the backward's saved statistics) against
    ``torch.logsumexp`` of the reference scores, and the output beside it
    unchanged."""
    qkv, bias, ids, _ = _inputs(4, 64, 2, 16, 2, with_ids, 11)
    qkv = torch.from_numpy(qkv).float().to(dtype)
    bias = torch.from_numpy(bias).float()
    ids = None if ids is None else torch.from_numpy(ids)
    out, lse = twa.window_attention_plain(qkv, bias, ids, with_stats=True)
    assert lse.shape == (4, 2, 64) and lse.dtype == torch.float32
    assert torch.equal(out, twa.window_attention_plain(qkv, bias, ids))
    # the reference scores, written out: f32 (q * scale) . k^T + bias + mask
    q, k = (qkv[:, :, i].transpose(1, 2) for i in range(2))
    qs = (q * torch.tensor(16 ** -0.5, dtype=dtype)).float()
    scores = qs @ k.float().transpose(-1, -2) + bias[None]
    if ids is not None:
        mask = (ids[:, None, :] != ids[:, :, None]).float() * -100.0
        scores = scores + mask.repeat(2, 1, 1)[:, None]
    torch.testing.assert_close(lse, torch.logsumexp(scores, -1), rtol=1e-5,
                               atol=1e-5)


def test_cpu_autograd_counts_no_launch():
    """On the CPU ``_WindowAttention`` takes the plain versions both ways
    and counts no kernel launch; its gradients are the plain backward's."""
    qkv, bias, ids, g = _inputs(2, 27, 2, 8, 1, True, 5)
    qkv, bias, g = (torch.from_numpy(a).float() for a in (qkv, bias, g))
    ids = torch.from_numpy(ids)
    before = (twa.window_attention.launches,
              twa.window_attention.backward_launches)
    q = qkv.clone().requires_grad_()
    b = bias.clone().requires_grad_()
    out = twa.window_attention(q, b, ids)
    assert out.grad_fn is not None
    out.backward(g)
    assert (twa.window_attention.launches,
            twa.window_attention.backward_launches) == before
    want = twa.window_attention_backward_plain(qkv, bias, ids, g)
    assert torch.equal(q.grad, want[0]) and torch.equal(b.grad, want[1])
    with torch.no_grad():
        twa.window_attention(qkv, bias, ids)
    assert twa.window_attention.launches == before[0]
