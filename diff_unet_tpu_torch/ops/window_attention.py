"""Fused window attention: the CUDA kernels and their plain PyTorch versions.

Counterpart of ``diff_unet_tpu/ops/pallas_attention.py``. Per (window,
head): ``softmax(q * Dh^-0.5 . k^T + bias[h] + region_mask) . v``, where
``region_mask`` is -100 between tokens of different shifted-window regions
(ids of window ``w`` are row ``w % nW`` of the ``(nW, N)`` table).

Layouts: ``qkv`` is the qkv projection's output viewed ``(BW, N, 3, H, Dh)``;
the result is ``(BW, N, H, Dh)``, which views as ``(BW, N, C)``. The kernel
source is ``csrc/window_attention.cu``: a forward and a backward kernel. The
forward saves the rows' log-sum-exp for the backward, which recomputes the
scores from it and writes the gradients of ``qkv`` and of the bias.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from diff_unet_tpu_torch.ops import _native


def _split(qkv: torch.Tensor):
    """q scaled in the working dtype, k and v, each ``(BW, H, N, Dh)``, the
    scale as a tensor of the working dtype, and the type the products and
    the softmax take: f32, or float64 for float64 inputs."""
    dh = qkv.shape[-1]
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    scale = torch.tensor(dh ** -0.5, dtype=qkv.dtype)
    return q * scale, k, v, scale, torch.promote_types(qkv.dtype,
                                                       torch.float32)


def _scores(qs: torch.Tensor, k: torch.Tensor, bias: torch.Tensor,
            region_ids: Optional[torch.Tensor],
            acc: torch.dtype) -> torch.Tensor:
    """``qs . k^T + bias[h]`` in ``acc``, plus -100 between regions."""
    bw, h, n, _ = qs.shape
    scores = qs.to(acc) @ k.to(acc).transpose(-1, -2)
    scores = scores + bias[None].to(acc)
    if region_ids is not None:
        nw = region_ids.shape[0]
        mask = torch.where(region_ids[:, None, :] != region_ids[:, :, None],
                           -100.0, 0.0).to(scores)         # (nW, N, N)
        scores = (scores.view(bw // nw, nw, h, n, n)
                  + mask[None, :, None]).view(bw, h, n, n)
    return scores


def window_attention_plain(qkv: torch.Tensor, bias: torch.Tensor,
                           region_ids: Optional[torch.Tensor] = None,
                           with_stats: bool = False):
    """Plain PyTorch version (``reference_window_attention``): q scaled in
    the working dtype, f32 scores and softmax, p cast to the working dtype
    before P.V, f32 accumulation (float64 stays float64). With
    ``with_stats`` it also returns the rows' f32 log-sum-exp ``(BW, H, N)``,
    taken as the kernel takes it:
    ``m + log(sum(exp(s - m)))`` with ``m`` the row max."""
    dt = qkv.dtype
    qs, k, v, _, acc = _split(qkv)
    scores = _scores(qs, k, bias, region_ids, acc)
    p = torch.softmax(scores, dim=-1).to(dt)
    out = (p.to(acc) @ v.to(acc)).to(dt).transpose(1, 2)
    if not with_stats:
        return out
    m = scores.amax(dim=-1, keepdim=True)
    lse = (m + torch.log(torch.exp(scores - m).sum(-1, keepdim=True)))
    return out, lse.squeeze(-1)


def window_attention_backward_plain(qkv: torch.Tensor, bias: torch.Tensor,
                                    region_ids: Optional[torch.Tensor],
                                    g: torch.Tensor
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The vector-Jacobian product of ``window_attention_plain`` for the
    output gradient ``g`` ``(BW, N, H, Dh)``: ``(dqkv, dbias)``, with
    ``dqkv`` in ``qkv``'s layout and dtype and ``dbias`` ``(H, N, N)`` in
    f32 (float64 for float64 inputs).
    The formulas of autograd through the plain version, with its rounding
    points: ``dP = g . v^T`` rounds to the working dtype (the backward of
    ``p.float()``), ``D = rowsum(P o dP)`` uses the f32 ``P``,
    ``dS = P o (dP - D)``, ``dq = round(dS . k) * scale``,
    ``dk = dS^T . qs``, ``dv = round(P)^T . g``, ``dbias = sum_w dS``."""
    dt = qkv.dtype
    qs, k, v, scale, acc = _split(qkv)
    p = torch.softmax(_scores(qs, k, bias, region_ids, acc), dim=-1)
    go = g.transpose(1, 2).to(acc)                            # (BW,H,N,Dh)
    dp = (go @ v.to(acc).transpose(-1, -2)).to(dt).to(acc)
    dv = (p.to(dt).to(acc).transpose(-1, -2) @ go).to(dt)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    dq = (ds @ k.to(acc)).to(dt) * scale
    dk = (ds.transpose(-1, -2) @ qs.to(acc)).to(dt)
    dqkv = torch.stack([t.transpose(1, 2) for t in (dq, dk, dv)], dim=2)
    return dqkv, ds.sum(0)


def _check(qkv: torch.Tensor, bias: torch.Tensor,
           region_ids: Optional[torch.Tensor]):
    """Validate the kernels' inputs; returns (nW, region ids pointer, the
    q scale as the working dtype rounds it, dtype code)."""
    _native.require_cuda(qkv, "qkv")
    if qkv.dim() != 5 or qkv.shape[2] != 3:
        raise ValueError(f"qkv must be (BW, N, 3, H, Dh), got {tuple(qkv.shape)}")
    bw, n, _, h, dh = qkv.shape
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"qkv dtype {qkv.dtype} not supported")
    if dh not in (4, 8, 16, 32):
        raise ValueError(f"head_dim {dh} not supported (4, 8, 16 or 32)")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("qkv must be contiguous and 16-byte aligned (a view "
                         "of the qkv Linear)")
    if (bias.dtype != torch.float32 or tuple(bias.shape) != (h, n, n)
            or not bias.is_contiguous() or bias.device != qkv.device):
        raise ValueError(f"bias must be contiguous f32 ({h}, {n}, {n}) on "
                         f"{qkv.device}, got {bias.dtype} {tuple(bias.shape)}")
    nw = 1
    ids_ptr = None
    if region_ids is not None:
        nw = region_ids.shape[0]
        if (region_ids.dtype != torch.int32 or region_ids.dim() != 2
                or region_ids.shape[1] != n or bw % nw
                or not region_ids.is_contiguous()
                or region_ids.device != qkv.device):
            raise ValueError("region_ids must be contiguous int32 (nW, N) on "
                             "the qkv device, with nW dividing BW")
        ids_ptr = region_ids.data_ptr()
    scale = torch.tensor(dh ** -0.5, dtype=qkv.dtype).item()
    return nw, ids_ptr, scale, 0 if qkv.dtype == torch.float32 else 1


def _forward(qkv: torch.Tensor, bias: torch.Tensor,
             region_ids: Optional[torch.Tensor], with_stats: bool = False):
    """The plain version for a CPU tensor, else the kernel; with
    ``with_stats`` also the rows' f32 log-sum-exp ``(BW, H, N)``."""
    if qkv.device.type == "cpu":
        return window_attention_plain(qkv, bias, region_ids, with_stats)
    nw, ids_ptr, scale, code = _check(qkv, bias, region_ids)
    bw, n, _, h, dh = qkv.shape
    out = torch.empty((bw, n, h, dh), dtype=qkv.dtype, device=qkv.device)
    lse = (torch.empty((bw, h, n), dtype=torch.float32, device=qkv.device)
           if with_stats else None)
    err = _native.load().window_attention_forward(
        qkv.data_ptr(), bias.data_ptr(), ids_ptr, out.data_ptr(),
        None if lse is None else lse.data_ptr(), bw, n, h, dh, nw, scale,
        code, _native.stream_ptr(qkv.device))
    _native.check(err, "window_attention_forward")
    window_attention.launches += 1
    return (out, lse) if with_stats else out


def backward_groups(bw: int, heads: int, sms: int) -> int:
    """CTAs per head of the backward kernel, each taking a run of windows:
    about two CTAs an SM over all heads, at most one per window."""
    groups = max(1, min(bw, -(-2 * sms // heads)))
    per_group = -(-bw // groups)
    return -(-bw // per_group)


def _backward(qkv: torch.Tensor, bias: torch.Tensor,
              region_ids: Optional[torch.Tensor], lse: torch.Tensor,
              g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel: ``(dqkv, dbias)`` from the forward's
    log-sum-exp and the output gradient. The kernel adds each window's
    bias gradient into ``dbias`` with float atomics, so ``dbias`` varies
    from run to run in its last bits (the order of the additions)."""
    nw, ids_ptr, scale, code = _check(qkv, bias, region_ids)
    bw, n, _, h, dh = qkv.shape
    g = g.contiguous()
    if g.shape != (bw, n, h, dh) or g.dtype != qkv.dtype or g.data_ptr() % 16:
        raise ValueError(f"the output gradient must be {qkv.dtype} "
                         f"({bw}, {n}, {h}, {dh}), got {g.dtype} "
                         f"{tuple(g.shape)}")
    if (lse is None or lse.shape != (bw, h, n) or lse.dtype != torch.float32
            or not lse.is_contiguous()):
        raise ValueError("lse must be the forward's contiguous f32 (BW, H, N)")
    groups = backward_groups(
        bw, h, torch.cuda.get_device_properties(qkv.device)
        .multi_processor_count)
    dqkv = torch.empty_like(qkv)
    dbias = torch.zeros((h, n, n), dtype=torch.float32, device=qkv.device)
    err = _native.load().window_attention_backward(
        qkv.data_ptr(), bias.data_ptr(), ids_ptr, lse.data_ptr(),
        g.data_ptr(), dqkv.data_ptr(), dbias.data_ptr(), bw, n, h, dh, nw,
        groups, scale, code, _native.stream_ptr(qkv.device))
    _native.check(err, "window_attention_backward")
    window_attention.backward_launches += 1
    return dqkv, dbias


class _WindowAttention(torch.autograd.Function):
    """Forward: the kernel, which also saves the rows' log-sum-exp (the
    plain version on the CPU). Backward: the backward kernel for ``qkv``
    and ``bias`` (``window_attention_backward_plain`` on the CPU);
    ``region_ids`` gets none."""

    @staticmethod
    def forward(ctx, qkv, bias, region_ids):
        out, lse = _forward(qkv, bias, region_ids, with_stats=True)
        ctx.save_for_backward(qkv, bias, region_ids, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        qkv, bias, region_ids, lse = ctx.saved_tensors
        if qkv.device.type == "cpu":
            dqkv, dbias = window_attention_backward_plain(qkv, bias,
                                                          region_ids, g)
        else:
            dqkv, dbias = _backward(qkv, bias, region_ids, lse, g)
        return dqkv, dbias, None


def window_attention(qkv: torch.Tensor, bias: torch.Tensor,
                     region_ids: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Fused window attention; differentiable in ``qkv`` and ``bias``. CPU
    tensors take the plain versions; CUDA tensors launch the kernels or
    raise."""
    if torch.is_grad_enabled() and (qkv.requires_grad or bias.requires_grad):
        return _WindowAttention.apply(qkv, bias, region_ids)
    return _forward(qkv, bias, region_ids)


window_attention.launches = 0
window_attention.backward_launches = 0
