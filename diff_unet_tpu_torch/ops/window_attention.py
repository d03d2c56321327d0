"""Fused window attention: the CUDA kernel and its plain PyTorch version.

Counterpart of ``diff_unet_tpu/ops/pallas_attention.py``. Per (window,
head): ``softmax(q * Dh^-0.5 . k^T + bias[h] + region_mask) . v``, where
``region_mask`` is -100 between tokens of different shifted-window regions
(ids of window ``w`` are row ``w % nW`` of the ``(nW, N)`` table).

Layouts: ``qkv`` is the qkv projection's output viewed ``(BW, N, 3, H, Dh)``;
the result is ``(BW, N, H, Dh)``, which views as ``(BW, N, C)``. The kernel
source is ``csrc/window_attention.cu``. The gradient recomputes the plain
version (the kernel has no backward yet, nor has the TPU kernel).
"""
from __future__ import annotations

from typing import Optional

import torch

from diff_unet_tpu_torch.ops import _native


def window_attention_plain(qkv: torch.Tensor, bias: torch.Tensor,
                           region_ids: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Plain PyTorch version (``reference_window_attention``): q scaled in
    the working dtype, f32 scores and softmax, p cast to the working dtype
    before P.V, f32 accumulation."""
    bw, n, _, h, dh = qkv.shape
    dt = qkv.dtype
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # (BW,H,N,Dh)
    q = q * torch.tensor(dh ** -0.5, dtype=dt)
    scores = q.float() @ k.float().transpose(-1, -2)
    scores = scores + bias[None].float()
    if region_ids is not None:
        nw = region_ids.shape[0]
        mask = torch.where(region_ids[:, None, :] != region_ids[:, :, None],
                           -100.0, 0.0).to(scores.device)      # (nW, N, N)
        scores = (scores.view(bw // nw, nw, h, n, n)
                  + mask[None, :, None]).view(bw, h, n, n)
    p = torch.softmax(scores, dim=-1).to(dt)
    out = (p.float() @ v.float()).to(dt)
    return out.transpose(1, 2)


def _forward(qkv: torch.Tensor, bias: torch.Tensor,
             region_ids: Optional[torch.Tensor]) -> torch.Tensor:
    """The plain version for a CPU tensor, else the kernel."""
    if qkv.device.type == "cpu":
        return window_attention_plain(qkv, bias, region_ids)
    _native.require_cuda(qkv, "qkv")
    if qkv.dim() != 5 or qkv.shape[2] != 3:
        raise ValueError(f"qkv must be (BW, N, 3, H, Dh), got {tuple(qkv.shape)}")
    bw, n, _, h, dh = qkv.shape
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"qkv dtype {qkv.dtype} not supported")
    if dh not in (4, 8, 16, 32):
        raise ValueError(f"head_dim {dh} not supported (4, 8, 16 or 32)")
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous (a view of the qkv Linear)")
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
    out = torch.empty((bw, n, h, dh), dtype=qkv.dtype, device=qkv.device)
    lib = _native.load()
    err = lib.window_attention_forward(
        qkv.data_ptr(), bias.data_ptr(), ids_ptr, out.data_ptr(), bw, n, h,
        dh, nw, scale, 0 if qkv.dtype == torch.float32 else 1,
        _native.stream_ptr(qkv.device))
    _native.check(err, "window_attention_forward")
    window_attention.launches += 1
    return out


class _WindowAttention(torch.autograd.Function):
    """Forward: the kernel (the plain version on the CPU). Backward:
    recompute the plain version and return its vector-Jacobian product
    for ``qkv`` and ``bias``, as the JAX package's ``custom_vjp``
    recomputes ``reference_window_attention``; ``region_ids`` gets none."""

    @staticmethod
    def forward(ctx, qkv, bias, region_ids):
        ctx.save_for_backward(qkv, bias, region_ids)
        return _forward(qkv, bias, region_ids)

    @staticmethod
    def backward(ctx, g):
        qkv, bias, region_ids = ctx.saved_tensors
        with torch.enable_grad():
            qkv = qkv.detach().requires_grad_()
            bias = bias.detach().requires_grad_()
            out = window_attention_plain(qkv, bias, region_ids)
            dqkv, dbias = torch.autograd.grad(out, (qkv, bias), g)
        return dqkv, dbias, None


def window_attention(qkv: torch.Tensor, bias: torch.Tensor,
                     region_ids: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Fused window attention; differentiable in ``qkv`` and ``bias``. CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if torch.is_grad_enabled() and (qkv.requires_grad or bias.requires_grad):
        return _WindowAttention.apply(qkv, bias, region_ids)
    return _forward(qkv, bias, region_ids)


window_attention.launches = 0
