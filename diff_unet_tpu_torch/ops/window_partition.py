"""Swin window partition with the zero padding fused, and its inverse with
the crop fused: the CUDA kernels and their plain PyTorch versions.

Counterpart of ``window_partition``/``window_reverse`` with the ``jnp.pad``
and the crop around them in ``diff_unet_tpu/ops/swin.py`` and of the TPU
kernel ``benchmarks/pallas_partition_probe.py:pallas_partition_t``, in the
port's ``(B*nW, N, C)`` window layout (no token padding).

``partition_windows(x, ws, pad)``: ``(B, D, H, W, C)`` -> ``(B*nW, N, C)``
of the volume zero-padded at the far end by ``pad``.
``reverse_windows(wt, ws, padded, valid)``: the inverse, cropped to
``valid``. Each is an ``autograd.Function`` whose backward is the other
(the adjoint of pad + partition is reverse + crop, and back). CPU tensors
take the plain versions; CUDA tensors launch the kernels of
``csrc/window_partition.cu`` or raise.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from diff_unet_tpu_torch.ops import _native

Dims = Tuple[int, int, int]


def window_partition(x: torch.Tensor, ws: Sequence[int]) -> torch.Tensor:
    """(B, D, H, W, C) -> (B*nW, wd*wh*ww, C); dims divisible by ``ws``."""
    b, d, h, w, c = x.shape
    x = x.reshape(b, d // ws[0], ws[0], h // ws[1], ws[1], w // ws[2],
                  ws[2], c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(-1, ws[0] * ws[1] * ws[2], c)


def window_reverse(windows: torch.Tensor, ws: Sequence[int],
                   dims: Sequence[int]) -> torch.Tensor:
    """Inverse of window_partition; ``dims`` = (B, D, H, W)."""
    b, d, h, w = dims
    x = windows.reshape(b, d // ws[0], h // ws[1], w // ws[2],
                        ws[0], ws[1], ws[2], -1)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b, d, h, w, -1)


def partition_windows_plain(x: torch.Tensor, ws: Dims, pad: Dims
                            ) -> torch.Tensor:
    """``F.pad`` at the far end, then ``window_partition``."""
    if any(pad):
        x = F.pad(x, (0, 0, 0, pad[2], 0, pad[1], 0, pad[0]))
    return window_partition(x, ws).contiguous()


def reverse_windows_plain(wt: torch.Tensor, ws: Dims, padded: Dims,
                          valid: Dims) -> torch.Tensor:
    """``window_reverse`` of the padded volume, then the crop to
    ``valid``."""
    nw = (padded[0] // ws[0]) * (padded[1] // ws[1]) * (padded[2] // ws[2])
    x = window_reverse(wt, ws, (wt.shape[0] // nw, *padded))
    return x[:, :valid[0], :valid[1], :valid[2]].contiguous()


def _grid(ws: Dims, padded: Dims, valid: Dims) -> Dims:
    """Windows per axis; raises unless ``padded`` is ``valid`` padded by
    less than a window up to a multiple of ``ws``."""
    for s, p, v in zip(ws, padded, valid):
        if s <= 0 or p % s or not 0 < v <= p or p - v >= s:
            raise ValueError(f"bad window geometry: window {ws}, padded "
                             f"{padded}, valid {valid}")
    return tuple(p // s for p, s in zip(padded, ws))


def _launch(fn, src: torch.Tensor, out: torch.Tensor, b: int, valid: Dims,
            grid: Dims, ws: Dims) -> None:
    if not src.is_contiguous():
        raise ValueError("window partition input must be contiguous")
    err = fn(src.data_ptr(), out.data_ptr(), b, *valid, *grid, *ws,
             src.shape[-1] * src.element_size(),
             _native.stream_ptr(src.device))
    _native.check(err, fn.__name__)


def _partition(x: torch.Tensor, ws: Dims, pad: Dims,
               backward: bool) -> torch.Tensor:
    """Pad + partition: the plain version for a CPU tensor, else the
    kernel (counted on ``partition_windows``)."""
    if x.device.type == "cpu":
        return partition_windows_plain(x, ws, pad)
    _native.require_cuda(x, "x")
    b, d, h, w, c = x.shape
    grid = _grid(ws, (d + pad[0], h + pad[1], w + pad[2]), (d, h, w))
    nw = grid[0] * grid[1] * grid[2]
    if b * nw > 65535:
        raise ValueError(f"window partition: {b * nw} windows exceed the "
                         "kernel's grid (65535)")
    out = torch.empty((b * nw, ws[0] * ws[1] * ws[2], c), dtype=x.dtype,
                      device=x.device)
    _launch(_native.load().window_partition_forward, x, out, b, (d, h, w),
            grid, ws)
    if backward:
        partition_windows.backward_launches += 1
    else:
        partition_windows.launches += 1
    return out


def _reverse(wt: torch.Tensor, ws: Dims, padded: Dims, valid: Dims,
             backward: bool) -> torch.Tensor:
    """Reverse + crop: the plain version for a CPU tensor, else the kernel
    (counted on ``reverse_windows``)."""
    if wt.device.type == "cpu":
        return reverse_windows_plain(wt, ws, padded, valid)
    _native.require_cuda(wt, "wt")
    grid = _grid(ws, padded, valid)
    nw = grid[0] * grid[1] * grid[2]
    n = ws[0] * ws[1] * ws[2]
    if wt.dim() != 3 or wt.shape[1] != n or wt.shape[0] % nw:
        raise ValueError(f"wt must be (B*{nw}, {n}, C), got "
                         f"{tuple(wt.shape)}")
    b = wt.shape[0] // nw
    if b * valid[0] > 65535:
        raise ValueError("window reverse: B * D exceeds the kernel's grid")
    out = torch.empty((b, *valid, wt.shape[2]), dtype=wt.dtype,
                      device=wt.device)
    _launch(_native.load().window_reverse_forward, wt, out, b, valid, grid,
            ws)
    if backward:
        reverse_windows.backward_launches += 1
    else:
        reverse_windows.launches += 1
    return out


class _PartitionWindows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ws, pad):
        ctx.geometry = (ws, tuple(s + p for s, p in zip(x.shape[1:4], pad)),
                        tuple(x.shape[1:4]))
        return _partition(x, ws, pad, backward=False)

    @staticmethod
    def backward(ctx, g):
        ws, padded, valid = ctx.geometry
        return _reverse(g.contiguous(), ws, padded, valid, backward=True), \
            None, None


class _ReverseWindows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, wt, ws, padded, valid):
        ctx.geometry = (ws, tuple(p - v for p, v in zip(padded, valid)))
        return _reverse(wt, ws, padded, valid, backward=False)

    @staticmethod
    def backward(ctx, g):
        ws, pad = ctx.geometry
        return _partition(g.contiguous(), ws, pad, backward=True), \
            None, None, None


def partition_windows(x: torch.Tensor, ws: Sequence[int],
                      pad: Sequence[int]) -> torch.Tensor:
    """(B, D, H, W, C) -> (B*nW, N, C) windows of ``x`` zero-padded by
    ``pad`` = (pd, ph, pw) at the far end of each axis; differentiable
    (backward: ``reverse_windows``)."""
    ws, pad = tuple(ws), tuple(pad)
    if torch.is_grad_enabled() and x.requires_grad:
        return _PartitionWindows.apply(x, ws, pad)
    return _partition(x, ws, pad, backward=False)


def reverse_windows(wt: torch.Tensor, ws: Sequence[int],
                    padded: Sequence[int], valid: Sequence[int]
                    ) -> torch.Tensor:
    """(B*nW, N, C) windows of a ``padded`` (D, H, W) volume -> (B, D', H',
    W', C) cropped to ``valid``; differentiable (backward:
    ``partition_windows``)."""
    ws, padded, valid = tuple(ws), tuple(padded), tuple(valid)
    if torch.is_grad_enabled() and wt.requires_grad:
        return _ReverseWindows.apply(wt, ws, padded, valid)
    return _reverse(wt, ws, padded, valid, backward=False)


# kernel launches on the forward path, and inside the other's backward
partition_windows.launches = partition_windows.backward_launches = 0
reverse_windows.launches = reverse_windows.backward_launches = 0
