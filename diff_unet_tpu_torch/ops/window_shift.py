"""Swin cyclic window shift on partitioned windows: CUDA kernel and plain
PyTorch version.

Counterpart of ``diff_unet_tpu/ops/pallas_shift.py``. Given the window
tensor ``(B*nW, N, C)`` of a volume partitioned into ``grid`` windows of
``ws`` tokens, return the window tensor of the same volume rolled by ``-ss``
(``window_partition(roll(window_reverse(wt), -ss))``). The inverse shift is
``ss`` negated, and it is also the backward (a permutation's adjoint is its
inverse). The kernel (``csrc/window_shift.cu``) gathers token rows by an
int32 source table, so it is bit-exact in both directions.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from diff_unet_tpu_torch.ops import _native
from diff_unet_tpu_torch.ops.window_partition import window_partition, \
    window_reverse


def partition_np(vol: np.ndarray, ws: Tuple[int, ...]) -> np.ndarray:
    """(D, H, W) -> (nW, N) window partition of a numpy volume."""
    d, h, w = vol.shape
    v = vol.reshape(d // ws[0], ws[0], h // ws[1], ws[1], w // ws[2], ws[2])
    return v.transpose(0, 2, 4, 1, 3, 5).reshape(-1, ws[0] * ws[1] * ws[2])


@functools.lru_cache(maxsize=None)
def shift_table(ws: Tuple[int, ...], ss: Tuple[int, ...],
                grid: Tuple[int, ...]) -> np.ndarray:
    """int32 (nW*N,) table: row ``w*N + n`` of the shifted window tensor is
    row ``table[w*N + n]`` of the unshifted one (per sample)."""
    dims = tuple(g * s for g, s in zip(grid, ws))
    flat = np.arange(int(np.prod(dims)), dtype=np.int64).reshape(dims)
    pos = np.empty(flat.size, np.int64)          # spatial index -> row
    pos[partition_np(flat, ws).reshape(-1)] = np.arange(flat.size)
    rolled = np.roll(flat, shift=tuple(-s for s in ss), axis=(0, 1, 2))
    return pos[partition_np(rolled, ws).reshape(-1)].astype(np.int32)


@functools.lru_cache(maxsize=None)
@torch.inference_mode(False)
def _table_on(ws, ss, grid, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(shift_table(ws, ss, grid)).to(device)


def shift_windows_plain(wt: torch.Tensor, ws: Tuple[int, ...],
                        ss: Tuple[int, ...], grid: Tuple[int, ...]
                        ) -> torch.Tensor:
    """reverse -> roll by -ss -> partition (``shift_windows_t_reference``)."""
    nw = grid[0] * grid[1] * grid[2]
    b = wt.shape[0] // nw
    dims = (b, grid[0] * ws[0], grid[1] * ws[1], grid[2] * ws[2])
    x = window_reverse(wt, ws, dims)
    x = torch.roll(x, shifts=tuple(-s for s in ss), dims=(1, 2, 3))
    return window_partition(x, ws)


def _shift(wt: torch.Tensor, ws: Tuple[int, ...], ss: Tuple[int, ...],
           grid: Tuple[int, ...], backward: bool) -> torch.Tensor:
    """The plain version for a CPU tensor, else the gather kernel (counted
    on ``shift_windows``)."""
    if wt.device.type == "cpu":
        return shift_windows_plain(wt, ws, ss, grid)
    _native.require_cuda(wt, "wt")
    n = ws[0] * ws[1] * ws[2]
    nw = grid[0] * grid[1] * grid[2]
    if wt.dim() != 3 or wt.shape[1] != n or wt.shape[0] % nw:
        raise ValueError(f"wt must be (B*{nw}, {n}, C), got {tuple(wt.shape)}")
    if not wt.is_contiguous():
        raise ValueError("wt must be contiguous")
    table = _table_on(ws, ss, grid, wt.device)
    out = torch.empty_like(wt)
    err = _native.load().shift_windows_forward(
        wt.data_ptr(), out.data_ptr(), table.data_ptr(), nw * n,
        wt.shape[0] * n, wt.shape[2] * wt.element_size(),
        _native.stream_ptr(wt.device))
    _native.check(err, "shift_windows_forward")
    if backward:
        shift_windows.backward_launches += 1
    else:
        shift_windows.launches += 1
    return out


class _ShiftWindows(torch.autograd.Function):
    """Backward: the same gather with the inverse table (``ss`` negated),
    as the JAX package's ``custom_vjp`` runs its kernel with ``-ss``."""

    @staticmethod
    def forward(ctx, wt, ws, ss, grid):
        ctx.geometry = (ws, ss, grid)
        return _shift(wt, ws, ss, grid, backward=False)

    @staticmethod
    def backward(ctx, g):
        ws, ss, grid = ctx.geometry
        return _shift(g.contiguous(), ws, tuple(-s for s in ss), grid,
                      backward=True), None, None, None


def shift_windows(wt: torch.Tensor, ws: Tuple[int, ...], ss: Tuple[int, ...],
                  grid: Tuple[int, ...]) -> torch.Tensor:
    """Window-space shift of ``wt`` (B*nW, N, C); differentiable. CPU
    tensors take the plain version; CUDA tensors launch the gather kernel
    (forward and backward) or raise."""
    ws, ss, grid = tuple(ws), tuple(ss), tuple(grid)
    if torch.is_grad_enabled() and wt.requires_grad:
        return _ShiftWindows.apply(wt, ws, ss, grid)
    return _shift(wt, ws, ss, grid, backward=False)


# kernel launches on the forward path, and in the backward
shift_windows.launches = shift_windows.backward_launches = 0
