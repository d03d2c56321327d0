"""3D shifted-window Swin transformer, channel-last, window-resident.

Counterpart of ``diff_unet_tpu/ops/swin.py``. Every stage runs in the
``(BW, N, C)`` window layout: the volume is padded and partitioned once
per stage by the partition kernel (``ops/window_partition.py``), the blocks
hop between the unshifted and shifted layouts with the window-shift kernel
(``ops/window_shift.py``), attention runs in the fused kernel
(``ops/window_attention.py``), and the windows are reversed and cropped
once at the end (``BasicLayer._forward_window_resident`` in the JAX
package, without its 128-lane token padding: N is the real token count).

Static geometry (region ids, valid masks, relative-position indices) is
numpy, cached per geometry, and uploaded once per device as normal (not
inference-mode) tensors, so serving and training share the cache.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from diff_unet_tpu_torch.ops.blocks import EPS, TEMB_FEATURES, Conv, \
    Dense, LayerNorm, swish
from diff_unet_tpu_torch.ops.window_attention import window_attention
from diff_unet_tpu_torch.ops.window_partition import partition_windows, \
    reverse_windows
from diff_unet_tpu_torch.ops.window_shift import partition_np, \
    shift_windows


# ---------- static geometry helpers ----------

def get_window_size(dims: Sequence[int], window_size: Sequence[int],
                    shift_size: Optional[Sequence[int]] = None):
    """Clamp the window to the input size and zero the shift there."""
    ws = list(window_size)
    ss = list(shift_size) if shift_size is not None else None
    for i, d in enumerate(dims):
        if d <= window_size[i]:
            ws[i] = d
            if ss is not None:
                ss[i] = 0
    return (tuple(ws), tuple(ss)) if ss is not None else tuple(ws)


@functools.lru_cache(maxsize=None)
def window_valid_mask(dims_padded: Tuple[int, ...],
                      dims_valid: Tuple[int, ...], ws: Tuple[int, ...],
                      ss: Tuple[int, ...]) -> Optional[np.ndarray]:
    """(nW, N) float32 {0,1} table of real (unpadded) tokens in the layout
    shifted by ``ss``, or None when the volume needed no padding."""
    if tuple(dims_padded) == tuple(dims_valid):
        return None
    vol = np.zeros(dims_padded, np.float32)
    vol[:dims_valid[0], :dims_valid[1], :dims_valid[2]] = 1.0
    vol = np.roll(vol, shift=tuple(-s for s in ss), axis=(0, 1, 2))
    return partition_np(vol, ws)


@functools.lru_cache(maxsize=None)
def window_region_ids(dims: Tuple[int, ...], ws: Tuple[int, ...],
                      ss: Tuple[int, ...]) -> np.ndarray:
    """(nW, N) int32 shift-region id of every token: the compact form of
    the shifted-window mask (-100 between tokens of different ids)."""
    d, h, w = dims
    img = np.zeros((d, h, w), np.float32)
    cnt = 0
    for ds in (slice(-ws[0]), slice(-ws[0], -ss[0] or None),
               slice(-ss[0] or d, None)):
        for hs in (slice(-ws[1]), slice(-ws[1], -ss[1] or None),
                   slice(-ss[1] or h, None)):
            for wsl in (slice(-ws[2]), slice(-ws[2], -ss[2] or None),
                        slice(-ss[2] or w, None)):
                img[ds, hs, wsl] = cnt
                cnt += 1
    return partition_np(img, ws).astype(np.int32)


@functools.lru_cache(maxsize=None)
def relative_position_index(ws: Tuple[int, ...]) -> np.ndarray:
    """(N, N) index into the (2wd-1)(2wh-1)(2ww-1) bias table."""
    coords = np.stack(
        np.meshgrid(*[np.arange(s) for s in ws], indexing="ij")
    ).reshape(len(ws), -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    for i in range(3):
        rel[:, :, i] += ws[i] - 1
    rel[:, :, 0] *= (2 * ws[1] - 1) * (2 * ws[2] - 1)
    rel[:, :, 1] *= 2 * ws[2] - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=None)
@torch.inference_mode(False)
def _region_ids_on(dims, ws, ss, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(window_region_ids(dims, ws, ss)).to(device)


@functools.lru_cache(maxsize=None)
@torch.inference_mode(False)
def _valid_mask_on(dims_padded, dims_valid, ws, ss, device: torch.device
                   ) -> Optional[torch.Tensor]:
    m = window_valid_mask(dims_padded, dims_valid, ws, ss)
    return None if m is None else torch.from_numpy(m).to(device)


@functools.lru_cache(maxsize=None)
@torch.inference_mode(False)
def _rpi_on(ws: Tuple[int, ...], n: int, device: torch.device
            ) -> torch.Tensor:
    # [:n, :n] of the UNCLAMPED window's index: at a clamped stage (6^3 of a
    # 7^3 window) the reference slices the 7^3 table instead of rebuilding
    rpi = relative_position_index(ws)[:n, :n]
    return torch.from_numpy(np.ascontiguousarray(rpi).reshape(-1)).to(device)


# ---------- modules ----------

class WindowAttention(nn.Module):
    """Windowed multi-head self-attention with relative position bias over
    (BW, N, C) windows; the attention core is the fused kernel."""

    def __init__(self, dim: int, num_heads: int,
                 window_size: Tuple[int, int, int],
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = tuple(window_size)
        table = int(np.prod([2 * s - 1 for s in self.window_size]))
        self.relative_position_bias_table = nn.Parameter(
            torch.empty(table, num_heads))
        self.qkv = Dense(dim, 3 * dim, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        nn.init.trunc_normal_(self.relative_position_bias_table.data, 0.0,
                              0.02, -0.04, 0.04, generator=generator)

    def relative_bias(self, n: int, device: torch.device) -> torch.Tensor:
        """(H, n, n) f32 bias gathered from the table."""
        idx = _rpi_on(self.window_size, n, device)
        bias = self.relative_position_bias_table[idx].view(n, n, -1)
        return bias.permute(2, 0, 1).float().contiguous()

    def forward(self, x: torch.Tensor,
                region_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        bw, n, c = x.shape
        h = self.num_heads
        qkv = self.qkv(x).view(bw, n, 3, h, c // h)
        out = window_attention(qkv, self.relative_bias(n, x.device),
                               region_ids)
        return self.proj(out.reshape(bw, n, c))


class SwinMlp(nn.Module):
    def __init__(self, dim: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.fc1 = Dense(dim, 4 * dim, dtype=dtype)
        self.fc2 = Dense(4 * dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))        # exact (erf) GELU


class SwinTransformerBlock(nn.Module):
    """norm1 -> window attention -> +residual -> norm2 -> MLP -> +residual.

    ``forward`` takes the (BW, N, C) window tensor already in this block's
    shift layout (the window-resident stage path); ``window_resident`` runs
    blocks on a (B, D, H, W, C) volume."""

    def __init__(self, dim: int, num_heads: int,
                 window_size: Tuple[int, int, int],
                 shift_size: Tuple[int, int, int],
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.window_size = tuple(window_size)
        self.shift_size = tuple(shift_size)
        self.norm1 = LayerNorm(dim, dtype=dtype)
        self.attn = WindowAttention(dim, num_heads, window_size, dtype=dtype)
        self.norm2 = LayerNorm(dim, dtype=dtype)
        self.mlp = SwinMlp(dim, dtype=dtype)

    def forward(self, wt: torch.Tensor,
                region_ids: Optional[torch.Tensor] = None,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``valid``: (nW, N) {0,1} real-token mask; padded tokens feed zeros
        to attention, as the zero-padded volume does in the reference."""
        bw, n, c = wt.shape
        h1 = self.norm1(wt)
        if valid is not None:
            nw = valid.shape[0]
            h1 = (h1.view(bw // nw, nw, n, c)
                  * valid[None, :, :, None].to(h1.dtype)).view(bw, n, c)
        wt = wt + self.attn(h1, region_ids)
        return wt + self.mlp(self.norm2(wt))


def window_resident(x: torch.Tensor, blocks: Sequence[SwinTransformerBlock],
                    window_size: Sequence[int],
                    shifts: Sequence[Sequence[int]]) -> torch.Tensor:
    """Run ``blocks`` (block i with shift ``shifts[i]``, clamped) over the
    (B, D, H, W, C) volume in window layout: pad and partition once, hop
    between shift layouts with the shift kernel, reverse and crop once."""
    _, d, h, w, _ = x.shape
    ws = get_window_size((d, h, w), window_size)
    pad = tuple((ws[i] - (d, h, w)[i] % ws[i]) % ws[i] for i in range(3))
    padded = (d + pad[0], h + pad[1], w + pad[2])
    grid = tuple(p // s for p, s in zip(padded, ws))

    wt = partition_windows(x.contiguous(), ws, pad)
    cur = (0, 0, 0)
    for blk, shift in zip(blocks, shifts):
        _, ss = get_window_size((d, h, w), window_size, shift)
        if ss != cur:
            wt = shift_windows(wt, ws, tuple(a - c for a, c in zip(ss, cur)),
                               grid)
            cur = ss
        ids = (_region_ids_on(padded, ws, ss, x.device) if any(ss)
               else None)
        valid = _valid_mask_on(padded, (d, h, w), ws, ss, x.device)
        wt = blk(wt, ids, valid)
    if any(cur):
        wt = shift_windows(wt, ws, tuple(-c for c in cur), grid)
    return reverse_windows(wt, ws, padded, (d, h, w))


class PatchMerging(nn.Module):
    """v0.9.0 'merging': 8-slice concat (duplicated (0,1,0)/(0,0,1) slices
    kept for weight compatibility) -> LayerNorm -> Linear(8c -> 2c)."""

    IDX = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1),
           (1, 0, 1), (0, 1, 0), (0, 0, 1), (1, 1, 1))

    def __init__(self, dim: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.norm = LayerNorm(8 * dim, dtype=dtype)
        self.reduction = Dense(8 * dim, 2 * dim, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, d, h, w, _ = x.shape
        if d % 2 or h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2, 0, d % 2))
        x = torch.cat([x[:, i::2, j::2, k::2, :] for i, j, k in self.IDX],
                      dim=-1)
        return self.reduction(self.norm(x))


class PatchEmbed(nn.Module):
    """Non-overlapping 2^3 conv patch embedding (kernel = stride = 2)."""

    def __init__(self, in_channels: int, embed_dim: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.proj = Conv(in_channels, embed_dim, kernel=2, stride=2,
                         padding="VALID", dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x)


class BasicLayer(nn.Module):
    """One Swin stage: ``depth`` blocks (alternating no-shift / shift),
    window-resident, then patch merging."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 window_size: Tuple[int, int, int],
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.window_size = tuple(window_size)
        self.shift = tuple(s // 2 for s in window_size)
        self.depth = depth
        for i in range(depth):
            self.add_module(f"blocks_{i}", SwinTransformerBlock(
                dim, num_heads, self.window_size,
                (0, 0, 0) if i % 2 == 0 else self.shift, dtype=dtype))
        self.downsample = PatchMerging(dim, dtype=dtype)

    def blocks(self) -> List[SwinTransformerBlock]:
        return [getattr(self, f"blocks_{i}") for i in range(self.depth)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        blocks = self.blocks()
        x = window_resident(x, blocks, self.window_size,
                            [blk.shift_size for blk in blocks])
        return self.downsample(x)


def stage_layer_norm(x: torch.Tensor) -> torch.Tensor:
    """Non-affine layer norm over channels, f32 statistics."""
    return F.layer_norm(x.float(), (x.shape[-1],), eps=EPS).to(x.dtype)


class SwinTransformer(nn.Module):
    """4-stage Swin ViT returning all five (layer-normed) stage outputs,
    with optional per-stage timestep injection
    (x_stage += t_proj_i(swish(temb)))."""

    def __init__(self, in_channels: int, embed_dim: int,
                 depths: Sequence[int] = (2, 2, 2, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: Tuple[int, int, int] = (7, 7, 7),
                 time_conditioned: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.time_conditioned = time_conditioned
        self.n_stages = len(depths)
        self.patch_embed = PatchEmbed(in_channels, embed_dim, dtype=dtype)
        for i, (depth, heads) in enumerate(zip(depths, num_heads)):
            self.add_module(f"layers{i + 1}", BasicLayer(
                embed_dim * 2 ** i, depth, heads, window_size, dtype=dtype))
        if time_conditioned:
            for i in range(len(depths) + 1):
                self.add_module(f"t_proj_{i}", Dense(
                    TEMB_FEATURES, embed_dim * 2 ** i, dtype=dtype))

    def _t_add(self, h: torch.Tensor, i: int,
               temb: Optional[torch.Tensor]) -> torch.Tensor:
        if not self.time_conditioned or temb is None:
            return h
        proj = getattr(self, f"t_proj_{i}")(swish(temb))
        return h + proj[:, None, None, None, :].to(h.dtype)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None
                ) -> List[torch.Tensor]:
        h = self._t_add(self.patch_embed(x), 0, temb)
        outs = [stage_layer_norm(h)]
        for i in range(self.n_stages):
            h = self._t_add(getattr(self, f"layers{i + 1}")(h), i + 1, temb)
            outs.append(stage_layer_norm(h))
        return outs
