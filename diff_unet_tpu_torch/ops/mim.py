"""3D masked-image-modeling utilities (counterpart of
``diff_unet_tpu/ops/mim.py``): patchify and unpatchify, random token
masking, the voxel block mask, region mask labels and the random patch
picker, over channel-last (NDHWC) tensors.

Draws take an explicit ``torch.Generator``; ``random_masking`` and
``block_mask`` also take the uniform draws themselves (``noise``), so that
a caller can pin them (the CPU tests hand them JAX's draws).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def patchify(x: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, D, H, W, C) -> (B, N, patch^3 * C), patches in (d, h, w) order,
    each patch's voxels in (pd, ph, pw, c) order."""
    b, d, h, w, c = x.shape
    if d % patch or h % patch or w % patch:
        raise ValueError(f"patchify: {(d, h, w)} is not a multiple of "
                         f"patch {patch}")
    x = x.reshape(b, d // patch, patch, h // patch, patch, w // patch,
                  patch, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(b, (d // patch) * (h // patch) * (w // patch),
                     patch ** 3 * c)


def unpatchify(tokens: torch.Tensor, grid: Tuple[int, int, int],
               patch: int, channels: int = 1) -> torch.Tensor:
    """Inverse of ``patchify`` given the (gd, gh, gw) patch grid."""
    b, n, _ = tokens.shape
    gd, gh, gw = grid
    if n != gd * gh * gw:
        raise ValueError(f"unpatchify: {n} tokens for a {grid} grid")
    x = tokens.reshape(b, gd, gh, gw, patch, patch, patch, channels)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b, gd * patch, gh * patch, gw * patch, channels)


def random_masking(tokens: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   mask_ratio: float = 0.75,
                   noise: Optional[torch.Tensor] = None):
    """Per-sample random token masking (MAE): the tokens of the
    ``int(N * (1 - mask_ratio))`` smallest uniform draws of each sample
    are kept. Returns (kept (B, len_keep, dim), mask (B, N) with 1 where
    masked, ids_restore (B, N)). ``noise`` (B, N) pins the draws."""
    b, n, dim = tokens.shape
    len_keep = int(n * (1.0 - mask_ratio))
    if noise is None:
        noise = torch.rand((b, n), generator=generator,
                           device=tokens.device)
    ids_shuffle = torch.argsort(noise, dim=1, stable=True)
    ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
    ids_keep = ids_shuffle[:, :len_keep]
    kept = torch.gather(tokens, 1, ids_keep[..., None].expand(-1, -1, dim))
    mask = torch.ones((b, n), device=tokens.device)
    mask[:, :len_keep] = 0.0
    mask = torch.gather(mask, 1, ids_restore)
    return kept, mask, ids_restore


def block_mask(shape: Tuple[int, int, int],
               generator: Optional[torch.Generator] = None, patch: int = 16,
               mask_ratio: float = 0.5,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Voxel keep grid (D, H, W) float32: each cell of the patch grid is
    kept (1) where its uniform draw is >= ``mask_ratio``, else zeroed.
    ``noise`` pins the draws: (..., gd * gh * gw) gives a (..., D, H, W)
    grid for each row (one per sample)."""
    gd, gh, gw = (s // patch for s in shape)
    if noise is None:
        noise = torch.rand(gd * gh * gw, generator=generator,
                           device=generator.device)
    keep = (noise >= mask_ratio).float()
    grid = keep.reshape(*keep.shape[:-1], gd, gh, gw)
    for axis in (-3, -2, -1):
        grid = grid.repeat_interleave(patch, dim=axis)
    return grid


def region_mask_labels(mask: torch.Tensor, regions: int = 2
                       ) -> torch.Tensor:
    """Masked fraction of each of the ``regions``^3 blocks of a (B, N)
    token mask over a cubic grid, blocks in (i, j, k) order: (B,
    regions^3)."""
    b, n = mask.shape
    g = round(n ** (1 / 3))
    step = g // regions
    m = mask.reshape(b, g, g, g)
    out = [m[:, i * step:(i + 1) * step, j * step:(j + 1) * step,
             k * step:(k + 1) * step].mean(dim=(1, 2, 3))
           for i in range(regions) for j in range(regions)
           for k in range(regions)]
    return torch.stack(out, dim=1)


def random_patch(volume_shape: Tuple[int, int, int],
                 generator: torch.Generator,
                 patch_size: Tuple[int, int, int]) -> Tuple[int, ...]:
    """Random crop origin: each axis uniform in [0, max(size - patch,
    0)]."""
    maxs = [max(s - p, 0) for s, p in zip(volume_shape, patch_size)]
    return tuple(int(torch.randint(0, m + 1, (), generator=generator,
                                   device=generator.device))
                 for m in maxs)
