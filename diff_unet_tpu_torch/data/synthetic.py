"""Seeded synthetic data: CT-like volumes for serving and (image, integer
label map) batches for training.

The repository holds no dataset, so the training path's checks and
profiles take their batches from ``SyntheticSegmentation`` (the NIfTI
pipeline, ``data/dataset.py``, serves real sets through ``data_path``):
each sample is a label map of ``num_labels`` values (background 0 and one
ellipsoid blob per organ class, every class present, so every class has a
centroid for label smoothing) and an image whose intensity follows the
labels plus noise, in [0, 1] like the JAX pipeline's scaled CT.
"""
from __future__ import annotations

from typing import Dict, Iterator, Sequence, Tuple

import numpy as np
import torch


def synthetic_ct(shape: Sequence[int], seed: int,
                 device: torch.device) -> torch.Tensor:
    """A (D, H, W, 1) volume in [0, 1]: smooth random blobs plus noise."""
    g = torch.Generator(device=device).manual_seed(seed)
    coarse = torch.randn((1, 1, *[max(2, s // 16) for s in shape]),
                         generator=g, device=device)
    smooth = torch.nn.functional.interpolate(coarse, size=tuple(shape),
                                             mode="trilinear")
    vol = torch.sigmoid(2.0 * smooth) + 0.05 * torch.randn(
        (1, 1, *shape), generator=g, device=device)
    return vol.clamp(0.0, 1.0)[0].permute(1, 2, 3, 0).contiguous()


def synthetic_pair(shape: Tuple[int, int, int], num_labels: int,
                   seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """(image (D, H, W, 1) float32 in [0, 1], label (D, H, W) int64 with
    every value of 0..num_labels-1 present)."""
    rng = np.random.default_rng(seed)
    shape_a = np.asarray(shape, np.float64)
    grid = np.ogrid[tuple(slice(0, s) for s in shape)]
    label = np.zeros(shape, np.int64)
    centres = []
    for c in range(1, num_labels):
        radii = rng.uniform(0.08, 0.18, 3) * shape_a
        centre = rng.uniform(radii, shape_a - radii)
        centres.append(centre)
        inside = sum(((g - m) / r) ** 2 for g, m, r in
                     zip(grid, centre, radii)) <= 1.0
        label[inside] = c
    for c, centre in enumerate(centres, start=1):    # a core for each class
        core = sum((g - m) ** 2 for g, m in zip(grid, centre)) <= 4.0
        label[core] = c
    missing = sorted(set(range(num_labels)) - set(np.unique(label)))
    if missing:
        raise ValueError(f"seed {seed}: label values {missing} were "
                         "painted over; use another seed")
    level = rng.uniform(0.2, 0.9, num_labels).astype(np.float32)
    level[0] = 0.1
    image = level[label] + 0.05 * rng.standard_normal(shape, np.float32)
    return np.clip(image, 0.0, 1.0)[..., None], label


class SyntheticSegmentation:
    """``batches`` seeded batches ``{"image": (B, D, H, W, 1) float32,
    "label": (B, D, H, W) int64}`` of ``synthetic_pair`` samples; the same
    batches on every pass."""

    def __init__(self, shape: Sequence[int], num_labels: int = 14,
                 batch_size: int = 1, batches: int = 4, seed: int = 0):
        self.shape = tuple(shape)
        self.num_labels = num_labels
        self.batch_size = batch_size
        self.batches = batches
        self.seed = seed

    def __len__(self) -> int:
        return self.batches

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for i in range(self.batches):
            pairs = [synthetic_pair(self.shape, self.num_labels,
                                    self.seed + i * self.batch_size + j)
                     for j in range(self.batch_size)]
            yield {"image": np.stack([p[0] for p in pairs]),
                   "label": np.stack([p[1] for p in pairs])}
