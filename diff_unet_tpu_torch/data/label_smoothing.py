"""Distance-based label smoothing: numpy on the host, and a learnable
module.

A copy of the numpy functions of ``diff_unet_tpu/data/label_smoothing.py``
(that module cannot be imported without jax): the integer label volume is
one-hot encoded, per-class centroids are computed, voxel-to-centroid
distance fields derived, and the label becomes
``|onehot - decay(distance) * alpha|`` with decay rational
``1/(d^order + eps)``, exponential ``x exp(-lambda x)`` or a damped sine;
``LabelSmoothingCacheDataset``, the NIfTI cache dataset whose labels are
smoothed on the raw label grid; and ``LearnableLabelSmoothing``, the
per-class learnable smoothing module.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
from torch import nn

from diff_unet_tpu_torch.data import transforms as T
from diff_unet_tpu_torch.data.dataset import CacheDataset
from diff_unet_tpu_torch.data.nifti import read_nifti, to_ras


def class_centroids(labels: np.ndarray, num_classes: int) -> np.ndarray:
    """Per-class centroids of an integer (D,H,W) label volume; zeros for
    absent classes."""
    coords = np.indices(labels.shape).astype(np.float32)  # (3, D, H, W)
    centroids = np.zeros((num_classes, 3), np.float32)
    for c in range(num_classes):
        mask = labels == c
        n = mask.sum()
        if n > 0:
            centroids[c] = [coords[i][mask].mean() for i in range(3)]
    return centroids


def distance_fields(labels: np.ndarray, num_classes: int) -> np.ndarray:
    """(C, D, H, W) euclidean distance of every voxel to each class
    centroid."""
    coords = np.stack(
        np.meshgrid(*[np.arange(s) for s in labels.shape], indexing="ij"),
        axis=-1,
    ).astype(np.float32)                                   # (D,H,W,3)
    cents = class_centroids(labels, num_classes)           # (C,3)
    diff = coords[None] - cents[:, None, None, None, :]
    return np.linalg.norm(diff, axis=-1)


def rational(x: np.ndarray, order: float = 1.0, eps: float = 1e-6):
    return 1.0 / (np.power(x, order) + eps)


def exponential_decay(x: np.ndarray, lam: float = 1.0):
    return x * np.exp(-lam * x)


def damped_sine(x: np.ndarray, lam: float = 0.05, omega: float = 0.1,
                phi: float = 0.0):
    return np.exp(-lam * x) * np.sin(omega * x + phi)


def smooth_labels(
    labels: np.ndarray,
    num_classes: int,
    alpha: float = 0.3,
    order: float = 1.0,
    lambda_decay: float = 1.0,
    kind: str = "rational",
    eps: float = 1e-6,
) -> np.ndarray:
    """Integer (D,H,W) -> smoothed float (D,H,W,C) labels."""
    onehot = np.eye(num_classes, dtype=np.float32)[labels.astype(np.int64)]
    dist = distance_fields(labels, num_classes)            # (C,D,H,W)
    if kind == "rational":
        decay = rational(dist, order, eps)
    elif kind == "exponential":
        decay = exponential_decay(dist, lambda_decay)
    elif kind == "damped_sine":
        decay = damped_sine(dist)
    else:
        raise NotImplementedError(kind)
    return np.abs(onehot - np.moveaxis(decay, 0, -1) * alpha)


class LabelSmoothingCacheDataset(CacheDataset):
    """CacheDataset whose labels are distance-smoothed float volumes
    (D, H, W, C): the raw label grid is smoothed at load time, before the
    window, foreground crop and respacing, and the resampled label keeps
    its C channels (nearest interpolation)."""

    def __init__(
        self,
        data: Sequence[Dict],
        *,
        num_classes: int = 14,
        smoothing_alpha: float = 0.3,
        smoothing_order: float = 1.0,
        num_workers: int = 8,
    ) -> None:
        def loader(item):
            img = to_ras(read_nifti(item["image"]))
            lab = to_ras(read_nifti(item["label"]))
            smoothed = smooth_labels(
                np.asarray(lab.data), num_classes, smoothing_alpha,
                smoothing_order,
            )
            image = T.scale_intensity_range(np.asarray(img.data, np.float32))
            image, smoothed = T.crop_foreground(image, smoothed)
            image = T.spacing_resample(image, img.spacing, order=1)
            smoothed = T.spacing_resample(smoothed, list(img.spacing) + [1.0],
                                          list(T.TARGET_SPACING) + [1.0],
                                          order=0)
            return {
                "image": np.ascontiguousarray(image, np.float32),
                "label": np.ascontiguousarray(smoothed, np.float32),
                "filename": item.get("image"),
                "spacing": np.asarray(T.TARGET_SPACING, np.float32),
            }

        super().__init__(list(data), mode="train", num_workers=num_workers,
                         item_loader=loader)


class LearnableLabelSmoothing(nn.Module):
    """Per-class learnable (alpha, beta) smoothing of one-hot labels by
    precomputed distance fields: |labels - alpha / (beta * dist + eps)|
    over (N, D, H, W, C); ``alpha`` starts at 0.3 and ``beta`` at 1, named
    as the flax parameters."""

    def __init__(self, num_classes: int, eps: float = 1e-6) -> None:
        super().__init__()
        self.eps = eps
        self.alpha = nn.Parameter(torch.full((num_classes,), 0.3))
        self.beta = nn.Parameter(torch.ones(num_classes))

    def forward(self, labels: torch.Tensor,
                distances: torch.Tensor) -> torch.Tensor:
        smooth = self.alpha / (self.beta * distances + self.eps)
        return torch.abs(labels - smooth)
