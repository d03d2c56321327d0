"""Distance-based label smoothing (numpy, host side).

A copy of the numpy functions of ``diff_unet_tpu/data/label_smoothing.py``
(that module cannot be imported without jax): the integer label volume is
one-hot encoded, per-class centroids are computed, voxel-to-centroid
distance fields derived, and the label becomes
``|onehot - decay(distance) * alpha|`` with decay rational
``1/(d^order + eps)``, exponential ``x exp(-lambda x)`` or a damped sine.
The learnable smoothing module is not ported yet.
"""
from __future__ import annotations

import numpy as np


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
