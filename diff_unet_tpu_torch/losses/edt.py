"""Signed distance maps for the boundary loss (counterpart of
``diff_unet_tpu/losses/edt.py``), on the host.

signed distance = edt(~mask) * ~mask - (edt(mask) - 1) * mask per class:
positive outside the object, negative inside, zeros for an absent class.
The distance transform is the port's exact C++ one (``ops/edt.py``,
``csrc/edt.cpp``); where it cannot be built, these raise.
"""
from __future__ import annotations

import numpy as np

from diff_unet_tpu_torch.ops.edt import distance_transform_edt


def signed_distance_maps(onehot: np.ndarray, sampling=None) -> np.ndarray:
    """float32 per-class signed distance maps of a one-hot (C, D, H, W)
    label volume."""
    onehot = np.asarray(onehot)
    res = np.zeros(onehot.shape, dtype=np.float32)
    for k in range(onehot.shape[0]):
        posmask = onehot[k].astype(bool)
        if not posmask.any():
            continue
        negmask = ~posmask
        res[k] = (distance_transform_edt(negmask, sampling) * negmask
                  - (distance_transform_edt(posmask, sampling) - 1)
                  * posmask)
    return res


def one_hot_to_dist(onehot: np.ndarray, sampling=None) -> np.ndarray:
    """The reference's ``one_hot2dist`` name for ``signed_distance_maps``."""
    return signed_distance_maps(onehot, sampling)


def batch_dist_maps(labels: np.ndarray) -> np.ndarray:
    """Signed distance maps of a batch of channel-last one-hot labels
    (B, D, H, W, C), in the same layout."""
    return np.stack([signed_distance_maps(np.moveaxis(lab, -1, 0))
                     .transpose(1, 2, 3, 0) for lab in np.asarray(labels)])
