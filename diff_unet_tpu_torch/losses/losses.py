"""Segmentation losses over channel-last (NDHWC) logits and labels
(counterpart of ``diff_unet_tpu/losses/losses.py``).

Ported: ``mse`` (on sigmoid probabilities), ``bce`` (with logits) and
``dice`` (MONAI ``DiceLoss(sigmoid=True)``), combined by ``sum``, ``mean``
or ``log`` as ``CompositeLoss`` does; the JAX package's lane fold is a TPU
layout and is left out. The other names of the registry raise
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch

_SMOOTH_NR = 1e-5
_SMOOTH_DR = 1e-5

# the JAX package's registry names that are not ported yet
_NOT_PORTED = ("ce", "focal", "dice_ce", "dice_focal", "generalized_dice",
               "generalized_dice_focal", "multi_neighbor", "hausdorff_er",
               "hausdorff_dt", "boundary", "generalized_wasserstein_dice")


def mse_loss(preds: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """MSE on sigmoid probabilities."""
    return torch.mean(torch.square(torch.sigmoid(preds) - labels))


def bce_loss(preds: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy with logits, in the stable form
    max(x, 0) - x*y + log(1 + exp(-|x|))."""
    return torch.mean(torch.clamp(preds, min=0) - preds * labels
                      + torch.log1p(torch.exp(-torch.abs(preds))))


def dice_loss(preds: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Soft Dice on sigmoid probabilities, per (batch, class) over the
    spatial axes, averaged."""
    p = torch.sigmoid(preds)
    axes = tuple(range(1, p.dim() - 1))
    inter = torch.sum(p * labels, dim=axes)
    denom = torch.sum(p, dim=axes) + torch.sum(labels, dim=axes)
    return torch.mean(1.0 - (2.0 * inter + _SMOOTH_NR)
                      / (denom + _SMOOTH_DR))


_LOSSES: Dict[str, Callable] = {"mse": mse_loss, "bce": bce_loss,
                                "dice": dice_loss}


class CompositeLoss:
    """``CompositeLoss("mse,bce,dice", num_classes, combine="sum")(preds,
    labels)``: preds are logits (N, D, H, W, C), labels float of the same
    shape (one-hot or smoothed)."""

    def __init__(self, losses: str, num_classes: int,
                 combine: str = "sum") -> None:
        self.num_classes = num_classes
        self.names: Sequence[str] = [s.strip() for s in losses.split(",")]
        for name in self.names:
            if name in _NOT_PORTED:
                raise NotImplementedError(
                    f"loss {name!r} is not ported to diff_unet_tpu_torch yet "
                    "(ROADMAP.md, training path)")
            if name not in _LOSSES:
                raise NotImplementedError(f"Loss ({name}) is not listed yet")
        if combine not in ("sum", "mean", "log"):
            raise NotImplementedError(
                "Unsupported loss_combine; choose from 'sum', 'mean', 'log'.")
        self.combine = combine

    def __call__(self, preds: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
        if preds.shape[-1] != self.num_classes:
            raise ValueError(
                f"preds have {preds.shape[-1]} channels but CompositeLoss was "
                f"configured for num_classes={self.num_classes}; check the "
                "include_background setting (it adds/removes the background "
                "channel before the loss)")
        values = [_LOSSES[name](preds, labels) for name in self.names]
        if len(values) == 1:
            return values[0]
        total = torch.stack(values)
        if self.combine == "sum":
            return total.sum()
        if self.combine == "mean":
            return total.mean()
        return torch.log1p(total.sum())
