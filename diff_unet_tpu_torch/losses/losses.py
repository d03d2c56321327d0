"""Segmentation losses over channel-last (NDHWC) logits and labels
(counterpart of ``diff_unet_tpu/losses/losses.py``): the whole registry.

``mse`` (on sigmoid probabilities), ``ce``, ``bce`` (with logits),
``dice`` (MONAI ``DiceLoss(sigmoid=True)``), ``focal`` (sigmoid focal,
gamma 2, no alpha), ``dice_ce``, ``dice_focal``, ``generalized_dice``
(weights 1/|G_c|^2, an empty class takes its row's largest weight),
``generalized_dice_focal``, ``generalized_wasserstein_dice`` (on argmax
class labels, all-ones distance matrix), ``boundary`` (on precomputed
signed distance maps, ``losses/edt.py``), ``hausdorff_er`` (five erosions
by a depthwise 6-connected cross, each min-max normalised over the whole
tensor, in float32 as the JAX package computes it), ``hausdorff_dt`` (on a
chamfer approximation of the distance fields) and ``multi_neighbor``
(centroid-angle consistency on argmax maps), combined by ``sum``, ``mean``
or ``log`` as ``CompositeLoss`` does. The JAX package's lane fold is a TPU
layout and is left out.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

_SMOOTH_NR = 1e-5
_SMOOTH_DR = 1e-5


def _spatial_axes(x: torch.Tensor) -> tuple:
    return tuple(range(1, x.dim() - 1))


def _bce(preds: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy with logits, in the stable form
    max(x, 0) - x*y + log(1 + exp(-|x|))."""
    return (torch.clamp(preds, min=0) - preds * labels
            + torch.log1p(torch.exp(-torch.abs(preds))))


def mse_loss(preds: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """MSE on sigmoid probabilities."""
    return torch.mean(torch.square(torch.sigmoid(preds) - labels))


def bce_loss(preds: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy with logits."""
    return torch.mean(_bce(preds, labels))


def ce_loss(preds: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Softmax cross-entropy against one-hot or probability labels."""
    logp = torch.log_softmax(preds, dim=-1)
    return -torch.mean(torch.sum(labels * logp, dim=-1))


def dice_loss(preds: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Soft Dice on sigmoid probabilities, per (batch, class) over the
    spatial axes, averaged."""
    p = torch.sigmoid(preds)
    axes = _spatial_axes(p)
    inter = torch.sum(p * labels, dim=axes)
    denom = torch.sum(p, dim=axes) + torch.sum(labels, dim=axes)
    return torch.mean(1.0 - (2.0 * inter + _SMOOTH_NR)
                      / (denom + _SMOOTH_DR))


def focal_loss(preds: torch.Tensor, labels: torch.Tensor,
               gamma: float = 2.0) -> torch.Tensor:
    """Sigmoid focal loss, MONAI ``FocalLoss`` defaults (gamma 2, no
    alpha): mean of (1 - p_t)^gamma * bce."""
    p = torch.sigmoid(preds)
    p_t = p * labels + (1.0 - p) * (1.0 - labels)
    return torch.mean(torch.pow(1.0 - p_t, gamma) * _bce(preds, labels))


def dice_ce_loss(preds, labels) -> torch.Tensor:
    return dice_loss(preds, labels) + ce_loss(preds, labels)


def dice_focal_loss(preds, labels) -> torch.Tensor:
    return dice_loss(preds, labels) + focal_loss(preds, labels)


def generalized_dice_loss(preds: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Generalized Dice (Sudre et al.) on sigmoid probabilities: class
    weights 1/|G_c|^2 per (batch, class); an empty class takes the largest
    weight of its row."""
    p = torch.sigmoid(preds)
    axes = _spatial_axes(p)
    inter = torch.sum(p * labels, dim=axes)                 # (B, C)
    gsum = torch.sum(labels, dim=axes)
    psum = torch.sum(p, dim=axes)
    present = gsum > 0
    w = 1.0 / torch.square(torch.clamp(gsum, min=1e-6))
    w = torch.where(present, w, torch.zeros_like(w))
    w_max = torch.amax(w, dim=-1, keepdim=True)
    w = torch.where(present, w, w_max)
    numer = 2.0 * torch.sum(w * inter, dim=-1) + _SMOOTH_NR
    denom = torch.sum(w * (psum + gsum), dim=-1) + _SMOOTH_DR
    return torch.mean(1.0 - numer / denom)


def generalized_dice_focal_loss(preds, labels) -> torch.Tensor:
    return generalized_dice_loss(preds, labels) + focal_loss(preds, labels)


def generalized_wasserstein_dice_loss(preds: torch.Tensor,
                                      class_labels: torch.Tensor,
                                      smooth: float = 1e-5) -> torch.Tensor:
    """Generalized Wasserstein Dice (Fidon et al. 2017) against integer
    class labels, with the all-ones distance matrix."""
    c = preds.shape[-1]
    dist = torch.ones((c, c), dtype=torch.float32, device=preds.device)
    probs = torch.softmax(preds, dim=-1)
    flat_p = probs.reshape(probs.shape[0], -1, c)            # (B, N, C)
    flat_t = class_labels.reshape(class_labels.shape[0], -1)  # (B, N)
    wass = torch.sum(dist[flat_t] * flat_p, dim=-1)          # (B, N)
    alpha = dist[flat_t, 0]
    tp = torch.sum(alpha * (1.0 - wass), dim=-1)
    denom = torch.sum(alpha, dim=-1) + torch.sum(alpha * wass, dim=-1)
    score = (2.0 * tp + smooth) / (denom + tp + smooth)
    return torch.mean(1.0 - score)


def boundary_loss(preds: torch.Tensor,
                  dist_maps: torch.Tensor) -> torch.Tensor:
    """Boundary loss: the sum over classes of mean(preds * signed
    distance), divided by C * B."""
    c, b = preds.shape[-1], preds.shape[0]
    per_class = torch.mean(preds * dist_maps,
                           dim=(0, *range(1, preds.dim() - 1)))
    return torch.sum(per_class) / (c * b)


def _cross_kernel(c: int, device: torch.device) -> torch.Tensor:
    """The 6-connected 3x3x3 cross normalised by 7, as a depthwise
    (C, 1, 3, 3, 3) float32 conv weight."""
    k = torch.zeros((3, 3, 3), dtype=torch.float32)
    for idx in ((1, 1, 1), (0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1),
                (1, 1, 0), (1, 1, 2)):
        k[idx] = 1.0
    return (k / 7.0).expand(c, 1, 3, 3, 3).contiguous().to(device)


def hausdorff_er_loss(preds: torch.Tensor, labels: torch.Tensor,
                      erosions: int = 5, alpha: float = 2.0
                      ) -> torch.Tensor:
    """Morphological-erosion Hausdorff loss: (preds - labels)^2 in
    float32, eroded ``erosions`` times by the cross (a shape-preserving
    depthwise conv), each erosion min-max normalised over the whole tensor
    and weighted by (k + 1)^alpha; log1p of the mean."""
    bound = torch.square(preds - labels).float()
    c = bound.shape[-1]
    kernel = _cross_kernel(c, bound.device)
    eroded = bound.permute(0, 4, 1, 2, 3)                    # NCDHW
    total = torch.zeros_like(eroded)
    zero = torch.zeros((), dtype=eroded.dtype, device=eroded.device)
    for k in range(erosions):
        dil = F.conv3d(eroded, kernel, padding=1, groups=c)
        ero = torch.maximum(dil - 0.5, zero)
        lo = torch.amin(ero)
        ptp = torch.amax(ero) - lo
        ero = torch.where(ptp > 0, (ero - lo) / torch.clamp(ptp, min=1e-12),
                          ero)
        total = total + ero * float(k + 1.0) ** alpha
        eroded = ero
    return torch.log1p(torch.mean(torch.nan_to_num(total)))


def approx_distance_field(mask: torch.Tensor,
                          iterations: int = 10) -> torch.Tensor:
    """Chamfer approximation of the distance to the mask (> 0.5) of an
    (N, D, H, W, C) tensor: ``iterations`` rounds of 6-neighbour
    min-propagation from 0 on the mask and ``iterations + 1`` elsewhere.
    Carries no gradient."""
    big = float(iterations + 1)
    with torch.no_grad():
        d = torch.where(mask > 0.5, torch.zeros_like(mask),
                        torch.full_like(mask, big))
        centre = [slice(None)] + [slice(1, 1 + s) for s in d.shape[1:4]] \
            + [slice(None)]
        for _ in range(iterations):
            padded = F.pad(d, (0, 0, 1, 1, 1, 1, 1, 1), value=big)
            m = d
            for axis in (1, 2, 3):
                for off in (0, 2):
                    idx = list(centre)
                    idx[axis] = slice(off, off + d.shape[axis])
                    m = torch.minimum(m, padded[tuple(idx)] + 1.0)
            d = m
    return d


def hausdorff_dt_loss(preds: torch.Tensor, labels: torch.Tensor,
                      alpha: float = 2.0,
                      dt_iterations: int = 10) -> torch.Tensor:
    """Distance-transform Hausdorff loss: mean of (p - g)^2 *
    (dt(p)^alpha + dt(g)^alpha), p = sigmoid(preds), the fields from
    ``approx_distance_field``."""
    p = torch.sigmoid(preds)
    pred_dt = approx_distance_field(p, dt_iterations)
    target_dt = approx_distance_field(labels, dt_iterations)
    field = torch.square(p - labels) * (torch.pow(pred_dt, alpha)
                                        + torch.pow(target_dt, alpha))
    return torch.mean(field)


def _class_centroids(class_map: torch.Tensor, num_classes: int,
                     dtype: torch.dtype):
    """Centroids (C, 3) of an integer (D, H, W) class map, and which
    classes are present."""
    onehot = F.one_hot(class_map, num_classes).to(dtype)    # (D, H, W, C)
    counts = onehot.sum(dim=(0, 1, 2))
    grids = torch.meshgrid(*[torch.arange(s, device=class_map.device,
                                          dtype=torch.float32)
                             for s in class_map.shape], indexing="ij")
    cents = torch.stack([(onehot * g[..., None].to(dtype)).sum(dim=(0, 1, 2))
                         for g in grids], dim=-1)
    return cents / torch.clamp(counts, min=1.0)[:, None], counts > 0


def _pairwise_angles(centroids: torch.Tensor, eps: float) -> torch.Tensor:
    """Angle at vertex i between the rays i->j and i->k, (C, C, C)."""
    diff = centroids[:, None, :] - centroids[None, :, :]
    norms = torch.sqrt(torch.sum(torch.square(diff), dim=-1, keepdim=True))
    norms = torch.where(norms > 0, norms, torch.ones_like(norms))
    unit = diff / (norms + eps)
    dots = torch.einsum("ijd,ikd->ijk", unit, unit)
    return torch.arccos(torch.clamp(dots, -1.0 + eps, 1.0 - eps))


def multi_neighbor_loss(preds: torch.Tensor, labels: torch.Tensor,
                        eps: float = 1e-6) -> torch.Tensor:
    """Inter-organ centroid-angle consistency between the argmax maps of
    sigmoid(preds) and of labels, over the class triples present in the
    label (j < k). Argmax carries no gradient."""
    c = preds.shape[-1]
    dt = preds.dtype
    triu = torch.triu(torch.ones((c, c), dtype=dt, device=preds.device), 1)
    sums, counts = [], []
    for p, lab in zip(preds, labels):
        l_cents, valid = _class_centroids(torch.argmax(lab, dim=-1), c, dt)
        p_cents, _ = _class_centroids(
            torch.argmax(torch.sigmoid(p), dim=-1), c, dt)
        v = valid.to(dt)
        mask = v[:, None, None] * v[None, :, None] * v[None, None, :]
        mask = mask * triu[None]
        delta = torch.square(_pairwise_angles(p_cents, eps)
                             - _pairwise_angles(l_cents, eps)) * mask
        cnt = mask.sum()
        sums.append(torch.where(cnt > 0, delta.sum(), torch.zeros_like(cnt)))
        counts.append(torch.clamp(cnt, min=1.0))
    return torch.stack(sums).sum() / torch.stack(counts).sum()


_LOSSES: Dict[str, Callable] = {
    "mse": mse_loss,
    "ce": ce_loss,
    "bce": bce_loss,
    "dice": dice_loss,
    "focal": focal_loss,
    "dice_ce": dice_ce_loss,
    "dice_focal": dice_focal_loss,
    "generalized_dice": generalized_dice_loss,
    "generalized_dice_focal": generalized_dice_focal_loss,
    "multi_neighbor": multi_neighbor_loss,
    "hausdorff_er": hausdorff_er_loss,
    "hausdorff_dt": hausdorff_dt_loss,
}
# the names that take other inputs than (preds, one-hot labels)
_SPECIAL = ("boundary", "generalized_wasserstein_dice")
LOSS_NAMES = tuple(_LOSSES) + _SPECIAL


class CompositeLoss:
    """``CompositeLoss("mse,bce,dice", num_classes, combine="sum")(preds,
    labels, dist_maps=None)``: preds are logits (N, D, H, W, C), labels
    float of the same shape (one-hot or smoothed), ``dist_maps`` the
    signed distance maps of the labels (same shape), which ``boundary``
    needs."""

    def __init__(self, losses: str, num_classes: int,
                 combine: str = "sum") -> None:
        self.num_classes = num_classes
        self.names: Sequence[str] = [s.strip() for s in losses.split(",")]
        for name in self.names:
            if name not in LOSS_NAMES:
                raise NotImplementedError(f"Loss ({name}) is not listed yet")
        if combine not in ("sum", "mean", "log"):
            raise NotImplementedError(
                "Unsupported loss_combine; choose from 'sum', 'mean', 'log'.")
        self.combine = combine

    @property
    def needs_dist_maps(self) -> bool:
        return "boundary" in self.names

    def __call__(self, preds: torch.Tensor, labels: torch.Tensor,
                 dist_maps: Optional[torch.Tensor] = None) -> torch.Tensor:
        if preds.shape[-1] != self.num_classes:
            raise ValueError(
                f"preds have {preds.shape[-1]} channels but CompositeLoss was "
                f"configured for num_classes={self.num_classes}; check the "
                "include_background setting (it adds/removes the background "
                "channel before the loss)")
        values: List[torch.Tensor] = []
        for name in self.names:
            if name == "boundary":
                if dist_maps is None:
                    raise ValueError(
                        "boundary loss requires precomputed dist_maps")
                values.append(boundary_loss(preds, dist_maps))
            elif name == "generalized_wasserstein_dice":
                values.append(generalized_wasserstein_dice_loss(
                    preds, torch.argmax(labels, dim=-1)))
            else:
                values.append(_LOSSES[name](preds, labels))
        if len(values) == 1:
            return values[0]
        total = torch.stack([v.to(preds.dtype) for v in values])
        if self.combine == "sum":
            return total.sum()
        if self.combine == "mean":
            return total.mean()
        return torch.log1p(total.sum())
