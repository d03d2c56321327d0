"""Segmentation metrics (counterpart of ``diff_unet_tpu/metrics/metrics.py``).

On the device, in torch: ``dice_coeff``, ``dice_per_class``,
``validation_dice`` and ``iou`` over channel-last one-hot masks (bool or
float, non-zero meaning set), with the JAX functions' semantics:
``validation_dice`` scores 1 for a class that is predicted but absent from
the label.

On the host, a copy of the JAX module's numpy suite: ``ConfusionMatrix``,
the surface distances (on the port's exact distance transform,
``ops/edt.py``, for 3D masks), ``hausdorff_distance(_95)``, the average
surface distances, and the function registry ``ALL_METRICS``, name for
name, with its NaN conventions for empty and full masks.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from scipy import ndimage as _ndi

from diff_unet_tpu_torch.ops import edt


# ---------- on the device (torch) ----------

def dice_coeff(result: torch.Tensor, reference: torch.Tensor) -> torch.Tensor:
    """2|A∩B| / (|A|+|B|), 0 when both are empty."""
    r = result.bool()
    g = reference.bool()
    intersection = (r & g).sum()
    size = r.sum() + g.sum()
    return torch.where(size > 0, 2.0 * intersection / size.clamp_min(1),
                       0.0)


def dice_per_class(outputs: torch.Tensor,
                   labels: torch.Tensor) -> torch.Tensor:
    """Per-class dice over channel-last one-hot masks (..., C) -> (C,)."""
    axes = tuple(range(outputs.dim() - 1))
    r = outputs.bool()
    g = labels.bool()
    inter = (r & g).sum(dim=axes).float()
    size = (r.sum(dim=axes) + g.sum(dim=axes)).float()
    return torch.where(size > 0, 2.0 * inter / size.clamp_min(1.0), 0.0)


def validation_dice(outputs: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """Per-class dice where a class with predictions but an empty label
    scores 1.0."""
    axes = tuple(range(outputs.dim() - 1))
    d = dice_per_class(outputs, labels)
    pred_any = outputs.bool().sum(dim=axes) > 0
    label_any = labels.bool().sum(dim=axes) > 0
    return torch.where(pred_any & ~label_any, 1.0, d)


def iou(result: torch.Tensor, reference: torch.Tensor) -> torch.Tensor:
    """|A∩B| / |A∪B|, 0 when both are empty."""
    r = result.bool()
    g = reference.bool()
    inter = (r & g).sum()
    union = (r | g).sum()
    return torch.where(union > 0, inter / union.clamp_min(1), 0.0)


# ---------- host-side (numpy/scipy) suite ----------

class ConfusionMatrix:
    """tp/fp/tn/fn plus derived scores (light_training metric.py:25-110)."""

    def __init__(self, test: Optional[np.ndarray] = None,
                 reference: Optional[np.ndarray] = None):
        self.test = None if test is None else np.asarray(test).astype(bool)
        self.reference = (
            None if reference is None else np.asarray(reference).astype(bool)
        )
        self._computed = False

    def compute(self):
        assert self.test is not None and self.reference is not None
        t, r = self.test, self.reference
        self.tp = int(np.sum(t & r))
        self.fp = int(np.sum(t & ~r))
        self.tn = int(np.sum(~t & ~r))
        self.fn = int(np.sum(~t & r))
        self.n = t.size
        self.test_empty = not t.any()
        self.test_full = t.all()
        self.reference_empty = not r.any()
        self.reference_full = r.all()
        self._computed = True

    def _ensure(self):
        if not self._computed:
            self.compute()

    def dice(self) -> float:
        self._ensure()
        denom = 2 * self.tp + self.fp + self.fn
        return 2 * self.tp / denom if denom > 0 else 0.0

    def jaccard(self) -> float:
        self._ensure()
        denom = self.tp + self.fp + self.fn
        return self.tp / denom if denom > 0 else 0.0

    def precision(self) -> float:
        self._ensure()
        denom = self.tp + self.fp
        return self.tp / denom if denom > 0 else 0.0

    def recall(self) -> float:
        self._ensure()
        denom = self.tp + self.fn
        return self.tp / denom if denom > 0 else 0.0

    sensitivity = recall

    def specificity(self) -> float:
        self._ensure()
        denom = self.tn + self.fp
        return self.tn / denom if denom > 0 else 0.0

    def accuracy(self) -> float:
        self._ensure()
        return (self.tp + self.tn) / self.n if self.n > 0 else 0.0

    # --- reference-parity accessors (metric.py:80-103) ---
    def get_matrix(self) -> Tuple[int, int, int, int]:
        self._ensure()
        return self.tp, self.fp, self.tn, self.fn

    def get_existence(self) -> Tuple[bool, bool, bool, bool]:
        self._ensure()
        return (self.test_empty, self.test_full,
                self.reference_empty, self.reference_full)


def _surface_distances(
    result: np.ndarray, reference: np.ndarray,
    voxelspacing=None,
) -> np.ndarray:
    """Distances from each border voxel of `result` to the border of
    `reference` (medpy __surface_distances semantics)."""
    result = np.atleast_1d(np.asarray(result).astype(bool))
    reference = np.atleast_1d(np.asarray(reference).astype(bool))
    conn = _ndi.generate_binary_structure(result.ndim, 1)
    r_border = result ^ _ndi.binary_erosion(result, conn, border_value=0)
    ref_border = reference ^ _ndi.binary_erosion(reference, conn,
                                                 border_value=0)
    if reference.ndim == 3:
        dt = edt.distance_transform_edt(~ref_border, voxelspacing)
    else:
        dt = _ndi.distance_transform_edt(~ref_border, sampling=voxelspacing)
    return dt[r_border]


def hausdorff_distance(result, reference, voxelspacing=None) -> float:
    """Symmetric Hausdorff distance (max of directed surface distances)."""
    hd1 = _surface_distances(result, reference, voxelspacing)
    hd2 = _surface_distances(reference, result, voxelspacing)
    if hd1.size == 0 or hd2.size == 0:
        return float("nan")
    return float(max(hd1.max(), hd2.max()))


def hausdorff_distance_95(result, reference, voxelspacing=None) -> float:
    """95th-percentile symmetric Hausdorff distance (HD95)."""
    hd1 = _surface_distances(result, reference, voxelspacing)
    hd2 = _surface_distances(reference, result, voxelspacing)
    if hd1.size == 0 or hd2.size == 0:
        return float("nan")
    return float(np.percentile(np.hstack([hd1, hd2]), 95))


def average_surface_distance(result, reference, voxelspacing=None) -> float:
    sds = _surface_distances(result, reference, voxelspacing)
    return float(sds.mean()) if sds.size else float("nan")


def average_symmetric_surface_distance(result, reference,
                                       voxelspacing=None) -> float:
    s1 = _surface_distances(result, reference, voxelspacing)
    s2 = _surface_distances(reference, result, voxelspacing)
    if s1.size == 0 or s2.size == 0:
        return float("nan")
    return float(np.hstack([s1, s2]).mean())


# ---------- function-style metric suite ----------
# Name-for-name parity with the reference registry
# (light_training/evaluation/metric.py:105-409): every function takes
# (test, reference, confusion_matrix=None, nan_for_nonexisting=True) and
# reproduces the reference's empty/full-mask NaN conventions.

def _cm(test, reference, confusion_matrix) -> ConfusionMatrix:
    return (confusion_matrix if confusion_matrix is not None
            else ConfusionMatrix(test, reference))


def _nan_or_zero(nan_for_nonexisting: bool) -> float:
    return float("nan") if nan_for_nonexisting else 0.0


def dice(test=None, reference=None, confusion_matrix=None,
         nan_for_nonexisting=True, **kwargs) -> float:
    """2TP / (2TP + FP + FN); NaN when both masks empty (metric.py:105-121)."""
    cm = _cm(test, reference, confusion_matrix)
    tp, fp, tn, fn = cm.get_matrix()
    t_e, _, r_e, _ = cm.get_existence()
    if t_e and r_e:
        return _nan_or_zero(nan_for_nonexisting)
    return float(2.0 * tp / (2 * tp + fp + fn))


def jaccard(test=None, reference=None, confusion_matrix=None,
            nan_for_nonexisting=True, **kwargs) -> float:
    """TP / (TP + FP + FN); NaN when both masks empty (metric.py:123-139)."""
    cm = _cm(test, reference, confusion_matrix)
    tp, fp, tn, fn = cm.get_matrix()
    t_e, _, r_e, _ = cm.get_existence()
    if t_e and r_e:
        return _nan_or_zero(nan_for_nonexisting)
    return float(tp / (tp + fp + fn))


def precision(test=None, reference=None, confusion_matrix=None,
              nan_for_nonexisting=True, **kwargs) -> float:
    """TP / (TP + FP); NaN when the prediction is empty (metric.py:141-156)."""
    cm = _cm(test, reference, confusion_matrix)
    tp, fp, tn, fn = cm.get_matrix()
    t_e, _, _, _ = cm.get_existence()
    if t_e:
        return _nan_or_zero(nan_for_nonexisting)
    return float(tp / (tp + fp))


def sensitivity(test=None, reference=None, confusion_matrix=None,
                nan_for_nonexisting=True, **kwargs) -> float:
    """TP / (TP + FN); NaN when the reference is empty (metric.py:159-175)."""
    cm = _cm(test, reference, confusion_matrix)
    tp, fp, tn, fn = cm.get_matrix()
    _, _, r_e, _ = cm.get_existence()
    if r_e:
        return _nan_or_zero(nan_for_nonexisting)
    return float(tp / (tp + fn))


def recall(test=None, reference=None, confusion_matrix=None,
           nan_for_nonexisting=True, **kwargs) -> float:
    return sensitivity(test, reference, confusion_matrix,
                       nan_for_nonexisting, **kwargs)


def specificity(test=None, reference=None, confusion_matrix=None,
                nan_for_nonexisting=True, **kwargs) -> float:
    """TN / (TN + FP); NaN when the reference is full (metric.py:183-199)."""
    cm = _cm(test, reference, confusion_matrix)
    tp, fp, tn, fn = cm.get_matrix()
    _, _, _, r_f = cm.get_existence()
    if r_f:
        return _nan_or_zero(nan_for_nonexisting)
    return float(tn / (tn + fp))


def accuracy(test=None, reference=None, confusion_matrix=None,
             **kwargs) -> float:
    """(TP + TN) / N (metric.py:201-210)."""
    cm = _cm(test, reference, confusion_matrix)
    tp, fp, tn, fn = cm.get_matrix()
    return float((tp + tn) / (tp + fp + tn + fn))


def fscore(test=None, reference=None, confusion_matrix=None,
           nan_for_nonexisting=True, beta=1.0, **kwargs) -> float:
    """(1+b^2)·P·R / (b^2·P + R) (metric.py:212-219). NaN when the
    denominator vanishes (the reference raises ZeroDivisionError there —
    documented deviation)."""
    cm = _cm(test, reference, confusion_matrix)
    p = precision(confusion_matrix=cm, nan_for_nonexisting=nan_for_nonexisting)
    r = recall(confusion_matrix=cm, nan_for_nonexisting=nan_for_nonexisting)
    denom = beta * beta * p + r
    if denom == 0 or np.isnan(denom):
        return float("nan")
    return float((1 + beta * beta) * p * r / denom)


def false_positive_rate(test=None, reference=None, confusion_matrix=None,
                        nan_for_nonexisting=True, **kwargs) -> float:
    """FP / (FP + TN) = 1 - specificity (metric.py:222-225)."""
    return 1 - specificity(test, reference, confusion_matrix,
                           nan_for_nonexisting)


def false_omission_rate(test=None, reference=None, confusion_matrix=None,
                        nan_for_nonexisting=True, **kwargs) -> float:
    """FN / (TN + FN); NaN when the prediction is full (metric.py:228-243)."""
    cm = _cm(test, reference, confusion_matrix)
    tp, fp, tn, fn = cm.get_matrix()
    _, t_f, _, _ = cm.get_existence()
    if t_f:
        return _nan_or_zero(nan_for_nonexisting)
    return float(fn / (fn + tn))


def false_negative_rate(test=None, reference=None, confusion_matrix=None,
                        nan_for_nonexisting=True, **kwargs) -> float:
    """FN / (TP + FN) = 1 - sensitivity (metric.py:246-249)."""
    return 1 - sensitivity(test, reference, confusion_matrix,
                           nan_for_nonexisting)


def true_negative_rate(test=None, reference=None, confusion_matrix=None,
                       nan_for_nonexisting=True, **kwargs) -> float:
    """TN / (TN + FP) = specificity (metric.py:252-255)."""
    return specificity(test, reference, confusion_matrix, nan_for_nonexisting)


def false_discovery_rate(test=None, reference=None, confusion_matrix=None,
                         nan_for_nonexisting=True, **kwargs) -> float:
    """FP / (TP + FP) = 1 - precision (metric.py:258-261)."""
    return 1 - precision(test, reference, confusion_matrix,
                         nan_for_nonexisting)


def negative_predictive_value(test=None, reference=None,
                              confusion_matrix=None,
                              nan_for_nonexisting=True, **kwargs) -> float:
    """TN / (TN + FN) = 1 - false omission rate (metric.py:264-267)."""
    return 1 - false_omission_rate(test, reference, confusion_matrix,
                                   nan_for_nonexisting)


def total_positives_test(test=None, reference=None, confusion_matrix=None,
                         **kwargs) -> int:
    """TP + FP (metric.py:270-278)."""
    cm = _cm(test, reference, confusion_matrix)
    tp, fp, tn, fn = cm.get_matrix()
    return tp + fp


def total_negatives_test(test=None, reference=None, confusion_matrix=None,
                         **kwargs) -> int:
    """TN + FN (metric.py:281-289)."""
    cm = _cm(test, reference, confusion_matrix)
    tp, fp, tn, fn = cm.get_matrix()
    return tn + fn


def total_positives_reference(test=None, reference=None,
                              confusion_matrix=None, **kwargs) -> int:
    """TP + FN (metric.py:292-300)."""
    cm = _cm(test, reference, confusion_matrix)
    tp, fp, tn, fn = cm.get_matrix()
    return tp + fn


def total_negatives_reference(test=None, reference=None,
                              confusion_matrix=None, **kwargs) -> int:
    """TN + FP (metric.py:303-311)."""
    cm = _cm(test, reference, confusion_matrix)
    tp, fp, tn, fn = cm.get_matrix()
    return tn + fp


def _distance_guard(test, reference, confusion_matrix, nan_for_nonexisting):
    """Reference distance metrics return NaN for empty OR full masks
    (metric.py:314-330 and siblings)."""
    cm = _cm(test, reference, confusion_matrix)
    t_e, t_f, r_e, r_f = cm.get_existence()
    if t_e or t_f or r_e or r_f:
        return cm, _nan_or_zero(nan_for_nonexisting)
    return cm, None


def hausdorff_distance_m(test=None, reference=None, confusion_matrix=None,
                         nan_for_nonexisting=True, voxel_spacing=None,
                         **kwargs) -> float:
    cm, guard = _distance_guard(test, reference, confusion_matrix,
                                nan_for_nonexisting)
    if guard is not None:
        return guard
    return hausdorff_distance(cm.test, cm.reference, voxel_spacing)


def hausdorff_distance_95_m(test=None, reference=None, confusion_matrix=None,
                            nan_for_nonexisting=True, voxel_spacing=None,
                            **kwargs) -> float:
    cm, guard = _distance_guard(test, reference, confusion_matrix,
                                nan_for_nonexisting)
    if guard is not None:
        return guard
    return hausdorff_distance_95(cm.test, cm.reference, voxel_spacing)


def avg_surface_distance(test=None, reference=None, confusion_matrix=None,
                         nan_for_nonexisting=True, voxel_spacing=None,
                         **kwargs) -> float:
    cm, guard = _distance_guard(test, reference, confusion_matrix,
                                nan_for_nonexisting)
    if guard is not None:
        return guard
    return average_surface_distance(cm.test, cm.reference, voxel_spacing)


def avg_surface_distance_symmetric(test=None, reference=None,
                                   confusion_matrix=None,
                                   nan_for_nonexisting=True,
                                   voxel_spacing=None, **kwargs) -> float:
    cm, guard = _distance_guard(test, reference, confusion_matrix,
                                nan_for_nonexisting)
    if guard is not None:
        return guard
    return average_symmetric_surface_distance(cm.test, cm.reference,
                                              voxel_spacing)


# Name-for-name parity with the reference's ALL_METRICS
# (light_training/evaluation/metric.py:389-409) — including its
# lower-case "total Negatives Reference" key, kept verbatim so lookups
# written against the reference keep working.
ALL_METRICS = {
    "False Positive Rate": false_positive_rate,
    "Dice": dice,
    "Jaccard": jaccard,
    "Hausdorff Distance": hausdorff_distance_m,
    "Hausdorff Distance 95": hausdorff_distance_95_m,
    "Precision": precision,
    "Recall": recall,
    "Avg. Symmetric Surface Distance": avg_surface_distance_symmetric,
    "Avg. Surface Distance": avg_surface_distance,
    "Accuracy": accuracy,
    "False Omission Rate": false_omission_rate,
    "Negative Predictive Value": negative_predictive_value,
    "False Negative Rate": false_negative_rate,
    "True Negative Rate": true_negative_rate,
    "False Discovery Rate": false_discovery_rate,
    "Total Positives Test": total_positives_test,
    "Total Negatives Test": total_negatives_test,
    "Total Positives Reference": total_positives_reference,
    "total Negatives Reference": total_negatives_reference,
}
