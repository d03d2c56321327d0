"""Offline visualization: segmentation overlays from the ``results.pkl``
that ``Tester.save_results`` writes (counterpart of
``diff_unet_tpu/utils/vis.py``). Renders axial slices of the CT volume with
label and prediction masks alpha-blended, one PNG per requested slice;
nothing is written without matplotlib.
"""
from __future__ import annotations

import pickle
from pathlib import Path
from typing import Optional, Sequence

import numpy as np


def _colormap(num_classes: int) -> np.ndarray:
    rng = np.random.RandomState(7)
    colors = rng.rand(num_classes, 3) * 0.8 + 0.2
    return colors


def overlay_slice(image2d: np.ndarray, mask2d: np.ndarray,
                  num_classes: int, alpha: float = 0.45) -> np.ndarray:
    """Grayscale slice + per-class colored mask -> RGB image."""
    img = image2d.astype(np.float32)
    lo, hi = img.min(), img.max()
    img = (img - lo) / (hi - lo + 1e-8)
    rgb = np.stack([img] * 3, axis=-1)
    colors = _colormap(num_classes + 1)
    for c in range(1, num_classes + 1):
        sel = mask2d == c
        rgb[sel] = (1 - alpha) * rgb[sel] + alpha * colors[c]
    return (rgb * 255).astype(np.uint8)


def save_overlay_png(path, image2d, mask2d, num_classes,
                     pred2d: Optional[np.ndarray] = None) -> bool:
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return False
    panels = [("image+label", overlay_slice(image2d, mask2d, num_classes))]
    if pred2d is not None:
        panels.append(("image+pred",
                       overlay_slice(image2d, pred2d, num_classes)))
    fig, axes = plt.subplots(1, len(panels), figsize=(5 * len(panels), 5))
    axes = np.atleast_1d(axes)
    for ax, (title, img) in zip(axes, panels):
        ax.imshow(img)
        ax.set_title(title)
        ax.axis("off")
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
    return True


def render_results(results_pkl, out_dir, num_classes: int,
                   slice_fracs: Sequence[float] = (0.25, 0.5, 0.75)) -> int:
    """Render overlays for every stored case; returns #PNGs written."""
    with open(results_pkl, "rb") as f:
        results = pickle.load(f)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    count = 0
    images = results.get("images") or []
    outputs = results.get("outputs") or []
    labels = results.get("labels") or []
    for i, (img, out, lab) in enumerate(zip(images, outputs, labels)):
        img = np.asarray(img)[..., 0] if np.ndim(img) == 4 else np.asarray(img)
        out_map = np.argmax(out, axis=-1) + 1 if np.ndim(out) == 4 else out
        lab_map = np.argmax(lab, axis=-1) + 1 if np.ndim(lab) == 4 else lab
        for frac in slice_fracs:
            z = int(img.shape[0] * frac)
            ok = save_overlay_png(
                out_dir / f"case{i}_z{z}.png", img[z], lab_map[z],
                num_classes, out_map[z],
            )
            count += int(ok)
    return count
