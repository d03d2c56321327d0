"""Host-side preprocessing and augmentation transforms (numpy,
channel-last).

A copy of ``diff_unet_tpu/data/transforms.py`` (that module cannot be
imported without jax). The pipeline:

train: ScaleIntensityRange(-175..250 -> 0..1, clip) -> CropForeground ->
RAS (at load) -> Spacing((1.5, 1.5, 2.0), bilinear/nearest) ->
RandCropByPosNegLabel((96, 96, 96), pos=1, neg=1) -> RandFlip x3 (p=.1) ->
RandRotate90 (p=.1) -> RandScaleIntensity(.1, p=.1) ->
RandShiftIntensity(.1, p=.5)
val: the deterministic prefix; test: load + window only.

Every random transform takes an explicit ``np.random.Generator`` (seeded
per (seed, epoch) by the loader), so the same seed draws the same crops
and flips as the JAX package's loader.

Volumes are (D, H, W) or (D, H, W, C) numpy arrays; images get a trailing
channel axis at the end of the pipeline.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from scipy import ndimage as _ndi

# the voxel grid every volume is resampled to, and the CT intensity window
# mapped to [0, 1], in every config (the reference's Spacingd and
# ScaleIntensityRanged)
TARGET_SPACING = (1.5, 1.5, 2.0)
A_MIN, A_MAX = -175.0, 250.0


def scale_intensity_range(
    img: np.ndarray,
    a_min: float = A_MIN,
    a_max: float = A_MAX,
    b_min: float = 0.0,
    b_max: float = 1.0,
    clip: bool = True,
) -> np.ndarray:
    img = (img.astype(np.float32) - a_min) / (a_max - a_min)
    img = img * (b_max - b_min) + b_min
    if clip:
        img = np.clip(img, b_min, b_max)
    return img


def foreground_bbox(img: np.ndarray, threshold: float = 0.0,
                    margin: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Bounding box (start, end) of voxels where img > threshold."""
    mask = img > threshold
    if not mask.any():
        return np.zeros(3, int), np.asarray(img.shape[:3], int)
    coords = np.nonzero(mask)
    start = np.array([max(int(c.min()) - margin, 0) for c in coords[:3]])
    end = np.array([
        min(int(c.max()) + 1 + margin, s)
        for c, s in zip(coords[:3], img.shape[:3])
    ])
    return start, end


def crop_foreground(image: np.ndarray, label: Optional[np.ndarray] = None,
                    threshold: float = 0.0):
    """CropForegroundd(source_key="image") parity."""
    start, end = foreground_bbox(image, threshold)
    sl = tuple(slice(int(s), int(e)) for s, e in zip(start, end))
    image = image[sl]
    if label is not None:
        label = label[sl]
    return image, label


def spacing_resample(
    vol: np.ndarray,
    current_spacing: Sequence[float],
    target_spacing: Sequence[float] = TARGET_SPACING,
    order: int = 1,
) -> np.ndarray:
    """Spacingd parity: resample to the target voxel spacing.

    order=1 (trilinear) for images, order=0 (nearest) for labels.

    Coordinate convention: half-pixel centers (`grid_mode=True`), i.e.
    x_in = (x_out + 0.5) / zoom - 0.5 with edge clamping — the same
    align_corners=False convention MONAI's Spacingd uses by default.
    Output size is round(in * zoom) (MONAI derives it from the physical
    extent; the two agree for exact ratios and differ by at most one voxel
    otherwise).
    """
    zoom = np.asarray(current_spacing, float) / np.asarray(target_spacing,
                                                           float)
    if np.allclose(zoom, 1.0):
        return vol
    if vol.ndim > len(zoom):
        zoom = np.concatenate([zoom, np.ones(vol.ndim - len(zoom))])
    out = _ndi.zoom(vol, zoom, order=order, mode="nearest",
                    grid_mode=True, prefilter=(order > 1))
    return np.ascontiguousarray(out)


def resampled_affine(
    affine: np.ndarray,
    current_spacing: Sequence[float],
    target_spacing: Sequence[float],
) -> np.ndarray:
    """World affine of the `spacing_resample` output grid.

    Carries the FULL direction matrix (rotation/shear included — a
    synthesized diagonal affine silently lands non-axis-aligned scans in a
    different world frame) and the half-pixel origin
    shift of the grid_mode=True convention: output voxel 0 sits at input
    index 0.5*(1/zoom - 1) per axis.
    """
    zoom = np.asarray(current_spacing, float) / np.asarray(
        target_spacing, float)
    out = np.asarray(affine, float).copy()
    rot = out[:3, :3].copy()
    out[:3, :3] = rot / zoom          # column k scaled by 1/zoom[k]
    out[:3, 3] = affine[:3, 3] + rot @ (0.5 * (1.0 / zoom - 1.0))
    return out


def pad_to_min_size(vol: np.ndarray, size: Sequence[int],
                    mode: str = "constant"):
    """Symmetrically pad spatial dims up to at least `size` (MONAI pads
    before RandCropByPosNegLabeld when the volume is smaller)."""
    pads = []
    for s, want in zip(vol.shape[:3], size):
        extra = max(0, want - s)
        pads.append((extra // 2, extra - extra // 2))
    pads += [(0, 0)] * (vol.ndim - 3)
    if any(p != (0, 0) for p in pads):
        vol = np.pad(vol, pads, mode=mode)
    return vol


def rand_crop_pos_neg(
    image: np.ndarray,
    label: np.ndarray,
    rng: np.random.Generator,
    spatial_size: Sequence[int] = (96, 96, 96),
    pos: float = 1.0,
    neg: float = 1.0,
    num_samples: int = 1,
    image_threshold: float = 0.0,
):
    """RandCropByPosNegLabeld parity: centers drawn from label-foreground
    voxels with probability pos/(pos+neg), else from label-background voxels
    where image > image_threshold."""
    image = pad_to_min_size(image, spatial_size)
    label = pad_to_min_size(label, spatial_size)
    shape = np.asarray(image.shape[:3])
    size = np.asarray(spatial_size)

    if label.ndim == 4:
        # channelled (e.g. distance-smoothed) labels: foreground = any
        # non-background channel dominant (channel 0 is background)
        fg_map = label[..., 1:].max(axis=-1) > 0.5
    else:
        fg_map = label > 0
    fg = np.argwhere(fg_map)
    bg_mask = (~fg_map) & (image > image_threshold)
    bg = np.argwhere(bg_mask)
    if len(bg) == 0:
        bg = np.argwhere(np.ones_like(label, bool))

    p_pos = pos / max(pos + neg, 1e-8)
    samples = []
    for _ in range(num_samples):
        take_pos = (rng.random() < p_pos) and len(fg) > 0
        pool = fg if take_pos else bg
        center = pool[rng.integers(len(pool))][:3]
        start = np.clip(center - size // 2, 0, shape - size)
        sl = tuple(slice(int(s), int(s + z)) for s, z in zip(start, size))
        samples.append((np.ascontiguousarray(image[sl]),
                        np.ascontiguousarray(label[sl])))
    return samples


def rand_flip(image, label, rng, prob: float = 0.1, axis: int = 0):
    if rng.random() < prob:
        image = np.flip(image, axis)
        label = np.flip(label, axis)
    return image, label


def rand_rotate90(image, label, rng, prob: float = 0.1, max_k: int = 3,
                  axes=(0, 1)):
    if rng.random() < prob:
        k = int(rng.integers(1, max_k + 1))
        image = np.rot90(image, k, axes)
        label = np.rot90(label, k, axes)
    return image, label


def rand_scale_intensity(image, rng, factors: float = 0.1,
                         prob: float = 0.1):
    if rng.random() < prob:
        image = image * (1.0 + rng.uniform(-factors, factors))
    return image


def rand_shift_intensity(image, rng, offsets: float = 0.1,
                         prob: float = 0.5):
    if rng.random() < prob:
        image = image + rng.uniform(-offsets, offsets)
    return image


# ---------- composed pipelines ----------

def deterministic_preprocess(
    image: np.ndarray,
    image_spacing: Sequence[float],
    label: Optional[np.ndarray] = None,
    *,
    crop_fg: bool = True,
):
    """The cacheable transform prefix: window -> crop fg -> resample.

    (RAS reorientation happens at load via nifti.to_ras.)
    Returns (image, label); the output grid's spacing is `TARGET_SPACING`
    and its world affine is `resampled_affine(affine, image_spacing,
    TARGET_SPACING)`.
    """
    image = scale_intensity_range(image)
    if crop_fg:
        image, label = crop_foreground(image, label)
    image = spacing_resample(image, image_spacing, order=1)
    if label is not None:
        label = spacing_resample(label, image_spacing, order=0)
    return image, label


def train_augment(
    image: np.ndarray,
    label: np.ndarray,
    rng: np.random.Generator,
    *,
    spatial_size: Sequence[int] = (96, 96, 96),
    num_samples: int = 1,
):
    """The random transform suffix applied per epoch to cached volumes."""
    crops = rand_crop_pos_neg(image, label, rng, spatial_size,
                              num_samples=num_samples)
    out = []
    for img, lab in crops:
        for ax in range(3):
            img, lab = rand_flip(img, lab, rng, 0.1, ax)
        img, lab = rand_rotate90(img, lab, rng, 0.1)
        img = rand_scale_intensity(img, rng, 0.1, 0.1)
        img = rand_shift_intensity(img, rng, 0.1, 0.5)
        out.append((np.ascontiguousarray(img, np.float32),
                    np.ascontiguousarray(lab)))
    return out
