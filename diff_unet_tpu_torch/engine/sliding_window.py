"""Sliding-window whole-volume inference (counterpart of
``diff_unet_tpu/engine/sliding_window.py``).

The volume is cut into overlapping ROIs (MONAI geometry: the last window of
each axis is clamped flush with the edge), the windows are predicted in
power-of-two batches, and the predictions are stitched with importance
weights. Each window's x_T noise comes from a ``torch.Generator`` seeded
from (seed, window start), so the stitched output does not depend on how
windows are batched.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_MASK63 = (1 << 63) - 1


def window_starts(dim: int, roi: int, overlap: float) -> list[int]:
    """Scan positions along one dimension: interval roi*(1-overlap), final
    window clamped flush with the volume edge."""
    if roi >= dim:
        return [0]
    interval = max(int(roi * (1.0 - overlap)), 1)
    starts = list(range(0, dim - roi + interval, interval))
    return [min(s, dim - roi) for s in starts]


def window_seed(seed: int, start: Sequence[int]) -> int:
    """63-bit generator seed derived only from (seed, window start): the
    counterpart of ``window_keys``."""
    h = seed & _MASK63
    for s in start:
        h = (h * 0x9E3779B97F4A7C15 + int(s) + 1) & _MASK63
        h ^= h >> 29
    return h


def volume_seed(seed: int, i: int) -> int:
    """The seed of the i-th volume of a served stream: the counterpart of
    ``jax.random.fold_in(rng, i)``."""
    return window_seed(seed, (i,))


def make_ddim_window_predictor(seg, seed: Optional[int] = None) -> Callable:
    """predictor(windows, starts, seeds=None) drawing each window's x_T
    noise from a generator seeded on (its seed, its start), so that the
    noise does not depend on the batching (eta = 0 DDIM). ``seeds`` gives
    each window its volume's seed (a continuous batch mixes volumes);
    without it every window takes ``seed``."""
    def predictor(windows: torch.Tensor, starts: np.ndarray,
                  seeds: Optional[Sequence[int]] = None) -> torch.Tensor:
        roi_shape = (*windows.shape[1:-1], seg.num_classes)
        if seeds is None:
            seeds = [seed] * len(starts)
        noise = []
        for s, vs in zip(starts, seeds):
            g = torch.Generator(device=windows.device)
            g.manual_seed(window_seed(vs, s))
            noise.append(torch.randn(roi_shape, generator=g,
                                     device=windows.device))
        return seg.ddim_sample(windows, noise=torch.stack(noise))
    return predictor


def bucket_shape(vol_shape: Sequence[int], roi: Sequence[int],
                 overlap: float) -> Tuple[int, ...]:
    """Pad (D, H, W) up to the next point of the scan grid
    ``roi + k*interval``; the per-dim window count is unchanged."""
    out = []
    for s, r in zip(vol_shape, roi):
        if s <= r:
            out.append(r)
        else:
            interval = max(int(r * (1.0 - overlap)), 1)
            out.append(r + -(-(s - r) // interval) * interval)
    return tuple(out)


def gaussian_importance(roi: Sequence[int], sigma_scale: float = 0.125
                        ) -> np.ndarray:
    """Gaussian blend map centred on the ROI (MONAI BlendMode.GAUSSIAN)."""
    grids = np.meshgrid(*[np.arange(r, dtype=np.float64) for r in roi],
                        indexing="ij")
    out = np.ones(tuple(roi), np.float64)
    for g, r in zip(grids, roi):
        sigma = r * sigma_scale
        center = (r - 1) / 2.0
        out *= np.exp(-((g - center) ** 2) / (2 * sigma ** 2))
    out = out / out.max()
    return np.maximum(out, np.finfo(np.float32).tiny).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class SlidingWindowInferer:
    """Sliding-window inferer over ``predictor(windows, starts)``, which
    maps (s, *roi, Cin) windows and their (s, 3) starts to (s, *roi, Cout)."""

    roi: Tuple[int, int, int] = (96, 96, 96)
    sw_batch_size: int = 4
    overlap: float = 0.25
    mode: str = "constant"  # "constant" | "gaussian"

    def _starts(self, vol_shape) -> list:
        d, h, w = vol_shape
        rd, rh, rw = self.roi
        return [(sd, sh, sw_)
                for sd in window_starts(d, rd, self.overlap)
                for sh in window_starts(h, rh, self.overlap)
                for sw_ in window_starts(w, rw, self.overlap)]

    def _geometry(self, vol_shape):
        """Window starts in power-of-two batch groups: full batches of
        ``unit`` (po2 floor of sw_batch_size); a tail >= unit/2 folds into
        one masked unit batch, a smaller tail runs as a descending po2
        chain. Returns [(starts (nb, s, 3) int32, valid (nb, s) float32)]."""
        starts = self._starts(vol_shape)
        n = len(starts)
        unit = 1
        while unit * 2 <= self.sw_batch_size:
            unit *= 2
        nb = n // unit
        tail = n - nb * unit
        pad = 0
        if tail and tail * 2 >= unit:
            nb += 1
            pad = unit - tail
            tail = 0
        groups = []
        if nb:
            block = starts[:nb * unit - pad] + [(0, 0, 0)] * pad
            valid = np.ones(nb * unit, np.float32)
            if pad:
                valid[-pad:] = 0.0
            groups.append((np.asarray(block, np.int32).reshape(nb, unit, 3),
                           valid.reshape(nb, unit)))
        idx = n - tail
        s = unit // 2
        while tail:
            while s > tail:
                s //= 2
            block = np.asarray(starts[idx:idx + s], np.int32)
            groups.append((block.reshape(1, s, 3),
                           np.ones((1, s), np.float32)))
            idx += s
            tail -= s
            s //= 2
        return groups

    def importance(self) -> np.ndarray:
        if self.mode == "constant":
            return np.ones(self.roi, np.float32)
        if self.mode == "gaussian":
            return gaussian_importance(self.roi)
        raise NotImplementedError(self.mode)

    def __call__(self, predictor: Callable, volume: torch.Tensor, *,
                 out_channels: int, groups=None) -> torch.Tensor:
        """volume (D, H, W, Cin) -> stitched (D, H, W, Cout) float32.
        ``groups`` overrides the geometry (as produced by ``_geometry``)."""
        if volume.dim() != 4:
            raise ValueError("volume must be (D, H, W, C)")
        vol_shape = tuple(volume.shape[:3])
        rd, rh, rw = self.roi
        pads = [max(0, r - s) for r, s in zip(self.roi, vol_shape)]
        if any(pads):
            volume = F.pad(volume, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
        padded_shape = tuple(volume.shape[:3])
        if groups is None:
            groups = self._geometry(padded_shape)
        dev = volume.device
        imp = torch.from_numpy(self.importance()).to(dev)
        accum = torch.zeros((*padded_shape, out_channels), dtype=torch.float32,
                            device=dev)
        weight = torch.zeros(padded_shape, dtype=torch.float32, device=dev)
        for starts_np, valid_np in groups:
            for batch_starts, batch_valid in zip(starts_np, valid_np):
                windows = torch.stack([
                    volume[sd:sd + rd, sh:sh + rh, sw:sw + rw]
                    for sd, sh, sw in batch_starts.tolist()])
                preds = predictor(windows, batch_starts).float()
                for (sd, sh, sw), p, v in zip(batch_starts.tolist(), preds,
                                              batch_valid.tolist()):
                    if v == 0.0:
                        continue
                    w_map = imp * v
                    accum[sd:sd + rd, sh:sh + rh, sw:sw + rw] += \
                        p * w_map[..., None]
                    weight[sd:sd + rd, sh:sh + rh, sw:sw + rw] += w_map
        weight = weight[..., None]
        stitched = torch.where(weight > 0, accum / weight,
                               torch.zeros((), device=dev))
        return stitched[:vol_shape[0], :vol_shape[1], :vol_shape[2]]
