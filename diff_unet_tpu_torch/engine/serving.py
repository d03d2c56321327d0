"""Cross-volume continuous window batching for sliding-window serving
(counterpart of ``diff_unet_tpu/engine/serving.py``).

The serial inferer (``sliding_window.SlidingWindowInferer``) answers each
volume alone, so an AMOS volume's 9 windows at sw_batch_size 4 run as
batches of 4 + 4 + 1. Here the windows of consecutive volumes share
``unit``-sized DDIM batches: a FIFO over (volume, window start) forms full
batches while the queue allows and, once the volumes run out, drains the
tail as a descending power-of-two chain. Volumes are pulled from any
iterable only while fewer than ``unit`` windows are pending, so a generator
fed by loader threads overlaps host decoding with the card's batches. A
volume's state (the volume, float32 accumulators of its stitch) is made on
the device when it is pulled and freed when its last window has been
stitched and it is finalized (normalise, sigmoid, threshold).

Each window's x_T noise comes from (its volume's seed, its start)
(``sliding_window.make_ddim_window_predictor``), so a volume served here
draws the same noise as ``Engine.infer`` with that seed, and a model that
treats the samples of a batch apart (DiffUNet) gives the same answer up to
the rounding of another batch size. A model whose batch norm takes batch
statistics at eval (``attention_diff_unet``) answers per batch: its answer
here is the one these batches give, and they are the JAX
``ContinuousBatchingInferer``'s, window for window.

The host runs at most ``PIPELINE_DEPTH`` batches ahead of the card: after a
batch's predict it records a CUDA event, and before the next predict it
waits on the event ``PIPELINE_DEPTH`` batches back (the JAX module's digest
fence), so that it pulls volumes, and makes their state on the card, no
earlier than the card needs them. Nothing else in the loop synchronises
the card.

Left out of the JAX module: its per-bucket LRU of jitted programs, its
power-of-two chunking of a batch's per-volume runs and its padding of each
volume to a bucket of the window grid, which all bounded the set of
compiled programs (the port compiles nothing per shape: a volume is padded
only up to the ROI); buffer donation; and the sharded predict over a device
mesh (multi-GPU serving is not ported).
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Iterable, Iterator, List, Optional, Sequence, \
    Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from diff_unet_tpu_torch.engine.sliding_window import (
    gaussian_importance,
    make_ddim_window_predictor,
    volume_seed,
    window_starts,
)

Start = Tuple[int, int, int]
PIPELINE_DEPTH = 2


def _po2_chain(n: int, unit: int) -> List[int]:
    """Descending power-of-two decomposition of a tail (< unit) task count."""
    out = []
    s = unit
    while n:
        while s > n:
            s //= 2
        out.append(s)
        n -= s
    return out


def schedule(volume_starts: Iterable[Sequence[Start]], unit: int
             ) -> Iterator[List[Tuple[int, Start]]]:
    """The batches of the FIFO over (volume, start), each as its (volume
    index, start) tasks in order. ``volume_starts`` yields each volume's
    window starts and is pulled only while fewer than ``unit`` tasks are
    pending: full ``unit`` batches while the queue allows, then the tail
    as a descending power-of-two chain."""
    it = iter(volume_starts)
    pending: deque = deque()
    pulled = 0
    exhausted = False
    while True:
        while not exhausted and len(pending) < unit:
            starts = next(it, None)
            if starts is None:
                exhausted = True
            else:
                pending.extend((pulled, s) for s in starts)
                pulled += 1
        if not pending:
            return
        size = (unit if len(pending) >= unit
                else _po2_chain(len(pending), unit)[0])
        yield [pending.popleft() for _ in range(size)]


class _VolumeState:
    """Device-resident serving state of one in-flight volume."""

    __slots__ = ("volume", "accum", "weight", "seed", "remaining", "shape")

    def __init__(self, volume, accum, weight, seed, remaining, shape):
        self.volume = volume
        self.accum = accum
        self.weight = weight
        self.seed = seed
        self.remaining = remaining
        self.shape = shape


class ContinuousBatchingInferer:
    """Serve many volumes through ``unit``-sized DDIM window batches.

    ``roi``, ``overlap`` and ``mode`` have the serial inferer's meaning
    (MONAI geometry and blending). ``predictor`` maps
    (windows (s, *roi, Cin), starts (s, 3) int32, seeds: s ints) to logits
    (s, *roi, Cout); the default is the DDIM window predictor over ``seg``
    (plain models and tests pass their own).
    """

    def __init__(self, seg, *, roi: Start, unit: int, overlap: float = 0.25,
                 mode: str = "constant",
                 predictor: Optional[Callable] = None) -> None:
        self.roi = tuple(roi)
        self.unit = int(unit)
        self.overlap = float(overlap)
        if mode == "constant":
            imp = np.ones(self.roi, np.float32)
        elif mode == "gaussian":
            imp = gaussian_importance(self.roi)
        else:
            raise NotImplementedError(mode)
        self._imp = torch.from_numpy(imp)
        self.num_classes = seg.num_classes
        self._predict = predictor or make_ddim_window_predictor(seg)

    # ---- geometry ----
    def starts(self, vol_shape: Sequence[int]) -> List[Start]:
        """Window starts of a (D, H, W) volume, padded up to the ROI where
        it is smaller (edge windows flush with the real volume)."""
        d, h, w = (max(r, s) for r, s in zip(self.roi, vol_shape))
        rd, rh, rw = self.roi
        return [(sd, sh, sw)
                for sd in window_starts(d, rd, self.overlap)
                for sh in window_starts(h, rh, self.overlap)
                for sw in window_starts(w, rw, self.overlap)]

    def plan(self, shapes: Iterable[Sequence[int]]
             ) -> List[List[Tuple[int, Start]]]:
        """The batches ``serve`` forms for volumes of ``shapes`` (D, H, W)."""
        return list(schedule((self.starts(s) for s in shapes), self.unit))

    def _make_state(self, volume: torch.Tensor, seed: int) -> _VolumeState:
        shape = tuple(volume.shape[:3])
        pads = [max(0, r - s) for r, s in zip(self.roi, shape)]
        if any(pads):
            volume = F.pad(volume, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
        padded = tuple(volume.shape[:3])
        dev = volume.device
        accum = torch.zeros((*padded, self.num_classes), dtype=torch.float32,
                            device=dev)
        weight = torch.zeros(padded, dtype=torch.float32, device=dev)
        return _VolumeState(volume, accum, weight, seed,
                            len(self.starts(shape)), shape)

    def _finalize(self, st: _VolumeState
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        w = st.weight[..., None]
        logits = torch.where(w > 0, st.accum / w,
                             torch.zeros((), device=w.device))
        d, h, wd = st.shape
        logits = logits[:d, :h, :wd]
        return logits, (torch.sigmoid(logits) > 0.5).float()

    # ---- serving ----
    @torch.inference_mode()
    def serve(self, volumes: Iterable[torch.Tensor], seed: int,
              seeds: Union[Sequence[int], Callable[[int], int], None] = None,
              on_result: Optional[Callable] = None) -> List:
        """Serve volumes (D, H, W, Cin) of any shapes, in any iterable
        (pulled lazily); returns [(logits, binary)] (D, H, W, Cout), each
        cropped to its volume's shape, on the volumes' device.

        Volume i's windows draw their noise from ``volume_seed(seed, i)``
        unless ``seeds`` gives its seed (a sequence, or a callable i ->
        seed for an unsized iterable). ``on_result(i, logits, binary)``
        receives each result as soon as its volume is finalized, instead of
        keeping it (its slot in the returned list stays None)."""
        if seeds is None:
            def seed_for(i):
                return volume_seed(seed, i)
        elif callable(seeds):
            seed_for = seeds
        else:
            seed_for = seeds.__getitem__
        states: dict = {}
        results: List = []

        def pull() -> Iterator[List[Start]]:
            # a volume's device state is made when the FIFO pulls it
            for i, vol in enumerate(volumes):
                results.append(None)
                states[i] = self._make_state(vol, seed_for(i))
                yield self.starts(states[i].shape)

        rd, rh, rw = self.roi
        fences: deque = deque()
        for batch in schedule(pull(), self.unit):
            windows = torch.stack([
                states[i].volume[sd:sd + rd, sh:sh + rh, sw:sw + rw]
                for i, (sd, sh, sw) in batch])
            if len(fences) >= PIPELINE_DEPTH:
                fences.popleft().synchronize()
            preds = self._predict(
                windows, np.asarray([s for _, s in batch], np.int32),
                [states[i].seed for i, _ in batch]).float()
            if preds.is_cuda:
                fence = torch.cuda.Event()
                fence.record()
                fences.append(fence)
            if self._imp.device != preds.device:
                self._imp = self._imp.to(preds.device)
            imp = self._imp
            for (i, (sd, sh, sw)), p in zip(batch, preds):
                st = states[i]
                st.accum[sd:sd + rd, sh:sh + rh, sw:sw + rw] += \
                    p * imp[..., None]
                st.weight[sd:sd + rd, sh:sh + rh, sw:sw + rw] += imp
                st.remaining -= 1
                if st.remaining == 0:
                    del states[i]                 # frees its accumulators
                    out = self._finalize(st)
                    if on_result is not None:
                        on_result(i, *out)
                    else:
                        results[i] = out
        return results
