"""RAM-cached NIfTI dataset and batch loader (counterpart of
``diff_unet_tpu/data/dataset.py``).

The deterministic transforms (load -> RAS -> window -> crop foreground ->
spacing resample) run once per volume on a thread pool and are cached in
RAM; the random augmentation suffix runs per epoch over the cached volumes
from a generator seeded with ``(seed, epoch)``, so a resumed run draws the
same crops as an uninterrupted one, and the same as the JAX loader.

Batches are channel-last numpy: image (B, D, H, W, 1) float32 and integer
label (B, D, H, W) (or float (B, D, H, W, C) for smoothed labels); the
engines convert labels to one-hot channels on the device.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from diff_unet_tpu_torch.data import transforms as T
from diff_unet_tpu_torch.data.nifti import read_nifti, to_ras


def _load_item(item: Dict, *, with_label: bool, crop_fg: bool) -> Dict:
    img = to_ras(read_nifti(item["image"]))
    label = None
    if with_label and "label" in item:
        lab = to_ras(read_nifti(item["label"]))
        label = np.asarray(lab.data)
    image, label = T.deterministic_preprocess(
        np.asarray(img.data, np.float32), img.spacing, label,
        crop_fg=crop_fg,
    )
    out = {
        "image": np.ascontiguousarray(image, np.float32),
        "filename": item.get("image"),
        "spacing": np.asarray(T.TARGET_SPACING, np.float32),
    }
    if label is not None:
        out["label"] = np.ascontiguousarray(
            label.astype(np.int16) if label.dtype.kind == "f" else label
        )
    return out


class CacheDataset:
    """Preprocess once on a thread pool, keep every volume in RAM."""

    def __init__(
        self,
        data: List[Dict],
        *,
        mode: str = "train",            # train | val | test
        num_workers: int = 8,
        item_loader: Optional[Callable] = None,
    ) -> None:
        self.mode = mode
        with_label = mode != "test"
        crop_fg = mode != "test"  # test pipeline is load+window only
        loader = item_loader or (
            lambda it: _load_item(it, with_label=with_label, crop_fg=crop_fg)
        )
        if num_workers > 1 and len(data) > 1:
            with ThreadPoolExecutor(max_workers=num_workers) as pool:
                self._cache = list(pool.map(loader, data))
        else:
            self._cache = [loader(it) for it in data]

    def __len__(self) -> int:
        return len(self._cache)

    def __getitem__(self, idx: int) -> Dict:
        return self._cache[idx]


class DataLoader:
    """Epoch iterator over a CacheDataset.

    train: shuffled; applies the random augmentation suffix per item (one
    pos/neg crop each) and collates the crops into (B, D, H, W, 1) /
    (B, D, H, W) batches.
    val/test: sequential, a batch of one whole volume.
    """

    def __init__(
        self,
        dataset: CacheDataset,
        *,
        batch_size: int = 1,
        spatial_size: Sequence[int] = (96, 96, 96),
        seed: int = 0,
        drop_last: bool = False,
    ) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.train = dataset.mode == "train"
        self.spatial_size = tuple(spatial_size)
        self.seed = seed
        self.epoch = 0
        self.drop_last = drop_last

    def __len__(self) -> int:
        if not self.train:
            return len(self.dataset)
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self) -> Iterator[Dict]:
        rng = np.random.default_rng((self.seed, self.epoch))
        order = np.arange(len(self.dataset))
        if self.train:
            rng.shuffle(order)

        if not self.train:
            for i in order:
                item = self.dataset[int(i)]
                batch = {"image": item["image"][None, ..., None]}
                if "label" in item:
                    batch["label"] = item["label"][None]
                batch["filename"] = [item.get("filename")]
                yield batch
            return

        images, labels = [], []
        for i in order:
            item = self.dataset[int(i)]
            crops = T.train_augment(
                item["image"], item["label"], rng,
                spatial_size=self.spatial_size,
            )
            for img, lab in crops:
                images.append(img)
                labels.append(lab)
                if len(images) == self.batch_size:
                    yield {
                        "image": np.stack(images)[..., None],
                        "label": np.stack(labels),
                    }
                    images, labels = [], []
        if images and not self.drop_last:
            yield {
                "image": np.stack(images)[..., None],
                "label": np.stack(labels),
            }
