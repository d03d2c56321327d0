"""Serving and training engines (counterpart of ``Engine``, ``Predictor``
and ``Trainer`` in ``diff_unet_tpu/engine/engine.py``).

``Predictor`` is built from the keys of a test config (``cfg/amos/test.yaml``
for ``diff_unet``, ``cfg/btcv/test.yaml`` for ``diff_swin_unetr``, or
keyword arguments), holds the model with seeded random weights (or weights
loaded with ``utils.weights.load_jax_params``), and serves whole volumes:
``infer(volume) -> (logits, binary)`` and ``serve(volumes)``. ``Trainer`` is
built from a train config (``cfg/amos/train.yaml``, ``cfg/btcv/train.yaml``)
and an iterable of batches, and ``train()`` runs the epochs. Both default to
``diff_unet``, as the JAX engine does. Both run on ``device`` (default
``cuda``) and raise where there is no card unless the caller asks for
``device="cpu"``.

Precision follows ``use_amp``: true computes in bf16 with float32
parameters, float32 norm/softmax statistics and a float32 DDIM state and
loss. The engine turns TF32 off for both cuBLAS matmuls and cuDNN
convolutions (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` = False), so float32 work is float32.
"""
from __future__ import annotations

import warnings
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple, \
    Union

import numpy as np
import torch

from diff_unet_tpu_torch.api import DiffusionSegmenter
from diff_unet_tpu_torch.engine.sliding_window import (
    SlidingWindowInferer,
    bucket_shape,
    make_ddim_window_predictor,
)
from diff_unet_tpu_torch.models.model_hub import create_model
from diff_unet_tpu_torch.data.label_smoothing import smooth_labels
from diff_unet_tpu_torch.engine.train import TrainStep, make_optimizer
from diff_unet_tpu_torch.losses.losses import CompositeLoss
from diff_unet_tpu_torch.utils.config import get_class_names, load_flat_yaml
from diff_unet_tpu_torch.utils.weights import init_random

# Config keys of the JAX engine that concern training, logging, datasets
# or checkpoints; the serving engine accepts and ignores them. The Trainer
# consumes the training keys among them itself.
_IGNORED_KEYS = frozenset((
    "data_name", "data_path", "batch_size", "num_workers", "losses",
    "loss_combine", "project_name", "wandb_name", "log_dir", "use_wandb",
    "use_cache", "label_smoothing", "smoothing_alpha",
    "smoothing_order", "lambda_decay", "mode", "epoch", "use_ema",
    "save_volumes", "continuous", "compile_cache", "num_devices",
    "spatial_shards", "quant_calibrate", "noise_ratio",
))


class Engine:
    def __init__(self, model_name: str = "diff_unet",
                 sw_batch_size: int = 4, overlap: float = 0.25,
                 image_size: int = 96, spatial_size: int = 96,
                 timesteps: int = 1000,
                 sample_steps: int = 10, classes: Optional[str] = None,
                 include_background: bool = False, feature_size: int = 48,
                 features: Optional[Sequence[int]] = None,
                 use_amp: bool = True, seed: int = 123,
                 sw_mode: str = "constant", pack: Optional[int] = None,
                 quantize: bool = False, model_path: Optional[str] = None,
                 device: Union[str, torch.device, None] = None,
                 **unused) -> None:
        unknown = sorted(k for k in unused if k not in _IGNORED_KEYS)
        if unknown:
            warnings.warn("Engine ignored unknown config keys: "
                          + ", ".join(unknown), stacklevel=2)
        if pack not in (None, 1):
            raise ValueError("channel packing (pack > 1) is a TPU layout; "
                             "the port runs unpacked")
        if quantize:
            raise NotImplementedError("W8A8 inference is not ported yet "
                                      "(ROADMAP.md, int8 inference)")
        if model_path is not None:
            raise NotImplementedError(
                "checkpoint loading is not ported yet (ROADMAP.md); pass "
                "model_path=None for seeded random weights, or load a JAX "
                "parameter tree with utils.weights.load_jax_params")
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {self.device} requested but torch.cuda.is_available()"
                " is false; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        self.model_name = model_name
        self.include_background = include_background
        self.sw_batch_size = sw_batch_size
        self.overlap = float(overlap)
        self.seed = seed
        self.class_names = (get_class_names(classes, include_background)
                            if classes
                            else {i + 1: str(i + 1) for i in range(13)})
        self.num_classes = len(self.class_names)
        self.dtype = torch.bfloat16 if use_amp else None

        self.module = create_model(
            model_name, out_channels=self.num_classes, image_size=image_size,
            spatial_size=spatial_size, feature_size=feature_size,
            features=features, dtype=self.dtype)
        init_random(self.module, seed)
        self.module.to(self.device)
        self.seg = DiffusionSegmenter(
            module=self.module, num_classes=self.num_classes,
            timesteps=timesteps, sample_steps=sample_steps)
        self._inferer = SlidingWindowInferer(
            roi=(spatial_size, image_size, image_size),
            sw_batch_size=sw_batch_size, overlap=self.overlap, mode=sw_mode)

    @torch.inference_mode()
    def infer(self, volume: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """volume (D, H, W, 1) -> (logits, binary), both (D, H, W, C).

        The volume is zero-padded to its window-grid bucket and the result
        cropped back; window starts come from the real shape (edge windows
        clamped flush with the real volume)."""
        volume = volume.to(self.device, torch.float32)
        vshape = tuple(volume.shape[:3])
        bucket = bucket_shape(vshape, self._inferer.roi, self.overlap)
        roi_padded = tuple(max(r, s) for r, s in
                           zip(self._inferer.roi, vshape))
        groups = self._inferer._geometry(roi_padded)
        pads = [b - s for b, s in zip(bucket, vshape)]
        if any(pads):
            volume = torch.nn.functional.pad(
                volume, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
        predictor = make_ddim_window_predictor(self.seg, self.seed)
        logits = self._inferer(predictor, volume,
                               out_channels=self.num_classes, groups=groups)
        binary = (torch.sigmoid(logits) > 0.5).float()
        d, h, w = vshape
        return logits[:d, :h, :w], binary[:d, :h, :w]

    def serve(self, volumes: Iterable[torch.Tensor]
              ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Answer each volume in turn with ``infer``."""
        return [self.infer(v) for v in volumes]


def convert_labels(labels: torch.Tensor, class_ids: Sequence[int]
                   ) -> torch.Tensor:
    """Integer label volume (N, D, H, W) -> one-hot float (N, D, H, W, C)
    over the (possibly non-contiguous) class ids."""
    ids = torch.as_tensor(list(class_ids), device=labels.device)
    return (labels[..., None] == ids).float()


class Predictor(Engine):
    """Whole-volume serving engine, no dataset attached."""

    def __init__(self, **kwargs) -> None:
        super().__init__(**kwargs)
        self.module.eval().requires_grad_(False)

    @classmethod
    def from_config(cls, path, **overrides) -> "Predictor":
        """Build from a flat YAML test config; ``overrides`` win."""
        cfg = dict(load_flat_yaml(path))
        cfg.update(overrides)
        return cls(**cfg)


class Trainer(Engine):
    """Training engine for ``diff_unet`` (``cfg/amos/train.yaml``) and
    ``diff_swin_unetr`` (``cfg/btcv/train.yaml``) over ``train_data``, an
    iterable of batches ``{"image": (B, D, H, W, 1) float, "label": (B, D,
    H, W) integer}`` (``data/synthetic.py``; the NIfTI pipeline is not
    ported yet). The batches are prepared once, as the JAX package's cache
    dataset does: labels are distance-smoothed over ``num_classes + 1``
    values and lose the background channel unless ``include_background``
    (``label_smoothing``), or are one-hot encoded over the class ids, and
    both tensors move to the device.

    ``train()`` runs epochs of one AdamW step per batch and stops with the
    previous step's loss when it is not finite. Validation and checkpoint
    saving are not ported: ``train()`` raises before an epoch that would
    reach ``val_freq`` or ``save_freq``. ``history`` holds one record per
    step: loss, grad norm and lr."""

    def __init__(self, train_data: Optional[Iterable[Dict[str, Any]]] = None,
                 max_epochs: int = 5000, lr: float = 1e-4,
                 weight_decay: float = 1e-3, scheduler: Optional[str] = None,
                 warmup_epochs: int = 100, val_freq: int = 1,
                 save_freq: int = 5, batch_size: int = 1,
                 losses: str = "mse,bce,dice", loss_combine: str = "sum",
                 label_smoothing: bool = False, smoothing_alpha: float = 0.3,
                 smoothing_order: float = 1.0, lambda_decay: float = 1.0,
                 noise_ratio: float = 0.5,
                 pretrained_path: Optional[str] = None,
                 ema_rate: Optional[float] = None, accum_steps: int = 1,
                 t_sampler: str = "uniform", use_wandb: bool = False,
                 model_name: str = "diff_unet", **kwargs) -> None:
        if model_name not in ("diff_unet", "diff_swin_unetr"):
            raise NotImplementedError(
                f"training {model_name} is not ported yet (ROADMAP.md); "
                "diff_unet and diff_swin_unetr are")
        if train_data is None:
            raise ValueError("Trainer needs train_data: the NIfTI dataset "
                             "pipeline (data_path) is not ported yet "
                             "(ROADMAP.md, engine surface)")
        if pretrained_path is not None:
            raise NotImplementedError("pretrained encoder loading is not "
                                      "ported yet (ROADMAP.md)")
        if use_wandb:
            raise NotImplementedError("wandb logging is not ported")
        super().__init__(model_name=model_name, **kwargs)
        self.module.train()
        self.max_epochs = max_epochs
        self.val_freq = val_freq
        self.save_freq = save_freq
        self.batch_size = batch_size
        self.label_smoothing = label_smoothing
        self.smoothing = dict(alpha=smoothing_alpha, order=smoothing_order,
                              lambda_decay=lambda_decay)
        self.noise_ratio = noise_ratio      # stored only, as in the model
        self.criterion = CompositeLoss(losses, self.num_classes,
                                       loss_combine)
        self.batches = [self._prepare(b) for b in train_data]
        optimizer, schedule = make_optimizer(
            self.module.parameters(), lr=float(lr),
            weight_decay=float(weight_decay),
            scheduler="warmup_cosine" if scheduler else None,
            warmup_epochs=warmup_epochs, max_epochs=max_epochs,
            steps_per_epoch=max(len(self.batches), 1),
            accum_steps=accum_steps)
        self.train_step = TrainStep(self.seg, self.criterion, optimizer,
                                    schedule, ema_rate=ema_rate,
                                    t_sampler=t_sampler)
        self.generator = torch.Generator(self.device).manual_seed(
            self.seed + 1)
        self.epoch = 0
        self.history: List[Dict[str, float]] = []

    @classmethod
    def from_config(cls, path, train_data=None, **overrides) -> "Trainer":
        """Build from a flat YAML train config; ``overrides`` win."""
        cfg = dict(load_flat_yaml(path))
        cfg.update(overrides)
        return cls(train_data=train_data, **cfg)

    def _prepare(self, batch: Dict[str, Any]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        image = np.asarray(batch["image"], np.float32)
        label = np.asarray(batch["label"])
        roi = tuple(self._inferer.roi)
        if image.shape != (self.batch_size, *roi, 1) or \
                label.shape != (self.batch_size, *roi):
            raise ValueError(
                f"batches must hold {self.batch_size} samples of {roi} "
                f"(image (..., 1), integer label), got {image.shape} and "
                f"{label.shape}")
        if self.label_smoothing:
            onehot = np.stack([smooth_labels(
                lab, self.num_classes + 1, self.smoothing["alpha"],
                self.smoothing["order"], self.smoothing["lambda_decay"])
                for lab in label])
            if not self.include_background:
                onehot = onehot[..., 1:]
            labels = torch.from_numpy(np.ascontiguousarray(onehot)).to(
                self.device)
        else:
            labels = convert_labels(torch.from_numpy(label).to(self.device),
                                    sorted(self.class_names))
        return torch.from_numpy(image).to(self.device), labels

    def train(self) -> None:
        for epoch in range(self.epoch, self.max_epochs):
            for freq, what in ((self.val_freq, "validation"),
                               (self.save_freq, "checkpoint saving")):
                if (epoch + 1) % freq == 0:
                    raise NotImplementedError(
                        f"epoch {epoch + 1} would run {what}, which is not "
                        "ported yet (ROADMAP.md, engine surface)")
            self.epoch = epoch
            self.train_epoch()
        self.epoch = self.max_epochs

    def train_epoch(self) -> None:
        # the previous step's loss is read after the next step is queued,
        # so the host never waits on a fresh result; the NaN abort fires
        # one step late, as in the JAX engine
        prev = None
        for image, labels in self.batches:
            metrics = self.train_step(image, labels,
                                      generator=self.generator)
            if prev is not None:
                self._record(prev)
            prev = metrics
        if prev is not None:
            self._record(prev)

    def _record(self, metrics: Dict[str, Any]) -> None:
        loss = float(metrics["loss"])
        if not np.isfinite(loss):
            raise RuntimeError("Training stopped due to the loss being NaN")
        self.history.append(dict(
            loss=loss, grad_norm=float(metrics["grad_norm"]),
            lr=metrics["lr"]))
