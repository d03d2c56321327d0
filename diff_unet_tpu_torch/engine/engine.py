"""Inference engine (counterpart of the inference part of ``Engine`` and of
``Predictor`` in ``diff_unet_tpu/engine/engine.py``).

``Predictor`` is built from the keys of a test config (``cfg/btcv/test.yaml``
or keyword arguments), holds a ``DiffSwinUNETR`` with seeded random weights
(or weights loaded with ``utils.weights.load_jax_params``), and serves whole
volumes: ``infer(volume) -> (logits, binary)`` and ``serve(volumes)``.

Precision follows ``use_amp``: true computes in bf16 with float32
parameters, float32 norm/softmax statistics and a float32 DDIM state. The
engine turns TF32 off for both cuBLAS matmuls and cuDNN convolutions
(``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` = False), so float32 work is float32.
"""
from __future__ import annotations

import warnings
from typing import Iterable, List, Optional, Tuple, Union

import torch

from diff_unet_tpu_torch.api import DiffusionSegmenter
from diff_unet_tpu_torch.engine.sliding_window import (
    SlidingWindowInferer,
    bucket_shape,
    make_ddim_window_predictor,
)
from diff_unet_tpu_torch.models.model_hub import create_model
from diff_unet_tpu_torch.utils.config import get_class_names, load_flat_yaml
from diff_unet_tpu_torch.utils.weights import init_random

# Config keys of the JAX engine that concern training, logging, datasets
# or checkpoints; the serving engine accepts and ignores them.
_IGNORED_KEYS = frozenset((
    "data_name", "data_path", "batch_size", "num_workers", "losses",
    "loss_combine", "project_name", "wandb_name", "log_dir", "use_wandb",
    "use_cache", "label_smoothing", "features", "smoothing_alpha",
    "smoothing_order", "lambda_decay", "mode", "epoch", "use_ema",
    "save_volumes", "continuous", "compile_cache", "num_devices",
    "spatial_shards", "quant_calibrate", "noise_ratio",
))


class Engine:
    def __init__(self, model_name: str = "diff_swin_unetr",
                 sw_batch_size: int = 4, overlap: float = 0.25,
                 image_size: int = 96, spatial_size: int = 96,
                 timesteps: int = 1000,
                 sample_steps: int = 10, classes: Optional[str] = None,
                 include_background: bool = False, feature_size: int = 48,
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
        self.device = torch.device(
            device if device is not None
            else ("cuda" if torch.cuda.is_available() else "cpu"))
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        self.model_name = model_name
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
            dtype=self.dtype)
        init_random(self.module, seed)
        self.module.to(self.device).eval().requires_grad_(False)
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


class Predictor(Engine):
    """Whole-volume serving engine, no dataset attached."""

    @classmethod
    def from_config(cls, path, **overrides) -> "Predictor":
        """Build from a flat YAML test config; ``overrides`` win."""
        cfg = dict(load_flat_yaml(path))
        cfg.update(overrides)
        return cls(**cfg)
