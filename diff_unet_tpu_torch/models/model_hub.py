"""Model factory (counterpart of ``create_model`` in
``diff_unet_tpu/models/model_hub.py``). ``diff_unet`` and
``diff_swin_unetr`` are ported so far."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

MODEL_NAMES = (
    "diff_unet",
    "smooth_diff_unet",
    "diff_swin_unetr",
    "attention_diff_unet",
    "swin_unetr",
    "attention_unet",
)


def parse_image_size(image_size: int, spatial_size: int
                     ) -> Tuple[int, int, int]:
    return (spatial_size, image_size, image_size)


def create_model(model_name: str, *, in_channels: int = 1,
                 out_channels: int, image_size: int = 96,
                 spatial_size: int = 96, feature_size: int = 48,
                 features: Optional[Sequence[int]] = None,
                 dtype: Optional[torch.dtype] = None):
    """Build a model module by name. ``features`` sets DiffUNet's six
    level widths (default (64, 64, 128, 256, 512, 64))."""
    if model_name == "diff_unet":
        from diff_unet_tpu_torch.models.diff_unet import DiffUNet
        kw = {"features": tuple(features)} if features else {}
        return DiffUNet(out_channels=out_channels, in_channels=in_channels,
                        dtype=dtype, **kw)
    if model_name == "diff_swin_unetr":
        from diff_unet_tpu_torch.models.swin_unetr import DiffSwinUNETR
        return DiffSwinUNETR(
            out_channels=out_channels, in_channels=in_channels,
            image_size=parse_image_size(image_size, spatial_size),
            feature_size=feature_size, dtype=dtype)
    if model_name in MODEL_NAMES:
        raise NotImplementedError(
            f"{model_name} is not ported to diff_unet_tpu_torch yet "
            "(ROADMAP.md, modules to port)")
    raise ValueError(f"Invalid model type: {model_name}")
