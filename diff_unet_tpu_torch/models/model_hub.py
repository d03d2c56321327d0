"""Model factory and model types (counterpart of
``diff_unet_tpu/models/model_hub.py``): every model family of the JAX
package's factory, with its ``quantize`` switch for ``diff_unet`` and
``diff_swin_unetr`` (W8A8 int8 serving); its ``pack`` and ``remat``
switches are TPU layout and memory work and are not ported."""
from __future__ import annotations

import enum
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


class ModelType(enum.Enum):
    DIFFUSION = "diffusion"
    SWIN_UNETR = "swin_unetr"
    ATTENTION_UNET = "attention_unet"


def get_model_type(model_name: str) -> ModelType:
    """Diffusion models train on q_sample and serve by DDIM; the others
    map an image to logits in one forward."""
    if model_name not in MODEL_NAMES:
        raise ValueError(f"Invalid model type: {model_name}")
    if "diff" in model_name:
        return ModelType.DIFFUSION
    if model_name == "swin_unetr":
        return ModelType.SWIN_UNETR
    return ModelType.ATTENTION_UNET


def parse_image_size(image_size: int, spatial_size: int
                     ) -> Tuple[int, int, int]:
    return (spatial_size, image_size, image_size)


def create_model(model_name: str, *, in_channels: int = 1,
                 out_channels: int, image_size: int = 96,
                 spatial_size: int = 96, feature_size: int = 48,
                 features: Optional[Sequence[int]] = None,
                 dtype: Optional[torch.dtype] = None,
                 quantize: bool = False):
    """Build a model module by name. ``features`` sets the six level
    widths of DiffUNet and SmoothDiffUNet (default (64, 64, 128, 256, 512,
    64)) and the level widths of AttentionDiffUNet (default (32, 64, 128,
    256, 512)); SmoothDiffUNet's smoothing weights take the (spatial_size,
    image_size, image_size) window's shape. ``quantize`` builds DiffUNet
    (its 3x3x3 convs and transposed convs) or DiffSwinUNETR (its UNETR
    blocks' convs) for W8A8 int8 serving, as the JAX package does, and no
    other family."""
    if quantize and model_name not in ("diff_unet", "diff_swin_unetr"):
        raise ValueError(
            f"quantize=True is only supported for diff_unet and "
            f"diff_swin_unetr (got {model_name}); W8A8 int8 inference "
            "covers their conv stacks (ops/int8.py)")
    kw = {"features": tuple(features)} if features else {}
    if model_name == "diff_unet":
        from diff_unet_tpu_torch.models.diff_unet import DiffUNet
        return DiffUNet(out_channels=out_channels, in_channels=in_channels,
                        dtype=dtype, quantize=quantize, **kw)
    if model_name == "smooth_diff_unet":
        from diff_unet_tpu_torch.models.smooth_diff_unet import \
            SmoothDiffUNet
        return SmoothDiffUNet(out_channels=out_channels,
                              in_channels=in_channels, image_size=image_size,
                              spatial_size=spatial_size, dtype=dtype, **kw)
    if model_name == "attention_diff_unet":
        from diff_unet_tpu_torch.models.attention_diff_unet import \
            AttentionDiffUNet
        return AttentionDiffUNet(out_channels=out_channels,
                                 in_channels=in_channels, dtype=dtype, **kw)
    if model_name == "diff_swin_unetr":
        from diff_unet_tpu_torch.models.swin_unetr import DiffSwinUNETR
        return DiffSwinUNETR(
            out_channels=out_channels, in_channels=in_channels,
            image_size=parse_image_size(image_size, spatial_size),
            feature_size=feature_size, dtype=dtype, quantize=quantize)
    if model_name == "swin_unetr":
        from diff_unet_tpu_torch.models.swin_unetr import SwinUNETR
        return SwinUNETR(
            out_channels=out_channels, in_channels=in_channels,
            image_size=parse_image_size(image_size, spatial_size),
            feature_size=feature_size, dtype=dtype)
    # attention_unet is listed but has no model in the JAX package either,
    # whose create_model raises ValueError for it
    raise ValueError(f"Invalid model type: {model_name}")
