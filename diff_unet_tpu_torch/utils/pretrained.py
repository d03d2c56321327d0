"""Pretrained encoder weights from MONAI-named PyTorch checkpoints
(counterpart of ``diff_unet_tpu/utils/torch_import.py``, the port's own
copy of its naming maps).

``encoder.pt`` (a HybridMIM ``BasicUNetEncoder`` state dict) fills the
whole image encoder of ``diff_unet``; ``swinvit.pt`` fills the Swin ViT of
the image encoder (``embed_model.swinViT``; the plain ``swin_unetr``
baseline has no encoder, and takes it into its own ``swinViT``). The
port's parameters keep PyTorch's layouts (Conv3d (out, in, kd, kh, kw),
Linear (out, in)), so a graft renames and copies; every tensor's shape is
checked. A ``.npz`` written by ``engine.checkpoint.save_jax_npz`` from
the encoder subtree of a JAX checkpoint (``params/<flax path>``) fills the
image encoder too; an Orbax directory raises with the conversion advice.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np
import torch
from torch import nn


def load_torch_state_dict(path) -> Dict[str, np.ndarray]:
    """The tensors of a ``torch.save``d state dict (or of its
    ``"state_dict"`` entry) as numpy arrays."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: v.detach().cpu().numpy() for k, v in obj.items()
            if isinstance(v, torch.Tensor)}


def _strip_module(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in sd.items()}


def map_two_conv(sd: Dict, prefix: str, name: str) -> Dict[str, np.ndarray]:
    """A MONAI ``TwoConv`` (two Convolution blocks, norm ``adn.N``) ->
    the port's ``TwoConv`` names under ``name``."""
    out = {}
    for j in (0, 1):
        tp = f"{prefix}conv_{j}."
        out[f"{name}.conv_{j}.conv.weight"] = sd[tp + "conv.weight"]
        out[f"{name}.conv_{j}.conv.bias"] = sd[tp + "conv.bias"]
        if tp + "adn.N.weight" in sd:
            out[f"{name}.conv_{j}.norm.weight"] = sd[tp + "adn.N.weight"]
            out[f"{name}.conv_{j}.norm.bias"] = sd[tp + "adn.N.bias"]
    return out


def map_basic_unet_encoder(sd: Dict[str, np.ndarray]
                           ) -> Dict[str, np.ndarray]:
    """HybridMIM ``BasicUNetEncoder`` (``conv_0.*``,
    ``down.{0..3}.convs.*``) -> the port's ``BasicUNetEncoder`` names."""
    sd = _strip_module(sd)
    out = map_two_conv(sd, "conv_0.", "conv_0")
    for i in range(4):
        out.update(map_two_conv(sd, f"down.{i}.convs.", f"down_{i + 1}.convs"))
    return out


def map_swin_vit(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A ``swinvit.pt`` state dict (``patch_embed``, ``layers{i}.0.blocks.
    {n}``, ``layers{i}.0.downsample``; MLP ``fc1/fc2`` or
    ``linear1/linear2``) -> the port's ``SwinTransformer`` names."""
    sd = _strip_module(sd)
    out = {"patch_embed.proj.weight": sd["patch_embed.proj.weight"],
           "patch_embed.proj.bias": sd["patch_embed.proj.bias"]}
    for i in range(1, 5):
        n = 0
        while f"layers{i}.0.blocks.{n}.norm1.weight" in sd:
            tb = f"layers{i}.0.blocks.{n}."
            blk = f"layers{i}.blocks_{n}."
            for key in ("norm1.weight", "norm1.bias", "norm2.weight",
                        "norm2.bias", "attn.relative_position_bias_table",
                        "attn.qkv.weight", "attn.proj.weight",
                        "attn.proj.bias"):
                out[blk + key] = sd[tb + key]
            if tb + "attn.qkv.bias" in sd:
                out[blk + "attn.qkv.bias"] = sd[tb + "attn.qkv.bias"]
            for tname, oname in (("fc1", "fc1"), ("linear1", "fc1"),
                                 ("fc2", "fc2"), ("linear2", "fc2")):
                for leaf in ("weight", "bias"):
                    if f"{tb}mlp.{tname}.{leaf}" in sd:
                        out[f"{blk}mlp.{oname}.{leaf}"] = \
                            sd[f"{tb}mlp.{tname}.{leaf}"]
            n += 1
        dp = f"layers{i}.0.downsample."
        if dp + "reduction.weight" in sd:
            for key in ("reduction.weight", "norm.weight", "norm.bias"):
                out[f"layers{i}.downsample.{key}"] = sd[dp + key]
    return out


@torch.no_grad()
def graft(module: nn.Module, weights: Dict[str, np.ndarray]) -> nn.Module:
    """Copy ``weights`` (the module's parameter names) into ``module`` as
    float32; raises on a name the module lacks or a shape that differs."""
    params = dict(module.named_parameters())
    for name, value in weights.items():
        if name not in params:
            raise KeyError(f"{name} is not a parameter of "
                           f"{type(module).__name__}")
        p = params[name]
        if tuple(p.shape) != tuple(value.shape):
            raise ValueError(f"{name}: module shape {tuple(p.shape)} vs "
                             f"pretrained {tuple(value.shape)}")
        p.copy_(torch.from_numpy(np.asarray(value, np.float32)))
    return module


def load_pretrained_encoder(path, module: nn.Module,
                            model_name: str = "diff_unet") -> nn.Module:
    """Graft pretrained weights into ``module`` by the reference's
    dispatch: ``swinvit.pt`` into the Swin ViT, a BasicUNet ``encoder.pt``
    into ``diff_unet``'s image encoder, a JAX encoder ``.npz`` into the
    image encoder."""
    p = Path(path)
    if p.is_dir():
        raise ValueError(
            f"{p} is a directory (an Orbax checkpoint of the encoder "
            "subtree?): the port cannot read Orbax. Convert it where jax is "
            "installed: restore it with orbax.checkpoint."
            "StandardCheckpointer().restore(path) and write it with "
            "diff_unet_tpu_torch.engine.checkpoint.save_jax_npz to "
            f"{p}.npz (README.md, 'JAX checkpoints'). Or pretrain the "
            "encoder with the port itself: python -m "
            "diff_unet_tpu_torch.pretrain_mim --out encoder.npz writes a "
            ".npz that pretrained_path takes")
    if p.suffix == ".npz":
        from diff_unet_tpu_torch.engine.checkpoint import read_jax_npz
        from diff_unet_tpu_torch.utils.weights import load_jax_params
        params, _, _ = read_jax_npz(p)
        load_jax_params(module.embed_model, params)
        return module
    sd = load_torch_state_dict(p)
    if p.name.endswith("swinvit.pt"):
        target = (module.embed_model.swinViT
                  if hasattr(module, "embed_model") else module.swinViT)
        graft(target, map_swin_vit(sd))
    elif model_name in ("diff_unet", "smooth_diff_unet"):
        graft(module.embed_model, map_basic_unet_encoder(sd))
    else:
        raise NotImplementedError(
            f"pretrained import for {model_name} from {path}")
    return module
