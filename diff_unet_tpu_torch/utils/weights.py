"""Parameters of the port: seeded random init, and import and export of a
JAX (flax) parameter tree (counterpart of
``diff_unet_tpu/utils/torch_import.py``, in the other direction).

Port submodules carry the flax scope names, so a flax path
``swinViT/layers1/blocks_0/attn/qkv/kernel`` is the port's
``swinViT.layers1.blocks_0.attn.qkv.weight``. Layout conversions:

- Dense kernel (in, out)              -> Linear weight (out, in)
- Conv kernel (kd, kh, kw, in, out)   -> (out, in, kd, kh, kw)
- ConvTranspose kernel (kd, kh, kw, in, out) -> (in, out, kd, kh, kw),
  spatially flipped (flax applies the kernel as a plain conv over the
  dilated input; PyTorch's is the gradient of a conv)
- LayerNorm / InstanceNorm scale      -> weight
- relative_position_bias_table        -> as is
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

from diff_unet_tpu_torch.ops.blocks import Conv, ConvTranspose, Dense, \
    InstanceNorm, LayerNorm
from diff_unet_tpu_torch.ops.swin import WindowAttention


def init_random(module: nn.Module, seed: int) -> nn.Module:
    """Re-draw every kernel and bias table from a generator seeded with
    ``seed`` (flax initialisers: lecun-normal kernels, zero biases,
    truncated-normal(0.02) bias tables; norm scales 1, biases 0)."""
    g = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, (Dense, Conv, ConvTranspose, WindowAttention)):
            m.reset_parameters(g)
    return module


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _convert(mod: nn.Module, leaf: str, a: np.ndarray
             ) -> Tuple[str, np.ndarray]:
    if isinstance(mod, Dense):
        if leaf == "kernel":
            return "weight", a.T
    elif isinstance(mod, Conv):
        if leaf == "kernel":
            return "weight", a.transpose(4, 3, 0, 1, 2)
    elif isinstance(mod, ConvTranspose):
        if leaf == "kernel":
            return "weight", a[::-1, ::-1, ::-1].transpose(3, 4, 0, 1, 2)
    elif isinstance(mod, (LayerNorm, InstanceNorm)):
        if leaf == "scale":
            return "weight", a
    elif isinstance(mod, WindowAttention):
        if leaf == "relative_position_bias_table":
            return leaf, a
        raise KeyError(f"unexpected WindowAttention parameter {leaf!r}")
    if leaf == "bias":
        return "bias", a
    raise KeyError(f"no conversion for {type(mod).__name__}.{leaf}")


def load_jax_params(module: nn.Module, params: Mapping) -> nn.Module:
    """Fill ``module`` from a flax parameter tree (nested dicts of arrays,
    with or without the top-level ``"params"`` collection). Raises on any
    flax key the module lacks and on any module parameter left unfilled."""
    if set(params.keys()) == {"params"}:
        params = params["params"]
    targets = dict(module.named_parameters())
    filled = set()
    for path, value in _flatten(params):
        scope, leaf = path[:-1], path[-1]
        try:
            mod = module.get_submodule(".".join(scope))
        except AttributeError as e:
            raise KeyError(f"flax scope {'/'.join(scope)} has no "
                           "counterpart in the module") from e
        name, arr = _convert(mod, leaf, np.asarray(value, np.float32))
        tname = ".".join((*scope, name))
        if tname not in targets:
            raise KeyError(f"flax parameter {'/'.join(path)} -> {tname} "
                           "is not a parameter of the module")
        p = targets[tname]
        if tuple(p.shape) != arr.shape:
            raise ValueError(f"{tname}: module shape {tuple(p.shape)} vs "
                             f"converted flax shape {arr.shape}")
        with torch.no_grad():
            p.copy_(torch.from_numpy(np.ascontiguousarray(arr)))
        filled.add(tname)
    missing = sorted(set(targets) - filled)
    if missing:
        raise KeyError(f"module parameters missing from the flax tree: "
                       f"{missing[:8]}{' ...' if len(missing) > 8 else ''}")
    return module


def _export(mod: nn.Module, leaf: str, a: np.ndarray
            ) -> Tuple[str, np.ndarray]:
    """Inverse of ``_convert``."""
    if leaf == "weight":
        if isinstance(mod, Dense):
            return "kernel", a.T
        if isinstance(mod, Conv):
            return "kernel", a.transpose(2, 3, 4, 1, 0)
        if isinstance(mod, ConvTranspose):
            return "kernel", a.transpose(2, 3, 4, 0, 1)[::-1, ::-1, ::-1]
        if isinstance(mod, (LayerNorm, InstanceNorm)):
            return "scale", a
    if leaf in ("bias", "relative_position_bias_table"):
        return leaf, a
    raise KeyError(f"no conversion for {type(mod).__name__}.{leaf}")


def export_jax_params(module: nn.Module, grads: bool = False
                      ) -> Dict[str, Any]:
    """The inverse of ``load_jax_params``: ``{"params": tree}`` of float32
    numpy arrays in flax's names and layouts; ``grads=True`` exports each
    parameter's ``.grad`` instead (the conversions are linear), and raises
    on a parameter without one."""
    tree: Dict[str, Any] = {}
    for name, p in module.named_parameters():
        scope, _, leaf = name.rpartition(".")
        t = p.grad if grads else p
        if t is None:
            raise ValueError(f"{name} has no gradient")
        key, arr = _export(module.get_submodule(scope), leaf,
                           t.detach().float().cpu().numpy())
        node = tree
        for k in scope.split(".") if scope else ():
            node = node.setdefault(k, {})
        node[key] = np.ascontiguousarray(arr)
    return {"params": tree}
