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
- LayerNorm / InstanceNorm / BatchStatsNorm scale -> weight
- relative_position_bias_table, SmoothLayer weights (D, H, W, C),
  FFParser weight_real / weight_imag  -> as is

``load_jax_quant`` carries a JAX ``quant`` collection (the W8A8 state that
``diff_unet_tpu/engine/quantize.py`` records) into a quantized port model's
int8 buffers (``ops/blocks.py``), with the same kernel conversions.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

from diff_unet_tpu_torch.models.smooth_diff_unet import FFParser, \
    SmoothLayer
from diff_unet_tpu_torch.ops.blocks import BatchStatsNorm, \
    ChannelLayerNorm, Conv, ConvTranspose, Dense, InstanceNorm, LayerNorm, \
    quant_sites
from diff_unet_tpu_torch.ops.swin import WindowAttention

NORM_MODULES = (LayerNorm, ChannelLayerNorm, InstanceNorm, BatchStatsNorm)
# parameters whose flax name and layout are the port's
AS_IS = {WindowAttention: ("relative_position_bias_table",),
         SmoothLayer: ("weights",), FFParser: ("weight_real", "weight_imag")}


def init_random(module: nn.Module, seed: int) -> nn.Module:
    """Re-draw every kernel, bias table and smoothing or spectral weight
    from a generator seeded with ``seed`` (flax initialisers: lecun-normal
    kernels, zero biases, truncated-normal(0.02) bias tables; the JAX
    package's 0.5 * N(0, 1) smoothing and N(0, 0.02) spectral weights;
    norm scales 1, biases 0)."""
    g = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, (Dense, Conv, ConvTranspose, WindowAttention,
                          SmoothLayer, FFParser)):
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
    elif isinstance(mod, NORM_MODULES):
        if leaf == "scale":
            return "weight", a
    elif isinstance(mod, tuple(AS_IS)):
        if leaf in AS_IS[type(mod)]:
            return leaf, a
        raise KeyError(f"unexpected {type(mod).__name__} parameter {leaf!r}")
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
        if isinstance(mod, NORM_MODULES):
            return "scale", a
    if leaf == "bias" or leaf in AS_IS.get(type(mod), ()):
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


def load_jax_quant(module: nn.Module, quant: Mapping) -> nn.Module:
    """Fill the int8 state of a ``quantize=True`` module from a flax
    ``quant`` collection (with or without the top-level ``"quant"`` key):
    ``wq`` = (int8 DHWIO kernel, (Cout,) scales) and ``sa`` of each
    quantized ``ConvNormAct`` scope, ``up_wq`` and ``up_sa`` of each
    ``UpCat``, ``conv1_``, ``conv2_`` and ``conv3_`` ``wq`` and ``sa`` of
    each Swin-UNETR ``UnetResBlock`` (3x3x3 and 1x1x1 DHWIO kernels). Every
    int8 conv needs its kernel; the activation scales are all there
    (calibrated) or none (dynamic), and a conv that reads another's input
    (``shared_scales``) takes its scale as the same tensor. Raises on a key
    without a counterpart, on a missing one and on a shared scale that
    differs from its source's."""
    if set(quant.keys()) == {"quant"}:
        quant = quant["quant"]
    names = {id(m): n for n, m in module.named_modules()}
    sites = {(names[id(o)], prefix): (o, w, axis)
             for o, prefix, w, axis in quant_sites(module)}
    for (_, prefix), (owner, *_) in sites.items():
        setattr(owner, prefix + "sa", None)
    seen = {"wq": set(), "sa": set()}
    for path, value in _flatten(quant):
        scope, leaf = ".".join(path[:-1]), path[-1]
        head, _, kind = leaf.rpartition("_")
        prefix = head + "_" if head else ""
        if kind not in seen or (scope, prefix) not in sites:
            raise KeyError(f"flax quant entry {'/'.join(path)} has no "
                           "counterpart in the module")
        owner, weight, axis = sites[(scope, prefix)]
        dev = weight.device
        if kind == "sa":
            setattr(owner, leaf, torch.tensor(float(np.asarray(value)),
                                              dtype=torch.float32,
                                              device=dev))
        else:
            kq, sw = (np.asarray(v) for v in value)
            # a conv's DHWIO kernel, or the transposed conv's flipped
            kq = (kq.transpose(4, 3, 0, 1, 2) if axis == 0 else
                  kq[::-1, ::-1, ::-1].transpose(3, 4, 0, 1, 2))
            if kq.shape != tuple(weight.shape) or kq.dtype != np.int8:
                raise ValueError(f"{'/'.join(path)}: int8 kernel {kq.dtype} "
                                 f"{kq.shape} for the module's "
                                 f"{tuple(weight.shape)}")
            setattr(owner, prefix + "wq", torch.from_numpy(
                np.array(kq)).to(dev))
            setattr(owner, prefix + "sw", torch.tensor(
                np.asarray(sw, np.float32), device=dev))
        seen[kind].add((scope, prefix))
    missing = sorted(set(sites) - seen["wq"])
    if missing:
        raise KeyError(f"int8 kernels missing from the flax quant tree: "
                       f"{missing[:8]}")
    if seen["sa"] and seen["sa"] != set(sites):
        raise KeyError("activation scales missing from the flax quant "
                       f"tree: {sorted(set(sites) - seen['sa'])[:8]}")
    for (scope, prefix), (owner, *_) in sites.items():
        source = getattr(owner, "shared_scales", {}).get(prefix)
        sa = getattr(owner, prefix + "sa")
        if source is None or sa is None:
            continue
        if not torch.equal(sa, getattr(owner, source + "sa")):
            raise ValueError(f"{scope}: {prefix}sa {float(sa)} differs from "
                             f"{source}sa, whose input it reads")
        setattr(owner, prefix + "sa", getattr(owner, source + "sa"))
    return module
