"""Checkpoints of the port (counterpart of
``diff_unet_tpu/engine/checkpoint.py``, which writes Orbax checkpoints;
the port has neither jax nor orbax, so it reads and writes two formats of
its own).

- **The port's own**, ``torch.save`` of a dict (``weights/epoch_{n}.pt``,
  ``best_{dice:.4f}.pt``, ``preempt.pt``): the module's ``state_dict``
  (the port's parameter names and layouts), the AdamW state, the update
  count that the lr schedule reads, the train generator's state and its
  device type, and the JAX engine's checkpoint metadata (epoch, loss,
  noise_ratio, global_step, best_mean_dice, project_name, id); when the
  run has them, the EMA tree (``ema``: parameter name -> tensor), the
  loss-aware sampler's ring and counts (``sampler``) and the gradient
  accumulated since the last update (``accum``: micro-step count and the
  running mean), so that a resume takes the same steps as a run that was
  not stopped. ``export_npz`` writes a ``.pt``'s parameters and EMA tree
  as the ``.npz`` below.
- **A JAX parameter tree as ``.npz``**: keys ``params/<flax path>`` and,
  optionally, ``ema_params/<flax path>`` (flax paths joined with ``/``),
  and ``__meta__``, the checkpoint's ``.meta.json`` as a JSON string.
  ``save_jax_npz`` writes it with numpy alone, so it runs where jax and
  Orbax are installed and torch is not: restore the Orbax checkpoint with
  ``orbax.checkpoint.StandardCheckpointer().restore(path)`` and pass its
  ``["params"]`` and ``.get("ema_params")`` (README.md, "JAX
  checkpoints"). The loader feeds ``utils.weights.load_jax_params``.

``resolve_model_path`` turns a config's ``model_path`` into a file: the
path itself if it is a file, else ``<path>.pt``, else ``<path>.npz``, so
the configs' ``.../weights/epoch_3000`` work unchanged.

This module imports torch only inside the functions that need it.
"""
from __future__ import annotations

import json
import os
import signal
import tempfile
import threading
from collections.abc import Mapping
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np

FORMAT = "diff_unet_tpu_torch"
META = "__meta__"


def resolve_model_path(path) -> Path:
    """The checkpoint file that ``path`` names (see the module docstring);
    raises FileNotFoundError, or ValueError for an Orbax directory that
    has not been converted."""
    p = Path(path)
    if p.is_file():
        return p
    for suffix in (".pt", ".npz"):
        q = p.with_name(p.name + suffix)
        if q.is_file():
            return q
    if p.is_dir():
        raise ValueError(
            f"{p} is a directory (an Orbax checkpoint of the JAX package?) "
            f"and neither {p}.pt nor {p}.npz exists: the port cannot read "
            "Orbax. Convert it where jax is installed: restore it with "
            "orbax.checkpoint.StandardCheckpointer().restore(path) and "
            "write raw['params'] and raw.get('ema_params') with "
            "diff_unet_tpu_torch.engine.checkpoint.save_jax_npz to "
            f"{p}.npz (README.md, 'JAX checkpoints')")
    raise FileNotFoundError(f"no checkpoint at {p}, {p}.pt or {p}.npz")


# ---------- JAX parameter trees as .npz ----------

def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def save_jax_npz(path, params: Mapping,
                 ema_params: Optional[Mapping] = None,
                 meta: Optional[Dict] = None) -> None:
    """Write a flax parameter tree (and its EMA tree and metadata) as the
    port's ``.npz``; numpy only."""
    arrays: Dict[str, np.ndarray] = {}
    for name, tree in (("params", params), ("ema_params", ema_params)):
        if tree is not None:
            for keys, v in _flatten(tree):
                arrays["/".join((name, *keys))] = np.asarray(v)
    if meta is not None:
        arrays[META] = np.asarray(json.dumps(meta))
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def read_jax_npz(path) -> Tuple[Dict, Optional[Dict], Dict]:
    """(params tree, EMA tree or None, metadata) of a ``save_jax_npz``
    file."""
    trees: Dict[str, Dict] = {}
    meta: Dict = {}
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            if key == META:
                meta = json.loads(str(z[key]))
                continue
            name, *keys = key.split("/")
            node = trees.setdefault(name, {})
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = z[key]
    if "params" not in trees:
        raise ValueError(f"{path} holds no params/ arrays")
    return trees["params"], trees.get("ema_params"), meta


# ---------- loading into a module ----------

def load_params(module, path, *, use_ema: bool = False) -> Dict:
    """Fill ``module``'s parameters from the checkpoint ``path`` names
    (``.pt`` or ``.npz``), the EMA tree with ``use_ema``; returns the
    checkpoint's metadata. A checkpoint without an EMA tree raises
    ValueError under ``use_ema``."""
    import torch

    from diff_unet_tpu_torch.utils.weights import load_jax_params

    p = resolve_model_path(path)
    if p.suffix == ".npz":
        params, ema, meta = read_jax_npz(p)
        if use_ema:
            if ema is None:
                raise ValueError(
                    f"use_ema=True but checkpoint {p} has no ema_params "
                    "(was it trained with ema_rate set?)")
            params = ema
        load_jax_params(module, params)
        return meta
    ckpt = _load_pt(p, torch)
    state = dict(ckpt["state_dict"])
    if use_ema:
        if ckpt.get("ema") is None:
            raise ValueError(f"use_ema=True but checkpoint {p} has no "
                             "ema_params (was it trained with ema_rate "
                             "set?)")
        state.update(ckpt["ema"])
    module.load_state_dict(state)
    return dict(ckpt["meta"])


def _load_pt(p: Path, torch) -> Dict:
    ckpt = torch.load(p, map_location="cpu", weights_only=True)
    if not isinstance(ckpt, dict) or ckpt.get("format") != FORMAT:
        raise ValueError(f"{p} is not a checkpoint written by "
                         "diff_unet_tpu_torch.engine.checkpoint")
    return ckpt


def load_training_state(path) -> Dict:
    """The whole ``.pt`` checkpoint for a resume: ``state_dict``,
    ``optimizer``, ``count``, ``generator``, ``generator_device``,
    ``meta``, and ``ema``, ``sampler`` and ``accum`` (None where the run
    had none). An ``.npz`` holds parameters only and raises."""
    import torch

    p = resolve_model_path(path)
    if p.suffix != ".pt":
        raise ValueError(
            f"resuming training needs the port's .pt checkpoint (parameters,"
            f" AdamW state, schedule count, generator); {p} holds "
            "parameters only")
    ckpt = _load_pt(p, torch)
    for key in ("ema", "sampler", "accum"):
        ckpt.setdefault(key, None)
    return ckpt


def export_npz(pt_path, npz_path, module) -> None:
    """Write the parameters and EMA tree of the port's ``.pt`` at
    ``pt_path`` as a JAX tree ``.npz`` (``save_jax_npz``), through
    ``module`` (the model the checkpoint was saved from), whose
    parameters it overwrites."""
    import torch

    from diff_unet_tpu_torch.utils.weights import export_jax_params

    ckpt = _load_pt(resolve_model_path(pt_path), torch)
    module.load_state_dict(ckpt["state_dict"])
    params = export_jax_params(module)
    ema = None
    if ckpt.get("ema") is not None:
        module.load_state_dict({**ckpt["state_dict"], **ckpt["ema"]})
        ema = export_jax_params(module)
    save_jax_npz(npz_path, params, ema, dict(ckpt["meta"]))


def save_checkpoint(path, module, optimizer=None, count: int = 0,
                    generator=None, meta: Optional[Dict] = None, *,
                    ema: Optional[Dict] = None, sampler: Optional[Dict] = None,
                    accum: Optional[Dict] = None) -> None:
    """Write the port's ``.pt`` checkpoint (see the module docstring)
    under a temporary name, then rename it into place."""
    import torch

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    state = {
        "format": FORMAT,
        "state_dict": module.state_dict(),
        "optimizer": None if optimizer is None else optimizer.state_dict(),
        "count": int(count),
        "generator": None if generator is None else generator.get_state(),
        "generator_device": (None if generator is None
                             else generator.device.type),
        "meta": dict(meta or {}),
        "ema": ema,
        "sampler": sampler,
        "accum": accum,
    }
    fd, tmp = tempfile.mkstemp(suffix=".pt", dir=path.parent)
    os.close(fd)
    try:
        torch.save(state, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def latest_checkpoint(weights_dir, prefix: str = "epoch_") -> Optional[Path]:
    """The newest epoch-addressed checkpoint in ``weights_dir``, or
    None."""
    weights_dir = Path(weights_dir)
    if not weights_dir.exists():
        return None
    candidates = []
    for p in weights_dir.iterdir():
        if p.name.startswith(prefix):
            try:
                candidates.append((int(p.name[len(prefix):].split(".")[0]), p))
            except ValueError:
                continue
    if not candidates:
        return None
    return max(candidates)[1]


class PreemptionGuard:
    """Save at the next safe point on SIGTERM / SIGUSR1: the Trainer polls
    ``requested`` once per step and writes a resumable ``preempt.pt``.

    Signal handlers can only be installed from the main thread; elsewhere
    the guard is a manual flag. ``close`` puts the previous handlers
    back."""

    def __init__(self, install: bool = True):
        self.requested = False
        self._previous: Dict[int, Any] = {}
        if install and threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGTERM, signal.SIGUSR1):
                self._previous[sig] = signal.signal(sig, self._handler)

    def _handler(self, signum, frame):
        self.requested = True

    def close(self) -> None:
        for sig, handler in self._previous.items():
            signal.signal(sig, handler)
        self._previous = {}
