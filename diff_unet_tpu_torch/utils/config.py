"""Flat ``key: value`` YAML configs without PyYAML, and the command line
of the entry points (counterpart of ``diff_unet_tpu/utils/config.py``).

The repository's ``cfg/*/*.yaml`` files are flat maps of scalars with
``#`` comments; this reads exactly that subset (null/true/false, ints,
floats, strings, and flow lists ``[a, b]`` of those) and raises on
anything else. ``parse_args`` takes ``--config path`` and ``key=value``
overrides, coerced by the same rules.
"""
from __future__ import annotations

import argparse
from collections import OrderedDict
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Union

from diff_unet_tpu_torch.utils.logging import format_table


def _scalar(text: str) -> Any:
    v = text.strip()
    if len(v) >= 2 and v[0] == "[" and v[-1] == "]":
        inner = v[1:-1].strip()
        return [_scalar(x) for x in inner.split(",")] if inner else []
    if len(v) >= 2 and v[0] == v[-1] and v[0] in "'\"":
        return v[1:-1]
    low = v.lower()
    if low in ("null", "~", ""):
        return None
    if low == "true":
        return True
    if low == "false":
        return False
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    return v


def load_flat_yaml(path: Union[str, Path]) -> Dict[Any, Any]:
    """Parse a flat YAML mapping of scalars; keys keep file order."""
    out: Dict[Any, Any] = OrderedDict()
    for lineno, raw in enumerate(Path(path).read_text().splitlines(), 1):
        line = raw.split(" #", 1)[0].rstrip()
        if not line.strip() or line.lstrip().startswith("#"):
            continue
        if raw[0] in " \t" or ":" not in line:
            raise ValueError(f"{path}:{lineno}: not a flat 'key: value' "
                             f"line: {raw!r}")
        key, value = line.split(":", 1)
        out[_scalar(key)] = _scalar(value)
    return out


def get_class_names(classes_yaml: Union[str, Path],
                    include_background: bool = False
                    ) -> "OrderedDict[int, str]":
    """classes.yaml -> OrderedDict{id: organ}, optionally without the
    background id 0."""
    classes = OrderedDict(load_flat_yaml(classes_yaml))
    if not include_background:
        classes.pop(0, None)
    return classes


def load_config(path: Union[str, Path],
                overrides: Optional[Sequence[str]] = None) -> Dict[Any, Any]:
    """A flat YAML config with ``key=value`` overrides applied; the path
    is kept under ``__config_path__``."""
    cfg = load_flat_yaml(path)
    cfg["__config_path__"] = str(path)
    for item in overrides or []:
        if "=" not in item:
            raise ValueError(f"override must be key=value, got {item!r}")
        key, value = item.split("=", 1)
        cfg[key.strip()] = _scalar(value)
    return cfg


def parse_args(argv: Optional[Sequence[str]] = None,
               quiet: bool = False) -> Dict[Any, Any]:
    """``--config path [key=value ...]`` -> the config; prints it as a
    table unless ``quiet``."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True,
                        help="Path to the YAML configuration file")
    parser.add_argument("overrides", nargs="*",
                        help="key=value config overrides")
    args = parser.parse_args(argv)
    cfg = load_config(args.config, args.overrides)
    if not quiet:
        rows = [(k, v) for k, v in cfg.items() if not str(k).startswith("__")]
        print(format_table(["Argument", "Value"], rows))
    return cfg


def engine_kwargs(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The config's keys as engine keyword arguments: without the
    ``__config_path__`` entry and the reference's device keys."""
    return {k: v for k, v in cfg.items() if not str(k).startswith("__")
            and k not in ("device_ids", "remove_bg")}
