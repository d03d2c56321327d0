"""Flat ``key: value`` YAML configs without PyYAML.

The repository's ``cfg/*/*.yaml`` files are flat maps of scalars with
``#`` comments; this reads exactly that subset (null/true/false, ints,
floats, strings) and raises on anything else.
"""
from __future__ import annotations

from collections import OrderedDict
from pathlib import Path
from typing import Any, Dict, Union


def _scalar(text: str) -> Any:
    v = text.strip()
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
