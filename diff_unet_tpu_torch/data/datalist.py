"""Decathlon datalist loading (counterpart of
``diff_unet_tpu/data/datalist.py``): ``dataset.json`` -> a list of
``{"image": path, "label": path}`` dicts with the paths made absolute.
The class map is read by ``utils.config.get_class_names``.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import List, Optional, Union


def _append_paths(base_dir: Path, items: list) -> List[dict]:
    out = []
    for item in items:
        item = dict(item)
        for key in ("image", "label"):
            v = item.get(key)
            if isinstance(v, str):
                item[key] = str((base_dir / v).resolve())
            elif isinstance(v, list):
                item[key] = [str((base_dir / p).resolve()) for p in v]
        out.append(item)
    return out


def load_decathlon_datalist(
    data_list_file_path: Union[str, Path],
    is_segmentation: bool = True,
    data_list_key: str = "training",
    base_dir: Optional[Union[str, Path]] = None,
) -> List[dict]:
    """dataset.json -> list of {"image": path, "label": path} dicts; a
    ``test`` list of bare paths becomes ``[{"image": path}, ...]``."""
    path = Path(data_list_file_path)
    if not path.is_file():
        raise ValueError(f"Data list file {path} does not exist.")
    with open(path) as f:
        json_data = json.load(f)
    if data_list_key not in json_data:
        raise ValueError(
            f'Data list {data_list_key} not specified in "{path}".')
    expected = json_data[data_list_key]
    if data_list_key == "test" and expected and not isinstance(
            expected[0], dict):
        expected = [{"image": i} for i in expected]
    base = Path(base_dir) if base_dir is not None else path.parent
    return _append_paths(base, expected)
