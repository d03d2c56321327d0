"""Volume serving entry point, the counterpart of the repository's
``predict.py``:

    python -m diff_unet_tpu_torch.predict --config cfg/amos/test.yaml \
        model_path=... input=/path/ct.nii.gz [output=/path/seg.nii.gz]

reads each CT, preprocesses it as evaluation does (RAS, intensity window,
spacing resample to (1.5, 1.5, 2.0); no foreground crop), serves it with
sliding-window DDIM, and writes an int16 labelmap over the class ids of
``classes`` with the resampled grid's RAS affine. ``input`` is one file, a
comma-separated list or a glob; with several inputs ``output`` is a
directory, and the volumes are served one after another. ``key=value``
arguments override the config; ``device=cpu`` runs on the CPU (the
default is the card).
"""
from __future__ import annotations

import glob as globlib
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

def load_preprocessed(image_path) -> Tuple[torch.Tensor, np.ndarray]:
    """NIfTI -> (volume (D, H, W, 1) float32, affine of the RAS grid)."""
    from diff_unet_tpu_torch.data import nifti
    from diff_unet_tpu_torch.data import transforms as T

    img = nifti.to_ras(nifti.read_nifti(image_path))
    vol, _ = T.deterministic_preprocess(
        np.asarray(img.data), img.spacing, crop_fg=False)
    # the full RAS affine of the resampled grid: rotation and shear carried
    # through, the half-voxel shift of the resample included
    affine = T.resampled_affine(img.affine, img.spacing, T.TARGET_SPACING)
    return torch.from_numpy(np.ascontiguousarray(vol[..., None],
                                                 np.float32)), affine


def predict_volume(engine, image_path, output_path=None) -> np.ndarray:
    """Serve one NIfTI file; returns the labelmap (D, H, W) int16 on the
    preprocessed (RAS, resampled) grid, written to ``output_path`` when
    given."""
    from diff_unet_tpu_torch.data import nifti
    from diff_unet_tpu_torch.engine.engine import channels_to_class_ids

    vol, affine = load_preprocessed(image_path)
    _, binarized = engine.infer(vol)
    labels = channels_to_class_ids(
        binarized.cpu().numpy(), sorted(engine.class_names)
    ).astype(np.int16)
    if output_path is not None:
        nifti.write_nifti(output_path, labels, affine)
        print(f"segmentation written to {output_path}")
    return labels


def _output_name(p: str) -> str:
    return Path(p).name.replace(".nii.gz", "").replace(".nii", "") \
        + "_seg.nii.gz"


def main(argv: Optional[Sequence[str]] = None) -> List[np.ndarray]:
    from diff_unet_tpu_torch.engine.engine import TESTER_KEYS, Predictor
    from diff_unet_tpu_torch.utils.config import engine_kwargs, parse_args

    kwargs = engine_kwargs(parse_args(argv))
    for key in TESTER_KEYS:
        kwargs.pop(key, None)
    spec = kwargs.pop("input")
    output = kwargs.pop("output", None)
    paths = [p for part in str(spec).split(",") if part.strip()
             for p in (sorted(globlib.glob(part.strip()))
                       or [part.strip()])]
    if not paths:
        raise FileNotFoundError(f"input matched no files: {spec}")
    if len(paths) == 1:
        outs = [output or str(Path(paths[0]).with_suffix("")) + "_seg.nii.gz"]
    else:
        out_dir = Path(output) if output else Path(".")
        out_dir.mkdir(parents=True, exist_ok=True)
        outs = [str(out_dir / _output_name(p)) for p in paths]
    engine = Predictor(**kwargs)
    return [predict_volume(engine, p, o) for p, o in zip(paths, outs)]


if __name__ == "__main__":
    main()
