"""Volume serving entry point, the counterpart of the repository's
``predict.py``:

    python -m diff_unet_tpu_torch.predict --config cfg/amos/test.yaml \
        model_path=... input=/path/ct.nii.gz [output=/path/seg.nii.gz]

reads each CT, preprocesses it as evaluation does (RAS, intensity window,
spacing resample to (1.5, 1.5, 2.0); no foreground crop), serves it with
sliding-window DDIM, and writes an int16 labelmap over the class ids of
``classes`` with the resampled grid's RAS affine. ``input`` is one file, a
comma-separated list or a glob. With several inputs ``output`` is a
directory, and the volumes are served together through cross-volume
continuous window batching (``predict_many``): loader threads read and
preprocess the next volumes while the card runs the current batches, and
a writer thread writes each labelmap as soon as its volume is finished.
``key=value`` arguments override the config; ``device=cpu`` runs on the
CPU (the default is the card). ``quantize=true`` serves W8A8 int8, and
``quant_calibrate=N`` first records static activation scales from the
first N windows of the first input.
"""
from __future__ import annotations

import glob as globlib
import itertools
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple

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


def _labelmap(engine, binary: np.ndarray, affine: np.ndarray,
              output_path) -> np.ndarray:
    """Binary channels (D, H, W, C) -> the int16 labelmap over the class
    ids, written with ``affine`` to ``output_path`` when given."""
    from diff_unet_tpu_torch.data import nifti
    from diff_unet_tpu_torch.engine.engine import channels_to_class_ids

    labels = channels_to_class_ids(
        binary, sorted(engine.class_names)).astype(np.int16)
    if output_path is not None:
        nifti.write_nifti(output_path, labels, affine)
        print(f"segmentation written to {output_path}")
    return labels


def _needs_calibration(engine) -> bool:
    """``quant_calibrate`` > 0 under ``quantize`` and no static scales
    recorded yet: a datalist-free Predictor calibrates on the first volume
    it serves (the Tester on its first validation case)."""
    return (engine.quantize and engine.quant_calibrate > 0
            and not engine._act_calibrated)


def predict_volume(engine, image_path, output_path=None) -> np.ndarray:
    """Serve one NIfTI file; returns the labelmap (D, H, W) int16 on the
    preprocessed (RAS, resampled) grid, written to ``output_path`` when
    given."""
    vol, affine = load_preprocessed(image_path)
    if _needs_calibration(engine):
        engine.calibrate(vol)
    _, binarized = engine.infer(vol)
    return _labelmap(engine, binarized.cpu().numpy(), affine, output_path)


def _host_copy(binary: torch.Tensor, stream: Optional[torch.cuda.Stream]
               ) -> Callable[[], np.ndarray]:
    """Start copying a finished binary output to the host without holding
    up the dispatch thread; returns a function that waits for the copy and
    gives the array. On the card the copy (as uint8, into pinned memory)
    runs on ``stream`` after an event on the current stream, so it waits
    for this volume's finalize only, not for the batches queued after
    it."""
    if not binary.is_cuda:
        array = binary.numpy()
        return lambda: array
    small = binary.to(torch.uint8).contiguous()
    host = torch.empty(small.shape, dtype=torch.uint8, pin_memory=True)
    stream.wait_stream(torch.cuda.current_stream(binary.device))
    with torch.cuda.stream(stream):
        host.copy_(small, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    small.record_stream(stream)

    def wait() -> np.ndarray:
        done.synchronize()
        return host.numpy()
    return wait


def predict_many(engine, image_paths: Sequence, output_paths: Sequence,
                 workers: int = 3, prefetch: int = 4) -> List[np.ndarray]:
    """Serve several NIfTI files through ``engine.serve_volumes`` with the
    engine seed for every volume (the noise ``predict_volume`` draws);
    returns the labelmaps in input order and writes each to its output
    path (None: not written).

    ``workers`` threads read and preprocess up to ``prefetch`` volumes
    ahead of the serve loop (gzip, the RAS transpose and the resample
    release the GIL); one writer thread maps each finished binary to class
    ids and writes it, off the thread that dispatches the batches."""
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    n = len(image_paths)
    affines: list = [None] * n
    out: list = [None] * n
    side = (torch.cuda.Stream(engine.device)
            if engine.device.type == "cuda" else None)
    writes: list = []

    def write(i: int, binary: Callable[[], np.ndarray]) -> None:
        out[i] = _labelmap(engine, binary(), affines[i], output_paths[i])

    with ThreadPoolExecutor(max_workers=workers) as loader, \
            ThreadPoolExecutor(max_workers=1) as writer:
        pending = deque(loader.submit(load_preprocessed, p)
                        for p in image_paths[:prefetch])
        submitted = len(pending)

        def stream():
            nonlocal submitted
            for i in range(n):
                vol, affines[i] = pending.popleft().result()
                if submitted < n:
                    pending.append(loader.submit(load_preprocessed,
                                                 image_paths[submitted]))
                    submitted += 1
                yield vol

        volumes = stream()
        if _needs_calibration(engine):
            # calibrate on the first served volume, then serve it first
            first = next(volumes)
            engine.calibrate(first)
            volumes = itertools.chain([first], volumes)

        def on_result(i, logits, binary):
            writes.append(writer.submit(write, i, _host_copy(binary, side)))

        engine.serve_volumes(volumes, seeds=lambda i: engine.seed,
                             on_result=on_result)
        for f in writes:
            f.result()
    return out


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
    if len(paths) == 1:
        return [predict_volume(engine, paths[0], outs[0])]
    return predict_many(engine, paths, outs)


if __name__ == "__main__":
    main()
