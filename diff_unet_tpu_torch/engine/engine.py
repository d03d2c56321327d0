"""Serving, evaluation and training engines (counterpart of ``Engine``,
``Predictor``, ``Tester`` and ``Trainer`` in
``diff_unet_tpu/engine/engine.py``).

``Predictor`` is built from the keys of a test config (``cfg/amos/test.yaml``
for ``diff_unet`` and, with ``model_name=smooth_diff_unet`` or
``attention_diff_unet``, the other two UNet families;
``cfg/btcv/test.yaml`` for ``diff_swin_unetr``, or keyword arguments;
``model_name=swin_unetr`` serves the plain Swin-UNETR baseline, one
forward per window batch and no DDIM loop), holds the model
with seeded random weights or the
weights of ``model_path`` (``engine/checkpoint.py``: the port's ``.pt`` or
a JAX tree as ``.npz``; ``use_ema`` takes the EMA tree), and serves whole
volumes: ``infer(volume) -> (logits, binary)``, ``serve(volumes)`` (one
after another) and ``serve_volumes(volumes)`` (continuous window batching
across volumes, ``engine/serving.py``). ``Tester`` adds the validation set
of ``data_path`` (a Decathlon ``dataset.json``) and scores each case: dice
on the device, HD95 and IoU per class on the host, the per-class table,
the mean dice and ``logs/<log_dir>/results.pkl``; ``continuous: N`` serves
the cases N at a time through ``serve_volumes``. ``Trainer`` is built from
a train config (``cfg/amos/train.yaml``, ``cfg/btcv/train.yaml``,
``cfg/msd/train.yaml``) and trains on the NIfTI set of ``data_path``, or
on ``train_data``, an iterable of batches;
``train()`` runs the epochs with validation every ``val_freq``, the
best-checkpoint gate, ``epoch_{n}.pt`` every ``save_freq`` and resume from
``model_path``. All default to ``diff_unet``, as the JAX engine does. All
run on ``device`` (default ``cuda``) and raise where there is no card
unless the caller asks for ``device="cpu"``.

``quantize`` serves ``diff_unet`` and ``diff_swin_unetr`` W8A8 int8
(``ops/int8.py``): the Predictor records the int8 kernels at build and
``calibrate(volume)`` records static activation scales from the first
``quant_calibrate`` ROI windows of a volume; the Tester calibrates on its
first validation case
when ``quant_calibrate`` > 0; otherwise each conv takes a dynamic scale
over its window batch. Training raises on it, as in the JAX engine.

Precision follows ``use_amp``: true computes in bf16 with float32
parameters, float32 norm/softmax statistics and a float32 DDIM state and
loss. The engine turns TF32 off for both cuBLAS matmuls and cuDNN
convolutions (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` = False), so float32 work is float32.
"""
from __future__ import annotations

import pickle
import time
import warnings
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, Optional, \
    Sequence, Tuple, Union

import numpy as np
import torch

from diff_unet_tpu_torch.api import DiffusionSegmenter, PlainSegmenter
from diff_unet_tpu_torch.data.dataset import CacheDataset, DataLoader
from diff_unet_tpu_torch.data.datalist import load_decathlon_datalist
from diff_unet_tpu_torch.data.label_smoothing import \
    LabelSmoothingCacheDataset, smooth_labels
from diff_unet_tpu_torch.engine import checkpoint as ckpt_lib
from diff_unet_tpu_torch.engine.serving import ContinuousBatchingInferer
from diff_unet_tpu_torch.engine.sliding_window import (
    SlidingWindowInferer,
    bucket_shape,
    make_ddim_window_predictor,
)
from diff_unet_tpu_torch.engine.train import TrainStep, make_optimizer
from diff_unet_tpu_torch.losses.edt import batch_dist_maps
from diff_unet_tpu_torch.losses.losses import CompositeLoss
from diff_unet_tpu_torch.metrics.metrics import hausdorff_distance_95, \
    jaccard, validation_dice
from diff_unet_tpu_torch.models.model_hub import ModelType, create_model, \
    get_model_type
from diff_unet_tpu_torch.utils.config import get_class_names, load_flat_yaml
from diff_unet_tpu_torch.utils.logging import MetricLogger, ProgressMeter
from diff_unet_tpu_torch.utils.pretrained import load_pretrained_encoder
from diff_unet_tpu_torch.utils.weights import init_random

# Config keys of the JAX engine that concern logging services, the TPU
# mesh and compile cache, or only training; the engines accept and ignore
# them (the Trainer consumes its training keys itself).
_IGNORED_KEYS = frozenset((
    "data_name", "losses", "loss_combine", "wandb_name", "use_cache",
    "mode", "compile_cache", "num_devices", "spatial_shards", "noise_ratio",
))
# keys of the shared test configs that only the Tester reads
TESTER_KEYS = ("save_volumes", "continuous")


def convert_labels(labels: torch.Tensor, class_ids: Sequence[int]
                   ) -> torch.Tensor:
    """Integer label volume (N, D, H, W) -> one-hot float (N, D, H, W, C)
    over the (possibly non-contiguous) class ids."""
    ids = torch.as_tensor(list(class_ids), device=labels.device)
    return (labels[..., None] == ids).float()


def channels_to_class_ids(onehot: np.ndarray,
                          class_ids: Sequence[int]) -> np.ndarray:
    """One-hot channels (..., C) -> integer class-id map; voxels with no
    active channel are background (0). Channel c is the c-th sorted class
    id (``convert_labels``)."""
    ids = np.asarray([0] + sorted(class_ids))
    onehot = np.asarray(onehot)
    best = onehot.argmax(-1).astype(np.int64)
    return ids[np.where(onehot.max(-1) > 0, best + 1, 0)]


class Engine:
    # the loaders ``set_dataloader`` builds: the Trainer's also "train"
    _phases: Tuple[Tuple[str, str], ...] = (("val", "validation"),)

    def __init__(self, model_name: str = "diff_unet",
                 data_path: Optional[str] = None, batch_size: int = 1,
                 sw_batch_size: int = 4, overlap: float = 0.25,
                 image_size: int = 96, spatial_size: int = 96,
                 timesteps: int = 1000,
                 sample_steps: int = 10, classes: Optional[str] = None,
                 num_workers: int = 2, include_background: bool = False,
                 label_smoothing: bool = False, smoothing_alpha: float = 0.3,
                 smoothing_order: float = 1.0, lambda_decay: float = 1.0,
                 feature_size: int = 48,
                 features: Optional[Sequence[int]] = None,
                 use_amp: bool = True, seed: int = 123,
                 sw_mode: str = "constant", pack: Optional[int] = None,
                 quantize: bool = False, quant_calibrate: int = 0,
                 model_path: Optional[str] = None,
                 use_ema: bool = False, epoch: Optional[int] = None,
                 project_name: Optional[str] = None,
                 log_dir: str = "logs", use_wandb: bool = False,
                 device: Union[str, torch.device, None] = None,
                 **unused) -> None:
        unknown = sorted(k for k in unused if k not in _IGNORED_KEYS)
        if unknown:
            warnings.warn("Engine ignored unknown config keys: "
                          + ", ".join(unknown), stacklevel=2)
        if pack not in (None, 1):
            raise ValueError("channel packing (pack > 1) is a TPU layout; "
                             "the port runs unpacked")
        if use_wandb:
            raise NotImplementedError("wandb logging is not ported")
        if use_ema and model_path is None:
            raise ValueError("use_ema=True needs a model_path with "
                             "ema_params; seeded random weights have none")
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {self.device} requested but torch.cuda.is_available()"
                " is false; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        self.model_name = model_name
        self.data_path = data_path
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.include_background = include_background
        self.label_smoothing = label_smoothing
        self.smoothing = dict(alpha=smoothing_alpha, order=smoothing_order,
                              lambda_decay=lambda_decay)
        self.sw_batch_size = sw_batch_size
        self.overlap = float(overlap)
        self.seed = seed
        self.project_name = project_name
        self.class_names = (get_class_names(classes, include_background)
                            if classes
                            else {i + 1: str(i + 1) for i in range(13)})
        self.num_classes = len(self.class_names)
        self.dtype = torch.bfloat16 if use_amp else None
        self.quantize = bool(quantize)
        self.quant_calibrate = int(quant_calibrate)
        self._act_calibrated = False

        self.module = create_model(
            model_name, out_channels=self.num_classes, image_size=image_size,
            spatial_size=spatial_size, feature_size=feature_size,
            features=features, dtype=self.dtype, quantize=self.quantize)
        init_random(self.module, seed)
        self.epoch = epoch or 0
        if model_path is not None:
            # the checkpoint's epoch wins; ``epoch`` is the fallback
            meta = ckpt_lib.load_params(self.module, model_path,
                                        use_ema=use_ema)
            self.epoch = meta.get("epoch", epoch or 0)
            print(f"Checkpoint loaded from {model_path}")
        self.module.to(self.device)
        self.model_type = get_model_type(model_name)
        if self.model_type == ModelType.DIFFUSION:
            self.seg = DiffusionSegmenter(
                module=self.module, num_classes=self.num_classes,
                timesteps=timesteps, sample_steps=sample_steps)
        else:
            self.seg = PlainSegmenter(module=self.module,
                                      num_classes=self.num_classes)
        self._inferer = SlidingWindowInferer(
            roi=(spatial_size, image_size, image_size),
            sw_batch_size=sw_batch_size, overlap=self.overlap, mode=sw_mode)
        self._continuous: Optional[ContinuousBatchingInferer] = None
        self._continuous_key: Optional[tuple] = None
        self.dataloader: Dict[str, DataLoader] = {}

    # ---- data ----
    def set_dataloader(self) -> Dict[str, DataLoader]:
        """Loaders over ``<data_path>/dataset.json``: the validation list
        (whole volumes, batch 1) and, for the Trainer, the training list
        (pos/neg crops of the ROI, ``batch_size``, the last partial batch
        dropped; label-smoothed when ``label_smoothing``)."""
        if self.data_path is None:
            raise ValueError(f"{type(self).__name__} needs data_path: a "
                             "directory holding a Decathlon dataset.json")
        data_json = Path(self.data_path) / "dataset.json"
        roi = tuple(self._inferer.roi)
        loaders: Dict[str, DataLoader] = {}
        for phase, key in self._phases:
            items = load_decathlon_datalist(data_json, True, key)
            if self.label_smoothing and phase == "train":
                ds = LabelSmoothingCacheDataset(
                    items, num_classes=self.num_classes + 1,
                    smoothing_alpha=self.smoothing["alpha"],
                    smoothing_order=self.smoothing["order"],
                    num_workers=max(self.num_workers, 4))
            else:
                ds = CacheDataset(items, mode=phase,
                                  num_workers=max(self.num_workers, 4))
            loaders[phase] = DataLoader(
                ds, batch_size=self.batch_size if phase == "train" else 1,
                spatial_size=roi, seed=self.seed,
                drop_last=(phase == "train"))
        self.dataloader = loaders
        return loaders

    def convert_labels(self, labels: torch.Tensor) -> torch.Tensor:
        """Integer labels -> one-hot channels over the configured class
        ids; smoothed float labels (N, D, H, W, C) lose the background
        channel unless ``include_background``."""
        if labels.dim() == 5:
            return labels if self.include_background else labels[..., 1:]
        return convert_labels(labels, sorted(self.class_names))

    def infer_case(self, batch: Dict[str, Any]
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """A validation batch (one whole volume) -> its image (D, H, W, 1),
        its labels and the served binary outputs (D, H, W, C), all on the
        device."""
        image = torch.from_numpy(batch["image"][0]).to(self.device)
        labels = self.convert_labels(
            torch.from_numpy(batch["label"]).to(self.device))[0]
        _, outputs = self.infer(image)
        return image, labels, outputs

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- W8A8 serving preparation ----
    def _offline_quantize(self, calibration_images=None) -> None:
        """Record the module's int8 kernels, and static activation scales
        when calibration window batches are given (``engine/quantize.py``,
        noise from the engine seed); each call starts again from the float
        weights, so a later ``calibrate`` re-records everything."""
        from diff_unet_tpu_torch.engine.quantize import \
            quantize_inference_params
        quantize_inference_params(self, calibration_images, seed=self.seed)
        self._act_calibrated = calibration_images is not None

    def _calibration_windows(self, volume: torch.Tensor
                             ) -> List[torch.Tensor]:
        """The first ``quant_calibrate`` (at least one) ROI windows of a
        volume (D, H, W, 1), zero-padded to the ROI, as one window batch."""
        roi = self._inferer.roi
        volume = torch.as_tensor(volume).to(self.device, torch.float32)
        pads = [max(0, r - s) for r, s in zip(roi, volume.shape[:3])]
        if any(pads):
            volume = torch.nn.functional.pad(
                volume, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
        starts = self._inferer._starts(tuple(volume.shape[:3]))
        starts = starts[:max(1, self.quant_calibrate)]
        return [torch.stack([volume[d:d + roi[0], h:h + roi[1], w:w + roi[2]]
                             for d, h, w in starts])]

    # ---- inference ----
    @torch.inference_mode()
    def infer(self, volume: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """volume (D, H, W, 1) -> (logits, binary), both (D, H, W, C).

        The volume is zero-padded to its window-grid bucket and the result
        cropped back; window starts come from the real shape (edge windows
        clamped flush with the real volume). Each window batch runs the
        DDIM loop, or one forward of a plain model."""
        volume = volume.to(self.device, torch.float32)
        vshape = tuple(volume.shape[:3])
        bucket = bucket_shape(vshape, self._inferer.roi, self.overlap)
        roi_padded = tuple(max(r, s) for r, s in
                           zip(self._inferer.roi, vshape))
        groups = self._inferer._geometry(roi_padded)
        pads = [b - s for b, s in zip(bucket, vshape)]
        if any(pads):
            volume = torch.nn.functional.pad(
                volume, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
        if self.model_type == ModelType.DIFFUSION:
            predictor = make_ddim_window_predictor(self.seg, self.seed)
        else:
            def predictor(windows, starts):
                return self.seg.predict(windows)
        logits = self._inferer(predictor, volume,
                               out_channels=self.num_classes, groups=groups)
        binary = (torch.sigmoid(logits) > 0.5).float()
        d, h, w = vshape
        return logits[:d, :h, :w], binary[:d, :h, :w]

    def serve(self, volumes: Iterable[torch.Tensor]
              ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Answer each volume in turn with ``infer``."""
        return [self.infer(v) for v in volumes]

    def serve_volumes(self, volumes: Iterable[torch.Tensor],
                      seeds: Union[Sequence[int], Callable[[int], int],
                                   None] = None,
                      on_result: Optional[Callable] = None
                      ) -> List[Optional[Tuple[torch.Tensor, torch.Tensor]]]:
        """Serve volumes (D, H, W, 1), from any iterable, through
        cross-volume continuous window batching (``engine/serving.py``):
        the windows of consecutive volumes share full DDIM batches of the
        unit, the power-of-two floor of ``sw_batch_size``. Volume i's noise
        comes from ``volume_seed(seed, i)``, or from ``seeds`` (a sequence
        or a callable i -> seed); given the engine seed for a volume, it
        draws the noise of ``infer``. Returns [(logits, binary)] on the
        device, or streams each to ``on_result(i, logits, binary)`` as its
        volume is finalized. The inferer is rebuilt when the unit, ROI,
        overlap or blend mode has changed since the last call."""
        unit = 1
        while unit * 2 <= self.sw_batch_size:
            unit *= 2
        key = (unit, self._inferer.roi, self.overlap, self._inferer.mode)
        if self._continuous_key != key:
            predictor = None
            if self.model_type != ModelType.DIFFUSION:
                def predictor(windows, starts, seeds):
                    return self.seg.predict(windows)
            self._continuous = ContinuousBatchingInferer(
                self.seg, roi=self._inferer.roi, unit=unit,
                overlap=self.overlap, mode=self._inferer.mode,
                predictor=predictor)
            self._continuous_key = key
        return self._continuous.serve(
            (v.to(self.device, torch.float32) for v in volumes), self.seed,
            seeds=seeds, on_result=on_result)


class Predictor(Engine):
    """Whole-volume serving engine, no dataset attached."""

    def __init__(self, **kwargs) -> None:
        super().__init__(**kwargs)
        self.module.eval().requires_grad_(False)
        if self.quantize:
            # weights only; calibrate(volume) records static scales
            self._offline_quantize()

    def calibrate(self, volume: torch.Tensor) -> None:
        """Record static activation scales from a representative volume
        (D, H, W, 1): its first ``quant_calibrate`` windows (at least
        one)."""
        if not self.quantize:
            raise ValueError("calibrate() needs quantize=True")
        self.quant_calibrate = max(self.quant_calibrate, 1)
        self._offline_quantize(self._calibration_windows(volume))

    @classmethod
    def from_config(cls, path, **overrides) -> "Predictor":
        """Build from a flat YAML test config, without its Tester-only
        keys; ``overrides`` win."""
        cfg = dict(load_flat_yaml(path))
        for k in TESTER_KEYS:
            cfg.pop(k, None)
        cfg.update(overrides)
        return cls(**cfg)


class Tester(Engine):
    """Evaluation over the validation list of ``data_path`` in a single
    process: each case is served as ``Predictor.infer`` serves it and
    scored (``_record_case``); ``test()`` prints the per-class dice / HD95
    / IoU table and the mean dice and writes ``logs/<log_dir>/results.pkl``
    (numpy arrays only: per-case dices, hd95s, ious and filenames, and with
    ``save_volumes`` the fp16 images and bool one-hot outputs and labels).
    ``case_seconds`` holds each case's seconds split four ways: inference
    (ended by a device synchronisation), dice on the device, HD95 + IoU on
    the host, and recording.

    ``continuous=N`` (N > 0) serves the cases N at a time (the last group
    may be smaller) through ``serve_volumes``, each with the engine seed,
    so that each case draws the serial path's noise; its inference
    seconds are the group's (ended by a device synchronisation) shared
    out over the group's cases in proportion to their window counts."""

    def __init__(self, log_dir: str = "logs", save_volumes: bool = True,
                 continuous: int = 0, **kwargs) -> None:
        super().__init__(log_dir=log_dir, **kwargs)
        self.module.eval().requires_grad_(False)
        self.save_volumes = save_volumes
        self.continuous = int(continuous)
        self.results: Dict[str, list] = {
            "images": [], "outputs": [], "labels": [], "dices": [],
            "ious": [], "hd95s": [], "filenames": []}
        self.case_seconds: List[Dict[str, float]] = []
        self.set_dataloader()
        self.logger = MetricLogger(log_dir=log_dir)
        self.logger.start_case_table(self.class_names)
        self.log_dir = Path("logs") / log_dir
        if self.quantize:
            calib = None
            if self.quant_calibrate > 0:
                batch = next(iter(self.dataloader["val"]))
                calib = self._calibration_windows(
                    torch.from_numpy(batch["image"][0]))
            self._offline_quantize(calib)

    @classmethod
    def from_config(cls, path, **overrides) -> "Tester":
        """Build from a flat YAML test config; ``overrides`` win."""
        cfg = dict(load_flat_yaml(path))
        cfg.update(overrides)
        return cls(**cfg)

    def test(self) -> Dict[str, list]:
        group: List[Dict[str, Any]] = []
        for batch in self.dataloader["val"]:
            if self.continuous > 0:
                group.append(batch)
                if len(group) == self.continuous:
                    self._serve_group(group)
                    group = []
            else:
                self.validation_step(batch)
        if group:
            self._serve_group(group)
        have = bool(self.results["dices"])
        mean_dice = float(np.mean(self.results["dices"])) if have else 0.0
        print(self.logger.per_class_table(
            self.class_names,
            np.mean(self.results["dices"], axis=0)
            if have else [0.0] * self.num_classes,
            hd95s=(np.nanmean(np.asarray(self.results["hd95s"], np.float64),
                              axis=0) if have else None),
            ious=(np.mean(self.results["ious"], axis=0) if have else None),
        ))
        print(f"mean dice : {mean_dice:.4f}")
        self.logger.log_case_table()
        self.save_results()
        return self.results

    def validation_step(self, batch: Dict[str, Any]) -> None:
        t0 = time.perf_counter()
        image, labels, outputs = self.infer_case(batch)
        self._sync()
        self._record_case(image, labels, outputs,
                          batch.get("filename", [None])[0],
                          inference_s=time.perf_counter() - t0)

    def _serve_group(self, group: List[Dict[str, Any]]) -> None:
        t0 = time.perf_counter()
        images = [torch.from_numpy(b["image"][0]).to(self.device)
                  for b in group]
        labels = [self.convert_labels(
            torch.from_numpy(b["label"]).to(self.device))[0] for b in group]
        results = self.serve_volumes(images, seeds=[self.seed] * len(group))
        self._sync()
        seconds = time.perf_counter() - t0
        windows = [len(self._continuous.starts(im.shape[:3]))
                   for im in images]
        for b, image, lab, (_, outputs), n in zip(group, images, labels,
                                                  results, windows):
            self._record_case(image, lab, outputs,
                              b.get("filename", [None])[0],
                              inference_s=seconds * n / sum(windows))

    def _record_case(self, image: torch.Tensor, labels: torch.Tensor,
                     outputs: torch.Tensor, filename: Optional[str],
                     inference_s: float = 0.0) -> None:
        t0 = time.perf_counter()
        dices = validation_dice(outputs, labels).cpu().numpy()
        t1 = time.perf_counter()
        out_np = outputs.cpu().numpy()
        lab_np = labels.cpu().numpy()
        hd95s = []
        ious = []
        for c in range(self.num_classes):
            o, lab = out_np[..., c] > 0, lab_np[..., c] > 0
            hd95s.append(hausdorff_distance_95(o, lab)
                         if o.any() and lab.any() else float("nan"))
            # the registry's IoU (TP / (TP + FP + FN)), 0 when both empty
            ious.append(jaccard(o, lab, nan_for_nonexisting=False))
        t2 = time.perf_counter()
        self.results["dices"].append(dices)
        self.results["hd95s"].append(hd95s)
        self.results["ious"].append(ious)
        self.results["filenames"].append(filename)
        img_np = image.cpu().numpy()[..., 0]
        if self.save_volumes:
            self.results["images"].append(img_np.astype(np.float16))
            self.results["outputs"].append(out_np > 0)
            self.results["labels"].append(lab_np > 0)
        vis_dir = self.log_dir / "vis"
        vis_dir.mkdir(parents=True, exist_ok=True)
        idx = len(self.results["dices"]) - 1
        class_ids = sorted(self.class_names)
        pred_lbl = channels_to_class_ids(out_np, class_ids)
        lab_lbl = channels_to_class_ids(lab_np, class_ids)
        self.logger.save_midslice_png(vis_dir / f"case{idx}.png", img_np,
                                      output=pred_lbl, label=lab_lbl)
        patient = (Path(filename).name.split(".")[0] if filename
                   else f"case{idx}")
        self.logger.add_case(
            patient, mean_dice=float(np.mean(dices)),
            mean_hd95=float(np.nanmean(np.asarray(hd95s, np.float64)))
            if not np.all(np.isnan(hd95s)) else float("nan"),
            mean_iou=float(np.mean(ious)),
            class_dices=dices,
        )
        split = dict(inference=inference_s, dice_device=t1 - t0,
                     hd95_iou_host=t2 - t1,
                     recording=time.perf_counter() - t2)
        self.case_seconds.append(split)
        print(f"case {idx} {patient} {tuple(img_np.shape)}: "
              + ", ".join(f"{k} {v:.4f} s" for k, v in split.items())
              + f"; mean dice {float(np.mean(dices)):.4f}", flush=True)

    def save_results(self) -> None:
        self.log_dir.mkdir(parents=True, exist_ok=True)
        path = self.log_dir / "results.pkl"
        with open(path, "wb") as f:
            pickle.dump(self.results, f)
        print(f"results saved to {path}")


class Trainer(Engine):
    """Training engine for every model of the factory: ``diff_unet``
    (``cfg/amos/train.yaml``, ``cfg/msd/train.yaml``; the AMOS recipe also
    with ``model_name=smooth_diff_unet`` or ``attention_diff_unet``),
    ``diff_swin_unetr`` (``cfg/btcv/train.yaml``) and the plain
    ``swin_unetr`` baseline (one forward per step, no q_sample).

    Data: the training and validation lists of ``data_path``'s
    ``dataset.json`` (``set_dataloader``; labels converted per batch on the
    device), or, when ``train_data`` is given, that iterable of batches
    ``{"image": (B, D, H, W, 1) float, "label": (B, D, H, W) integer}``
    (``data/synthetic.py``), prepared once and moved to the device, with no
    validation set (``data_path`` is then unused). Labels are
    distance-smoothed over ``num_classes + 1`` values and lose the
    background channel unless ``include_background`` (``label_smoothing``),
    or are one-hot encoded over the class ids. Where ``losses`` lists
    ``boundary``, each batch's signed distance maps are computed on the
    host (``losses/edt.py``, the exact C++ EDT).

    The train step (``engine/train.py:TrainStep``) takes the JAX Trainer's
    keys: ``ema_rate`` (an EMA tree updated after every call),
    ``accum_steps`` (an AdamW update every k calls on the mean of their
    gradients) and ``t_sampler`` (``uniform`` or ``loss_aware``).
    ``pretrained_path`` grafts a MONAI ``encoder.pt`` or ``swinvit.pt``
    (``utils/pretrained.py``) unless ``model_path`` resumes.

    ``train()`` runs epochs of one train call per batch and stops with the
    previous step's loss when it is not finite; after each epoch it saves
    ``logs/<log_dir>/weights/epoch_{n}.pt`` every ``save_freq`` epochs,
    then validates every ``val_freq`` epochs (mean ``validation_dice`` over
    the validation volumes; a new best above 0.5 is saved as
    ``best_{dice:.4f}.pt``). SIGTERM or SIGUSR1 saves ``preempt.pt`` after
    the current step and returns. ``model_path`` resumes from a ``.pt``:
    parameters, AdamW state, schedule count, generator, EMA tree, sampler
    state, accumulated gradient and metadata, from the saved epoch on, so
    a resumed run takes the same steps as one that was not stopped.
    ``history`` holds one record per step: loss, grad norm and lr."""

    _phases = (("train", "training"), ("val", "validation"))

    def __init__(self, train_data: Optional[Iterable[Dict[str, Any]]] = None,
                 max_epochs: int = 5000, lr: float = 1e-4,
                 weight_decay: float = 1e-3, scheduler: Optional[str] = None,
                 warmup_epochs: int = 100, val_freq: int = 1,
                 save_freq: int = 5, losses: str = "mse,bce,dice",
                 loss_combine: str = "sum", noise_ratio: float = 0.5,
                 pretrained_path: Optional[str] = None,
                 ema_rate: Optional[float] = None, accum_steps: int = 1,
                 t_sampler: str = "uniform", model_name: str = "diff_unet",
                 model_path: Optional[str] = None, log_dir: str = "logs",
                 **kwargs) -> None:
        if kwargs.get("quantize"):
            raise ValueError("quantize=true is an inference-only option "
                             "(use it with test.py / predict.py)")
        if train_data is None and kwargs.get("data_path") is None:
            raise ValueError("Trainer needs data_path (a directory holding "
                             "a Decathlon dataset.json) or train_data (an "
                             "iterable of batches)")
        super().__init__(model_name=model_name, log_dir=log_dir, **kwargs)
        self.module.train()
        self.max_epochs = max_epochs
        self.val_freq = val_freq
        self.save_freq = save_freq
        self.noise_ratio = noise_ratio      # stored only, as in the model
        self.criterion = CompositeLoss(losses, self.num_classes,
                                       loss_combine)
        self.log_dir = Path("logs") / log_dir
        self.weights_path = self.log_dir / "weights"
        # the signed distance maps of each train_data batch, for boundary
        self.batch_dist_maps: Optional[List[torch.Tensor]] = None
        if train_data is not None:
            self.batches = [self._prepare(b) for b in train_data]
            if self.criterion.needs_dist_maps:
                self.batch_dist_maps = [self._dist_maps(lab)
                                        for _, lab in self.batches]
            steps_per_epoch = len(self.batches)
        else:
            self.batches = None
            steps_per_epoch = len(self.set_dataloader()["train"])
        self.logger = MetricLogger(log_dir=log_dir)
        optimizer, schedule = make_optimizer(
            self.module.parameters(), lr=float(lr),
            weight_decay=float(weight_decay),
            scheduler="warmup_cosine" if scheduler else None,
            warmup_epochs=warmup_epochs, max_epochs=max_epochs,
            steps_per_epoch=max(steps_per_epoch, 1))
        self.train_step = TrainStep(
            self.seg, self.criterion, optimizer, schedule,
            ema_rate=ema_rate, t_sampler=t_sampler, accum_steps=accum_steps)
        self.generator = torch.Generator(self.device).manual_seed(
            self.seed + 1)
        self.start_epoch = 0
        self.global_step = 0
        self.best_mean_dice = 0.0
        self.loss = 0.0
        self.run_id = 0
        self.preemption: Optional[ckpt_lib.PreemptionGuard] = None
        self.history: List[Dict[str, float]] = []
        if model_path is not None:
            self.load_checkpoint(model_path)
        elif pretrained_path is not None:
            load_pretrained_encoder(pretrained_path, self.module,
                                    self.model_name)
            self.train_step.reset_ema()
            print(f"Load pretrained weights from {pretrained_path}")

    @classmethod
    def from_config(cls, path, train_data=None, **overrides) -> "Trainer":
        """Build from a flat YAML train config; ``overrides`` win."""
        cfg = dict(load_flat_yaml(path))
        cfg.update(overrides)
        return cls(train_data=train_data, **cfg)

    def _prepare(self, batch: Dict[str, Any]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """A ``train_data`` batch on the device, labels as channels."""
        image = np.asarray(batch["image"], np.float32)
        label = np.asarray(batch["label"])
        roi = tuple(self._inferer.roi)
        if image.shape != (self.batch_size, *roi, 1) or \
                label.shape != (self.batch_size, *roi):
            raise ValueError(
                f"batches must hold {self.batch_size} samples of {roi} "
                f"(image (..., 1), integer label), got {image.shape} and "
                f"{label.shape}")
        if self.label_smoothing:
            label = np.stack([smooth_labels(
                lab, self.num_classes + 1, self.smoothing["alpha"],
                self.smoothing["order"], self.smoothing["lambda_decay"])
                for lab in label])
        return self._to_device(image, label)

    def _to_device(self, image: np.ndarray, label: np.ndarray
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        image = torch.from_numpy(np.ascontiguousarray(image)).to(self.device)
        label = torch.from_numpy(np.ascontiguousarray(label)).to(self.device)
        return image, self.convert_labels(label)

    def _dist_maps(self, labels: torch.Tensor) -> torch.Tensor:
        """The signed distance maps of channel labels (B, D, H, W, C),
        computed on the host, on the labels' device."""
        return torch.from_numpy(batch_dist_maps(labels.cpu().numpy())).to(
            labels.device)

    # ---- checkpoints ----
    def _param_names(self) -> List[str]:
        return [n for n, _ in self.module.named_parameters()]

    def save_model(self, path) -> None:
        step = self.train_step
        meta = {
            "epoch": self.epoch + 1,
            "loss": float(self.loss),
            "noise_ratio": self.noise_ratio,
            "global_step": self.global_step,
            "best_mean_dice": float(self.best_mean_dice),
            "project_name": self.project_name,
            "id": self.run_id,
        }
        ckpt_lib.save_checkpoint(
            path, self.module, step.optimizer, step.count, self.generator,
            meta, **step.extra_state(self._param_names()))
        print(f"model is saved in {path}")

    def load_checkpoint(self, model_path) -> None:
        """Resume from the port's ``.pt``: parameters, AdamW state,
        schedule count, generator (when saved from the same device type),
        EMA tree, sampler state, accumulated gradient and metadata;
        training goes on at the saved epoch."""
        state = ckpt_lib.load_training_state(model_path)
        step = self.train_step
        self.module.load_state_dict(state["state_dict"])
        if state["optimizer"] is not None:
            step.optimizer.load_state_dict(state["optimizer"])
        step.count = state["count"]
        step.load_extra_state(state, self._param_names())
        if state["generator"] is not None:
            if state["generator_device"] == self.device.type:
                self.generator.set_state(state["generator"])
            else:
                warnings.warn(
                    f"the checkpoint's generator ran on "
                    f"{state['generator_device']}, this trainer's on "
                    f"{self.device.type}: t and noise restart from the "
                    "seed", stacklevel=2)
        meta = state["meta"]
        self.start_epoch = self.epoch = meta.get("epoch", 0)
        self.global_step = meta.get("global_step", 0)
        self.best_mean_dice = meta.get("best_mean_dice", 0.0)
        self.noise_ratio = meta.get("noise_ratio", self.noise_ratio)
        self.project_name = meta.get("project_name", self.project_name)
        self.run_id = meta.get("id") or 0
        print(f"Checkpoint loaded from {model_path}")

    # ---- loops ----
    def train(self) -> None:
        epochs = range(self.start_epoch, self.max_epochs)
        if "val" not in self.dataloader and any(
                (e + 1) % self.val_freq == 0 for e in epochs):
            raise ValueError(
                f"validation every {self.val_freq} epochs needs the "
                "validation set of data_path; train_data brings none")
        self.preemption = ckpt_lib.PreemptionGuard()
        try:
            for epoch in epochs:
                self.epoch = epoch
                self.train_epoch(epoch)
                if self.preemption.requested:
                    path = self.weights_path / "preempt.pt"
                    self.save_model(path)
                    print(f"preemption checkpoint saved to {path}; resume "
                          f"with model_path={path}")
                    return
                if (epoch + 1) % self.val_freq == 0:
                    dices = [self.validation_step(batch)
                             for batch in self.dataloader["val"]]
                    self.validation_end(dices, epoch)
                self.start_epoch = epoch + 1
        finally:
            self.preemption.close()

    def train_epoch(self, epoch: int) -> None:
        if self.batches is not None:
            batches: Iterable = self.batches
            total = len(self.batches)
        else:
            loader = self.dataloader["train"]
            loader.set_epoch(epoch)
            batches = (self._to_device(b["image"], b["label"])
                       for b in loader)
            total = len(loader)
        meter = ProgressMeter(total, desc=f"Epoch {epoch}")
        # the previous step's loss is read after the next step is queued,
        # so the host never waits on a fresh result; the NaN abort fires
        # one step late, as in the JAX engine
        losses: List[float] = []
        prev = None
        for i, (image, labels) in enumerate(batches):
            self.global_step += 1
            metrics = self.train_step(image, labels,
                                      generator=self.generator,
                                      dist_maps=self.dist_maps_of(i, labels))
            if prev is not None:
                losses.append(self._record(prev))
                meter.update(loss=losses[-1])
            prev = metrics
            if self.preemption is not None and self.preemption.requested:
                break
        if prev is not None:
            losses.append(self._record(prev))
        self.loss = float(np.mean(losses)) if losses else 0.0
        self.logger.log({"loss": self.loss, "epoch": epoch},
                        step=self.global_step)
        if (epoch + 1) % self.save_freq == 0:
            self.save_model(self.weights_path / f"epoch_{epoch + 1}.pt")

    def dist_maps_of(self, i: int, labels: torch.Tensor
                     ) -> Optional[torch.Tensor]:
        """The distance maps of batch ``i`` where ``boundary`` needs them:
        precomputed for ``train_data``, computed now for loader batches."""
        if not self.criterion.needs_dist_maps:
            return None
        if self.batch_dist_maps is not None:
            return self.batch_dist_maps[i]
        return self._dist_maps(labels)

    def _record(self, metrics: Dict[str, Any]) -> float:
        loss = float(metrics["loss"])
        if not np.isfinite(loss):
            raise RuntimeError("Training stopped due to the loss being NaN")
        self.history.append(dict(
            loss=loss, grad_norm=float(metrics["grad_norm"]),
            lr=metrics["lr"]))
        return loss

    def validation_step(self, batch: Dict[str, Any]) -> float:
        _, labels, outputs = self.infer_case(batch)
        return float(validation_dice(outputs, labels).mean())

    def validation_end(self, dices: Sequence[float], epoch: int) -> None:
        mean_dice = float(np.mean(dices)) if dices else 0.0
        if mean_dice > self.best_mean_dice:
            self.best_mean_dice = mean_dice
            if mean_dice > 0.5:
                self.save_model(self.weights_path
                                / f"best_{mean_dice:.4f}.pt")
        print(f"mean_dice : {mean_dice:.4f}")
        self.logger.log({"mean_dice": mean_dice}, step=epoch)
