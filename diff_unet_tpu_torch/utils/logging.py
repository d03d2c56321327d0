"""Metric logging, tables and image dumps (counterpart of
``diff_unet_tpu/utils/logging.py``): stdout, a JSONL sink
(``metrics.jsonl``), the per-class dice / HD95 / IoU table, the per-case
table mirrored to ``cases.jsonl``, mid-slice PNG dumps (when matplotlib is
installed) and a progress meter. wandb is not ported: the port's engines
raise on ``use_wandb: true``, so this logger has no wandb sink.
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np


def format_table(headers: Sequence[str], rows: Sequence[Sequence]) -> str:
    """ASCII table."""
    cells = [[str(h) for h in headers]] + [
        [str(c) for c in row] for row in rows
    ]
    widths = [max(len(r[i]) for r in cells) for i in range(len(headers))]
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    out = [sep]
    for i, row in enumerate(cells):
        out.append(
            "|" + "|".join(f" {c:<{w}} " for c, w in zip(row, widths)) + "|"
        )
        if i == 0:
            out.append(sep)
    out.append(sep)
    return "\n".join(out)


class MetricLogger:
    """Scalar/metric sink: a JSONL file under ``log_dir``."""

    def __init__(self, log_dir: Optional[str] = None) -> None:
        self.log_dir = Path(log_dir) if log_dir else None
        self._file = None
        if self.log_dir:
            self.log_dir.mkdir(parents=True, exist_ok=True)
            self._file = open(self.log_dir / "metrics.jsonl", "a")
        self._case_class_names: Dict[int, str] = {}
        self._case_rows: Optional[list] = None

    def log(self, metrics: Dict, step: Optional[int] = None) -> None:
        record = {"time": time.time(), "step": step, **{
            k: (float(v) if isinstance(v, (int, float, np.floating)) else v)
            for k, v in metrics.items()
        }}
        if self._file:
            self._file.write(json.dumps(record) + "\n")
            self._file.flush()

    def per_class_table(self, class_names: Dict[int, str],
                        dices: Sequence[float],
                        hd95s: Optional[Sequence[float]] = None,
                        ious: Optional[Sequence[float]] = None) -> str:
        """dice / hd95 / iou columns, one row per class."""
        headers = (["class", "dice"]
                   + (["hd95"] if hd95s is not None else [])
                   + (["iou"] if ious is not None else []))
        rows = []
        for i, (cid, name) in enumerate(class_names.items()):
            row = [f"{cid}:{name}", f"{float(dices[i]):.4f}"]
            if hd95s is not None:
                row.append(f"{float(hd95s[i]):.2f}")
            if ious is not None:
                row.append(f"{float(ious[i]):.4f}")
            rows.append(row)
        return format_table(headers, rows)

    # ---- per-case segmentation table ----
    def start_case_table(self, class_names: Dict[int, str]) -> None:
        """Begin the per-case results table (patient, dice, hd95, iou and
        one dice column per class), written to ``cases.jsonl``."""
        self._case_class_names = dict(class_names)
        self._case_rows = []

    def add_case(self, patient: str, mean_dice: float, mean_hd95: float,
                 mean_iou: float, class_dices: Sequence[float]) -> None:
        """One table row of case metrics."""
        def _num(v):
            v = float(v)
            return v if np.isfinite(v) else None  # strict-JSON safe

        self._case_rows.append({
            "patient": patient,
            "dice": _num(mean_dice),
            "hd95": _num(mean_hd95),
            "iou": _num(mean_iou),
            **{
                name: _num(d)
                for name, d in zip(self._case_class_names.values(),
                                   class_dices)
            },
        })

    def log_case_table(self) -> None:
        """Write the table to ``cases.jsonl``."""
        if self.log_dir and self._case_rows is not None:
            with open(self.log_dir / "cases.jsonl", "w") as f:
                for row in self._case_rows:
                    f.write(json.dumps(row) + "\n")

    def save_midslice_png(self, path, image: np.ndarray,
                          output: Optional[np.ndarray] = None,
                          label: Optional[np.ndarray] = None,
                          frac: float = 0.75) -> bool:
        """Mid-slice image / output / label panels as one PNG; False (and
        nothing written) without matplotlib."""
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return False
        idx = int(image.shape[0] * frac)
        panels = [("image", image[idx], "gray")]
        if output is not None:
            panels.append(("output", output[idx], "viridis"))
        if label is not None:
            panels.append(("label", label[idx], "viridis"))
        fig, axes = plt.subplots(1, len(panels), figsize=(4 * len(panels), 4))
        axes = np.atleast_1d(axes)
        for ax, (title, img2d, cmap) in zip(axes, panels):
            ax.imshow(np.asarray(img2d), cmap=cmap)
            ax.set_title(title)
            ax.axis("off")
        fig.savefig(path, bbox_inches="tight")
        plt.close(fig)
        return True

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = None


class ProgressMeter:
    """Minimal tqdm replacement: rate + loss postfix on stdout."""

    def __init__(self, total: int, desc: str = "", every: int = 10):
        self.total = total
        self.desc = desc
        self.every = every
        self.n = 0
        self.t0 = time.time()

    def update(self, **postfix) -> None:
        self.n += 1
        if self.n % self.every == 0 or self.n == self.total:
            rate = self.n / max(time.time() - self.t0, 1e-9)
            extras = " ".join(f"{k}={v:.4g}" for k, v in postfix.items())
            print(f"{self.desc} [{self.n}/{self.total}] "
                  f"{rate:.2f} it/s {extras}", flush=True)
