"""Overfit DiffUNet on synthetic organs and report the dice trajectory, the
counterpart of ``examples/overfit_synthetic.py``:

    python -m diff_unet_tpu_torch.overfit [--size 48] [--iters 401]
        [--features 64 64 128 256 512 64] [--eval-every 100]
        [--device cuda] [--out overfit.npz]

Four synthetic volumes of ``size``^3 from ``RandomState(i)`` (the
example's cases at 48: a sphere and a box organ over noise, with an
intensity signal; at other sizes the organs' positions and extents scale
with the side), one batch of all four. The example's recipe: DiffUNet in
bf16 (``use_amp``), mse + bce + dice, AdamW at lr 3e-4 and weight decay
1e-5 at a constant rate, every step on the same batch with the same t and
noise (the example passes one key to every step: here a generator seeded
alike before each step), through the port's ``Trainer`` step. Every
``eval_every`` iterations (and at the first) it serves each volume with a
``Predictor`` (DDIM-10, ROI = the volume, sw_batch_size 1, overlap 0,
noise seed 9) and prints one JSON line: iteration, loss, mean dice,
elapsed seconds; then ``FINAL (iter, loss, dice)``. ``--out`` saves the
trained parameters as a JAX-tree ``.npz`` (``engine/checkpoint.py``), which
``model_path`` serves. On the CPU pass ``--device cpu`` (and a small
``--size`` / ``--features``).
"""
from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

C = 2                       # organ classes: 1 sphere, 2 box
SIDE = 48                   # the example's side
CLASSES_YAML = "0: background\n1: sphere\n2: box\n"
STEP_SEED = 1               # every step's t and noise (the example's key(1))


def make_case(seed: int, size: int = SIDE):
    """(image (S, S, S) float32, labels (S, S, S) int32): the example's
    ``make_case`` at 48, its bounds scaled by size / 48 elsewhere."""
    def sc(v: int) -> int:
        return max(1, round(v * size / SIDE))

    r = np.random.RandomState(seed)
    img = r.randn(size, size, size).astype(np.float32) * 0.05
    lab = np.zeros((size, size, size), np.int32)
    c1 = r.randint(sc(14), size - sc(14), 3)
    rad = r.randint(sc(6), max(sc(10), sc(6) + 1))
    zz, yy, xx = np.mgrid[:size, :size, :size]
    d1 = (zz - c1[0]) ** 2 + (yy - c1[1]) ** 2 + (xx - c1[2]) ** 2
    lab[d1 < rad ** 2] = 1
    c2 = r.randint(sc(8), size - sc(16), 3)
    w = r.randint(sc(5), max(sc(9), sc(5) + 1))
    lab[c2[0]:c2[0] + w, c2[1]:c2[1] + w, c2[2]:c2[2] + w] = 2
    img += (lab == 1) * 0.7 + (lab == 2) * 0.4
    return img, lab


def make_cases(size: int = SIDE):
    """The four cases: images (4, S, S, S, 1), integer labels (4, S, S, S)
    and one-hot labels (4, S, S, S, 2) over classes 1 and 2."""
    cases = [make_case(i, size) for i in range(4)]
    images = np.stack([c[0] for c in cases])[..., None]
    labels = np.stack([c[1] for c in cases])
    onehot = np.stack([(labels == i).astype(np.float32) for i in (1, 2)], -1)
    return images, labels, onehot


def engine_kwargs(size: int, features: Optional[Sequence[int]],
                  device: str, classes: str) -> Dict:
    """The engine keys of the recipe (``classes``: a classes YAML path)."""
    kw = dict(model_name="diff_unet", image_size=size, spatial_size=size,
              classes=classes, use_amp=True, sample_steps=10,
              sw_batch_size=1, overlap=0.0, device=device)
    if features:
        kw["features"] = tuple(features)
    return kw


def build_predictor(size: int = SIDE,
                    features: Optional[Sequence[int]] = None,
                    device: str = "cuda", seed: int = 9, **kw):
    """A ``Predictor`` of the recipe's evaluation (``kw``: ``model_path``,
    ``quantize``, ``quant_calibrate``, ...)."""
    from diff_unet_tpu_torch.engine.engine import Predictor

    with tempfile.TemporaryDirectory() as tmp:
        classes = Path(tmp) / "classes.yaml"
        classes.write_text(CLASSES_YAML)
        return Predictor(seed=seed, **engine_kwargs(size, features, device,
                                                     str(classes)), **kw)


def evaluate(predictor, images: np.ndarray, onehot: np.ndarray):
    """Serve each volume; returns (mean dice of each case, the binary
    outputs (S, S, S, 2) on the device)."""
    from diff_unet_tpu_torch.metrics.metrics import validation_dice

    dices, binaries = [], []
    for img, lab in zip(images, onehot):
        _, binary = predictor.infer(torch.from_numpy(img))
        lab = torch.from_numpy(lab).to(binary.device)
        dices.append(float(validation_dice(binary, lab).mean()))
        binaries.append(binary)
    return dices, binaries


def run(size: int = SIDE, iters: int = 401,
        features: Optional[Sequence[int]] = None, eval_every: int = 100,
        device: str = "cuda", out: Optional[str] = None) -> Dict:
    """Train and evaluate as the module docstring says; returns {"trajectory":
    [(iter, loss, mean dice, elapsed s)], "losses": every step's loss,
    "seconds": training and evaluation, "out": the .npz path or None}."""
    from diff_unet_tpu_torch.engine.checkpoint import save_jax_npz
    from diff_unet_tpu_torch.engine.engine import Trainer
    from diff_unet_tpu_torch.utils.weights import export_jax_params

    images, labels, onehot = make_cases(size)
    with tempfile.TemporaryDirectory() as tmp:
        classes = Path(tmp) / "classes.yaml"
        classes.write_text(CLASSES_YAML)
        trainer = Trainer(
            train_data=[{"image": images, "label": labels}], batch_size=4,
            lr=3e-4, weight_decay=1e-5, max_epochs=iters,
            log_dir=str(Path(tmp) / "logs"), seed=0,
            **engine_kwargs(size, features, device, str(classes)))
        predictor = build_predictor(size, features, device)
    image, label = trainer.batches[0]
    gen = torch.Generator(trainer.device)
    t0 = time.perf_counter()
    traj: List[tuple] = []
    losses: List[float] = []
    for it in range(iters):
        gen.manual_seed(STEP_SEED)
        loss = float(trainer.train_step(image, label, generator=gen)["loss"])
        losses.append(loss)
        if it % eval_every == 0 or it == iters - 1:
            predictor.module.load_state_dict(trainer.module.state_dict())
            dice = float(np.mean(evaluate(predictor, images, onehot)[0]))
            traj.append((it, round(loss, 4), round(dice, 4)))
            print(json.dumps({"iter": it, "loss": round(loss, 4),
                              "mean_dice": round(dice, 4),
                              "elapsed_s": round(time.perf_counter() - t0,
                                                 1)}), flush=True)
    print("FINAL", traj[-1], flush=True)
    if out is not None:
        save_jax_npz(out, export_jax_params(trainer.module),
                     meta={"epoch": iters})
    return {"trajectory": traj, "losses": losses,
            "seconds": time.perf_counter() - t0, "out": out}


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--size", type=int, default=SIDE)
    p.add_argument("--iters", type=int, default=401)
    p.add_argument("--features", type=int, nargs=6, default=None)
    p.add_argument("--eval-every", type=int, default=100)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None,
                   help="save the trained parameters to this .npz")
    a = p.parse_args(argv)
    return run(a.size, a.iters, a.features, a.eval_every, a.device, a.out)


if __name__ == "__main__":
    main()
