"""Training step: q_sample, denoise, loss, backward and an AdamW update
(counterpart of ``diff_unet_tpu/engine/train.py``, uniform timestep
sampler only).

The learning rate follows optax's count: update ``k`` (from 0) uses
``schedule(k)``, so under a warmup the first update has lr 0. AdamW decays
every parameter, biases, norm scales and the relative-position tables
included, as ``optax.adamw`` does (one parameter group, no mask).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

from diff_unet_tpu_torch.api import DiffusionSegmenter
from diff_unet_tpu_torch.losses.losses import CompositeLoss

Schedule = Callable[[int], float]


def linear_warmup_cosine(base_lr: float, warmup_epochs: int, max_epochs: int,
                         steps_per_epoch: int, warmup_start_lr: float = 0.0,
                         eta_min: float = 0.0) -> Schedule:
    """Per-step lr: linear ``warmup_start_lr -> base_lr`` over
    ``warmup_epochs``, then cosine to ``eta_min`` at ``max_epochs``."""

    def schedule(step: int) -> float:
        epoch = step / steps_per_epoch
        if epoch < warmup_epochs:
            return warmup_start_lr + (base_lr - warmup_start_lr) * min(
                epoch / max(warmup_epochs, 1e-8), 1.0)
        progress = (epoch - warmup_epochs) / max(max_epochs - warmup_epochs,
                                                 1e-8)
        progress = min(max(progress, 0.0), 1.0)
        return eta_min + (base_lr - eta_min) * 0.5 * (
            1.0 + math.cos(math.pi * progress))

    return schedule


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float = 1e-4,
                   weight_decay: float = 1e-3,
                   scheduler: Optional[str] = None, warmup_epochs: int = 100,
                   max_epochs: int = 5000, steps_per_epoch: int = 1,
                   accum_steps: int = 1
                   ) -> Tuple[torch.optim.AdamW, Schedule]:
    """AdamW (betas (0.9, 0.999), eps 1e-8) over ``params`` and its
    per-update learning-rate schedule (warmup-cosine for the cosine
    schedulers, else constant)."""
    if accum_steps > 1:
        raise NotImplementedError("gradient accumulation (accum_steps > 1) "
                                  "is not ported yet (ROADMAP.md, training "
                                  "path)")
    if scheduler in ("cosine_annealing", "warmup_cosine", "cosine"):
        schedule = linear_warmup_cosine(lr, warmup_epochs, max_epochs,
                                        steps_per_epoch)
    elif scheduler is None:
        def schedule(step: int) -> float:
            return lr
    else:
        raise ValueError(f"unknown scheduler {scheduler!r}")
    optimizer = torch.optim.AdamW(list(params), lr=schedule(0),
                                  betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=weight_decay)
    return optimizer, schedule


def apply_update(optimizer: torch.optim.Optimizer, schedule: Schedule,
                 count: int) -> float:
    """Update number ``count`` with lr ``schedule(count)``; returns it."""
    lr = schedule(count)
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()
    return lr


class TrainStep:
    """One training step of a diffusion segmenter: x_start = labels*2-1;
    t, noise ~ uniform, N(0, 1) from ``generator`` (or given); x_t =
    q_sample; preds = denoise(image, x_t, t) in f32; loss = criterion;
    backward; AdamW update. Returns device tensors ``loss``, ``grad_norm``
    (global L2 of the gradients, before the update) and ``nonfinite``,
    and the update's ``lr``; the gradients stay on the parameters."""

    def __init__(self, seg: DiffusionSegmenter, criterion: CompositeLoss,
                 optimizer: torch.optim.Optimizer, schedule: Schedule, *,
                 ema_rate: Optional[float] = None,
                 t_sampler: str = "uniform") -> None:
        if ema_rate:
            raise NotImplementedError("EMA parameters are not ported yet "
                                      "(ROADMAP.md, training path)")
        if t_sampler != "uniform":
            raise NotImplementedError(
                f"t_sampler {t_sampler!r} is not ported yet (ROADMAP.md, "
                "training path); the uniform sampler is")
        self.seg = seg
        self.criterion = criterion
        self.optimizer = optimizer
        self.schedule = schedule
        self.params = [p for group in optimizer.param_groups
                       for p in group["params"]]
        self.count = 0

    def __call__(self, image: torch.Tensor, labels: torch.Tensor, *,
                 generator: Optional[torch.Generator] = None,
                 t: Optional[torch.Tensor] = None,
                 noise: Optional[torch.Tensor] = None
                 ) -> Dict[str, torch.Tensor]:
        self.optimizer.zero_grad(set_to_none=True)
        x_start = labels * 2.0 - 1.0
        x_t, t, _ = self.seg.q_sample(x_start, generator, t=t, noise=noise)
        preds = self.seg.denoise(image, x_t, t).float()
        loss = self.criterion(preds, labels)
        loss.backward()
        grads = [p.grad for p in self.params]
        if any(g is None for g in grads):
            raise RuntimeError("a parameter got no gradient; optax would "
                               "still decay it")
        grad_norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads]))
        lr = apply_update(self.optimizer, self.schedule, self.count)
        self.count += 1
        loss = loss.detach()
        return {"loss": loss, "grad_norm": grad_norm,
                "nonfinite": ~torch.isfinite(loss), "lr": lr}
