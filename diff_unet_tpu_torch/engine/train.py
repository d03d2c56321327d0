"""Training step: q_sample, denoise, loss, backward and an AdamW update
(counterpart of ``diff_unet_tpu/engine/train.py``), with the JAX
Trainer's keys: EMA parameters (``ema_rate``), gradient accumulation
(``accum_steps``, ``optax.MultiSteps`` semantics), the loss-aware timestep
sampler (``t_sampler="loss_aware"``), the boundary loss's distance maps
and the plain (non-diffusion) branch.

The learning rate follows optax's count: update ``k`` (from 0) uses
``schedule(k)``, so under a warmup the first update has lr 0. AdamW decays
every parameter, biases, norm scales and the relative-position tables
included, as ``optax.adamw`` does (one parameter group, no mask).
"""
from __future__ import annotations

import math
import warnings
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple, \
    Union

import torch

from diff_unet_tpu_torch.api import DiffusionSegmenter, PlainSegmenter
from diff_unet_tpu_torch.diffusion import resample
from diff_unet_tpu_torch.engine.ema import init_ema, update_ema
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
                   max_epochs: int = 5000, steps_per_epoch: int = 1
                   ) -> Tuple[torch.optim.AdamW, Schedule]:
    """AdamW (betas (0.9, 0.999), eps 1e-8) over ``params`` and its
    per-update learning-rate schedule (warmup-cosine for the cosine
    schedulers, else constant). ``steps_per_epoch`` counts train calls;
    under accumulation (``TrainStep(accum_steps=k)``) the schedule still
    advances once per update, so its epochs last k times as many calls,
    as the JAX package's ``optax.MultiSteps`` wrapping does."""
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
    """One training call of a segmenter. A ``DiffusionSegmenter``
    (``model_type`` "diffusion"): x_start = labels*2-1; t ~ the sampler
    (uniform, or loss-aware from ``sampler_state``) and noise ~ N(0, 1)
    from ``generator``, or given; x_t = q_sample; preds = denoise(image,
    x_t, t) in f32. A ``PlainSegmenter`` ("segmentation"): preds =
    module(image). Then the loss
    (with ``dist_maps`` where ``boundary`` is listed; under the loss-aware
    sampler, the mean of each sample's own loss times its importance
    weight), backward and, every ``accum_steps`` calls, an AdamW update on
    the running mean acc + (g - acc) / (n + 1) of the calls' gradients
    (``optax.MultiSteps``: the parameters do not move between updates).
    After every call, micro-steps included, the EMA tree moves toward the
    parameters and the sampler records each sample's loss at its t.

    Returns device tensors ``loss``, ``grad_norm`` (global L2 of this
    call's gradients) and ``nonfinite``, the ``lr`` of the pending or
    applied update and ``updated``. The gradients (their running mean
    under accumulation) stay on the parameters."""

    def __init__(self, seg: Union[DiffusionSegmenter, PlainSegmenter],
                 criterion: CompositeLoss,
                 optimizer: torch.optim.Optimizer, schedule: Schedule, *,
                 ema_rate: Optional[float] = None,
                 t_sampler: str = "uniform", accum_steps: int = 1) -> None:
        if t_sampler not in ("uniform", "loss_aware"):
            raise ValueError(f"unknown t_sampler {t_sampler!r}: uniform or "
                             "loss_aware")
        model_type = ("segmentation" if isinstance(seg, PlainSegmenter)
                      else "diffusion")
        if model_type == "segmentation" and t_sampler != "uniform":
            raise ValueError("the loss-aware sampler draws timesteps; a "
                             "plain segmentation model has none")
        if int(accum_steps) < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        self.seg = seg
        self.criterion = criterion
        self.optimizer = optimizer
        self.schedule = schedule
        self.model_type = model_type
        self.params = [p for group in optimizer.param_groups
                       for p in group["params"]]
        self.count = 0              # updates applied
        self.micro = 0              # calls accumulated since the last one
        self.accum_steps = int(accum_steps)
        self.ema_rate = float(ema_rate) if ema_rate else None
        self.ema = init_ema(self.params) if self.ema_rate else None
        self.sampler_state = (
            resample.init_loss_aware(seg.timesteps,
                                     device=self.params[0].device)
            if t_sampler == "loss_aware" else None)

    def reset_ema(self) -> None:
        """Restart the EMA tree from the current parameters."""
        if self.ema is not None:
            self.ema = init_ema(self.params)

    def extra_state(self, names: Sequence[str]) -> Dict:
        """A checkpoint's ``ema`` (the EMA tree by parameter ``names``),
        ``sampler`` (ring and counts) and ``accum`` (the micro-step count
        and the running mean of a pending update), None where absent."""
        sampler = self.sampler_state
        return dict(
            ema=(None if self.ema is None
                 else {n: e.detach() for n, e in zip(names, self.ema)}),
            sampler=(None if sampler is None
                     else {"losses": sampler.losses,
                           "counts": sampler.counts}),
            accum=(None if not self.micro else
                   {"micro": self.micro,
                    "grads": [p.grad.detach() for p in self.params]}))

    @torch.no_grad()
    def load_extra_state(self, state: Dict, names: Sequence[str]) -> None:
        """Restore what ``extra_state`` saved; an EMA tree or sampler state
        the checkpoint lacks restarts."""
        dev = self.params[0].device
        if self.ema is not None:
            if state.get("ema") is None:
                warnings.warn("the checkpoint has no EMA tree: it restarts "
                              "from the loaded parameters", stacklevel=3)
                self.reset_ema()
            else:
                self.ema = [state["ema"][n].to(p.device, p.dtype).clone()
                            for n, p in zip(names, self.params)]
        if self.sampler_state is not None and state.get("sampler"):
            self.sampler_state = resample.LossAwareState(
                state["sampler"]["losses"].to(dev),
                state["sampler"]["counts"].to(dev))
        accum = state.get("accum")
        self.micro = accum["micro"] if accum else 0
        for i, p in enumerate(self.params):
            p.grad = accum["grads"][i].to(dev).clone() if accum else None

    def _preds(self, image, labels, generator, t, noise):
        if self.model_type == "segmentation":
            return self.seg.predict(image).float(), None, None
        weights = None
        if self.sampler_state is not None:
            if t is None:
                t, weights = resample.sample_loss_aware(
                    self.sampler_state, generator, labels.shape[0])
            else:
                weights = resample.weights_for(self.sampler_state, t)
        x_t, t, _ = self.seg.q_sample(labels * 2.0 - 1.0, generator, t=t,
                                      noise=noise)
        return self.seg.denoise(image, x_t, t).float(), t, weights

    def __call__(self, image: torch.Tensor, labels: torch.Tensor, *,
                 generator: Optional[torch.Generator] = None,
                 t: Optional[torch.Tensor] = None,
                 noise: Optional[torch.Tensor] = None,
                 dist_maps: Optional[torch.Tensor] = None
                 ) -> Dict[str, torch.Tensor]:
        acc = [p.grad for p in self.params] if self.micro else None
        for p in self.params:
            p.grad = None
        preds, t, weights = self._preds(image, labels, generator, t, noise)
        per_example = None
        if weights is not None:
            per_example = torch.stack([self.criterion(
                preds[i:i + 1], labels[i:i + 1],
                None if dist_maps is None else dist_maps[i:i + 1])
                for i in range(preds.shape[0])])
            loss = torch.mean(per_example * weights)
        else:
            loss = self.criterion(preds, labels, dist_maps)
        loss.backward()
        grads = [p.grad for p in self.params]
        if any(g is None for g in grads):
            raise RuntimeError("a parameter got no gradient; optax would "
                               "still decay it")
        grad_norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads]))
        if acc is not None:
            # optax.MultiSteps: acc + (g - acc) / (n + 1)
            step = torch._foreach_sub(grads, acc)
            torch._foreach_div_(step, self.micro + 1)
            torch._foreach_add_(acc, step)
            for p, a in zip(self.params, acc):
                p.grad = a
        self.micro += 1
        lr = self.schedule(self.count)
        updated = self.micro == self.accum_steps
        if updated:
            apply_update(self.optimizer, self.schedule, self.count)
            self.count += 1
            self.micro = 0
        if self.ema is not None:
            update_ema(self.ema, self.params, self.ema_rate)
        if per_example is not None:
            self.sampler_state = resample.update_loss_aware(
                self.sampler_state, t, per_example)
        loss = loss.detach()
        return {"loss": loss, "grad_norm": grad_norm,
                "nonfinite": ~torch.isfinite(loss), "lr": lr,
                "updated": updated}
