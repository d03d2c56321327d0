"""Exponential moving average of parameters (counterpart of
``diff_unet_tpu/engine/ema.py``).

The EMA tree is a list of float32 tensors beside the parameters, on their
device. ``update_ema`` computes ``e * rate + p * (1 - rate)`` in that
order, a product and a sum (no fused ``lerp``), so that a CPU run agrees
with the JAX package's to the last bit or two.
"""
from __future__ import annotations

from typing import List, Sequence

import torch


def init_ema(params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The EMA tree starts as a copy of the parameters."""
    return [p.detach().clone() for p in params]


@torch.no_grad()
def update_ema(ema: Sequence[torch.Tensor], params: Sequence[torch.Tensor],
               rate: float = 0.9999) -> None:
    """ema <- ema * rate + params * (1 - rate), in place."""
    ema = list(ema)
    scaled = torch._foreach_mul([p.detach().to(e.dtype)
                                 for p, e in zip(params, ema)], 1.0 - rate)
    torch._foreach_mul_(ema, rate)
    torch._foreach_add_(ema, scaled)


class EmaTracker:
    """Several EMA rates side by side (the vendored TrainLoop keeps one
    parameter copy per rate)."""

    def __init__(self, params: Sequence[torch.Tensor],
                 rates: Sequence[float] = (0.9999,)) -> None:
        self.rates = tuple(rates)
        self.ema = [init_ema(params) for _ in self.rates]

    def update(self, params: Sequence[torch.Tensor]) -> None:
        for e, r in zip(self.ema, self.rates):
            update_ema(e, params, r)

    def get(self, rate: float = None) -> List[torch.Tensor]:
        if rate is None:
            return self.ema[0]
        return self.ema[self.rates.index(rate)]
