"""The loss-aware timestep sampler (counterpart of
``diff_unet_tpu/diffusion/resample.py``, ``LossSecondMomentResampler``).

The state is a ring of the last ``history`` losses of every timestep and
a count of each, both on the device. Until every timestep holds a full
history the distribution is uniform; then p_t is proportional to
sqrt(E[loss_t^2]), mixed with a uniform floor. A draw takes t from p with
``torch.multinomial`` and weights each sample by 1 / (T * p[t]).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class LossAwareState(NamedTuple):
    losses: torch.Tensor      # (T, history) float32
    counts: torch.Tensor      # (T,) int32: losses recorded, at most history


def init_loss_aware(num_timesteps: int, history: int = 10,
                    device: Optional[torch.device] = None
                    ) -> LossAwareState:
    return LossAwareState(
        losses=torch.zeros((num_timesteps, history), dtype=torch.float32,
                           device=device),
        counts=torch.zeros((num_timesteps,), dtype=torch.int32,
                           device=device))


def loss_aware_weights(state: LossAwareState,
                       uniform_prob: float = 0.001) -> torch.Tensor:
    """The (T,) sampling distribution; uniform until warmed up."""
    t_count, history = state.losses.shape
    warmed = torch.all(state.counts >= history)
    second_moment = torch.sqrt(torch.mean(torch.square(state.losses),
                                          dim=-1))
    p = second_moment / torch.clamp(torch.sum(second_moment), min=1e-12)
    p = p * (1.0 - uniform_prob) + uniform_prob / t_count
    uniform = torch.full_like(p, 1.0 / t_count)
    return torch.where(warmed, p, uniform)


def weights_for(state: LossAwareState, t: torch.Tensor,
                uniform_prob: float = 0.001) -> torch.Tensor:
    """Importance weights 1 / (T * p[t]) of given timesteps."""
    p = loss_aware_weights(state, uniform_prob)
    return 1.0 / (p.shape[0] * p[t])


def sample_loss_aware(state: LossAwareState,
                      generator: Optional[torch.Generator], batch: int,
                      uniform_prob: float = 0.001
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw (t, importance weights) from the loss-aware distribution, with
    ``generator`` on the state's device."""
    p = loss_aware_weights(state, uniform_prob)
    t = torch.multinomial(p, batch, replacement=True, generator=generator)
    return t, 1.0 / (p.shape[0] * p[t])


@torch.no_grad()
def update_loss_aware(state: LossAwareState, t: torch.Tensor,
                      losses: torch.Tensor) -> LossAwareState:
    """Record each sample's loss in its timestep's ring (a full ring drops
    its oldest). Where a timestep repeats in the batch, its last sample in
    batch order is recorded and its count rises once, as the JAX scatter
    does; every duplicate writes that same row, so the scatter's order
    does not matter on the card."""
    history = state.losses.shape[1]
    t = t.long()
    losses = losses.detach().float()
    # the index of each sample's last occurrence in the batch
    same = t[:, None] == t[None, :]
    order = torch.arange(1, t.shape[0] + 1, device=t.device)
    last = torch.amax(same * order[None, :], dim=1) - 1
    loss = losses[last]
    counts = state.counts[t]
    full = counts >= history
    row = state.losses[t]
    row = torch.where(full[:, None], torch.roll(row, -1, dims=1), row)
    slot = torch.clamp(counts, max=history - 1).long()
    row = row.scatter(1, slot[:, None], loss[:, None])
    new_losses = state.losses.index_put((t,), row)
    new_counts = state.counts.index_put(
        (t,), torch.clamp(counts + 1, max=history).to(state.counts.dtype))
    return LossAwareState(new_losses, new_counts)
