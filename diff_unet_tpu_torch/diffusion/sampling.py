"""DDIM sampling (counterpart of ``ddim_step`` / ``ddim_sample_loop`` in
``diff_unet_tpu/diffusion/sampling.py``), as a Python loop over the
respaced steps with no host synchronisation inside it.

The returned logit map is the sum of the per-step ``pred_xstart`` (the
Diff-UNet behaviour), accumulated in float32 on the device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from diff_unet_tpu_torch.diffusion import gaussian
from diff_unet_tpu_torch.diffusion.gaussian import DenoiseFn
from diff_unet_tpu_torch.diffusion.schedule import Schedule, extract


class SampleLoopOutput(NamedTuple):
    sample: torch.Tensor
    pred_xstart: torch.Tensor       # the final sample (see ddim_sample_loop)
    pred_xstart_sum: torch.Tensor   # sum of pred_xstart over all steps


def ddim_step(denoise_fn: DenoiseFn, schedule: Schedule, x: torch.Tensor,
              t: torch.Tensor):
    """One deterministic (eta = 0) DDIM update x_t -> x_{t-1}, with the
    x_0 prediction clipped to [-1, 1]."""
    nd = x.dim()
    out = gaussian.p_mean_variance(denoise_fn, schedule, x, t)
    eps = gaussian.predict_eps_from_xstart(schedule, x, t, out.pred_xstart)
    alpha_bar_prev = extract(schedule, "alphas_cumprod_prev", t, nd)
    mean_pred = (out.pred_xstart * torch.sqrt(alpha_bar_prev)
                 + torch.sqrt(1.0 - alpha_bar_prev) * eps)
    return mean_pred, out


def ddim_sample_loop(denoise_fn: DenoiseFn, schedule: Schedule,
                     noise: torch.Tensor) -> SampleLoopOutput:
    """Deterministic DDIM from x_T = ``noise`` down to t = 0.

    As in the JAX package, ``pred_xstart`` of the result is the final
    sample, not the last step's own pred_xstart."""
    x = noise.float()
    accum = torch.zeros_like(x)
    for step in range(schedule.num_timesteps - 1, -1, -1):
        t = torch.full((x.shape[0],), step, dtype=torch.int64,
                       device=x.device)
        x, out = ddim_step(denoise_fn, schedule, x, t)
        accum = accum + out.pred_xstart
    return SampleLoopOutput(sample=x, pred_xstart=x, pred_xstart_sum=accum)
