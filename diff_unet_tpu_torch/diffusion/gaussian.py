"""Gaussian diffusion math needed by training and DDIM sampling
(counterpart of part of ``diff_unet_tpu/diffusion/gaussian.py``).

``denoise_fn(x, t)`` always receives raw (unrespaced) timesteps; the
respace map is applied here via ``Schedule.map_timesteps``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from diff_unet_tpu_torch.diffusion.schedule import Schedule, extract

START_X = "start_x"
FIXED_LARGE = "fixed_large"

DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def q_sample(schedule: Schedule, x_start: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """Sample x_t ~ q(x_t | x_0)."""
    nd = x_start.dim()
    return (extract(schedule, "sqrt_alphas_cumprod", t, nd) * x_start
            + extract(schedule, "sqrt_one_minus_alphas_cumprod", t, nd)
            * noise)


def uniform_timesteps(generator: Optional[torch.Generator], batch: int,
                      num_timesteps: int, device: torch.device
                      ) -> torch.Tensor:
    """Uniform schedule sampler: t ~ U[0, T) (its weights are all 1)."""
    return torch.randint(0, num_timesteps, (batch,), generator=generator,
                         device=device)


def predict_xstart_from_eps(schedule: Schedule, x_t, t, eps):
    nd = x_t.dim()
    return (extract(schedule, "sqrt_recip_alphas_cumprod", t, nd) * x_t
            - extract(schedule, "sqrt_recipm1_alphas_cumprod", t, nd) * eps)


def predict_eps_from_xstart(schedule: Schedule, x_t, t, pred_xstart):
    nd = x_t.dim()
    return ((extract(schedule, "sqrt_recip_alphas_cumprod", t, nd) * x_t
             - pred_xstart)
            / extract(schedule, "sqrt_recipm1_alphas_cumprod", t, nd))


class PMeanVariance(NamedTuple):
    mean: torch.Tensor
    variance: torch.Tensor
    log_variance: torch.Tensor
    pred_xstart: torch.Tensor
    model_output: torch.Tensor


def p_mean_variance(denoise_fn: DenoiseFn, schedule: Schedule,
                    x: torch.Tensor, t: torch.Tensor, *,
                    mean_type: str = START_X, var_type: str = FIXED_LARGE,
                    clip_denoised: bool = True) -> PMeanVariance:
    """p(x_{t-1} | x_t) and the x_0 prediction for the START_X /
    FIXED_LARGE parameterisation of the Diff-UNet family."""
    if mean_type != START_X or var_type != FIXED_LARGE:
        raise NotImplementedError(
            f"mean_type={mean_type!r} var_type={var_type!r} are not ported "
            "yet (ROADMAP.md, diffusion core)")
    nd = x.dim()
    model_output = denoise_fn(x, schedule.map_timesteps(t))
    variance = extract(schedule, "fixed_large_variance", t, nd)
    log_variance = extract(schedule, "fixed_large_log_variance", t, nd)
    pred_xstart = model_output
    if clip_denoised:
        pred_xstart = torch.clamp(pred_xstart, -1.0, 1.0)
    mean = (extract(schedule, "posterior_mean_coef1", t, nd) * pred_xstart
            + extract(schedule, "posterior_mean_coef2", t, nd) * x)
    return PMeanVariance(mean, variance, log_variance, pred_xstart,
                         model_output)
