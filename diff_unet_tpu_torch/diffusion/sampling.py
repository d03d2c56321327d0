"""Sampling loops (counterpart of ``diff_unet_tpu/diffusion/sampling.py``):
DDIM with any eta, ancestral DDPM, and the DDIM reverse ODE, each as a
Python loop over the respaced steps with no host synchronisation inside
it.

A sample loop returns the sum of the per-step ``pred_xstart`` (the
Diff-UNet behaviour), accumulated in float32 on the device, and reports
the final sample as ``pred_xstart``, as the JAX loops do. A stochastic
loop draws x_T and each step's noise from an explicit ``torch.Generator``
on the state's device, or takes them: ``noise`` is x_T and ``step_noise``
gives step t's draw by its (respaced) index t.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import torch

from diff_unet_tpu_torch.diffusion import gaussian
from diff_unet_tpu_torch.diffusion.gaussian import (DenoiseFn, FIXED_LARGE,
                                                    START_X, StepNoise)
from diff_unet_tpu_torch.diffusion.schedule import Schedule, extract


class SampleLoopOutput(NamedTuple):
    sample: torch.Tensor
    pred_xstart: torch.Tensor       # the final sample (see the docstring)
    pred_xstart_sum: torch.Tensor   # sum of pred_xstart over all steps


def _nonzero_mask(t: torch.Tensor, ndim: int) -> torch.Tensor:
    mask = (t != 0).float()
    return mask.reshape(mask.shape + (1,) * (ndim - mask.dim()))


def ddim_step(denoise_fn: DenoiseFn, schedule: Schedule, x: torch.Tensor,
              t: torch.Tensor, noise: Optional[torch.Tensor] = None, *,
              generator: Optional[torch.Generator] = None,
              eta: float = 0.0, mean_type: str = START_X,
              var_type: str = FIXED_LARGE, clip_denoised: bool = True,
              denoised_fn: Optional[Callable] = None):
    """One DDIM update x_t -> x_{t-1} (DDIM eq. 12). At eta > 0 sigma
    enters the mean, and sigma times ``noise`` (or a draw from
    ``generator``) is added where t != 0."""
    nd = x.dim()
    if eta != 0.0:
        noise = gaussian.draw_noise(x, generator, noise)
    out = gaussian.p_mean_variance(
        denoise_fn, schedule, x, t, mean_type=mean_type, var_type=var_type,
        clip_denoised=clip_denoised, denoised_fn=denoised_fn)
    eps = gaussian.predict_eps_from_xstart(schedule, x, t, out.pred_xstart)
    alpha_bar = extract(schedule, "alphas_cumprod", t, nd)
    alpha_bar_prev = extract(schedule, "alphas_cumprod_prev", t, nd)
    sigma = (eta * torch.sqrt((1.0 - alpha_bar_prev) / (1.0 - alpha_bar))
             * torch.sqrt(1.0 - alpha_bar / alpha_bar_prev))
    mean_pred = (out.pred_xstart * torch.sqrt(alpha_bar_prev)
                 + torch.sqrt(1.0 - alpha_bar_prev - sigma ** 2) * eps)
    if eta != 0.0:
        mean_pred = mean_pred + _nonzero_mask(t, nd) * sigma * noise
    return mean_pred, out


def p_sample_step(denoise_fn: DenoiseFn, schedule: Schedule,
                  x: torch.Tensor, t: torch.Tensor,
                  noise: Optional[torch.Tensor] = None, *,
                  generator: Optional[torch.Generator] = None,
                  mean_type: str = START_X, var_type: str = FIXED_LARGE,
                  clip_denoised: bool = True,
                  denoised_fn: Optional[Callable] = None):
    """One ancestral DDPM update: the model's mean plus its standard
    deviation times ``noise`` (or a draw from ``generator``) where
    t != 0."""
    noise = gaussian.draw_noise(x, generator, noise)
    out = gaussian.p_mean_variance(
        denoise_fn, schedule, x, t, mean_type=mean_type, var_type=var_type,
        clip_denoised=clip_denoised, denoised_fn=denoised_fn)
    sample = (out.mean + _nonzero_mask(t, x.dim())
              * torch.exp(0.5 * out.log_variance) * noise)
    return sample, out


def _sample_loop(step_fn, schedule: Schedule, noise: Optional[torch.Tensor],
                 shape: Optional[Sequence[int]],
                 generator: Optional[torch.Generator]) -> SampleLoopOutput:
    """Run ``step_fn(x, t, step)`` from t = T - 1 down to 0 from x_T =
    ``noise``, or a draw of ``shape`` from ``generator`` (on its device)."""
    if generator is None and noise is None:
        raise ValueError("a sample loop needs a torch.Generator on the "
                         "state's device or its x_T (noise)")
    if noise is None:
        if shape is None:
            raise ValueError("a sample loop needs x_T (noise) or its shape")
        noise = torch.randn(tuple(shape), generator=generator,
                            device=generator.device)
    x = noise.float()
    accum = torch.zeros_like(x)
    for step in range(schedule.num_timesteps - 1, -1, -1):
        t = torch.full((x.shape[0],), step, dtype=torch.int64,
                       device=x.device)
        x, out = step_fn(x, t, step)
        accum = accum + out.pred_xstart
    return SampleLoopOutput(sample=x, pred_xstart=x, pred_xstart_sum=accum)


def ddim_sample_loop(denoise_fn: DenoiseFn, schedule: Schedule,
                     noise: Optional[torch.Tensor] = None, *,
                     shape: Optional[Sequence[int]] = None,
                     generator: Optional[torch.Generator] = None,
                     step_noise: Optional[StepNoise] = None,
                     eta: float = 0.0, mean_type: str = START_X,
                     var_type: str = FIXED_LARGE, clip_denoised: bool = True,
                     denoised_fn: Optional[Callable] = None
                     ) -> SampleLoopOutput:
    """DDIM from x_T = ``noise`` (or a draw of ``shape``) down to t = 0.
    At eta = 0 the loop is deterministic and draws nothing; at eta > 0
    each step's noise comes from ``step_noise`` or ``generator``."""
    def step_fn(x, t, step):
        draw = (None if step_noise is None
                else gaussian.step_draw(step_noise, step, x, generator))
        return ddim_step(denoise_fn, schedule, x, t, draw,
                         generator=generator, eta=eta, mean_type=mean_type,
                         var_type=var_type, clip_denoised=clip_denoised,
                         denoised_fn=denoised_fn)
    return _sample_loop(step_fn, schedule, noise, shape, generator)


def p_sample_loop(denoise_fn: DenoiseFn, schedule: Schedule,
                  noise: Optional[torch.Tensor] = None, *,
                  shape: Optional[Sequence[int]] = None,
                  generator: Optional[torch.Generator] = None,
                  step_noise: Optional[StepNoise] = None,
                  mean_type: str = START_X, var_type: str = FIXED_LARGE,
                  clip_denoised: bool = True,
                  denoised_fn: Optional[Callable] = None
                  ) -> SampleLoopOutput:
    """Ancestral DDPM from x_T = ``noise`` (or a draw of ``shape``) down to
    t = 0, each step's noise from ``step_noise`` or ``generator``."""
    def step_fn(x, t, step):
        draw = (None if step_noise is None
                else gaussian.step_draw(step_noise, step, x, generator))
        return p_sample_step(denoise_fn, schedule, x, t, draw,
                             generator=generator, mean_type=mean_type,
                             var_type=var_type, clip_denoised=clip_denoised,
                             denoised_fn=denoised_fn)
    return _sample_loop(step_fn, schedule, noise, shape, generator)


def ddim_reverse_step(denoise_fn: DenoiseFn, schedule: Schedule,
                      x: torch.Tensor, t: torch.Tensor, *,
                      mean_type: str = START_X, var_type: str = FIXED_LARGE,
                      clip_denoised: bool = True):
    """One DDIM reverse-ODE update x_t -> x_{t+1}."""
    nd = x.dim()
    out = gaussian.p_mean_variance(
        denoise_fn, schedule, x, t, mean_type=mean_type, var_type=var_type,
        clip_denoised=clip_denoised)
    eps = gaussian.predict_eps_from_xstart(schedule, x, t, out.pred_xstart)
    alpha_bar_next = extract(schedule, "alphas_cumprod_next", t, nd)
    mean_pred = (out.pred_xstart * torch.sqrt(alpha_bar_next)
                 + torch.sqrt(1.0 - alpha_bar_next) * eps)
    return mean_pred, out


def ddim_reverse_sample_loop(denoise_fn: DenoiseFn, schedule: Schedule,
                             x: torch.Tensor, *, mean_type: str = START_X,
                             var_type: str = FIXED_LARGE,
                             clip_denoised: bool = True) -> torch.Tensor:
    """Encode x_0 -> x_T along the DDIM reverse ODE, from t = 0 up to
    T - 1; returns x_T."""
    for step in range(schedule.num_timesteps):
        t = torch.full((x.shape[0],), step, dtype=torch.int64,
                       device=x.device)
        x, _ = ddim_reverse_step(denoise_fn, schedule, x, t,
                                 mean_type=mean_type, var_type=var_type,
                                 clip_denoised=clip_denoised)
    return x
