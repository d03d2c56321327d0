"""Segmentation API (counterpart of ``diff_unet_tpu/api.py``):
``DiffusionSegmenter`` gives training ``q_sample`` and ``denoise`` and
serving the respaced DDIM loop (embed the image once, return the per-step
pred_xstart sum as logits), DDIM with eta > 0 and ancestral DDPM;
``PlainSegmenter`` gives a non-diffusion baseline (``swin_unetr``) the
same surface, one forward per image."""
from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Optional, Tuple, Union

import torch
from torch import nn

from diff_unet_tpu_torch.diffusion import gaussian, sampling
from diff_unet_tpu_torch.diffusion.schedule import Schedule


@dataclasses.dataclass(eq=False)
class PlainSegmenter:
    """A segmentation module that maps an image to class logits in one
    forward (no timesteps, no DDIM loop)."""

    module: nn.Module
    num_classes: int

    def predict(self, image: torch.Tensor) -> torch.Tensor:
        return self.module(image)


@dataclasses.dataclass(eq=False)
class DiffusionSegmenter:
    """A denoiser module (``DiffSwinUNETR``, ``DiffUNet``, ...) with its
    train and sample diffusion processes: ``schedule_name`` ("linear" or
    "cosine") and the model's mean and variance parameterisation, as in
    the JAX package (no engine key sets them)."""

    module: nn.Module
    num_classes: int
    timesteps: int = 1000
    sample_steps: int = 10
    schedule_name: str = "linear"
    mean_type: str = gaussian.START_X
    var_type: str = gaussian.FIXED_LARGE

    @cached_property
    def train_schedule(self) -> Schedule:
        return Schedule.create(self.schedule_name, self.timesteps)

    @cached_property
    def sample_schedule(self) -> Schedule:
        return Schedule.create(self.schedule_name, self.timesteps,
                               respace=[self.sample_steps])

    def q_sample(self, x_start: torch.Tensor,
                 generator: Optional[torch.Generator] = None, *,
                 t: Optional[torch.Tensor] = None,
                 noise: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Draw t ~ U[0, T) and noise ~ N(0, 1) from ``generator`` (on
        x_start's device), unless given; return (x_t, t, noise)."""
        if t is None:
            t = gaussian.uniform_timesteps(generator, x_start.shape[0],
                                           self.timesteps, x_start.device)
        if noise is None:
            noise = torch.randn(x_start.shape, generator=generator,
                                dtype=x_start.dtype, device=x_start.device)
        x_t = gaussian.q_sample(self.train_schedule, x_start, t, noise)
        return x_t, t, noise

    def denoise(self, image: torch.Tensor, x: torch.Tensor,
                t: torch.Tensor) -> torch.Tensor:
        """Predict x_0 logits for x_t at step t, conditioned on the
        image."""
        return self.module.denoise(image, x, t)

    def embedded_denoiser(self, image: torch.Tensor) -> gaussian.DenoiseFn:
        """Embed ``image`` once; returns denoise_fn(x, t) over those
        embeddings, for a sampling loop."""
        embeddings = self.module.embed(image)

        def denoise_fn(x, t):
            return self.module.denoise_with_embeddings(x, t, embeddings,
                                                       image)
        return denoise_fn

    def ddim_sample(self, image: torch.Tensor, *, noise: torch.Tensor,
                    eta: float = 0.0,
                    generator: Optional[torch.Generator] = None,
                    step_noise: Optional[gaussian.StepNoise] = None,
                    return_all: bool = False
                    ) -> Union[torch.Tensor, sampling.SampleLoopOutput]:
        """Respaced DDIM over image (B, D, H, W, Cin) from x_T = ``noise``
        (B, D, H, W, num_classes); sliding-window inference passes
        per-window noise keyed on window start coordinates. At eta > 0
        each step's noise comes from ``step_noise`` (by respaced step) or
        ``generator`` (on the image's device). Returns the per-step
        pred_xstart sum, or with ``return_all`` the loop's
        ``SampleLoopOutput``."""
        out = sampling.ddim_sample_loop(
            self.embedded_denoiser(image), self.sample_schedule, noise,
            generator=generator, step_noise=step_noise, eta=eta,
            mean_type=self.mean_type, var_type=self.var_type)
        return out if return_all else out.pred_xstart_sum

    def ddpm_sample(self, image: torch.Tensor, *,
                    generator: Optional[torch.Generator] = None,
                    noise: Optional[torch.Tensor] = None,
                    step_noise: Optional[gaussian.StepNoise] = None
                    ) -> sampling.SampleLoopOutput:
        """Ancestral sampling over the respaced process: x_T = ``noise``
        or a draw from ``generator`` (on the image's device), each step's
        noise from ``step_noise`` or ``generator``."""
        shape = (image.shape[0], *image.shape[1:-1], self.num_classes)
        return sampling.p_sample_loop(
            self.embedded_denoiser(image), self.sample_schedule, noise,
            shape=shape, generator=generator, step_noise=step_noise,
            mean_type=self.mean_type, var_type=self.var_type)
