"""Diffusion-segmentation API (counterpart of ``DiffusionSegmenter`` in
``diff_unet_tpu/api.py``): for training, ``q_sample`` and ``denoise``; for
serving, embed the image once, then run the respaced DDIM loop and return
the per-step pred_xstart sum as logits."""
from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Optional, Tuple

import torch
from torch import nn

from diff_unet_tpu_torch.diffusion import gaussian, sampling
from diff_unet_tpu_torch.diffusion.schedule import Schedule


@dataclasses.dataclass(eq=False)
class DiffusionSegmenter:
    """A denoiser module (``DiffSwinUNETR``) with its sampling process."""

    module: nn.Module
    num_classes: int
    timesteps: int = 1000
    sample_steps: int = 10

    @cached_property
    def train_schedule(self) -> Schedule:
        return Schedule.create("linear", self.timesteps)

    @cached_property
    def sample_schedule(self) -> Schedule:
        return Schedule.create("linear", self.timesteps,
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

    def ddim_sample(self, image: torch.Tensor, *,
                    noise: torch.Tensor) -> torch.Tensor:
        """Respaced DDIM (eta = 0) over image (B, D, H, W, Cin) from x_T =
        ``noise`` (B, D, H, W, num_classes); sliding-window inference passes
        per-window noise keyed on window start coordinates. Returns the
        per-step pred_xstart sum."""
        embeddings = self.module.embed(image)

        def denoise_fn(x, t):
            return self.module.denoise_with_embeddings(x, t, embeddings,
                                                       image)

        return sampling.ddim_sample_loop(denoise_fn, self.sample_schedule,
                                         noise).pred_xstart_sum
