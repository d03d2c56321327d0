"""Diffusion-segmentation API (counterpart of ``DiffusionSegmenter`` in
``diff_unet_tpu/api.py``): embed the image once, then run the respaced
DDIM loop and return the per-step pred_xstart sum as logits."""
from __future__ import annotations

import dataclasses
from functools import cached_property

import torch
from torch import nn

from diff_unet_tpu_torch.diffusion import sampling
from diff_unet_tpu_torch.diffusion.schedule import Schedule


@dataclasses.dataclass(eq=False)
class DiffusionSegmenter:
    """A denoiser module (``DiffSwinUNETR``) with its sampling process."""

    module: nn.Module
    num_classes: int
    timesteps: int = 1000
    sample_steps: int = 10

    @cached_property
    def sample_schedule(self) -> Schedule:
        return Schedule.create("linear", self.timesteps,
                               respace=[self.sample_steps])

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
