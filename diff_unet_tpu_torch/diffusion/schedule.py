"""Diffusion noise schedules and timestep respacing.

A copy of the float64 numpy code of ``diff_unet_tpu/diffusion/schedule.py``
(the JAX package cannot be imported without jax). ``extract`` gathers a
table by timestep as a torch op; tables are uploaded once per device and
dtype, so a sampling loop makes no host transfer.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Union

import numpy as np
import torch


def linear_beta_schedule(num_timesteps: int) -> np.ndarray:
    """Linear beta schedule from Ho et al., scaled to any step count."""
    scale = 1000.0 / num_timesteps
    return np.linspace(scale * 0.0001, scale * 0.02, num_timesteps,
                       dtype=np.float64)


def space_timesteps(num_timesteps: int,
                    section_counts: Union[str, Sequence[int]]) -> list[int]:
    """Strided subset of timesteps (sorted ascending), including the
    per-section fractional striding and the "ddimN" string form."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired = int(section_counts[len("ddim"):])
            for stride in range(1, num_timesteps):
                if len(range(0, num_timesteps, stride)) == desired:
                    return list(range(0, num_timesteps, stride))
            raise ValueError(
                f"cannot create exactly {desired} steps with an integer stride")
        section_counts = [int(x) for x in section_counts.split(",")]

    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps: list[int] = []
    for i, count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < count:
            raise ValueError(f"cannot divide section of {size} steps into {count}")
        frac_stride = 1.0 if count <= 1 else (size - 1) / (count - 1)
        cur = 0.0
        for _ in range(count):
            all_steps.append(start_idx + round(cur))
            cur += frac_stride
        start_idx += size
    return sorted(set(all_steps))


@dataclasses.dataclass(frozen=True, eq=False)
class Schedule:
    """Precomputed diffusion tables (float64 numpy, shape (T,)) plus the
    respaced-index -> raw-timestep map."""

    betas: np.ndarray
    timestep_map: np.ndarray

    def __post_init__(self):
        betas = np.asarray(self.betas, dtype=np.float64)
        if betas.ndim != 1 or not ((betas > 0).all() and (betas <= 1).all()):
            raise ValueError("betas must be a 1-D array in (0, 1]")
        object.__setattr__(self, "betas", betas)
        tmap = np.asarray(self.timestep_map, dtype=np.int32)
        if tmap.shape != betas.shape:
            raise ValueError("timestep_map must match betas")
        object.__setattr__(self, "timestep_map", tmap)

        alphas = 1.0 - betas
        ac = np.cumprod(alphas, axis=0)
        ac_prev = np.append(1.0, ac[:-1])
        post_var = betas * (1.0 - ac_prev) / (1.0 - ac)
        fl_var = np.append(post_var[1], betas[1:])
        with np.errstate(divide="ignore"):
            fields = dict(
                alphas_cumprod=ac,
                alphas_cumprod_prev=ac_prev,
                sqrt_alphas_cumprod=np.sqrt(ac),
                sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - ac),
                sqrt_recip_alphas_cumprod=np.sqrt(1.0 / ac),
                sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / ac - 1.0),
                posterior_variance=post_var,
                posterior_mean_coef1=betas * np.sqrt(ac_prev) / (1.0 - ac),
                posterior_mean_coef2=(1.0 - ac_prev) * np.sqrt(alphas)
                / (1.0 - ac),
                fixed_large_variance=fl_var,
                fixed_large_log_variance=np.log(fl_var),
            )
        for k, v in fields.items():
            object.__setattr__(self, k, v)

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])

    @classmethod
    def create(cls, schedule_name: str = "linear", num_timesteps: int = 1000,
               respace: Optional[Union[str, Sequence[int]]] = None
               ) -> "Schedule":
        """Build a (possibly respaced) schedule; ``respace=[10]`` is the
        DDIM-10 sampling process."""
        if schedule_name != "linear":
            raise NotImplementedError(
                f"beta schedule {schedule_name!r} is not ported yet "
                "(ROADMAP.md, diffusion core)")
        betas = linear_beta_schedule(num_timesteps)
        if respace is None:
            return cls(betas, np.arange(num_timesteps, dtype=np.int32))
        keep = space_timesteps(num_timesteps, respace)
        base_ac = np.cumprod(1.0 - betas)
        new_betas, last = [], 1.0
        for i in keep:
            new_betas.append(1.0 - base_ac[i] / last)
            last = base_ac[i]
        return cls(np.asarray(new_betas, np.float64),
                   np.asarray(keep, np.int32))

    def table(self, name: str, device: torch.device,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Table ``name`` as a device tensor, uploaded once."""
        return _uploaded(self, name, torch.device(device), dtype)

    def map_timesteps(self, t: torch.Tensor) -> torch.Tensor:
        """Respaced indices -> raw model timesteps."""
        return self.table("timestep_map", t.device, torch.int64)[t]


@functools.lru_cache(maxsize=256)
@torch.inference_mode(False)        # shared by serving and training
def _uploaded(schedule: Schedule, name: str, device: torch.device,
              dtype: torch.dtype) -> torch.Tensor:
    return torch.as_tensor(getattr(schedule, name), dtype=dtype,
                           device=device)


def extract(schedule: Schedule, name: str, t: torch.Tensor,
            ndim: int) -> torch.Tensor:
    """Gather per-timestep f32 scalars of table ``name`` and broadcast to an
    ``ndim``-rank tensor."""
    vals = schedule.table(name, t.device)[t]
    return vals.reshape(vals.shape + (1,) * (ndim - vals.dim()))
