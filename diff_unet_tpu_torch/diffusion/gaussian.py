"""Gaussian diffusion math (counterpart of
``diff_unet_tpu/diffusion/gaussian.py``): the forward process, the model's
p(x_{t-1} | x_t) over every mean and variance parameterisation, the
variational bound in bits per dim, the training losses and the whole-chain
bits-per-dim loop.

``denoise_fn(x, t)`` always receives raw (unrespaced) timesteps; the
respace map is applied here via ``Schedule.map_timesteps``. Tensors are
channel-last, (B, ..., C); a learned variance doubles the model output's
last axis. Random draws come from an explicit ``torch.Generator`` on the
tensors' device, or are passed in.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Union

import torch

from diff_unet_tpu_torch.diffusion.schedule import Schedule, extract

# model mean parameterisations
PREVIOUS_X = "previous_x"
START_X = "start_x"
EPSILON = "epsilon"
MEAN_TYPES = (PREVIOUS_X, START_X, EPSILON)

# model variance parameterisations
LEARNED = "learned"
LEARNED_RANGE = "learned_range"
FIXED_SMALL = "fixed_small"
FIXED_LARGE = "fixed_large"
VAR_TYPES = (LEARNED, LEARNED_RANGE, FIXED_SMALL, FIXED_LARGE)

LOSS_TYPES = ("mse", "rescaled_mse", "kl", "rescaled_kl")

DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
# the N(0, 1) draws of a loop, by (respaced) timestep: draws[t] or draws(t)
StepNoise = Union[Sequence[torch.Tensor], Callable[[int], torch.Tensor]]


def draw_noise(like: torch.Tensor, generator: Optional[torch.Generator],
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``noise`` if given, else N(0, 1) of ``like``'s shape, dtype and
    device from ``generator``, which must live on that device. With
    neither, raises: a stochastic step never falls back to another
    device's generator or to a deterministic update."""
    if noise is not None:
        return noise
    if generator is None:
        raise ValueError("a stochastic step needs a torch.Generator on the "
                         f"state's device ({like.device}) or its noise")
    return torch.randn(like.shape, generator=generator, dtype=like.dtype,
                       device=like.device)


def step_draw(step_noise: Optional[StepNoise], t: int, like: torch.Tensor,
              generator: Optional[torch.Generator]) -> torch.Tensor:
    """Step ``t``'s draw: ``step_noise[t]`` (or ``step_noise(t)``) if given,
    else from ``generator`` (``draw_noise``)."""
    if step_noise is None:
        return draw_noise(like, generator)
    return step_noise(t) if callable(step_noise) else step_noise[t]


def check_types(mean_type: str, var_type: str) -> None:
    if mean_type not in MEAN_TYPES:
        raise NotImplementedError(f"unknown mean type {mean_type!r}: one of "
                                  f"{MEAN_TYPES}")
    if var_type not in VAR_TYPES:
        raise NotImplementedError(f"unknown variance type {var_type!r}: one "
                                  f"of {VAR_TYPES}")


def mean_flat(x: torch.Tensor) -> torch.Tensor:
    """Mean over all non-batch dimensions."""
    return torch.mean(x, dim=tuple(range(1, x.dim())))


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL divergence between two diagonal Gaussians; any argument may be a
    Python float."""
    like = next(a for a in (mean1, logvar1, mean2, logvar2)
                if isinstance(a, torch.Tensor))
    logvar1, logvar2 = (a if isinstance(a, torch.Tensor)
                        else torch.tensor(a).to(like)
                        for a in (logvar1, logvar2))
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + ((mean1 - mean2) ** 2) * torch.exp(-logvar2))


def approx_standard_normal_cdf(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                   * (x + 0.044715 * x ** 3)))


def discretized_gaussian_log_likelihood(x: torch.Tensor, *,
                                        means: torch.Tensor,
                                        log_scales: torch.Tensor
                                        ) -> torch.Tensor:
    """Log-likelihood of a Gaussian discretized into 255 bins over [-1, 1]
    (the outer bins open)."""
    centered_x = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered_x
                                                      + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered_x
                                                     - 1.0 / 255.0))
    log_cdf_plus = torch.log(torch.clamp(cdf_plus, min=1e-12))
    log_one_minus_cdf_min = torch.log(torch.clamp(1.0 - cdf_min, min=1e-12))
    log_cdf_delta = torch.log(torch.clamp(cdf_plus - cdf_min, min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min,
                                   log_cdf_delta))


def q_mean_variance(schedule: Schedule, x_start: torch.Tensor,
                    t: torch.Tensor):
    """Mean, variance and log variance of q(x_t | x_0)."""
    nd = x_start.dim()
    mean = extract(schedule, "sqrt_alphas_cumprod", t, nd) * x_start
    variance = extract(schedule, "one_minus_alphas_cumprod", t, nd)
    log_variance = extract(schedule, "log_one_minus_alphas_cumprod", t, nd)
    return mean, variance, log_variance


def q_sample(schedule: Schedule, x_start: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """Sample x_t ~ q(x_t | x_0)."""
    nd = x_start.dim()
    return (extract(schedule, "sqrt_alphas_cumprod", t, nd) * x_start
            + extract(schedule, "sqrt_one_minus_alphas_cumprod", t, nd)
            * noise)


def q_posterior_mean(schedule: Schedule, x_start, x_t, t):
    """The mean of q(x_{t-1} | x_t, x_0)."""
    nd = x_t.dim()
    return (extract(schedule, "posterior_mean_coef1", t, nd) * x_start
            + extract(schedule, "posterior_mean_coef2", t, nd) * x_t)


def q_posterior_mean_variance(schedule: Schedule, x_start, x_t, t):
    """Mean, variance and (clipped) log variance of q(x_{t-1} | x_t,
    x_0)."""
    nd = x_t.dim()
    return (q_posterior_mean(schedule, x_start, x_t, t),
            extract(schedule, "posterior_variance", t, nd),
            extract(schedule, "posterior_log_variance_clipped", t, nd))


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


def predict_xstart_from_xprev(schedule: Schedule, x_t, t, xprev):
    nd = x_t.dim()
    return (extract(schedule, "recip_posterior_mean_coef1", t, nd) * xprev
            - extract(schedule, "posterior_mean_coef2_over_coef1", t, nd)
            * x_t)


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
                    clip_denoised: bool = True,
                    denoised_fn: Optional[Callable] = None
                    ) -> PMeanVariance:
    """The model's p(x_{t-1} | x_t) and its x_0 prediction. ``t`` indexes
    the (possibly respaced) ``schedule``; the model sees raw timesteps.
    ``denoised_fn`` maps the x_0 prediction before the clip to [-1, 1]."""
    check_types(mean_type, var_type)
    nd = x.dim()
    model_output = denoise_fn(x, schedule.map_timesteps(t))

    if var_type in (LEARNED, LEARNED_RANGE):
        if model_output.shape[-1] != 2 * x.shape[-1]:
            raise ValueError(f"a {var_type} variance needs 2 x {x.shape[-1]}"
                             f" output channels, got {model_output.shape}")
        model_output, model_var_values = torch.chunk(model_output, 2, -1)
        if var_type == LEARNED:
            log_variance = model_var_values
        else:
            min_log = extract(schedule, "posterior_log_variance_clipped", t,
                              nd)
            max_log = extract(schedule, "log_betas", t, nd)
            frac = (model_var_values + 1.0) / 2.0
            log_variance = frac * max_log + (1.0 - frac) * min_log
        variance = torch.exp(log_variance)
    elif var_type == FIXED_LARGE:
        variance = extract(schedule, "fixed_large_variance", t, nd)
        log_variance = extract(schedule, "fixed_large_log_variance", t, nd)
    else:
        variance = extract(schedule, "posterior_variance", t, nd)
        log_variance = extract(schedule, "posterior_log_variance_clipped", t,
                               nd)

    def process_xstart(v):
        if denoised_fn is not None:
            v = denoised_fn(v)
        return torch.clamp(v, -1.0, 1.0) if clip_denoised else v

    if mean_type == PREVIOUS_X:
        pred_xstart = process_xstart(
            predict_xstart_from_xprev(schedule, x, t, model_output))
        mean = model_output
    else:
        pred_xstart = process_xstart(
            model_output if mean_type == START_X
            else predict_xstart_from_eps(schedule, x, t, model_output))
        mean = q_posterior_mean(schedule, pred_xstart, x, t)
    return PMeanVariance(mean, variance, log_variance, pred_xstart,
                         model_output)


def vb_terms_bpd(denoise_fn: DenoiseFn, schedule: Schedule, x_start, x_t,
                 t, *, mean_type: str = START_X,
                 var_type: str = FIXED_LARGE, clip_denoised: bool = True
                 ) -> Dict[str, torch.Tensor]:
    """One term of the variational bound in bits per dim: the decoder's
    negative log-likelihood at t = 0, else KL(q(x_{t-1} | x_t, x_0) ||
    p(x_{t-1} | x_t)). Returns ``output`` (B,) and ``pred_xstart``."""
    true_mean, _, true_log_var = q_posterior_mean_variance(
        schedule, x_start, x_t, t)
    out = p_mean_variance(denoise_fn, schedule, x_t, t, mean_type=mean_type,
                          var_type=var_type, clip_denoised=clip_denoised)
    kl = mean_flat(normal_kl(true_mean, true_log_var, out.mean,
                             out.log_variance)) / math.log(2.0)
    decoder_nll = mean_flat(-discretized_gaussian_log_likelihood(
        x_start, means=out.mean, log_scales=0.5 * out.log_variance)
    ) / math.log(2.0)
    return {"output": torch.where(t == 0, decoder_nll, kl),
            "pred_xstart": out.pred_xstart}


def training_losses(denoise_fn: DenoiseFn, schedule: Schedule,
                    x_start: torch.Tensor, t: torch.Tensor,
                    generator: Optional[torch.Generator] = None, *,
                    mean_type: str = START_X, var_type: str = FIXED_LARGE,
                    loss_type: str = "mse",
                    noise: Optional[torch.Tensor] = None
                    ) -> Dict[str, torch.Tensor]:
    """Per-example diffusion training losses at timesteps ``t``, with x_t
    drawn from ``noise`` or from ``generator``.

    ``kl`` / ``rescaled_kl`` (times T): the variational bound term, keys
    ``loss`` and ``pred_xstart``. ``mse`` / ``rescaled_mse``: the mean
    squared error of the mean parameterisation's target (keys ``mse``,
    ``loss``); a learned variance adds the bound term ``vb`` (times T /
    1000 when rescaled), which sees the predicted mean detached, so that
    the bound trains the variance alone."""
    if loss_type not in LOSS_TYPES:
        raise NotImplementedError(f"unknown loss type {loss_type!r}: one of "
                                  f"{LOSS_TYPES}")
    check_types(mean_type, var_type)
    noise = draw_noise(x_start, generator, noise)
    x_t = q_sample(schedule, x_start, t, noise)

    if loss_type in ("kl", "rescaled_kl"):
        vb = vb_terms_bpd(denoise_fn, schedule, x_start, x_t, t,
                          mean_type=mean_type, var_type=var_type,
                          clip_denoised=False)
        loss = vb["output"]
        if loss_type == "rescaled_kl":
            loss = loss * schedule.num_timesteps
        return {"loss": loss, "pred_xstart": vb["pred_xstart"]}

    model_output = denoise_fn(x_t, schedule.map_timesteps(t))
    terms = {}
    if var_type in (LEARNED, LEARNED_RANGE):
        model_output, model_var_values = torch.chunk(model_output, 2, -1)
        frozen = torch.cat([model_output.detach(), model_var_values], -1)
        terms["vb"] = vb_terms_bpd(
            lambda *_: frozen, schedule, x_start, x_t, t,
            mean_type=mean_type, var_type=var_type,
            clip_denoised=False)["output"]
        if loss_type == "rescaled_mse":
            terms["vb"] = terms["vb"] * (schedule.num_timesteps / 1000.0)
    if mean_type == PREVIOUS_X:
        target = q_posterior_mean(schedule, x_start, x_t, t)
    else:
        target = x_start if mean_type == START_X else noise
    terms["mse"] = mean_flat((target - model_output) ** 2)
    terms["loss"] = terms["mse"] + terms.get("vb", 0.0)
    return terms


def prior_bpd(schedule: Schedule, x_start: torch.Tensor) -> torch.Tensor:
    """KL(q(x_T | x_0) || N(0, 1)) in bits per dim, (B,)."""
    t = torch.full((x_start.shape[0],), schedule.num_timesteps - 1,
                   dtype=torch.int64, device=x_start.device)
    mean, _, log_var = q_mean_variance(schedule, x_start, t)
    return mean_flat(normal_kl(mean, log_var, 0.0, 0.0)) / math.log(2.0)


def calc_bpd_loop(denoise_fn: DenoiseFn, schedule: Schedule,
                  x_start: torch.Tensor,
                  generator: Optional[torch.Generator] = None, *,
                  step_noise: Optional[StepNoise] = None,
                  mean_type: str = START_X, var_type: str = FIXED_LARGE,
                  clip_denoised: bool = True) -> Dict[str, torch.Tensor]:
    """Bits per dim over the whole chain: a Python loop from t = T - 1 down
    to 0 with no host synchronisation inside it. Step t's x_t is drawn
    from ``step_noise`` (by t) or ``generator``. Returns ``total_bpd`` and
    ``prior_bpd`` (B,), and ``vb``, ``xstart_mse``, ``mse`` (B, T), newest
    step first."""
    check_types(mean_type, var_type)
    rows = {"vb": [], "xstart_mse": [], "mse": []}
    for step in range(schedule.num_timesteps - 1, -1, -1):
        t = torch.full((x_start.shape[0],), step, dtype=torch.int64,
                       device=x_start.device)
        noise = step_draw(step_noise, step, x_start, generator)
        x_t = q_sample(schedule, x_start, t, noise)
        vb = vb_terms_bpd(denoise_fn, schedule, x_start, x_t, t,
                          mean_type=mean_type, var_type=var_type,
                          clip_denoised=clip_denoised)
        eps = predict_eps_from_xstart(schedule, x_t, t, vb["pred_xstart"])
        rows["vb"].append(vb["output"])
        rows["xstart_mse"].append(mean_flat((vb["pred_xstart"] - x_start)
                                            ** 2))
        rows["mse"].append(mean_flat((eps - noise) ** 2))
    out = {k: torch.stack(v, dim=1) for k, v in rows.items()}
    prior = prior_bpd(schedule, x_start)
    return {"total_bpd": out["vb"].sum(dim=1) + prior, "prior_bpd": prior,
            **out}
