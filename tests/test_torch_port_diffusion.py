"""PyTorch port, diffusion core: schedule tables, DDIM step and the DDIM-10
loop against the JAX package, with the same numpy inputs and noise."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from diff_unet_tpu.diffusion import gaussian as jg
from diff_unet_tpu.diffusion import sampling as js
from diff_unet_tpu.diffusion import schedule as jsch
from diff_unet_tpu_torch.diffusion import gaussian as tg
from diff_unet_tpu_torch.diffusion import sampling as ts
from diff_unet_tpu_torch.diffusion import schedule as tsch
from tests.test_torch_port_swin import torch_threads  # noqa: F401

TABLES = ("betas", "alphas_cumprod", "alphas_cumprod_prev",
          "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
          "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
          "posterior_variance", "posterior_mean_coef1",
          "posterior_mean_coef2", "fixed_large_variance",
          "fixed_large_log_variance", "timestep_map")


@pytest.mark.parametrize("respace", [None, [10], "ddim25", "10,5,3"])
def test_schedule_tables_match(respace):
    want = jsch.Schedule.create("linear", 1000, respace=respace)
    got = tsch.Schedule.create("linear", 1000, respace=respace)
    for name in TABLES:
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)


def test_space_timesteps_and_unknown_options():
    """space_timesteps as in JAX; an unknown schedule name, mean type or
    variance type raises, as JAX's do (the model is never called)."""
    for counts in ([10], [3, 7], "ddim50", "2,4,6"):
        assert tsch.space_timesteps(1000, counts) == \
            jsch.space_timesteps(1000, counts)
    with pytest.raises(NotImplementedError, match="quadratic"):
        tsch.Schedule.create("quadratic", 1000)
    s = tsch.Schedule.create("linear", 1000, respace=[10])
    x = torch.zeros(1, 2)

    def never(a, b):
        raise AssertionError("the model ran")

    for kw in (dict(mean_type="score"), dict(var_type="fixed_medium")):
        with pytest.raises(NotImplementedError, match=next(iter(
                kw.values()))):
            tg.p_mean_variance(never, s, x, torch.zeros(1).long(), **kw)


def _jax_fn(x, t):
    return jnp.tanh(1.7 * x + 0.002 * t.reshape((-1,) + (1,) * (x.ndim - 1)))


def _torch_fn(x, t):
    return torch.tanh(1.7 * x + 0.002 * t.reshape((-1,) + (1,) * (x.dim() - 1)))


def test_q_sample_and_ddim_step_match():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 4, 5, 6, 2)).astype(np.float32)
    noise = rng.standard_normal(x.shape).astype(np.float32)
    t = np.array([0, 4, 9], np.int32)
    js_ = jsch.Schedule.create("linear", 1000, respace=[10])
    ts_ = tsch.Schedule.create("linear", 1000, respace=[10])
    tt = torch.from_numpy(t).long()
    np.testing.assert_allclose(
        tg.q_sample(ts_, torch.from_numpy(x), tt,
                    torch.from_numpy(noise)).numpy(),
        np.asarray(jg.q_sample(js_, x, t, noise)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tg.predict_xstart_from_eps(ts_, torch.from_numpy(x), tt,
                                   torch.from_numpy(noise)).numpy(),
        np.asarray(jg.predict_xstart_from_eps(js_, x, t, noise)),
        rtol=1e-5, atol=1e-4)
    want, wout = js.ddim_step(_jax_fn, js_, jnp.asarray(x), jnp.asarray(t))
    got, tout = ts.ddim_step(_torch_fn, ts_, torch.from_numpy(x),
                             torch.from_numpy(t).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    for f in ("mean", "variance", "log_variance", "pred_xstart"):
        np.testing.assert_allclose(getattr(tout, f).numpy(),
                                   np.asarray(getattr(wout, f)),
                                   rtol=1e-4, atol=1e-4, err_msg=f)


def test_ddim_sample_loop_matches_with_injected_noise():
    """DDIM-10 from the same x_T: the per-step pred_xstart sum at 1e-3
    (ten clipped steps summed), and the final sample reported as
    pred_xstart as in the JAX loop."""
    import jax

    rng = np.random.default_rng(1)
    noise = rng.standard_normal((2, 6, 5, 4, 3)).astype(np.float32)
    js_ = jsch.Schedule.create("linear", 1000, respace=[10])
    ts_ = tsch.Schedule.create("linear", 1000, respace=[10])
    want = js.ddim_sample_loop(_jax_fn, js_, noise.shape, jax.random.key(0),
                               noise=jnp.asarray(noise))
    got = ts.ddim_sample_loop(_torch_fn, ts_, torch.from_numpy(noise))
    np.testing.assert_allclose(got.pred_xstart_sum.numpy(),
                               np.asarray(want.pred_xstart_sum),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got.sample.numpy(), np.asarray(want.sample),
                               rtol=1e-4, atol=1e-4)
    assert torch.equal(got.pred_xstart, got.sample)
