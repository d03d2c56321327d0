"""PyTorch port, the whole diffusion core against the JAX package, with the
same numpy inputs and the JAX loops' own draws rebuilt with
``jax.random`` and injected: the cosine schedule and every table;
``normal_kl``, the discretized likelihood and the q distributions;
``p_mean_variance`` over the 3 x 4 parameterisations; ``vb_terms_bpd``;
``training_losses`` and its gradients through a parametric toy; the DDIM
(eta > 0), DDPM and reverse-DDIM steps and loops; ``calc_bpd_loop``; and
``DiffusionSegmenter.ddpm_sample`` / ``ddim_sample(eta=1)`` on a small
DiffUNet. The single-step math runs in float64 on both sides (float32
tanh and exp round otherwise on each side) and is held at 1e-5; the loops
keep the port's float32 state and are held at 1e-4 of the largest value;
the model at 1e-3 of max |y|, as the other model parity tests."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diff_unet_tpu.api import DiffusionSegmenter as JSeg
from diff_unet_tpu.diffusion import gaussian as jg
from diff_unet_tpu.diffusion import sampling as js
from diff_unet_tpu.diffusion import schedule as jsch
from diff_unet_tpu.models.diff_unet import DiffUNet as JModel
from diff_unet_tpu_torch.api import DiffusionSegmenter as TSeg
from diff_unet_tpu_torch.diffusion import gaussian as tg
from diff_unet_tpu_torch.diffusion import sampling as ts
from diff_unet_tpu_torch.diffusion import schedule as tsch
from diff_unet_tpu_torch.diffusion.schedule import extract
from diff_unet_tpu_torch.models.diff_unet import DiffUNet as TModel
from diff_unet_tpu_torch.utils.weights import load_jax_params
from tests.test_torch_port_diffusion import TABLES
from tests.test_torch_port_swin import random_flax_params
from tests.test_torch_port_swin import torch_threads  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
MEANS = (jg.START_X, jg.EPSILON, jg.PREVIOUS_X)
VARS = (jg.FIXED_LARGE, jg.FIXED_SMALL, jg.LEARNED, jg.LEARNED_RANGE)
NEW_TABLES = ("alphas_cumprod_next", "log_one_minus_alphas_cumprod",
              "posterior_log_variance_clipped")
SHAPE = (3, 4, 5, 6, 2)          # (B, D, H, W, C)


def both(name, steps=1000, respace=None):
    return (jsch.Schedule.create(name, steps, respace=respace),
            tsch.Schedule.create(name, steps, respace=respace))


def toy_params(c_out, seed=0, c_in=SHAPE[-1]):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((c_in, c_out)) * 0.7,
            rng.standard_normal(c_out) * 0.3)


def jtoy(w, b):
    """A parametric elementwise-in-space denoiser: tanh(x W + b + t/1000)
    (its output in [-1, 1], as a log-variance fraction must be)."""
    def fn(x, t):
        tt = t.reshape((-1,) + (1,) * (x.ndim - 1)).astype(x.dtype)
        return jnp.tanh(jnp.einsum("...c,cd->...d", x, w) + b + 1e-3 * tt)
    return fn


def ttoy(w, b):
    def fn(x, t):
        tt = t.reshape((-1,) + (1,) * (x.dim() - 1)).to(x.dtype)
        return torch.tanh(x @ w + b + 1e-3 * tt)
    return fn


def out_channels(var_type, c=SHAPE[-1]):
    return 2 * c if var_type in (jg.LEARNED, jg.LEARNED_RANGE) else c


def x_start_like(rng, shape=SHAPE):
    """Values in [-1, 1], half of them exactly +-1 (the labels' x_0), so
    the decoder likelihood takes all three of its branches."""
    x = rng.uniform(-1.0, 1.0, shape)
    edge = rng.random(shape) < 0.5
    return np.where(edge, np.sign(x), x)


def assert_close(got, want, rel, err_msg=""):
    """|got - want| <= rel * max |want|."""
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=err_msg)


@pytest.mark.parametrize("name,steps,respace", [
    ("cosine", 1000, None), ("cosine", 1000, [10]),
    ("cosine", 1000, "ddim50"), ("cosine", 100, "10,5,3"),
    ("linear", 1000, None), ("linear", 1000, [10])])
def test_schedule_tables_bit_for_bit(name, steps, respace):
    want, got = both(name, steps, respace)
    for table in TABLES + NEW_TABLES:
        np.testing.assert_array_equal(getattr(got, table),
                                      getattr(want, table), err_msg=table)
    np.testing.assert_array_equal(tsch.cosine_beta_schedule(steps),
                                  jsch.cosine_beta_schedule(steps))


@pytest.mark.parametrize("fn", ["normal_kl", "discretized_ll",
                                "q_posterior", "q_mean_variance",
                                "prior_bpd"])
def test_gaussian_math_matches(fn):
    """Float64 on both sides, at 1e-5."""
    rng = np.random.default_rng(1)
    a, b = (rng.standard_normal(SHAPE) for _ in range(2))
    la, lb = (rng.uniform(-3.0, 1.0, SHAPE) for _ in range(2))
    x0 = x_start_like(rng)
    t = np.array([0, 417, 999], np.int32)
    js_, ts_ = both("cosine")
    tt = torch.from_numpy(t).long()
    T = torch.from_numpy
    with jax.enable_x64(True):
        if fn == "normal_kl":
            pairs = [(tg.normal_kl(T(a), T(la), T(b), T(lb)),
                      jg.normal_kl(a, la, b, lb)),
                     (tg.normal_kl(T(a), T(la), 0.0, 0.0),
                      jg.normal_kl(a, la, 0.0, 0.0))]
        elif fn == "discretized_ll":
            means = x0 + 0.01 * rng.standard_normal(SHAPE)
            scales = rng.uniform(-6.0, -1.0, SHAPE)
            pairs = [(tg.discretized_gaussian_log_likelihood(
                T(x0), means=T(means), log_scales=T(scales)),
                jg.discretized_gaussian_log_likelihood(
                    x0, means=means, log_scales=scales))]
        elif fn == "q_posterior":
            pairs = list(zip(
                tg.q_posterior_mean_variance(ts_, T(x0), T(a), tt),
                jg.q_posterior_mean_variance(js_, x0, a, t)))
        elif fn == "q_mean_variance":
            pairs = list(zip(tg.q_mean_variance(ts_, T(x0), tt),
                             jg.q_mean_variance(js_, x0, t)))
        else:
            pairs = [(tg.prior_bpd(ts_, T(x0)), jg.prior_bpd(js_, x0))]
        for i, (got, want) in enumerate(pairs):
            np.testing.assert_allclose(
                got.numpy(), np.broadcast_to(np.asarray(want), got.shape),
                **TOL, err_msg=f"{fn} output {i}")


@pytest.mark.parametrize("var_type", VARS)
@pytest.mark.parametrize("mean_type", MEANS)
def test_p_mean_variance_matches(mean_type, var_type):
    """Every parameterisation, with and without the clip and a
    ``denoised_fn``, float64 at 1e-5."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal(SHAPE)
    t = np.array([0, 4, 9], np.int32)
    w, b = toy_params(out_channels(var_type))
    js_, ts_ = both("linear", respace=[10])
    with jax.enable_x64(True):
        for clip in (True, False):
            for denoised in (None, lambda v: 0.5 * v + 0.1):
                want = jg.p_mean_variance(
                    jtoy(w, b), js_, x, t, mean_type=mean_type,
                    var_type=var_type, clip_denoised=clip,
                    denoised_fn=denoised)
                got = tg.p_mean_variance(
                    ttoy(torch.from_numpy(w), torch.from_numpy(b)), ts_,
                    torch.from_numpy(x), torch.from_numpy(t).long(),
                    mean_type=mean_type, var_type=var_type,
                    clip_denoised=clip, denoised_fn=denoised)
                for f in want._fields:
                    g = getattr(got, f)
                    np.testing.assert_allclose(
                        g.numpy(), np.broadcast_to(np.asarray(
                            getattr(want, f)), g.shape), **TOL,
                        err_msg=f"{f}, clip {clip}, denoised_fn "
                                f"{denoised is not None}")


@pytest.mark.parametrize("var_type", [jg.FIXED_LARGE, jg.LEARNED_RANGE])
@pytest.mark.parametrize("mean_type", MEANS)
def test_vb_terms_bpd_matches(mean_type, var_type):
    """t = 0 (the decoder NLL) and t > 0 (the KL) in one batch."""
    rng = np.random.default_rng(3)
    x0 = x_start_like(rng)
    xt = rng.standard_normal(SHAPE)
    t = np.array([0, 1, 63], np.int32)
    w, b = toy_params(out_channels(var_type), seed=1)
    js_, ts_ = both("cosine", 100)
    with jax.enable_x64(True):
        want = jg.vb_terms_bpd(jtoy(w, b), js_, x0, xt, t,
                               mean_type=mean_type, var_type=var_type)
        got = tg.vb_terms_bpd(
            ttoy(torch.from_numpy(w), torch.from_numpy(b)), ts_,
            torch.from_numpy(x0), torch.from_numpy(xt),
            torch.from_numpy(t).long(), mean_type=mean_type,
            var_type=var_type)
    for k in ("output", "pred_xstart"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **TOL, err_msg=k)


@pytest.mark.parametrize("mean_type", MEANS)
@pytest.mark.parametrize("var_type", [jg.FIXED_LARGE, jg.LEARNED_RANGE])
@pytest.mark.parametrize("loss_type", tg.LOSS_TYPES)
def test_training_losses_and_gradients_match(loss_type, var_type,
                                             mean_type):
    """The terms and the toy's parameter gradients of their sum against
    ``jax.value_and_grad`` (float64, 1e-5 of the largest): a learned
    variance's VLB sees the mean through ``.detach()`` where JAX has
    ``stop_gradient``, else the mse gradients would differ. T = 100, so
    the rescaled losses' factors (T, T / 1000) are not 1."""
    rng = np.random.default_rng(4)
    x0 = x_start_like(rng)
    noise = rng.standard_normal(SHAPE)
    t = np.array([0, 37, 99], np.int32)
    w, b = toy_params(out_channels(var_type), seed=2)
    js_, ts_ = both("cosine", 100)
    with jax.enable_x64(True):
        def jterms(params):
            return jg.training_losses(
                jtoy(*params), js_, x0, t, None, mean_type=mean_type,
                var_type=var_type, loss_type=loss_type, noise=noise)
        want = jterms((w, b))
        jgrads = jax.grad(lambda p: jnp.sum(jterms(p)["loss"]))((w, b))
    tw, tb = (torch.tensor(a, requires_grad=True) for a in (w, b))
    got = tg.training_losses(ttoy(tw, tb), ts_, torch.from_numpy(x0),
                             torch.from_numpy(t).long(),
                             mean_type=mean_type, var_type=var_type,
                             loss_type=loss_type,
                             noise=torch.from_numpy(noise))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), **TOL, err_msg=k)
    got["loss"].sum().backward()
    for g, jgr, name in zip((tw.grad, tb.grad), jgrads, ("w", "b")):
        assert_close(g, jgr, 1e-5, err_msg=f"d loss / d {name}")


def jax_normal(key, shape, dtype=jnp.float32):
    return np.array(jax.random.normal(key, shape, dtype))


@pytest.mark.parametrize("kind", ["ddim_eta0.5", "ddpm"])
@pytest.mark.parametrize("var_type", [jg.FIXED_LARGE, jg.LEARNED_RANGE])
def test_stochastic_step_matches_with_the_jax_draw(kind, var_type):
    """One DDIM step at eta 0.5 or one ancestral step, with t = 0 in the
    batch (no noise added there), the JAX step's own draw injected;
    float64 at 1e-5."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal(SHAPE)
    t = np.array([0, 5, 9], np.int32)
    w, b = toy_params(out_channels(var_type), seed=3)
    js_, ts_ = both("linear", respace=[10])
    key = jax.random.key(7)
    kw = dict(var_type=var_type)
    with jax.enable_x64(True):
        draw = jax_normal(key, SHAPE, jnp.float64)
        if kind == "ddpm":
            want, _ = js.p_sample_step(jtoy(w, b), js_, x, t, key, **kw)
        else:
            want, _ = js.ddim_step(jtoy(w, b), js_, x, t, key, eta=0.5,
                                   **kw)
    fn = ttoy(torch.from_numpy(w), torch.from_numpy(b))
    args = (fn, ts_, torch.from_numpy(x), torch.from_numpy(t).long(),
            torch.from_numpy(draw))
    got, _ = (ts.p_sample_step(*args, **kw) if kind == "ddpm"
              else ts.ddim_step(*args, eta=0.5, **kw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def loop_draws(key, shape, steps):
    """The JAX sample loop's x_T and step draws: x_T from split(key)[1],
    step t from fold_in(split(key)[0], t)."""
    rest, init = jax.random.split(key)
    return (jax_normal(init, shape),
            [jax_normal(jax.random.fold_in(rest, s), shape)
             for s in range(steps)])


@pytest.mark.parametrize("loop", ["p_sample_loop", "ddim_eta1",
                                  "ddim_eta1_learned"])
def test_sample_loops_match_with_the_jax_draws(loop):
    """Ten respaced steps of DDPM or DDIM at eta 1 from the JAX loop's own
    x_T and step draws (float32 state on both sides): sample and
    pred_xstart sum at 1e-4 of the largest value; step noise given as a
    sequence and as a callable."""
    var_type = jg.LEARNED_RANGE if loop.endswith("learned") else \
        jg.FIXED_LARGE
    w, b = toy_params(out_channels(var_type), seed=4)
    js_, ts_ = both("linear", respace=[10])
    shape = (2, 6, 5, 4, SHAPE[-1])
    key = jax.random.key(11)
    x_t, draws = loop_draws(key, shape, 10)
    jfn = jtoy(w.astype(np.float32), b.astype(np.float32))
    tfn = ttoy(torch.from_numpy(w).float(), torch.from_numpy(b).float())
    step_noise = [torch.from_numpy(d) for d in draws]
    if loop == "p_sample_loop":
        want = js.p_sample_loop(jfn, js_, shape, key, var_type=var_type)
        got = ts.p_sample_loop(tfn, ts_, torch.from_numpy(x_t),
                               step_noise=step_noise, var_type=var_type)
    else:
        want = js.ddim_sample_loop(jfn, js_, shape, key,
                                   noise=jnp.asarray(x_t), eta=1.0,
                                   var_type=var_type)
        got = ts.ddim_sample_loop(tfn, ts_, torch.from_numpy(x_t), eta=1.0,
                                  step_noise=step_noise.__getitem__,
                                  var_type=var_type)
    for f in ("sample", "pred_xstart", "pred_xstart_sum"):
        assert_close(getattr(got, f), getattr(want, f), 1e-4, err_msg=f)
    assert torch.equal(got.pred_xstart, got.sample)


@pytest.mark.parametrize("mean_type,var_type", [
    (jg.START_X, jg.FIXED_LARGE), (jg.EPSILON, jg.LEARNED_RANGE)])
def test_calc_bpd_loop_matches_with_the_jax_draws(mean_type, var_type):
    """The whole chain of a T = 100 schedule, step t's noise from
    fold_in(key, t) as in the JAX scan: every key at 1e-4 of its largest
    value, (B, T) newest first."""
    rng = np.random.default_rng(6)
    x0 = x_start_like(rng, (2, 4, 3, 5, 2)).astype(np.float32)
    w, b = toy_params(out_channels(var_type), seed=5)
    js_, ts_ = both("linear", 100)
    key = jax.random.key(13)
    want = jg.calc_bpd_loop(
        jtoy(w.astype(np.float32), b.astype(np.float32)), js_, x0, key,
        mean_type=mean_type, var_type=var_type)
    got = tg.calc_bpd_loop(
        ttoy(torch.from_numpy(w).float(), torch.from_numpy(b).float()), ts_,
        torch.from_numpy(x0),
        step_noise=lambda s: torch.from_numpy(jax_normal(
            jax.random.fold_in(key, s), x0.shape)),
        mean_type=mean_type, var_type=var_type)
    assert list(got) == list(want)
    assert got["vb"].shape == (2, 100)
    for k in want:
        assert_close(got[k], want[k], 1e-4, err_msg=k)


@pytest.mark.parametrize("mean_type", [jg.START_X, jg.EPSILON])
def test_ddim_reverse_sample_loop_matches(mean_type):
    rng = np.random.default_rng(7)
    x0 = x_start_like(rng).astype(np.float32)
    w, b = toy_params(SHAPE[-1], seed=6)
    js_, ts_ = both("cosine", respace=[10])
    want = js.ddim_reverse_sample_loop(
        jtoy(w.astype(np.float32), b.astype(np.float32)), js_,
        jnp.asarray(x0), mean_type=mean_type)
    got = ts.ddim_reverse_sample_loop(
        ttoy(torch.from_numpy(w).float(), torch.from_numpy(b).float()), ts_,
        torch.from_numpy(x0), mean_type=mean_type)
    assert_close(got, want, 1e-4)


# ---- DiffusionSegmenter on a small DiffUNet ----

FEATURES = (8, 8, 16, 32, 64, 8)
S, C = 16, 3


@pytest.fixture(scope="module")
def unet():
    rng = np.random.default_rng(8)
    image = rng.standard_normal((2, S, S, S, 1)).astype(np.float32)
    x = rng.standard_normal((2, S, S, S, C)).astype(np.float32)
    t = np.array([3, 640], np.int32)
    jm = JModel(out_channels=C, features=FEATURES)
    params = random_flax_params(jm, image, x, t, seed=1)
    tm = load_jax_params(TModel(C, features=FEATURES), params).eval()
    return jm, params, tm, image


def packed_state_factor(w, c):
    """The W-folding factor of the JAX ``ddim_sample``'s loop state
    (``api.py``, unpacked model): its step draws are made in that packed
    layout, a row-major reshape of the unpacked one."""
    fs = 1
    while w % (fs * 2) == 0 and fs * 2 * c <= 128:
        fs *= 2
    return fs


@pytest.mark.parametrize("process,rel", [
    (dict(), 1e-3),
    (dict(schedule_name="cosine", var_type=jg.FIXED_SMALL), 1e-3),
    (dict(mean_type=jg.EPSILON, var_type=jg.FIXED_SMALL), 1e-3),
    (dict(schedule_name="cosine", mean_type=jg.EPSILON), 2e-3)],
    ids=["default", "cosine", "epsilon", "cosine_epsilon"])
def test_segmenter_ddpm_and_stochastic_ddim_match_jax(unet, process, rel):
    """``ddpm_sample`` (each process) and ``ddim_sample(eta=1.0,
    return_all=True)`` (the default process) against the JAX segmenter
    with its own draws rebuilt and injected (JAX float32: its loops fix
    the state's dtype), at 1e-3 of max |y|. Cosine with EPSILON is held at
    2e-3: the cosine schedule's last alpha_bar is 2.4e-9, so the first
    step's x_0 from the predicted eps multiplies either side's float32
    rounding by sqrt(1 / alpha_bar) = 2e4 before the clip, and a voxel
    whose x_0 lands near +-1 differs (1.39e-3 of max |y| at one voxel of
    this input; linear with EPSILON and cosine with START_X agree to 6e-5
    and 2e-6)."""
    jm, params, tm, image = unet
    jseg = JSeg(jm, C, **process)
    tseg = TSeg(tm, C, **process)
    assert tseg.train_schedule.betas.tolist() == \
        jseg.train_schedule.betas.tolist()
    shape = (2, S, S, S, C)
    key = jax.random.key(17)
    x_t, draws = loop_draws(key, shape, 10)
    want = jax.jit(lambda p, im: jseg.ddpm_sample(p, im, key))(params,
                                                               image)
    with torch.no_grad():
        got = tseg.ddpm_sample(torch.from_numpy(image),
                               noise=torch.from_numpy(x_t),
                               step_noise=[torch.from_numpy(d)
                                           for d in draws])
    for f in ("sample", "pred_xstart_sum"):
        assert_close(getattr(got, f), getattr(want, f), rel,
                     err_msg=f"ddpm {f}")
    if process:
        return          # the processes share the loop code: one DDIM case

    fs = packed_state_factor(S, C)
    packed = (2, S, S, S // fs, C * fs)
    rest, _ = jax.random.split(key)
    draws = [jax_normal(jax.random.fold_in(rest, s), packed).reshape(shape)
             for s in range(10)]
    want = jax.jit(lambda p, im, nz: jseg.ddim_sample(
        p, im, key, noise=nz, eta=1.0, return_all=True))(params, image, x_t)
    with torch.no_grad():
        got = tseg.ddim_sample(torch.from_numpy(image),
                               noise=torch.from_numpy(x_t), eta=1.0,
                               step_noise=[torch.from_numpy(d)
                                           for d in draws],
                               return_all=True)
    for f in ("sample", "pred_xstart", "pred_xstart_sum"):
        assert_close(getattr(got, f), getattr(want, f), rel,
                     err_msg=f"ddim eta 1 {f}")


def parent_ddim_sample(seg, image: torch.Tensor,
                       noise: torch.Tensor) -> torch.Tensor:
    """DDIM-10 at eta 0 as ``DiffusionSegmenter.ddim_sample`` computed it
    before the stochastic samplers came (START_X, FIXED_LARGE): the
    reference that the main path must still equal bit for bit. The smoke
    script keeps the same loop for its full-width check on the card."""
    sched = seg.sample_schedule
    embeddings = seg.module.embed(image)
    x = noise.float()
    accum = torch.zeros_like(x)
    for step in range(sched.num_timesteps - 1, -1, -1):
        t = torch.full((x.shape[0],), step, dtype=torch.int64,
                       device=x.device)
        nd = x.dim()
        pred = torch.clamp(seg.module.denoise_with_embeddings(
            x, sched.map_timesteps(t), embeddings, image), -1.0, 1.0)
        eps = ((extract(sched, "sqrt_recip_alphas_cumprod", t, nd) * x
                - pred) / extract(sched, "sqrt_recipm1_alphas_cumprod", t,
                                  nd))
        abp = extract(sched, "alphas_cumprod_prev", t, nd)
        x = pred * torch.sqrt(abp) + torch.sqrt(1.0 - abp) * eps
        accum = accum + pred
    return accum


def test_ddim_sample_at_eta_0_keeps_its_bits(unet):
    """The main path's DDIM-10 at eta 0 gives the old loop's bits
    (``parent_ddim_sample``, which the smoke script's phase 11b also holds
    at full width on the card)."""
    _, _, tm, image = unet
    noise = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, S, S, S, C)).astype(np.float32))
    seg = TSeg(tm, C)
    with torch.no_grad():
        want = parent_ddim_sample(seg, torch.from_numpy(image), noise)
        got = seg.ddim_sample(torch.from_numpy(image), noise=noise)
        out = seg.ddim_sample(torch.from_numpy(image), noise=noise,
                              eta=0.0, return_all=True)
    assert torch.equal(got, want)
    assert torch.equal(out.pred_xstart_sum, want)


STOCHASTIC_CALLS = ("ddim_step", "p_sample_step", "ddim_sample_loop",
                    "p_sample_loop", "p_sample_loop_x_T", "training_losses",
                    "calc_bpd_loop", "ddpm_sample", "ddim_sample")


@pytest.mark.parametrize("call", STOCHASTIC_CALLS)
def test_stochastic_call_without_draws_raises(unet, call):
    """No generator and no noise: a stochastic call raises (the toy ones
    before the model runs); none falls back to eta 0 or to another
    device."""
    _, _, tm, image = unet
    seg = TSeg(tm, C)
    ts_ = tsch.Schedule.create("linear", 1000, respace=[10])

    def never(x, t):
        raise AssertionError("the model ran")

    x = torch.zeros(SHAPE)
    t = torch.tensor([0, 1, 2])
    im = torch.from_numpy(image)
    calls = {
        "ddim_step": lambda: ts.ddim_step(never, ts_, x, t, eta=0.5),
        "p_sample_step": lambda: ts.p_sample_step(never, ts_, x, t),
        "ddim_sample_loop": lambda: ts.ddim_sample_loop(never, ts_, x,
                                                        eta=1.0),
        "p_sample_loop": lambda: ts.p_sample_loop(never, ts_, x),
        "p_sample_loop_x_T": lambda: ts.p_sample_loop(
            never, ts_, shape=SHAPE, step_noise=[x] * 10),
        "training_losses": lambda: tg.training_losses(never, ts_, x, t),
        "calc_bpd_loop": lambda: tg.calc_bpd_loop(never, ts_, x),
        "ddpm_sample": lambda: seg.ddpm_sample(im),
        "ddim_sample": lambda: seg.ddim_sample(
            im, noise=torch.zeros(2, S, S, S, C), eta=1.0),
    }
    with torch.no_grad(), pytest.raises(ValueError, match="Generator"):
        calls[call]()
