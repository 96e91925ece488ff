"""Port parity: the continuous-time solvers (xtts_tpu_torch/diffusion/
solvers.py) and the samplers built on them (gaussian.py `unipc`,
`solver_sample_loop`, the ten-name `sample_loop`) against the JAX package's
on the CPU.

Solver cases run the analytic linear eps model of tests/test_solvers.py
(copied here: that file loads the reference checkout when it is collected)
over its option matrix, from one numpy x_T; tolerance rtol / atol 1e-4
(f32 chains of 6-13 linear updates; the samples reach |x| ~ 700, where
the two frameworks' f32 sums differ by a few 1e-4 absolute, 1e-6 relative).
The render cases run the tiny AA-diffusion of tests/test_torch_port_e2e.py
from a shared x_T, within 1e-3 (its render tolerance)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xtts_tpu.diffusion import gaussian as jg, solvers as js  # noqa: E402
from xtts_tpu.infer import api as japi  # noqa: E402
from xtts_tpu_torch.diffusion import gaussian as tg  # noqa: E402
from xtts_tpu_torch.diffusion import solvers as ts  # noqa: E402
from xtts_tpu_torch.infer import api as tapi  # noqa: E402
from test_torch_port_e2e import (MB, TINY, inputs, one_torch_thread,  # noqa: E402,F401
                                 pair)

B, C, T = 2, 3, 8
SHAPE = (B, C, T)
BETAS = np.linspace(1e-4, 0.02, 1000)
RNG = np.random.default_rng(0)
CVEC = RNG.standard_normal(SHAPE).astype(np.float32)
X_T = RNG.standard_normal(SHAPE).astype(np.float32)
TOL = dict(rtol=1e-4, atol=1e-4)
RENDER_TOL = dict(rtol=1e-3, atol=1e-3)


def jax_eps(x, t_input):
    """Analytic eps model, linear in x; t is model-input time."""
    a = 0.4 * jnp.cos(t_input / 300.0).reshape(-1, 1, 1)
    b = 0.2 * jnp.sin(t_input / 200.0).reshape(-1, 1, 1)
    return a * x + b * jnp.asarray(CVEC)


def torch_eps(x, t_input):
    a = 0.4 * torch.cos(t_input / 300.0).reshape(-1, 1, 1)
    b = 0.2 * torch.sin(t_input / 200.0).reshape(-1, 1, 1)
    return a * x + b * torch.from_numpy(CVEC)


def make_ns(schedule="discrete"):
    if schedule == "discrete":
        return (js.NoiseScheduleVP("discrete", betas=BETAS),
                ts.NoiseScheduleVP("discrete", betas=BETAS))
    kw = dict(continuous_beta_0=0.025, continuous_beta_1=5.0)
    return (js.NoiseScheduleVP("linear", **kw),
            ts.NoiseScheduleVP("linear", **kw))


def dpm_pair(schedule="discrete", **kw):
    jns, tns = make_ns(schedule)
    want = np.asarray(js.sample_dpm_solver(jax_eps, jns, jnp.asarray(X_T),
                                           **kw))
    got = ts.sample_dpm_solver(torch_eps, tns, torch.from_numpy(X_T),
                               **kw).numpy()
    return got, want


@pytest.mark.parametrize("alg", ["dpmsolver++", "dpmsolver"])
@pytest.mark.parametrize("stype", ["dpmsolver", "taylor"])
@pytest.mark.parametrize("order,steps", [(1, 6), (2, 8), (3, 8), (2, 12),
                                         (3, 13)])
def test_dpm_multistep(alg, stype, order, steps):
    got, want = dpm_pair(steps=steps, order=order, method="multistep",
                         algorithm_type=alg, solver_type=stype)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("alg", ["dpmsolver++", "dpmsolver"])
@pytest.mark.parametrize("stype", ["dpmsolver", "taylor"])
@pytest.mark.parametrize("order,steps,method", [
    (2, 7, "singlestep"), (3, 8, "singlestep"), (2, 8, "singlestep_fixed"),
    (3, 9, "singlestep_fixed"), (1, 5, "singlestep")])
def test_dpm_singlestep(alg, stype, order, steps, method):
    got, want = dpm_pair(steps=steps, order=order, method=method,
                         algorithm_type=alg, solver_type=stype)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("skip", ["logSNR", "time_quadratic",
                                  "time_uniform"])
@pytest.mark.parametrize("method", ["multistep", "singlestep"])
def test_dpm_skip_types(skip, method):
    got, want = dpm_pair(steps=10, order=2, method=method, skip_type=skip)
    np.testing.assert_allclose(got, want, **TOL)


def test_dpm_continuous_schedule():
    got, want = dpm_pair("linear", steps=10, order=2, method="multistep")
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("method", ["multistep", "singlestep"])
def test_dpm_denoise_to_zero_and_thresholding(method):
    got, want = dpm_pair(steps=8, order=2, method=method,
                         denoise_to_zero=True,
                         correcting_x0_fn="dynamic_thresholding")
    np.testing.assert_allclose(got, want, **TOL)


def test_dynamic_thresholding():
    x0 = RNG.standard_normal((2, 4, 16)).astype(np.float32) * 3.0
    np.testing.assert_allclose(
        ts.dynamic_thresholding(torch.from_numpy(x0)).numpy(),
        np.asarray(js.dynamic_thresholding(jnp.asarray(x0))), rtol=1e-5,
        atol=1e-6)


@pytest.mark.parametrize("variant", ["bh1", "bh2", "vary_coeff"])
@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("predict_x0", [True, False])
def test_unipc(variant, order, predict_x0):
    jns, tns = make_ns()
    kw = dict(steps=max(order, 8), order=order, variant=variant,
              predict_x0=predict_x0)
    want = np.asarray(js.sample_unipc(jax_eps, jns, jnp.asarray(X_T), **kw))
    got = ts.sample_unipc(torch_eps, tns, torch.from_numpy(X_T), **kw)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("skip", ["logSNR", "time_quadratic"])
def test_unipc_skip_types_thresholding_and_denoise_to_zero(skip):
    jns, tns = make_ns()
    kw = dict(steps=8, order=2, variant="bh2", skip_type=skip,
              denoise_to_zero=True, correcting_x0_fn="dynamic_thresholding")
    want = np.asarray(js.sample_unipc(jax_eps, jns, jnp.asarray(X_T), **kw))
    got = ts.sample_unipc(torch_eps, tns, torch.from_numpy(X_T), **kw)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_host_coefficients_identical():
    """The copied float64 host code gives JAX's grids and coefficients to
    the bit (same numpy expressions)."""
    jns, tns = make_ns()
    ts_j = js.get_time_steps(jns, "logSNR", 1.0, 1e-3, 12)
    ts_t = ts.get_time_steps(tns, "logSNR", 1.0, 1e-3, 12)
    np.testing.assert_array_equal(ts_t, ts_j)
    for p in (1, 2, 3):
        prev = [ts_j[3 - k] for k in range(p)]
        np.testing.assert_array_equal(
            ts._dpm_ms_coeffs(tns, "dpmsolver++", "taylor", p, ts_j[4],
                              prev)[1],
            js._dpm_ms_coeffs(jns, "dpmsolver++", "taylor", p, ts_j[4],
                              prev)[1])
        for v in ("bh1", "bh2", "vary_coeff"):
            for a, b in zip(ts._unipc_coeffs(tns, v, True, p, ts_j[4], prev),
                            js._unipc_coeffs(jns, v, True, p, ts_j[4], prev)):
                np.testing.assert_array_equal(a, b)
    for steps in range(3, 17):
        for order in (1, 2, 3):
            assert (ts._singlestep_orders(steps, order)
                    == js._singlestep_orders(steps, order))


def test_wrap_guidance_and_cfg_mix():
    """wrap_guidance's u + s (c - u) through a multistep run, and the
    solver path's paired-call CFG mix in gaussian.solver_sample_loop."""
    jns, tns = make_ns()
    jg_fn = js.wrap_guidance(jax_eps, lambda x, t: 0.5 * jax_eps(x, t) + 0.1,
                             2.0)
    tg_fn = ts.wrap_guidance(torch_eps,
                             lambda x, t: 0.5 * torch_eps(x, t) + 0.1, 2.0)
    want = np.asarray(js.sample_dpm_solver(jg_fn, jns, jnp.asarray(X_T),
                                           steps=8, order=2))
    got = ts.sample_dpm_solver(tg_fn, tns, torch.from_numpy(X_T), steps=8,
                               order=2).numpy()
    np.testing.assert_allclose(got, want, **TOL)

    # the paired (cond, uncond) model outputs [eps ; var] of the samplers
    def jpair(x, t):
        e = jax_eps(x, t.astype(jnp.float32))
        return (jnp.concatenate([e, e], axis=1),
                jnp.concatenate([0.5 * e + 0.1, e], axis=1))

    def tpair(x, t):
        e = torch_eps(x, t.float())
        return torch.cat([e, e], dim=1), torch.cat([0.5 * e + 0.1, e], dim=1)

    jgd = jg.GaussianDiffusion.spaced(1000, 6, conditioning_free=True,
                                      conditioning_free_k=2.0)
    tgd = tg.GaussianDiffusion.spaced(1000, 6, conditioning_free_k=2.0)
    np.testing.assert_array_equal(tgd.base_betas, jgd.base_betas)
    for name in ("dpm++2m_solver", "unipc_bh2", "unipc"):
        want = np.asarray(jgd.sample_loop(jpair, SHAPE, jax.random.PRNGKey(0),
                                          noise=jnp.asarray(X_T),
                                          sampler=name))
        got = tgd.sample_loop(tpair, SHAPE, noise=torch.from_numpy(X_T),
                              sampler=name).numpy()
        np.testing.assert_allclose(got, want, **TOL, err_msg=name)


def test_unknown_sampler_raises_keyerror():
    gd = tg.GaussianDiffusion.spaced(1000, 4)
    with pytest.raises(KeyError):
        gd.sample_loop(lambda x, t: x, (1, 2, 4), noise=torch.zeros(1, 2, 4),
                       sampler="euler")


@pytest.mark.parametrize("sampler", ["unipc", "dpm++3m", "unipc_vary"])
def test_tiny_render(pair, inputs, sampler):
    """The tiny AA-diffusion render (latent -> 4-step sampler with CFG ->
    Vocos) from shared codes and x_T, through `unipc` (the spaced
    predictor-corrector), one DPM-Solver and one UniPC solver name: wav
    within 1e-3 of JAX's. The model calls are counted and equal the
    sampler's (gaussian.model_calls)."""
    jtts, ttts, _ = pair
    wav, text = inputs
    cond = np.array(jtts.cond_mel_from_wav(wav))
    n, n_b = 50, 64
    codes = np.full((1, n_b), TINY.gpt.stop_mel_token, np.int32)
    codes[0, :n] = np.random.default_rng(2).integers(0, 198, n)
    lens = np.array([n], np.int32)
    key = jax.random.PRNGKey(3)
    xt = np.array(jax.random.normal(jax.random.split(key)[1],
                                    (1, MB, 4 * n_b)))
    want = np.asarray(jtts._render_full_jit(
        jtts.vars["gpt"], jtts.vars["diffusion"], jtts.vars["vocos"],
        jnp.asarray(cond), japi.normalize_tacotron_mel(jnp.asarray(cond)),
        jnp.asarray(text), jnp.array([16]), jnp.asarray(codes),
        jnp.asarray(lens) * 1024, key, 1.0, steps=4, sampler=sampler,
        cond_free_k=2.0))
    calls = []
    denoise = ttts.diffusion.denoise

    def counted(*a, **k):
        calls.append(1)
        return denoise(*a, **k)

    ttts.diffusion.denoise = counted
    try:
        got = ttts._render(torch.from_numpy(cond),
                           torch.from_numpy(text).long(),
                           torch.from_numpy(codes).long(),
                           torch.from_numpy(lens).long(), None,
                           tapi.TTSSettings(sampler=sampler,
                                            diffusion_steps=4),
                           noise=torch.from_numpy(xt)).numpy()
    finally:
        del ttts.diffusion.denoise
    assert len(calls) == tg.model_calls(sampler, 4)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **RENDER_TOL)
