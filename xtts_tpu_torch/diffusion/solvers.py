"""Diffusion-ODE solvers: DPM-Solver / DPM-Solver++ orders 1-3
(singlestep, multistep), UniPC (bh1 / bh2 / vary_coeff), dynamic
thresholding (port of xtts_tpu/diffusion/solvers.py).

The host half is the JAX module's float64 numpy code, copied: the time
grids, lambdas, per-step update coefficients and the UniPC Vandermonde
solves are fixed once the grid is, and every exponential-integrator update
is a linear map over the buffered model values. The device half is a
Python loop over tensors: each step is one model call plus a linear
combination whose coefficients are Python floats (taken in f32, as the JAX
scan reads them), or `order` chained calls for the singlestep methods.

Conventions follow the reference sampler package: continuous time t in
[1/N, 1] for discrete models with model input time (t - 1/N) * N;
`eps_fn(x, t_input (B,)) -> eps`; classifier-free guidance composed by
`wrap_guidance` with the model_wrapper mix u + s (c - u).

Model calls: multistep DPM-Solver and UniPC `steps`; singlestep the sum of
its order schedule (`steps` for "singlestep", (steps // order) * order for
"singlestep_fixed"); denoise_to_zero one more.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

EpsFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


# --------------------------------------------------------------------------
# noise schedule (host, float64 numpy)

def _pl_interp(x, xp, fp):
    """Piecewise-linear interpolation, extrapolated linearly at both ends
    (np.interp clamps)."""
    x = np.asarray(x, np.float64)
    xp = np.asarray(xp, np.float64)
    fp = np.asarray(fp, np.float64)
    if xp[0] > xp[-1]:
        xp, fp = xp[::-1], fp[::-1]
    y = np.interp(x, xp, fp)
    lo = x < xp[0]
    hi = x > xp[-1]
    if np.any(lo):
        slope = (fp[1] - fp[0]) / (xp[1] - xp[0])
        y = np.where(lo, fp[0] + slope * (x - xp[0]), y)
    if np.any(hi):
        slope = (fp[-1] - fp[-2]) / (xp[-1] - xp[-2])
        y = np.where(hi, fp[-1] + slope * (x - xp[-1]), y)
    return y


class NoiseScheduleVP:
    """VP forward-SDE schedule. 'discrete': piecewise-linear log_alpha(t)
    over t_i = (i+1)/N, the log-SNR tail beyond -5.1 dropped; 'linear': the
    continuous VPSDE with (beta_0, beta_1)."""

    def __init__(self, schedule: str = "discrete", betas=None,
                 alphas_cumprod=None, continuous_beta_0: float = 0.1,
                 continuous_beta_1: float = 20.0):
        if schedule not in ("discrete", "linear"):
            raise ValueError(f"unsupported schedule {schedule}")
        self.schedule = schedule
        self.T = 1.0
        if schedule == "discrete":
            if betas is not None:
                log_alphas = 0.5 * np.cumsum(
                    np.log(1.0 - np.asarray(betas, np.float64)))
            else:
                log_alphas = 0.5 * np.log(
                    np.asarray(alphas_cumprod, np.float64))
            log_alphas = self._clip_alpha(log_alphas)
            self.total_N = len(log_alphas)
            self.log_alpha_array = log_alphas
            self.t_array = np.linspace(0.0, 1.0, self.total_N + 1)[1:]
        else:
            self.total_N = 1000
            self.beta_0 = float(continuous_beta_0)
            self.beta_1 = float(continuous_beta_1)

    @staticmethod
    def _clip_alpha(log_alphas, clipped_lambda=-5.1):
        log_sigmas = 0.5 * np.log1p(-np.exp(2.0 * log_alphas))
        lambs = log_alphas - log_sigmas
        idx = int(np.searchsorted(lambs[::-1], clipped_lambda))
        return log_alphas[:-idx] if idx > 0 else log_alphas

    def marginal_log_mean_coeff(self, t):
        t = np.asarray(t, np.float64)
        if self.schedule == "discrete":
            return _pl_interp(t, self.t_array, self.log_alpha_array)
        return (-0.25 * t ** 2 * (self.beta_1 - self.beta_0)
                - 0.5 * t * self.beta_0)

    def marginal_alpha(self, t):
        return np.exp(self.marginal_log_mean_coeff(t))

    def marginal_std(self, t):
        return np.sqrt(1.0 - np.exp(2.0 * self.marginal_log_mean_coeff(t)))

    def marginal_lambda(self, t):
        la = self.marginal_log_mean_coeff(t)
        return la - 0.5 * np.log1p(-np.exp(2.0 * la))

    def inverse_lambda(self, lamb):
        lamb = np.asarray(lamb, np.float64)
        if self.schedule == "linear":
            tmp = 2.0 * (self.beta_1 - self.beta_0) * np.logaddexp(
                -2.0 * lamb, 0.0)
            delta = self.beta_0 ** 2 + tmp
            return (tmp / (np.sqrt(delta) + self.beta_0)
                    / (self.beta_1 - self.beta_0))
        log_alpha = -0.5 * np.logaddexp(0.0, -2.0 * lamb)
        return _pl_interp(log_alpha, self.log_alpha_array[::-1],
                          self.t_array[::-1])

    def model_input_time(self, t):
        """Continuous t -> the model's input time."""
        if self.schedule == "discrete":
            return ((np.asarray(t, np.float64) - 1.0 / self.total_N)
                    * self.total_N)
        return np.asarray(t, np.float64)


def get_time_steps(ns: NoiseScheduleVP, skip_type: str, t_T: float,
                   t_0: float, N: int) -> np.ndarray:
    """Sampling time grid, (N+1,) host float64."""
    if skip_type == "logSNR":
        lam = np.linspace(ns.marginal_lambda(t_T), ns.marginal_lambda(t_0),
                          N + 1)
        return ns.inverse_lambda(lam)
    if skip_type == "time_uniform":
        return np.linspace(t_T, t_0, N + 1)
    if skip_type == "time_quadratic":
        return np.linspace(t_T ** 0.5, t_0 ** 0.5, N + 1) ** 2
    raise ValueError(f"unsupported skip_type {skip_type}")


# --------------------------------------------------------------------------
# model values (device)

def dynamic_thresholding(x0: torch.Tensor, ratio: float = 0.995,
                         max_val: float = 1.0) -> torch.Tensor:
    """Imagen-style dynamic thresholding: each row clipped to its `ratio`
    quantile of |x0| (at least max_val) and divided by it."""
    flat = x0.abs().reshape(x0.shape[0], -1)
    s = torch.quantile(flat, ratio, dim=1)
    s = torch.clamp(s, min=max_val).reshape((-1,) + (1,) * (x0.dim() - 1))
    return torch.clamp(x0, -s, s) / s


def wrap_guidance(eps_fn_cond: EpsFn, eps_fn_uncond: EpsFn,
                  guidance_scale: float) -> EpsFn:
    """Classifier-free guidance with the model_wrapper mix u + s (c - u)
    (not the ancestral path's ramped (1 + k) c - k u)."""

    def fn(x, t_input):
        c = eps_fn_cond(x, t_input)
        u = eps_fn_uncond(x, t_input)
        return u + guidance_scale * (c - u)

    return fn


def _f32(v) -> float:
    """A host coefficient as the f32 value the JAX scan reads."""
    return float(np.float32(v))


def _make_eval(eps_fn: EpsFn, predict_x0: bool, correcting_x0_fn):
    """(x, consts) -> eps (dpmsolver) or x0 (dpmsolver++); consts =
    (t_input, alpha_t, sigma_t) as f32 floats."""

    def ev(x, consts):
        t_in, alpha, sigma = consts
        eps = eps_fn(x, torch.full((x.shape[0],), t_in, dtype=x.dtype,
                                   device=x.device))
        if not predict_x0:
            return eps
        x0 = (x - sigma * eps) / alpha
        if correcting_x0_fn == "dynamic_thresholding":
            x0 = dynamic_thresholding(x0)
        elif callable(correcting_x0_fn):
            x0 = correcting_x0_fn(x0, t_in)
        return x0

    return ev


def _eval_consts(ns: NoiseScheduleVP, t) -> np.ndarray:
    return np.stack([ns.model_input_time(t), ns.marginal_alpha(t),
                     ns.marginal_std(t)], axis=-1)


def _consts(row) -> Tuple[float, float, float]:
    return tuple(_f32(v) for v in row)


def _combine(cx: float, x: torch.Tensor, coeffs: Sequence[float],
             values: Sequence[torch.Tensor]) -> torch.Tensor:
    """cx * x + sum_k coeffs[k] * values[k] (zero coefficients skipped:
    the buffer slots a lower-order step does not use)."""
    out = cx * x
    for c, v in zip(coeffs, values):
        if c != 0.0:
            out = out + c * v
    return out


# --------------------------------------------------------------------------
# multistep DPM-Solver coefficients (host)

def _dpm_ms_coeffs(ns: NoiseScheduleVP, alg: str, stype: str, p: int,
                   t: float, tprevs: Sequence[float]
                   ) -> Tuple[float, np.ndarray]:
    """(c_x, c_m[3]) of the order-p multistep update x_t = c_x x + c_m .
    [m0, m1, m2], newest model value first."""
    lam = ns.marginal_lambda
    la = ns.marginal_log_mean_coeff
    tp0 = tprevs[0]
    h = lam(t) - lam(tp0)
    alpha_t, sigma_t = np.exp(la(t)), ns.marginal_std(t)
    pp = alg == "dpmsolver++"
    if pp:
        cx = sigma_t / ns.marginal_std(tp0)
        phi1 = np.expm1(-h)
        lead = -alpha_t * phi1
    else:
        cx = np.exp(la(t) - la(tp0))
        phi1 = np.expm1(h)
        lead = -sigma_t * phi1
    cm = np.zeros(3)
    cm[0] = lead
    if p >= 2:
        r0 = (lam(tp0) - lam(tprevs[1])) / h
        d10 = np.array([1.0 / r0, -1.0 / r0, 0.0])
        if p == 2:
            if stype == "dpmsolver":
                cm += 0.5 * lead * d10
            elif pp:
                cm += alpha_t * (phi1 / h + 1.0) * d10
            else:
                cm += -sigma_t * (phi1 / h - 1.0) * d10
        else:
            r1 = (lam(tprevs[1]) - lam(tprevs[2])) / h
            d11 = np.array([0.0, 1.0 / r1, -1.0 / r1])
            d1 = d10 + (r0 / (r0 + r1)) * (d10 - d11)
            d2 = (d10 - d11) / (r0 + r1)
            if pp:
                phi2 = phi1 / h + 1.0
                phi3 = phi2 / h - 0.5
                cm += alpha_t * phi2 * d1 - alpha_t * phi3 * d2
            else:
                phi2 = phi1 / h - 1.0
                phi3 = phi2 / h - 0.5
                cm += -sigma_t * phi2 * d1 - sigma_t * phi3 * d2
    return cx, cm


# --------------------------------------------------------------------------
# UniPC coefficients (host)

def _unipc_coeffs(ns: NoiseScheduleVP, variant: str, predict_x0: bool,
                  p: int, t: float, tprevs: Sequence[float]
                  ) -> Tuple[float, np.ndarray, np.ndarray, float]:
    """(c_x, c_pred[3], c_corr[3], c_mt) of one UniPC step: predictor
    x_p = c_x x + c_pred . m; corrector x_c = c_x x + c_corr . m + c_mt m_t
    with m_t = model(x_p, t)."""
    lam = ns.marginal_lambda
    la = ns.marginal_log_mean_coeff
    tp0 = tprevs[0]
    h = lam(t) - lam(tp0)
    alpha_t, sigma_t = np.exp(la(t)), ns.marginal_std(t)

    rks, d1_rows = [], []
    for i in range(1, p):
        rk = (lam(tprevs[i]) - lam(tp0)) / h
        rks.append(rk)
        row = np.zeros(3)
        row[i] = 1.0 / rk
        row[0] = -1.0 / rk
        d1_rows.append(row)
    rks.append(1.0)
    rks = np.array(rks)
    K = len(rks)

    hh = -h if predict_x0 else h
    h_phi_1 = np.expm1(hh)
    if predict_x0:
        cx = sigma_t / ns.marginal_std(tp0)
        base0 = -alpha_t * h_phi_1
        amp = alpha_t
    else:
        cx = np.exp(la(t) - la(tp0))
        base0 = -sigma_t * h_phi_1
        amp = sigma_t

    cp = np.zeros(3)
    cc = np.zeros(3)
    cp[0] = base0
    cc[0] = base0
    if variant in ("bh1", "bh2"):
        B_h = hh if variant == "bh1" else np.expm1(hh)
        R, b = [], []
        fact = 1
        h_phi_k = h_phi_1 / hh - 1.0
        for i in range(1, K + 1):
            R.append(rks ** (i - 1))
            b.append(h_phi_k * fact / B_h)
            fact *= i + 1
            h_phi_k = h_phi_k / hh - 1.0 / fact
        R = np.stack(R)
        b = np.array(b)
        gain = -amp * B_h
        if p >= 2:
            rhos_p = (np.array([0.5]) if p == 2
                      else np.linalg.solve(R[:-1, :-1], b[:-1]))
            for k in range(p - 1):
                cp += gain * rhos_p[k] * d1_rows[k]
        rhos_c = np.array([0.5]) if p == 1 else np.linalg.solve(R, b)
        for k in range(p - 1):
            cc += gain * rhos_c[k] * d1_rows[k]
        cc[0] -= gain * rhos_c[-1]
        c_mt = gain * rhos_c[-1]
    elif variant == "vary_coeff":
        C = np.stack([rks ** k / math.factorial(k + 1) for k in range(K)],
                     axis=1)
        h_phi_ks = []
        fact = 1
        h_phi_k = h_phi_1
        for k in range(1, K + 2):
            h_phi_ks.append(h_phi_k)
            h_phi_k = h_phi_k / hh - 1.0 / fact
            fact *= k + 1
        if p >= 2:
            A_p = np.linalg.inv(C[:-1, :-1])
            for k in range(K - 1):
                for i in range(p - 1):
                    cp += -amp * h_phi_ks[k + 1] * A_p[k, i] * d1_rows[i]
        A_c = np.linalg.inv(C)
        k_last = max(K - 2, 0)
        for k in range(K - 1):
            for i in range(p - 1):
                cc += -amp * h_phi_ks[k + 1] * A_c[k, i] * d1_rows[i]
        c_mt = -amp * h_phi_ks[K] * A_c[k_last, -1]
        cc[0] -= c_mt
    else:
        raise ValueError(f"unknown UniPC variant {variant}")
    return cx, cp, cc, c_mt


# --------------------------------------------------------------------------
# singlestep DPM-Solver stage coefficients (host)

def _dpm_ss_coeffs(ns: NoiseScheduleVP, alg: str, stype: str, p: int,
                   s: float, t: float, r1: Optional[float],
                   r2: Optional[float]):
    """Stage times + linear stage coefficients of the order-p singlestep
    update: (eval_times (3,), flat coefficients)
      order 1: [e_x, e_0]
      order 2: [a_x, a_0, b_x, b_0, b_1]
      order 3: [a_x, a_0, c_x, c_0, c_1, d_x, d_0, d_1, d_2]."""
    lam = ns.marginal_lambda
    la = ns.marginal_log_mean_coeff
    sig = ns.marginal_std
    h = lam(t) - lam(s)
    pp = alg == "dpmsolver++"
    if p == 1:
        if pp:
            coeffs = [sig(t) / sig(s), -np.exp(la(t)) * np.expm1(-h)]
        else:
            coeffs = [np.exp(la(t) - la(s)), -sig(t) * np.expm1(h)]
        return np.array([s, s, s]), np.array(coeffs)

    r1 = 0.5 if (r1 is None and p == 2) else (1.0 / 3.0 if r1 is None else r1)
    s1 = float(ns.inverse_lambda(lam(s) + r1 * h))
    if pp:
        phi11 = np.expm1(-r1 * h)
        phi1 = np.expm1(-h)
        a = [sig(s1) / sig(s), -np.exp(la(s1)) * phi11]
        alpha_t = np.exp(la(t))
        if p == 2:
            if stype == "dpmsolver":
                w = (0.5 / r1) * alpha_t * phi1
                b = [sig(t) / sig(s), -alpha_t * phi1 + w, -w]
            else:
                w = (1.0 / r1) * alpha_t * (phi1 / h + 1.0)
                b = [sig(t) / sig(s), -alpha_t * phi1 - w, w]
            return np.array([s, s1, s1]), np.array(a + b)
        r2 = 2.0 / 3.0 if r2 is None else r2
        s2 = float(ns.inverse_lambda(lam(s) + r2 * h))
        phi12 = np.expm1(-r2 * h)
        phi22 = np.expm1(-r2 * h) / (r2 * h) + 1.0
        phi2 = phi1 / h + 1.0
        phi3 = phi2 / h - 0.5
        alpha_s2 = np.exp(la(s2))
        w2 = (r2 / r1) * alpha_s2 * phi22
        c = [sig(s2) / sig(s), -alpha_s2 * phi12 - w2, w2]
        if stype == "dpmsolver":
            w = (1.0 / r2) * alpha_t * phi2
            d = [sig(t) / sig(s), -alpha_t * phi1 - w, 0.0, w]
        else:
            d10 = np.array([-1.0 / r1, 1.0 / r1, 0.0])
            d11 = np.array([-1.0 / r2, 0.0, 1.0 / r2])
            d1v = (r2 * d10 - r1 * d11) / (r2 - r1)
            d2v = 2.0 * (d11 - d10) / (r2 - r1)
            dm = alpha_t * phi2 * d1v - alpha_t * phi3 * d2v
            dm[0] -= alpha_t * phi1
            d = [sig(t) / sig(s)] + list(dm)
        return np.array([s, s1, s2]), np.array(a + c + d)
    phi11 = np.expm1(r1 * h)
    phi1 = np.expm1(h)
    a = [np.exp(la(s1) - la(s)), -sig(s1) * phi11]
    if p == 2:
        if stype == "dpmsolver":
            w = (0.5 / r1) * sig(t) * phi1
            b = [np.exp(la(t) - la(s)), -sig(t) * phi1 + w, -w]
        else:
            w = (1.0 / r1) * sig(t) * (phi1 / h - 1.0)
            b = [np.exp(la(t) - la(s)), -sig(t) * phi1 + w, -w]
        return np.array([s, s1, s1]), np.array(a + b)
    r2 = 2.0 / 3.0 if r2 is None else r2
    s2 = float(ns.inverse_lambda(lam(s) + r2 * h))
    phi12 = np.expm1(r2 * h)
    phi22 = np.expm1(r2 * h) / (r2 * h) - 1.0
    phi2 = phi1 / h - 1.0
    phi3 = phi2 / h - 0.5
    w2 = (r2 / r1) * sig(s2) * phi22
    c = [np.exp(la(s2) - la(s)), -sig(s2) * phi12 + w2, -w2]
    if stype == "dpmsolver":
        w = (1.0 / r2) * sig(t) * phi2
        d = [np.exp(la(t) - la(s)), -sig(t) * phi1 + w, 0.0, -w]
    else:
        d10 = np.array([-1.0 / r1, 1.0 / r1, 0.0])
        d11 = np.array([-1.0 / r2, 0.0, 1.0 / r2])
        d1v = (r2 * d10 - r1 * d11) / (r2 - r1)
        d2v = 2.0 * (d11 - d10) / (r2 - r1)
        dm = -sig(t) * phi2 * d1v - sig(t) * phi3 * d2v
        dm[0] -= sig(t) * phi1
        d = [np.exp(la(t) - la(s))] + list(dm)
    return np.array([s, s1, s2]), np.array(a + c + d)


def _singlestep_orders(steps: int, order: int) -> List[int]:
    """DPM-Solver-fast order schedule."""
    if order == 3:
        K = steps // 3 + 1
        if steps % 3 == 0:
            return [3] * (K - 2) + [2, 1]
        if steps % 3 == 1:
            return [3] * (K - 1) + [1]
        return [3] * (K - 1) + [2]
    if order == 2:
        if steps % 2 == 0:
            return [2] * (steps // 2)
        return [2] * (steps // 2) + [1]
    return [1] * steps


# --------------------------------------------------------------------------
# samplers (public)

def sample_dpm_solver(eps_fn: EpsFn, ns: NoiseScheduleVP, x: torch.Tensor,
                      steps: int = 20, order: int = 2,
                      skip_type: str = "time_uniform",
                      method: str = "multistep",
                      algorithm_type: str = "dpmsolver++",
                      solver_type: str = "dpmsolver",
                      lower_order_final: bool = True,
                      denoise_to_zero: bool = False,
                      t_start: Optional[float] = None,
                      t_end: Optional[float] = None,
                      correcting_x0_fn=None) -> torch.Tensor:
    """DPM-Solver sampling from x = x_T. Model calls: see the module
    docstring."""
    t_0 = 1.0 / ns.total_N if t_end is None else t_end
    t_T = ns.T if t_start is None else t_start
    predict_x0 = algorithm_type == "dpmsolver++"
    ev = _make_eval(eps_fn, predict_x0, correcting_x0_fn)

    if method == "multistep":
        assert steps >= order
        ts = get_time_steps(ns, skip_type, t_T, t_0, steps)
        coeffs = []
        for i in range(1, steps + 1):
            p = min(order, i)
            if lower_order_final and steps < 10:
                p = min(p, steps + 1 - i)
            cx, cm = _dpm_ms_coeffs(ns, algorithm_type, solver_type, p,
                                    ts[i], [ts[i - 1 - k] for k in range(p)])
            coeffs.append((_f32(cx), [_f32(c) for c in cm]))
        evc = _eval_consts(ns, ts)                       # (steps + 1, 3)
        m0 = ev(x, _consts(evc[0]))
        buf = [m0, m0, m0]
        for i in range(steps - 1):
            cx, cm = coeffs[i]
            x = _combine(cx, x, cm, buf)
            buf = [ev(x, _consts(evc[i + 1])), buf[0], buf[1]]
        cx, cm = coeffs[-1]
        x = _combine(cx, x, cm, buf)
    elif method in ("singlestep", "singlestep_fixed"):
        if method == "singlestep":
            orders = _singlestep_orders(steps, order)
            if skip_type == "logSNR":
                grid = get_time_steps(ns, skip_type, t_T, t_0, len(orders))
            else:
                full = get_time_steps(ns, skip_type, t_T, t_0, steps)
                grid = full[np.cumsum([0] + orders)]
        else:
            K = steps // order
            orders = [order] * K
            grid = get_time_steps(ns, skip_type, t_T, t_0, K)
        for m, p in enumerate(orders):
            s_m, t_m = float(grid[m]), float(grid[m + 1])
            inner = get_time_steps(ns, skip_type, s_m, t_m, p)
            lam_in = ns.marginal_lambda(inner)
            h = lam_in[-1] - lam_in[0]
            r1 = None if p <= 1 else float((lam_in[1] - lam_in[0]) / h)
            r2 = None if p <= 2 else float((lam_in[2] - lam_in[0]) / h)
            times, cf = _dpm_ss_coeffs(ns, algorithm_type, solver_type, p,
                                       s_m, t_m, r1, r2)
            evc = _eval_consts(ns, times)
            cf = [_f32(c) for c in cf]
            m_s = ev(x, _consts(evc[0]))
            if p == 1:
                x = _combine(cf[0], x, cf[1:2], [m_s])
                continue
            x1 = _combine(cf[0], x, cf[1:2], [m_s])
            m_s1 = ev(x1, _consts(evc[1]))
            if p == 2:
                x = _combine(cf[2], x, cf[3:5], [m_s, m_s1])
                continue
            x2 = _combine(cf[2], x, cf[3:5], [m_s, m_s1])
            m_s2 = ev(x2, _consts(evc[2]))
            x = _combine(cf[5], x, cf[6:9], [m_s, m_s1, m_s2])
    else:
        raise ValueError(f"unsupported method {method}")

    if denoise_to_zero:
        dz = _make_eval(eps_fn, True, correcting_x0_fn)
        x = dz(x, _consts(_eval_consts(ns, t_0)))
    return x


def sample_unipc(eps_fn: EpsFn, ns: NoiseScheduleVP, x: torch.Tensor,
                 steps: int = 20, order: int = 2, variant: str = "bh2",
                 predict_x0: bool = True, skip_type: str = "time_uniform",
                 lower_order_final: bool = True,
                 denoise_to_zero: bool = False,
                 t_start: Optional[float] = None,
                 t_end: Optional[float] = None,
                 correcting_x0_fn=None) -> torch.Tensor:
    """UniPC multistep sampling from x = x_T. The corrector's model value
    is the next step's newest buffer entry, so the model runs `steps`
    times; the final step is predictor-only."""
    t_0 = 1.0 / ns.total_N if t_end is None else t_end
    t_T = ns.T if t_start is None else t_start
    assert steps >= order
    ev = _make_eval(eps_fn, predict_x0, correcting_x0_fn)

    ts = get_time_steps(ns, skip_type, t_T, t_0, steps)
    coeffs = []
    for i in range(1, steps + 1):
        p = min(order, i)
        if lower_order_final:
            p = min(p, steps + 1 - i)
        cx, cp, cc, cmt = _unipc_coeffs(ns, variant, predict_x0, p, ts[i],
                                        [ts[i - 1 - k] for k in range(p)])
        coeffs.append((_f32(cx), [_f32(c) for c in cp],
                       [_f32(c) for c in cc], _f32(cmt)))
    evc = _eval_consts(ns, ts)

    m0 = ev(x, _consts(evc[0]))
    buf = [m0, m0, m0]
    for i in range(steps - 1):
        cx, cp, cc, cmt = coeffs[i]
        x_p = _combine(cx, x, cp, buf)
        m_t = ev(x_p, _consts(evc[i + 1]))
        x = _combine(cx, x, cc + [cmt], buf + [m_t])
        buf = [m_t, buf[0], buf[1]]
    cx, cp, _, _ = coeffs[-1]
    x = _combine(cx, x, cp, buf)

    if denoise_to_zero:
        dz = _make_eval(eps_fn, True, correcting_x0_fn)
        x = dz(x, _consts(_eval_consts(ns, t_0)))
    return x
