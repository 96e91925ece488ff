"""Gaussian diffusion process (port of xtts_tpu/diffusion/gaussian.py).

Schedules and coefficient tables are host f64 numpy, built by the same
code as the JAX module; per-step scalars are taken in f32 on the sample's
device. The sampling loops (ancestral `p`, `ddim`, `dpm++2m`, `unipc`) are
Python loops over the spaced steps, and the continuous-time solvers
(diffusion/solvers.py) run over the base training schedule
(`solver_sample_loop`): `sample_loop` takes JAX's ten sampler names. Each
loop takes an explicit x_T (`noise=`), and
draws in-loop noise from a torch.Generator, or from one generator a row
(`randn_rows`): each row's noise chain then depends on its own generator
alone, whatever else is in the batch (JAX's per-row keys,
xtts_tpu/diffusion/gaussian.py:235-260).

Shipped-path semantics: linear 1000-step schedule, SpacedDiffusion
re-spacing with the timestep map, epsilon prediction + learned-range
variance, CFG mix (1+k)*cond - k*uncond with the linear ramp
k * (1 - t_spaced / T_spaced). The training half: `q_sample` and
`training_losses`, MSE(eps) + the vb term with the mean frozen
(ttts/utils/diffusion.py:930-1014), in f32 whatever the model computes in.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from xtts_tpu_torch.parallel import mesh as pmesh


def linear_beta_schedule(num_steps: int) -> np.ndarray:
    """The shipped schedule: linear, scaled by 1000 / num_steps."""
    scale = 1000.0 / num_steps
    return np.linspace(scale * 0.0001, scale * 0.02, num_steps,
                       dtype=np.float64)


def get_named_beta_schedule(name: str, num_steps: int) -> np.ndarray:
    """`linear` (scaled by 1000 / num_steps) or `cosine` (Nichol &
    Dhariwal's alpha_bar, each beta capped at 0.999)."""
    if name == "linear":
        return linear_beta_schedule(num_steps)
    if name == "cosine":
        def alpha_bar(t):
            return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2
        return np.array([min(1 - alpha_bar((i + 1) / num_steps)
                             / alpha_bar(i / num_steps), 0.999)
                         for i in range(num_steps)], dtype=np.float64)
    raise NotImplementedError(name)


def space_timesteps(num_timesteps: int, section_counts) -> set:
    """Subset of the original timesteps to keep; section_counts is an
    int or a list of per-section counts."""
    if isinstance(section_counts, int):
        section_counts = [section_counts]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx, all_steps = 0, []
    for i, count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < count:
            raise ValueError(f"cannot divide section of {size} steps into "
                             f"{count}")
        stride = 1 if count <= 1 else (size - 1) / (count - 1)
        cur = 0.0
        for _ in range(count):
            all_steps.append(start_idx + round(cur))
            cur += stride
        start_idx += size
    return set(all_steps)


ModelFn = Callable[[torch.Tensor, torch.Tensor], object]
# model(x (B, C, T), t_orig (B,)) -> (B, 2C, T) [eps ; var_frac], or a
# (cond, uncond) pair of those for the paired CFG call (the CFG mix runs
# only for the pair)


Generators = Union[None, torch.Generator, Sequence[torch.Generator]]


def randn_rows(shape, generator: Generators, device) -> torch.Tensor:
    """Standard normal draws of `shape` from one generator, or, given a
    sequence of generators (one a row of shape[0]), row i from the i-th
    alone. At one row the two draw the same numbers from the same seed.
    One generator in a parallel.mesh.row_block draws for the whole wave and
    keeps the block's rows."""
    if isinstance(generator, (list, tuple)):
        if len(generator) != shape[0]:
            raise ValueError(f"{len(generator)} generators for "
                             f"{shape[0]} rows")
        return torch.stack([torch.randn(tuple(shape[1:]), generator=g,
                                        device=device) for g in generator])
    return pmesh.block_draw(lambda s: torch.randn(
        s, generator=generator, device=device), shape)


def _x_T(shape, generator, noise, device) -> torch.Tensor:
    if noise is not None:
        return noise
    if device is None:
        raise ValueError("a sample loop takes its x_T (noise) or the device "
                         "to draw it on")
    return randn_rows(shape, generator, device)


@dataclass(frozen=True)
class GaussianDiffusion:
    betas: np.ndarray
    timestep_map: Optional[np.ndarray] = None
    conditioning_free_k: float = 1.0
    # the full training schedule, kept by spaced() for the continuous-time
    # solvers (solver_sample_loop)
    base_betas: Optional[np.ndarray] = field(default=None, repr=False)

    alphas_cumprod: np.ndarray = field(default=None, repr=False)
    alphas_cumprod_prev: np.ndarray = field(default=None, repr=False)
    sqrt_alphas_cumprod: np.ndarray = field(default=None, repr=False)
    sqrt_one_minus_alphas_cumprod: np.ndarray = field(default=None,
                                                      repr=False)
    sqrt_recip_alphas_cumprod: np.ndarray = field(default=None, repr=False)
    sqrt_recipm1_alphas_cumprod: np.ndarray = field(default=None, repr=False)
    posterior_log_variance_clipped: np.ndarray = field(default=None,
                                                       repr=False)
    posterior_mean_coef1: np.ndarray = field(default=None, repr=False)
    posterior_mean_coef2: np.ndarray = field(default=None, repr=False)

    def __post_init__(self):
        betas = np.asarray(self.betas, dtype=np.float64)
        alphas = 1.0 - betas
        acp = np.cumprod(alphas)
        acp_prev = np.append(1.0, acp[:-1])
        post_var = betas * (1.0 - acp_prev) / (1.0 - acp)
        derived = dict(
            betas=betas, alphas_cumprod=acp, alphas_cumprod_prev=acp_prev,
            sqrt_alphas_cumprod=np.sqrt(acp),
            sqrt_one_minus_alphas_cumprod=np.sqrt(1 - acp),
            sqrt_recip_alphas_cumprod=np.sqrt(1.0 / acp),
            sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / acp - 1),
            posterior_log_variance_clipped=np.log(
                np.append(post_var[1], post_var[1:])),
            posterior_mean_coef1=betas * np.sqrt(acp_prev) / (1.0 - acp),
            posterior_mean_coef2=(1.0 - acp_prev) * np.sqrt(alphas)
            / (1.0 - acp))
        for k, v in derived.items():
            object.__setattr__(self, k, v)

    @property
    def num_timesteps(self) -> int:
        return len(self.betas)

    @staticmethod
    def spaced(num_train_steps: int = 1000, sampling_steps: int = 50,
               schedule: str = "linear", **kw) -> "GaussianDiffusion":
        """SpacedDiffusion equivalent."""
        base_betas = get_named_beta_schedule(schedule, num_train_steps)
        acp = np.cumprod(1.0 - base_betas)
        use = space_timesteps(num_train_steps, sampling_steps)
        new_betas, tmap, last = [], [], 1.0
        for i, a in enumerate(acp):
            if i in use:
                new_betas.append(1 - a / last)
                last = a
                tmap.append(i)
        return GaussianDiffusion(betas=np.array(new_betas),
                                 timestep_map=np.array(tmap),
                                 base_betas=base_betas, **kw)

    def map_t(self, t: torch.Tensor) -> torch.Tensor:
        """Spaced index -> original timestep fed to the model."""
        if self.timestep_map is None:
            return t
        return torch.as_tensor(self.timestep_map, device=t.device)[t]

    def _ex(self, arr: np.ndarray, t: torch.Tensor, ndim: int) -> torch.Tensor:
        """Per-t f32 scalars, shaped (B, 1, ...) to broadcast over ndim."""
        vals = torch.as_tensor(np.asarray(arr, np.float32), device=t.device)[t]
        return vals.reshape(vals.shape + (1,) * (ndim - 1))

    def q_sample(self, x_start, t, noise):
        n = x_start.dim()
        return (self._ex(self.sqrt_alphas_cumprod, t, n) * x_start
                + self._ex(self.sqrt_one_minus_alphas_cumprod, t, n) * noise)

    def q_posterior_mean(self, x_start, x_t, t):
        n = x_t.dim()
        return (self._ex(self.posterior_mean_coef1, t, n) * x_start
                + self._ex(self.posterior_mean_coef2, t, n) * x_t)

    def predict_xstart_from_eps(self, x_t, t, eps):
        n = x_t.dim()
        return (self._ex(self.sqrt_recip_alphas_cumprod, t, n) * x_t
                - self._ex(self.sqrt_recipm1_alphas_cumprod, t, n) * eps)

    def _cfg_scale(self, t: torch.Tensor) -> torch.Tensor:
        """Ramped guidance strength on the SPACED index and count (the
        reference's ramp; the shipped path always ramps)."""
        return self.conditioning_free_k * (1.0 - t.float()
                                           / self.num_timesteps)

    def p_mean_variance_from_output(self, model_output, x, t,
                                    model_output_uncond=None):
        """Split eps/var, learned-range log-variance, CFG mix, posterior
        mean. t is the spaced index (B,)."""
        n = x.dim()
        eps, var_frac = model_output.chunk(2, dim=1)
        if model_output_uncond is not None:
            eps_uc = model_output_uncond.chunk(2, dim=1)[0]
            cfk = self._cfg_scale(t).reshape((-1,) + (1,) * (n - 1))
            eps = (1 + cfk) * eps - cfk * eps_uc
        min_log = self._ex(self.posterior_log_variance_clipped, t, n)
        max_log = self._ex(np.log(self.betas), t, n)
        frac = (var_frac + 1) / 2
        model_log_var = frac * max_log + (1 - frac) * min_log
        pred_xstart = torch.clamp(self.predict_xstart_from_eps(x, t, eps),
                                  -1, 1)
        mean = self.q_posterior_mean(pred_xstart, x, t)
        return {"mean": mean, "log_variance": model_log_var,
                "pred_xstart": pred_xstart, "eps": eps}

    @staticmethod
    def _model_out(model_fn, x, t_orig):
        out = model_fn(x, t_orig)
        return out if isinstance(out, tuple) else (out, None)

    def p_sample_loop(self, model_fn: ModelFn, shape, generator=None,
                      noise: Optional[torch.Tensor] = None,
                      device=None) -> torch.Tensor:
        """Ancestral sampling over all spaced steps (the live path). x_T is
        `noise`, or drawn on `device` (one of the two is required).
        generator: one torch.Generator (batch-level noise, the reference's
        semantics) or one a row (randn_rows)."""
        x = _x_T(shape, generator, noise, device)
        b = shape[0]
        for i in range(self.num_timesteps):
            t = torch.full((b,), self.num_timesteps - 1 - i,
                           dtype=torch.long, device=x.device)
            out, out_uc = self._model_out(model_fn, x, self.map_t(t))
            pmv = self.p_mean_variance_from_output(out, x, t, out_uc)
            x = pmv["mean"]
            if i < self.num_timesteps - 1:
                z = randn_rows(x.shape, generator, x.device)
                x = x + torch.exp(0.5 * pmv["log_variance"]) * z
        return x

    def ddim_sample_loop(self, model_fn: ModelFn, shape, generator=None,
                         noise: Optional[torch.Tensor] = None,
                         eta: float = 0.0, device=None) -> torch.Tensor:
        """DDIM; deterministic at eta = 0, so a chain from a shared x_T is
        comparable across frameworks."""
        x = _x_T(shape, generator, noise, device)
        b = shape[0]
        n = len(shape)
        for i in range(self.num_timesteps):
            t = torch.full((b,), self.num_timesteps - 1 - i,
                           dtype=torch.long, device=x.device)
            out, out_uc = self._model_out(model_fn, x, self.map_t(t))
            pmv = self.p_mean_variance_from_output(out, x, t, out_uc)
            eps = ((self._ex(self.sqrt_recip_alphas_cumprod, t, n) * x
                    - pmv["pred_xstart"])
                   / self._ex(self.sqrt_recipm1_alphas_cumprod, t, n))
            ab = self._ex(self.alphas_cumprod, t, n)
            ab_prev = self._ex(self.alphas_cumprod_prev, t, n)
            sigma = (eta * torch.sqrt((1 - ab_prev) / (1 - ab))
                     * torch.sqrt(1 - ab / ab_prev))
            x = (pmv["pred_xstart"] * torch.sqrt(ab_prev)
                 + torch.sqrt(1 - ab_prev - sigma ** 2) * eps)
            if eta > 0 and i < self.num_timesteps - 1:
                x = x + sigma * randn_rows(x.shape, generator, x.device)
        return x

    def dpmpp_2m_sample_loop(self, model_fn: ModelFn, shape, generator=None,
                             noise: Optional[torch.Tensor] = None,
                             device=None) -> torch.Tensor:
        """DPM-Solver++(2M), data-prediction form, over the spaced schedule
        (xtts_tpu/diffusion/gaussian.py:332-391, `sampler="dpm++2m"`).
        CFG is the constant-k mix u + k (c - u) of the k-diffusion path,
        not the ancestral ramp; x0 is clipped to [-1, 1]; the first step is
        Euler, the later ones extrapolate from the previous x0; the last
        step returns x0. Deterministic given x_T. Per-step scalars in f32,
        as the JAX loop takes them."""
        x = _x_T(shape, generator, noise, device)
        b, steps = shape[0], self.num_timesteps
        acp = np.asarray(self.alphas_cumprod)
        alpha = np.sqrt(acp).astype(np.float32)
        sigma = np.sqrt(1.0 - acp).astype(np.float32)
        lam = (np.log(np.sqrt(acp)) - np.log(np.sqrt(1.0 - acp))
               ).astype(np.float32)
        k = self.conditioning_free_k
        x0_prev, h_prev = None, np.float32(0.0)
        for step in range(steps):
            i = steps - 1 - step
            t = torch.full((b,), i, dtype=torch.long, device=x.device)
            out, out_uc = self._model_out(model_fn, x, self.map_t(t))
            eps = out.chunk(2, dim=1)[0]
            if out_uc is not None:
                eps_uc = out_uc.chunk(2, dim=1)[0]
                eps = eps_uc + k * (eps - eps_uc)
            x0 = torch.clamp(self.predict_xstart_from_eps(x, t, eps), -1, 1)
            if step == steps - 1:
                return x0
            h = np.float32(lam[i - 1] - lam[i])
            if step == 0:
                d = x0
            else:
                c = np.float32(1.0) / (np.float32(2.0)
                                       * np.float32(h_prev / max(h, 1e-12)))
                d = (1 + float(c)) * x0 - float(c) * x0_prev
            x = (float(sigma[i - 1] / sigma[i]) * x
                 - float(alpha[i - 1] * np.expm1(-h)) * d)
            x0_prev, h_prev = x0, h
        return x

    def _pred_x0_mix(self, model_fn, x, i: int) -> torch.Tensor:
        """The clipped x0 of spaced index i under the constant-k CFG mix
        u + k (c - u) (the k-diffusion path's, not the ancestral ramp)."""
        t = torch.full((x.shape[0],), i, dtype=torch.long, device=x.device)
        out, out_uc = self._model_out(model_fn, x, self.map_t(t))
        eps = out.chunk(2, dim=1)[0]
        if out_uc is not None:
            eps_uc = out_uc.chunk(2, dim=1)[0]
            eps = eps_uc + self.conditioning_free_k * (eps - eps_uc)
        return torch.clamp(self.predict_xstart_from_eps(x, t, eps), -1, 1)

    def unipc_sample_loop(self, model_fn: ModelFn, shape, generator=None,
                          noise: Optional[torch.Tensor] = None,
                          device=None) -> torch.Tensor:
        """Order-2 predictor-corrector in log-SNR space over the spaced
        schedule (xtts_tpu/diffusion/gaussian.py:393-454, `sampler=
        "unipc"`): the predictor is the dpm++2m extrapolation, the corrector
        a trapezoid with a model call at the predicted point. Two model
        calls a step, the last step's included (it returns the corrector's
        x0). Per-step scalars in f32, as the JAX loop takes them."""
        x = _x_T(shape, generator, noise, device)
        steps = self.num_timesteps
        acp = np.asarray(self.alphas_cumprod)
        alpha = np.sqrt(acp).astype(np.float32)
        sigma = np.sqrt(1.0 - acp).astype(np.float32)
        lam = (np.log(np.sqrt(acp)) - np.log(np.sqrt(1.0 - acp))
               ).astype(np.float32)
        m_prev, h_prev = None, np.float32(0.0)
        for step in range(steps):
            i = steps - 1 - step
            i_next = max(i - 1, 0)
            m0 = self._pred_x0_mix(model_fn, x, i)
            h = np.float32(lam[i_next] - lam[i])
            scale = float(sigma[i_next] / sigma[i])
            lead = np.float32(alpha[i_next] * np.expm1(-h))
            if step == 0:
                d_p = m0
            else:
                r = np.float32(h_prev / max(h, np.float32(1e-12)))
                d_p = m0 + (m0 - m_prev) / float(
                    max(np.float32(2.0) * r, np.float32(1e-12)))
            x_p = scale * x - float(lead) * d_p
            m1 = self._pred_x0_mix(model_fn, x_p, i_next)
            if step == steps - 1:
                return m1
            x = scale * x - float(lead * np.float32(0.5)) * (m0 + m1)
            m_prev, h_prev = m0, h
        return x

    def solver_sample_loop(self, model_fn: ModelFn, shape, generator=None,
                           noise: Optional[torch.Tensor] = None,
                           device=None, *, method: str = "multistep",
                           order: int = 2, variant: Optional[str] = None,
                           algorithm: str = "dpmsolver++",
                           skip_type: str = "time_uniform") -> torch.Tensor:
        """A continuous-time DPM-Solver / UniPC run over the BASE training
        schedule with as many model evaluations as spaced steps
        (xtts_tpu/diffusion/gaussian.py:456-495). The model takes float
        base-schedule times, and CFG is the model_wrapper mix u + k (c - u);
        a ReferenceNet table hoisted over the spaced grid does not apply."""
        from xtts_tpu_torch.diffusion import solvers as S
        base = self.base_betas if self.base_betas is not None else self.betas
        ns = S.NoiseScheduleVP("discrete", betas=np.asarray(base, np.float64))
        k = self.conditioning_free_k

        def eps_fn(x, t_input):
            out, out_uc = self._model_out(model_fn, x, t_input)
            eps = out.chunk(2, dim=1)[0]
            if out_uc is not None:
                eps_uc = out_uc.chunk(2, dim=1)[0]
                eps = eps_uc + k * (eps - eps_uc)
            return eps

        x = _x_T(shape, generator, noise, device)
        steps = self.num_timesteps
        if variant is not None:
            return S.sample_unipc(eps_fn, ns, x, steps=steps, order=order,
                                  variant=variant, skip_type=skip_type)
        return S.sample_dpm_solver(eps_fn, ns, x, steps=steps, order=order,
                                   method=method, algorithm_type=algorithm,
                                   skip_type=skip_type)

    def sample_loop(self, model_fn: ModelFn, shape, generator=None,
                    noise=None, sampler: str = "p",
                    device=None) -> torch.Tensor:
        """Run the named sampler (JAX's table: an unknown name raises
        KeyError)."""
        solver = functools.partial
        fns = {"p": self.p_sample_loop, "ddim": self.ddim_sample_loop,
               "dpm++2m": self.dpmpp_2m_sample_loop,
               "unipc": self.unipc_sample_loop,
               # continuous-time solvers over the base schedule
               "dpm++2m_solver": solver(self.solver_sample_loop, order=2),
               "dpm++3m": solver(self.solver_sample_loop, order=3),
               "dpm++fast": solver(self.solver_sample_loop, order=3,
                                   method="singlestep"),
               "unipc_bh1": solver(self.solver_sample_loop, order=2,
                                   variant="bh1"),
               "unipc_bh2": solver(self.solver_sample_loop, order=2,
                                   variant="bh2"),
               "unipc_vary": solver(self.solver_sample_loop, order=2,
                                    variant="vary_coeff")}
        return fns[sampler](model_fn, shape, generator=generator, noise=noise,
                            device=device)


    # ------------------------------------------------------------------
    # training

    def training_losses(self, model_fn, x_start: torch.Tensor,
                        t: torch.Tensor, noise: torch.Tensor):
        """MSE(eps) + the vb term with the model's mean frozen
        (ttts/utils/diffusion.py:963-1014). t: the (B,) indices of this
        process; model_fn(x_t, t_orig) -> (B, 2C, T). The loss math runs in
        f32 whatever the model computes in. Returns per-example 'loss',
        'mse', 'vb' and 'x_start_predicted'."""
        x_t = self.q_sample(x_start, t, noise)
        out = model_fn(x_t, self.map_t(t)).float()
        eps, var_frac = out.chunk(2, dim=1)
        frozen = torch.cat([eps.detach(), var_frac], dim=1)
        vb = self._vb_terms(frozen, x_start, x_t, t)
        mse = _mean_flat((noise - eps) ** 2)
        return {"loss": mse + vb, "mse": mse, "vb": vb,
                "x_start_predicted": self.predict_xstart_from_eps(x_t, t,
                                                                  eps)}

    def _vb_terms(self, model_output, x_start, x_t, t):
        """KL(q(x_{t-1} | x_t, x_0) || p) in bits; the decoder NLL at
        t = 0."""
        pmv = self.p_mean_variance_from_output(model_output, x_t, t)
        true_mean = self.q_posterior_mean(x_start, x_t, t)
        true_logvar = self._ex(self.posterior_log_variance_clipped, t,
                               x_t.dim())
        kl = _normal_kl(true_mean, true_logvar, pmv["mean"],
                        pmv["log_variance"])
        kl = _mean_flat(kl) / math.log(2.0)
        nll = -_discretized_gaussian_log_likelihood(
            x_start, pmv["mean"], 0.5 * pmv["log_variance"])
        nll = _mean_flat(nll) / math.log(2.0)
        return torch.where(t == 0, nll, kl)


def _mean_flat(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=tuple(range(1, x.dim())))


def _normal_kl(mean1, logvar1, mean2, logvar2):
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + ((mean1 - mean2) ** 2) * torch.exp(-logvar2))


def _approx_standard_normal_cdf(x):
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                   * (x + 0.044715 * x ** 3)))


def _discretized_gaussian_log_likelihood(x, means, log_scales):
    centered = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = _approx_standard_normal_cdf(inv_stdv * (centered + 1.0 / 255.0))
    cdf_min = _approx_standard_normal_cdf(inv_stdv * (centered - 1.0 / 255.0))
    log_cdf_plus = torch.log(torch.clamp(cdf_plus, min=1e-12))
    log_one_minus_cdf_min = torch.log(torch.clamp(1.0 - cdf_min, min=1e-12))
    log_cdf_delta = torch.log(torch.clamp(cdf_plus - cdf_min, min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min,
                                   log_cdf_delta))


# the samplers that walk the spaced timestep grid (a ReferenceNet table
# hoisted over that grid serves them); the others take float times
SPACED_SAMPLERS = ("p", "ddim", "dpm++2m", "unipc")


def model_calls(sampler: str, steps: int) -> int:
    """Denoiser calls of one `sample_loop` run of `steps` spaced steps."""
    if sampler == "unipc":
        return 2 * steps
    if sampler == "dpm++fast":
        from xtts_tpu_torch.diffusion.solvers import _singlestep_orders
        return sum(_singlestep_orders(steps, 3))
    return steps
