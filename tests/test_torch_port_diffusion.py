"""Port parity: AA-diffusion model and the Gaussian diffusion process
(xtts_tpu_torch vs xtts_tpu), f32 on the CPU, weights carried by
utils.convert.aa_diffusion_from_jax. eps/var at rtol 1e-3 / atol 1e-4."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xtts_tpu.core.config import CLIPRefConfig, DiffusionModelConfig  # noqa
from xtts_tpu_torch.core import config as tcfg  # noqa: E402
from xtts_tpu.diffusion import gaussian as jg  # noqa: E402
from xtts_tpu.models import aa_diffusion as jad  # noqa: E402
from xtts_tpu_torch.diffusion import gaussian as tg  # noqa: E402
from xtts_tpu_torch.models import aa_diffusion as tad  # noqa: E402
from xtts_tpu_torch.utils import convert  # noqa: E402
from test_torch_port_e2e import shaped_zeros  # noqa: E402

CFG = DiffusionModelConfig(
    in_channels=8, out_channels=16, model_channels=64, num_res_blocks=1,
    channel_mult=(1, 1), num_heads=2, context_dim=32, in_latent_channels=128,
    clip=CLIPRefConfig(embed_dim=32, width=32, layers=2, head_width=16,
                       patch_size=4, in_channels=8, max_patches=64))
TOL = dict(rtol=1e-3, atol=1e-4)


def randomize(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = randomize(v, rng)
            continue
        v = np.asarray(v)
        if k == "scale":
            x = 1.0 + 0.1 * rng.standard_normal(v.shape)
        elif k == "bias" or v.ndim <= 1:
            x = 0.1 * rng.standard_normal(v.shape)
        else:
            x = rng.standard_normal(v.shape) / np.sqrt(np.prod(v.shape[:-1]))
        out[k] = x.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def models():
    jm = jad.AADiffusion(CFG)
    # the compiled init's shapes and key order by tracing alone
    # (randomize redraws every leaf: the same draws)
    init = shaped_zeros(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 16)), jnp.array([0]),
        jnp.zeros((1, 128, 4)), jnp.zeros((1, 8, 16))))
    params = randomize(init["params"], np.random.default_rng(0))
    port_cfg = tcfg.DiffusionModelConfig.from_dict(CFG.to_dict())
    tm = tad.AADiffusion(port_cfg).eval()
    tm.load_state_dict(convert.to_torch(device="cpu", sd=convert.aa_diffusion_from_jax(
        params, port_cfg)))
    return jm, {"params": params}, tm


def _inputs(seed=1, b=2, tx=24, tl=6, tr=20):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 8, tx)).astype(np.float32),
            np.array([5, 900][:b], np.int32),
            rng.standard_normal((b, 128, tl)).astype(np.float32),
            rng.standard_normal((b, 8, tr)).astype(np.float32))


def _t(a):
    return torch.from_numpy(a).long() if a.dtype == np.int32 else \
        torch.from_numpy(a)


def test_encode_reference_and_features(models):
    jm, jv, tm = models
    _, t, _, refer = _inputs()
    jctx = jm.apply(jv, refer, method=jm.encode_reference)
    jfe = jm.apply(jv, refer, t, jctx, method=jm.reference_features)
    with torch.no_grad():
        tctx = tm.encode_reference(_t(refer))
        tfe = tm.reference_features(_t(refer), _t(t), tctx)
    np.testing.assert_allclose(tctx.numpy(), np.asarray(jctx), **TOL)
    assert len(tfe) == len(jfe) == 2
    for a, b in zip(tfe, jfe):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_denoise_eps_var(models):
    jm, jv, tm = models
    x, t, hint, refer = _inputs(2)
    hint_r = np.repeat(hint, 4, axis=2)
    jctx = jm.apply(jv, refer, method=jm.encode_reference)
    jfe = jm.apply(jv, refer, t, jctx, method=jm.reference_features)
    jout = jm.apply(jv, x, t, hint_r, jctx, jfe, method=jm.denoise)
    with torch.no_grad():
        tctx = tm.encode_reference(_t(refer))
        tfe = tm.reference_features(_t(refer), _t(t), tctx)
        tout = tm.denoise(_t(x), _t(t), _t(hint_r), tctx, tfe)
    assert tout.shape == (2, 16, 24)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)


@pytest.mark.parametrize("cfree", [False, True])
def test_staged_forward_matches_jax_call(models, cfree):
    """The port's stages, composed as the render composes them (hint
    resized to 4x, or the unconditioned embedding), against JAX's
    monolithic AADiffusion.__call__."""
    jm, jv, tm = models
    x, t, hint, refer = _inputs(3)
    jout = jm.apply(jv, x, t, hint, refer, conditioning_free=cfree)
    with torch.no_grad():
        h = (tm.uncond_hint(2, x.shape[-1]) if cfree else
             tad.nearest_resize_time(_t(hint).transpose(1, 2),
                                     x.shape[-1]).transpose(1, 2))
        ctx = tm.encode_reference(_t(refer))
        fe = tm.reference_features(_t(refer), _t(t), ctx)
        tout = tm.denoise(_t(x), _t(t), h, ctx, fe)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)


def test_resize_and_tacotron_norm():
    x = np.random.default_rng(4).standard_normal((2, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tad.nearest_resize_time(torch.from_numpy(x), 30).numpy(),
        np.asarray(jad.nearest_resize_time(jnp.asarray(x), 30)))
    m = (x * 10).astype(np.float32)
    np.testing.assert_allclose(
        tad.normalize_tacotron_mel(torch.from_numpy(m)).numpy(),
        np.asarray(jad.normalize_tacotron_mel(jnp.asarray(m))), rtol=1e-6)
    np.testing.assert_allclose(
        tad.denormalize_tacotron_mel(torch.from_numpy(m)).numpy(),
        np.asarray(jad.denormalize_tacotron_mel(jnp.asarray(m))), rtol=1e-6)


@pytest.mark.parametrize("steps", [50, 10, 25])
def test_spaced_schedule_tables(steps):
    want = jg.GaussianDiffusion.spaced(1000, steps)
    got = tg.GaussianDiffusion.spaced(1000, steps)
    np.testing.assert_array_equal(got.timestep_map, want.timestep_map)
    for name in ("betas", "posterior_log_variance_clipped",
                 "posterior_mean_coef1", "posterior_mean_coef2",
                 "sqrt_recipm1_alphas_cumprod"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))


@pytest.mark.parametrize("t", [0, 1, 25, 49])
def test_p_mean_variance_cfg_ramp(t):
    jgd = jg.GaussianDiffusion.spaced(1000, 50, conditioning_free=True,
                                      conditioning_free_k=2.0,
                                      ramp_conditioning_free=True)
    tgd = tg.GaussianDiffusion.spaced(1000, 50, conditioning_free_k=2.0)
    rng = np.random.default_rng(t)
    out, out_uc, x = (rng.standard_normal(s).astype(np.float32) for s in
                      ((2, 16, 12), (2, 16, 12), (2, 8, 12)))
    tt = np.full((2,), t, np.int32)
    want = jgd.p_mean_variance_from_output(jnp.asarray(out), jnp.asarray(x),
                                           jnp.asarray(tt), jnp.asarray(out_uc))
    got = tgd.p_mean_variance_from_output(_t(out), _t(x), _t(tt), _t(out_uc))
    for k in ("mean", "log_variance", "pred_xstart", "eps"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_ddim_chain_from_shared_xt(models):
    """A whole 6-step DDIM chain with the paired-CFG model call, from the
    same x_T: deterministic (eta = 0), so the two chains must agree."""
    jm, jv, tm = models
    _, _, hint, refer = _inputs(5, b=1, tx=16)
    hint = np.repeat(hint, 4, axis=2)[:, :, :16]
    jgd = jg.GaussianDiffusion.spaced(1000, 6, conditioning_free=True,
                                      conditioning_free_k=2.0)
    tgd = tg.GaussianDiffusion.spaced(1000, 6, conditioning_free_k=2.0)
    xt = np.random.default_rng(6).standard_normal((1, 8, 16)).astype(
        np.float32)
    jctx = jm.apply(jv, refer, method=jm.encode_reference)
    juc = jm.apply(jv, 1, 16, method=jm.uncond_hint)

    def jfn(x, t):
        fe = jm.apply(jv, refer, t, jctx, method=jm.reference_features)
        c = jm.apply(jv, x, t, hint, jctx, fe, method=jm.denoise)
        u = jm.apply(jv, x, t, juc, jctx, fe, method=jm.denoise)
        return c, u

    want = jgd.ddim_sample_loop(jfn, xt.shape, jax.random.PRNGKey(0),
                                noise=jnp.asarray(xt))
    with torch.no_grad():
        tctx = tm.encode_reference(_t(refer))
        tuc = tm.uncond_hint(1, 16)

        def tfn(x, t):
            fe = tm.reference_features(_t(refer), t, tctx)
            return (tm.denoise(x, t, _t(hint), tctx, fe),
                    tm.denoise(x, t, tuc, tctx, fe))

        got = tgd.ddim_sample_loop(tfn, xt.shape, noise=_t(xt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_p_sample_loop_generator_determinism(models):
    _, _, tm = models
    gd = tg.GaussianDiffusion.spaced(1000, 4)
    fn = lambda x, t: torch.cat([x * 0.5, torch.zeros_like(x)], dim=1)
    runs = [gd.p_sample_loop(fn, (1, 8, 10), torch.Generator().manual_seed(3),
                             device="cpu") for _ in range(2)]
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)
    assert torch.isfinite(runs[0]).all()
