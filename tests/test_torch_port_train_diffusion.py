"""The diffusion trainer's parts against the JAX package's on the CPU, f32:
the beta schedules, `training_losses` (both branches of the vb term: the
decoder NLL at t = 0, the KL at t > 0), the loss-second-moment timestep
sampler, PatchDropout's selection, and the whole diffusion loss
(train/steps.py make_diffusion_loss: the frozen DVAE's codes, the frozen
GPT's latents, the uncond-hint substitution, PatchDropout and the vb term)
with its gradients against jax.grad's, the draws fixed on both sides.
Also P7: no training forward of the CLI's model (flash=False, as JAX's
trainers) reaches flash_mha, while the serving model's does at the same
shapes; and the whole loss with flash=True, through K2's forward and
backward (the autograd Function's CPU twins), against JAX's flash=True
loss at 600 | 900 (rtol 1e-3 / atol 1e-4).

Tolerances: schedules within 1e-12 relative (float64 on both sides, the
cosine through libm); training_losses' loss, mse and vb within 1e-4
relative; the sampler's weights within 1e-6 relative and its history and
counts equal; the diffusion loss within 1e-4 relative and every gradient
within rtol 1e-4 / atol 1e-6 of jax.grad's (as test_torch_port_train_
losses.py holds them), except the output conv's variance rows, which
carry the t = 0 decoder NLL's ill-conditioned gradient: those within 1e-3
of their norm.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xtts_tpu.core.config import (CLIPRefConfig, DiffusionModelConfig,  # noqa: E402
                                  DVAEConfig, GPTConfig)
from xtts_tpu.diffusion import gaussian as jg, resample as jrs  # noqa: E402
from xtts_tpu.models import aa_diffusion as jad, dvae as jdv, gpt as jgpt  # noqa: E402
from xtts_tpu.train import steps as jsteps  # noqa: E402
from xtts_tpu_torch.core import config as tcfg  # noqa: E402
from xtts_tpu_torch.diffusion import gaussian as tg, resample as trs  # noqa: E402
from xtts_tpu_torch.models import aa_diffusion as tad  # noqa: E402
from xtts_tpu_torch.models import dvae as tdv, gpt as tgpt  # noqa: E402
from xtts_tpu_torch.train import steps as tsteps  # noqa: E402
from xtts_tpu_torch.utils import convert  # noqa: E402
from test_torch_port_e2e import one_torch_thread  # noqa: E402,F401

MB = 8
DVAE_CFG = DVAEConfig(channels=MB, num_tokens=30, hidden_dim=16,
                      num_resnet_blocks=1, codebook_dim=16, num_layers=2)
GPT_CFG = GPTConfig(layers=1, model_dim=32, heads=2, max_mel_tokens=24,
                    max_text_tokens=16, number_text_tokens=16,
                    start_text_token=15, number_mel_codes=32,
                    start_mel_token=30, stop_mel_token=31, mel_bins=MB,
                    cond_attn_blocks=1)
DIFF_CFG = DiffusionModelConfig(
    in_channels=MB, out_channels=2 * MB, model_channels=32,
    num_res_blocks=1, channel_mult=(1,), num_heads=2, context_dim=32,
    in_latent_channels=32,
    clip=CLIPRefConfig(embed_dim=32, width=32, layers=1, head_width=16,
                       patch_size=4, in_channels=MB, max_patches=64))
GRAD = dict(rtol=1e-4, atol=1e-6)


def fill(shapes, rng):
    """Every leaf of a shape tree drawn: norms near 1, biases and vectors
    small, matrices and kernels lecun-scaled."""
    out = {}
    for k, v in shapes.items():
        if isinstance(v, dict):
            out[k] = fill(v, rng)
            continue
        if k == "scale":
            x = 1.0 + 0.1 * rng.standard_normal(v.shape)
        elif k == "embedding":
            x = 0.3 * rng.standard_normal(v.shape)
        elif k == "bias" or len(v.shape) <= 1:
            x = 0.1 * rng.standard_normal(v.shape)
        else:
            x = rng.standard_normal(v.shape) / np.sqrt(np.prod(v.shape[:-1]))
        out[k] = x.astype(np.float32)
    return out


def _shapes(module, *args, **kw):
    """The variables' shapes by tracing alone (a compiled flax init costs
    more than the comparisons)."""
    return jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args,
                                              **kw))


@pytest.fixture(scope="module")
def models():
    """The JAX models and the port's, the same drawn weights in both."""
    rng = np.random.default_rng(0)
    jd = jad.AADiffusion(DIFF_CFG)
    dparams = fill(_shapes(jd, jnp.zeros((1, MB, 16)), jnp.array([0]),
                           jnp.zeros((1, 32, 4)),
                           jnp.zeros((1, MB, 16)))["params"], rng)
    jgm = jgpt.UnifiedVoice(GPT_CFG)
    gparams = fill(_shapes(jgm, jnp.zeros((1, MB, 16)),
                           jnp.zeros((1, 8), jnp.int32), jnp.array([8]),
                           jnp.zeros((1, 4), jnp.int32),
                           jnp.array([4096]))["params"], rng)
    jdm = jdv.DVAE(DVAE_CFG)
    vshapes = _shapes(jdm, jnp.zeros((1, MB, 32)))
    vvars = {"params": fill(vshapes["params"], rng),
             "codebook": {k: rng.standard_normal(v.shape).astype(np.float32)
                          for k, v in vshapes["codebook"].items()}}
    td = tad.AADiffusion(tcfg.DiffusionModelConfig.from_dict(
        DIFF_CFG.to_dict()))
    td.load_state_dict(convert.to_torch(convert.aa_diffusion_from_jax(
        {"params": dparams}, td.cfg), "cpu"))
    tgm = tgpt.UnifiedVoice(tcfg.GPTConfig.from_dict(GPT_CFG.to_dict()))
    tgm.load_state_dict(convert.to_torch(convert.unified_voice_from_jax(
        {"params": gparams}, GPT_CFG.layers, GPT_CFG.cond_attn_blocks),
        "cpu"))
    tdm = tdv.DVAE(tcfg.DVAEConfig.from_dict(DVAE_CFG.to_dict()))
    tdm.load_state_dict(convert.to_torch(convert.dvae_from_jax(
        vvars, DVAE_CFG.num_layers, DVAE_CFG.num_resnet_blocks), "cpu"))
    return dict(jd=jd, dparams=dparams, jgm=jgm, gvars={"params": gparams},
                jdm=jdm, vvars=vvars, td=td, tgm=tgm.eval(), tdm=tdm.eval())


@pytest.mark.parametrize("name,n", [("linear", 1000), ("cosine", 1000),
                                    ("linear", 100)])
def test_beta_schedules_match_jax(name, n):
    np.testing.assert_allclose(tg.get_named_beta_schedule(name, n),
                               jg.get_named_beta_schedule(name, n),
                               rtol=1e-12, atol=0)


@pytest.mark.parametrize("schedule", ["linear", "cosine"])
def test_training_losses_both_branches(schedule):
    """A fixed stand-in model (the same function of x_t and t in both), an
    explicit noise, t = 0 (the decoder NLL) and t > 0 (the KL). The mse of
    every row, the loss and vb of the t > 0 rows within 1e-4. At t = 0 the
    NLL is held element by element: at beta_0 ~ 1e-4 the scale is ~1/100,
    and where both CDFs of the +-1/255 bin round to 1 in f32 the bin's
    mass is decided by one ulp of tanh (XLA's against ATen's), so an
    element whose mass is below 1e-6 on the JAX side must be below 1e-6
    (log -13.8) on the port's too; every other element within 1e-4; and
    the t = 0 rows' vb is the mean of the port's NLL in bits.

    The bound on the others: each CDF is 0.5 (1 + tanh), and near 1 an f32
    tanh is one ulp (2^-24) from another implementation's, so the bin's
    mass m moves by up to 2 2^-24 and its log by 2 2^-24 / m; the check
    allows twice that beside 1e-4 relative."""
    rng = np.random.default_rng(3)
    x0 = np.clip(rng.standard_normal((4, MB, 20)) * 0.6, -1.2, 1.2
                 ).astype(np.float32)
    noise = rng.standard_normal(x0.shape).astype(np.float32)
    t = np.array([0, 0, 17, 640], np.int32)
    w = rng.standard_normal((2 * MB, MB)).astype(np.float32) * 0.3

    def jfn(x, tt):
        h = jnp.einsum("oc,bct->bot", w, x)
        return jnp.tanh(h + (tt[:, None, None] / 1000.0))

    def tfn(x, tt):
        h = torch.einsum("oc,bct->bot", torch.from_numpy(w), x)
        return torch.tanh(h + (tt[:, None, None] / 1000.0))

    jgd = jg.GaussianDiffusion(betas=jg.get_named_beta_schedule(schedule,
                                                                1000))
    tgd = tg.GaussianDiffusion(betas=tg.get_named_beta_schedule(schedule,
                                                                1000))
    want = jax.jit(lambda x, n: jgd.training_losses(
        jfn, x, jnp.asarray(t), noise=n))(x0, noise)
    got = tgd.training_losses(tfn, torch.from_numpy(x0),
                              torch.from_numpy(t).long(),
                              torch.from_numpy(noise))
    tol = dict(rtol=1e-4, atol=1e-7)
    for k in ("mse", "x_start_predicted"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **tol, err_msg=k)
    for k in ("loss", "vb"):
        np.testing.assert_allclose(got[k].numpy()[2:],
                                   np.asarray(want[k])[2:], **tol,
                                   err_msg=k)
    # the t = 0 rows: the decoder NLL, element by element
    x0_, t0 = torch.from_numpy(x0[:2]), torch.zeros(2, dtype=torch.long)
    xt = tgd.q_sample(x0_, t0, torch.from_numpy(noise[:2]))
    pmv = tgd.p_mean_variance_from_output(tfn(xt, t0).float(), xt, t0)
    mean, half = pmv["mean"], 0.5 * pmv["log_variance"]
    nll_t = tg._discretized_gaussian_log_likelihood(x0_, mean, half).numpy()
    nll_j = np.asarray(jg._discretized_gaussian_log_likelihood(
        x0[:2], mean.numpy(), half.numpy()))
    low = np.log(1e-6)
    sat = nll_j < low
    assert (nll_t[sat] < low).all()
    gap = np.abs(nll_t - nll_j)[~sat]
    allowed = (1e-4 * np.abs(nll_j) + 4 * 2.0 ** -24 / np.exp(nll_j))[~sat]
    assert (gap <= allowed).all(), (gap - allowed).max()
    np.testing.assert_allclose(got["vb"].numpy()[:2],
                               -nll_t.mean(axis=(1, 2)) / np.log(2.0),
                               rtol=1e-6)
    assert np.isclose(got["loss"].numpy()[:2],
                      got["mse"].numpy()[:2] + got["vb"].numpy()[:2]).all()


def test_loss_second_moment_sampler_matches_jax():
    """Weights before and after warm-up, the update (with a t drawn twice:
    the last loss kept, counted twice) and the importance weights of a
    given t."""
    T, H = 12, 3
    rng = np.random.default_rng(4)
    jr = jrs.LossSecondMomentResampler(T, history_per_term=H)
    tr = trs.LossSecondMomentResampler(T, history_per_term=H)
    hist = rng.random((T, H)).astype(np.float32)
    for counts in (np.full(T, H - 1, np.int32),
                   np.arange(H, H + T).astype(np.int32)):
        js = jrs.LossAwareState(jnp.asarray(hist), jnp.asarray(counts))
        ts = trs.LossAwareState(torch.from_numpy(hist),
                                torch.from_numpy(counts))
        np.testing.assert_allclose(tr.weights(ts).numpy(),
                                   np.asarray(jr.weights(js)), rtol=1e-6)
        t = np.array([3, 7, 3, 11, 0], np.int32)
        losses = rng.random(5).astype(np.float32)
        jn = jr.update(js, jnp.asarray(t), jnp.asarray(losses))
        tn = tr.update(ts, torch.from_numpy(t).long(),
                       torch.from_numpy(losses))
        np.testing.assert_array_equal(tn.history.numpy(),
                                      np.asarray(jn.history))
        np.testing.assert_array_equal(tn.counts.numpy(),
                                      np.asarray(jn.counts))
        p = np.asarray(jr.weights(js))
        _, w = tr.sample(torch.Generator().manual_seed(0), 64, ts)
        t_d, w_d = tr.sample(torch.Generator().manual_seed(0), 64, ts)
        np.testing.assert_allclose(w_d.numpy(), 1.0 / (T * p[t_d.numpy()]),
                                   rtol=1e-6)
        assert torch.equal(w, w_d)


def test_patch_dropout_selection_is_jax_top_k():
    """The kept patches are the cls token, then the top_k of the draw in
    descending order (lax.top_k's rule), keep = max(1, int(n (1 - p)))."""
    rng = np.random.default_rng(5)
    b, n, c, p = 3, 11, 4, 0.4
    x = rng.standard_normal((b, n + 1, c)).astype(np.float32)
    rand = rng.standard_normal((b, n)).astype(np.float32)
    keep = max(1, int(n * (1.0 - p)))
    assert tad.patch_keep(n, p) == keep
    _, idx = jax.lax.top_k(jnp.asarray(rand), keep)
    want = np.concatenate(
        [x[:, :1], np.take_along_axis(x[:, 1:], np.asarray(idx)[..., None],
                                      axis=1)], axis=1)
    got = tad.patch_dropout(torch.from_numpy(x), p, torch.from_numpy(rand))
    np.testing.assert_array_equal(got.numpy(), want)


def _batch(seed=6):
    rng = np.random.default_rng(seed)
    t_mel = 24
    return {"mel": rng.standard_normal((3, MB, t_mel)).astype(np.float32),
            "refer_mel": rng.standard_normal((3, MB, 40)).astype(np.float32),
            "text": rng.integers(1, 14, (3, 7)).astype(np.int32),
            "text_lengths": np.array([7, 4, 5], np.int32),
            "wav_lengths": np.array([24, 15, 20], np.int32) * 256}


def test_diffusion_loss_and_grads_match_jax(models, monkeypatch):
    """make_diffusion_loss against JAX's with the draws fixed: t (0 and two
    t > 0), the noise, the unconditioned rows (one of three) and the
    PatchDropout draw, injected into JAX's jax.random calls."""
    m = models
    batch = _batch()
    rng = np.random.default_rng(7)
    n_patch = 40 // DIFF_CFG.clip.patch_size
    draws = {"t": np.array([0, 412, 977], np.int32),
             "uncond": np.array([False, True, False]),
             "noise": rng.standard_normal((3, MB, 24)).astype(np.float32),
             "patch_rand": rng.standard_normal((3, n_patch)
                                               ).astype(np.float32)}
    u = np.where(draws["uncond"], 0.05, 0.5).astype(np.float32)

    def normal(key, shape=(), dtype=jnp.float32):
        shape = tuple(shape)
        for k in ("noise", "patch_rand"):
            if shape == draws[k].shape:
                return jnp.asarray(draws[k])
        raise AssertionError(f"unexpected normal draw {shape}")

    monkeypatch.setattr(jax.random, "normal", normal)
    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, lo, hi, *a, **k:
                        jnp.asarray(draws["t"]))
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape=(), *a, **k: jnp.asarray(u))
    jgd = jg.GaussianDiffusion(betas=jg.get_named_beta_schedule("linear",
                                                                1000))
    jloss = jsteps.make_diffusion_loss(m["jd"], jgd, m["jgm"], m["gvars"],
                                       m["jdm"], m["vvars"], 0.1)
    (jl, jaux), jgrad = jax.jit(jax.value_and_grad(
        lambda p, b: jloss(p, {}, b, jax.random.PRNGKey(0)),
        has_aux=True))(m["dparams"], batch)
    monkeypatch.undo()

    tgd = tg.GaussianDiffusion(betas=tg.get_named_beta_schedule("linear",
                                                                1000))
    tloss = tsteps.make_diffusion_loss(m["td"], tgd, m["tgm"], m["tdm"],
                                       0.1)
    tb = {k: torch.from_numpy(v).long() if v.dtype == np.int32
          else torch.from_numpy(v) for k, v in batch.items()}
    td = {"t": torch.from_numpy(draws["t"]).long(),
          "w": torch.ones(3), "uncond": torch.from_numpy(draws["uncond"]),
          "noise": torch.from_numpy(draws["noise"]),
          "patch_rand": torch.from_numpy(draws["patch_rand"])}
    m["td"].zero_grad(set_to_none=True)
    tl, taux = tloss(tb, None, draws=td)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-4)
    for k in ("mse", "vb"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=1e-4, err_msg=k)
    want = convert.aa_diffusion_from_jax(
        {"params": jax.tree_util.tree_map(np.asarray, jgrad)}, m["td"].cfg)
    unused = 0
    for n, p in m["td"].named_parameters():
        # a ReferenceNet part past its last exported feature is outside
        # the graph: JAX's gradient there is zero
        g = (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
        unused += p.grad is None
        assert p.grad is not None or n.startswith("refer_model."), n
        if n.startswith("base_model.out.2."):
            # the output conv's variance rows take the t = 0 row's decoder
            # NLL gradient, whose bin masses one ulp of tanh decides (see
            # test_training_losses_both_branches): those rows as a whole
            # within 1e-3 of their norm (1.2e-4 read; with every t > 0 they
            # meet the elementwise bound), the eps rows element by element
            v, wv = g[MB:], want[n][MB:]
            assert np.linalg.norm(v - wv) <= 1e-3 * np.linalg.norm(wv), n
            g, w = g[:MB], want[n][:MB]
        else:
            w = want[n]
        np.testing.assert_allclose(g, w, **GRAD, err_msg=n)
    assert unused > 0
    # every parameter learns: the uncond row reaches the embedding, the
    # ReferenceNet and CLIP tower their gradients
    assert float(m["td"].unconditioned_cat_embedding.grad.abs().sum()) > 0


def test_latent_pass_zeroes_the_padding(models):
    """diffusion_latent_fn: the frozen latents past ceil(wav / 1024) + 1
    codes are zero, the rest the GPT's own latents."""
    m = models
    tb = {k: torch.from_numpy(v).long() if v.dtype == np.int32
          else torch.from_numpy(v) for k, v in _batch().items()}
    lat = tsteps.diffusion_latent_fn(m["tgm"], m["tdm"])(tb)
    n_keep = np.ceil(_batch()["wav_lengths"] / 1024).astype(int) + 1
    for i, k in enumerate(n_keep):
        assert float(lat[i, :, k:].abs().sum()) == 0.0
        assert float(lat[i, :, :k].abs().min(dim=0).values.max()) > 0
    assert not lat.requires_grad


def test_training_forward_never_reaches_k2(monkeypatch):
    """P7: at a width where the consumer attention's Tq * Tk >= 2^19, the
    trainer's model (flash=False, the registry's and the CLI's default)
    never calls flash_mha in a training forward; the serving API's
    (flash=True) calls it at the same shapes."""
    calls = [0]
    plain = tad.flash_mha

    def counted(*a, **k):
        calls[0] += 1
        return plain(*a, **k)

    monkeypatch.setattr(tad, "flash_mha", counted)
    cfg = tcfg.DiffusionModelConfig.from_dict(DIFF_CFG.to_dict())
    cfg = cfg.replace(clip=cfg.clip.replace(max_patches=128))
    rng = np.random.default_rng(8)
    tx, tr = 600, 300
    assert tx * (tx + tr) >= 1 << 19
    x = torch.from_numpy(rng.standard_normal((1, MB, tx)).astype(np.float32))
    hint = torch.from_numpy(rng.standard_normal((1, 32, tx // 4)
                                                ).astype(np.float32))
    refer = torch.from_numpy(rng.standard_normal((1, MB, tr)
                                                 ).astype(np.float32))
    t = torch.tensor([100])
    g = torch.Generator().manual_seed(0)
    from xtts_tpu_torch.utils.registry import load_model
    trained = load_model("diffusion", tcfg.XTTSConfig(diffusion=cfg),
                         device="cpu", generator=g)
    out = trained(x, t, hint, refer, uncond_mask=torch.tensor([False]),
                  train=True, generator=g)
    out.float().pow(2).mean().backward()
    assert calls[0] == 0
    assert trained.base_model.blocks[1][1].transformer_blocks[0] \
        .attn1.to_q.weight.grad is not None
    serving = tad.AADiffusion(cfg, flash=True)
    with torch.no_grad():
        serving(x, t, hint, refer)
    assert calls[0] == 1      # the consumer attn1 of its one transformer


# ---------------------------------------------------------------------------
# The slice as a whole: the diffusion loss with flash=True, through K2's
# forward and backward, at Tq * Tk >= 2^19


T_LONG, R_LONG = 600, 300       # the consumer attention: 600 | 900
GPT_LONG = GPT_CFG.replace(max_mel_tokens=160)         # 150 codes
DIFF_LONG = DIFF_CFG.replace(clip=DIFF_CFG.clip.replace(max_patches=128))


@pytest.fixture(scope="module")
def flash_case():
    """JAX's make_diffusion_loss over AADiffusion(flash=True) at 600 | 900,
    its flash_mha run as JAX's own tests run it on the CPU (the reference
    core behind its padding, segment mask and slice), the draws fixed; the
    loss, aux and gradients once, for the port's cases to compare with."""
    rng = np.random.default_rng(11)
    jd = jad.AADiffusion(DIFF_LONG, flash=True)
    dparams = fill(_shapes(jd, jnp.zeros((1, MB, 16)), jnp.array([0]),
                           jnp.zeros((1, 32, 4)),
                           jnp.zeros((1, MB, 16)))["params"], rng)
    jgm = jgpt.UnifiedVoice(GPT_LONG)
    gparams = fill(_shapes(jgm, jnp.zeros((1, MB, 16)),
                           jnp.zeros((1, 8), jnp.int32), jnp.array([8]),
                           jnp.zeros((1, 4), jnp.int32),
                           jnp.array([4096]))["params"], rng)
    jdm = jdv.DVAE(DVAE_CFG)
    vshapes = _shapes(jdm, jnp.zeros((1, MB, 32)))
    vvars = {"params": fill(vshapes["params"], rng),
             "codebook": {k: rng.standard_normal(v.shape).astype(np.float32)
                          for k, v in vshapes["codebook"].items()}}
    batch = {
        "mel": rng.standard_normal((2, MB, T_LONG)).astype(np.float32),
        "refer_mel": rng.standard_normal((2, MB, R_LONG)).astype(np.float32),
        "text": rng.integers(1, 14, (2, 7)).astype(np.int32),
        "text_lengths": np.array([7, 5], np.int32),
        "wav_lengths": np.array([T_LONG, 520], np.int32) * 256}
    draws = {"t": np.array([412, 977], np.int32),
             "uncond": np.array([False, True]),
             "noise": rng.standard_normal((2, MB, T_LONG)).astype(np.float32),
             "patch_rand": rng.standard_normal(
                 (2, R_LONG // DIFF_CFG.clip.patch_size)).astype(np.float32)}
    u = np.where(draws["uncond"], 0.05, 0.5).astype(np.float32)

    def normal(key, shape=(), dtype=jnp.float32):
        for k in ("noise", "patch_rand"):
            if tuple(shape) == draws[k].shape:
                return jnp.asarray(draws[k])
        raise AssertionError(f"unexpected normal draw {shape}")

    from xtts_tpu.nn import flash_attn as jfa
    ref_core = jfa.flash_mha
    calls = [0]

    def flash_ref(*a, **k):
        calls[0] += 1
        return ref_core(*a, core="reference", **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", normal)
        mp.setattr(jax.random, "randint", lambda key, shape, lo, hi, *a, **k:
                   jnp.asarray(draws["t"]))
        mp.setattr(jax.random, "uniform",
                   lambda key, shape=(), *a, **k: jnp.asarray(u))
        mp.setattr(jfa, "flash_available", lambda: True)
        mp.setattr(jfa, "flash_mha", flash_ref)
        jgd = jg.GaussianDiffusion(betas=jg.get_named_beta_schedule(
            "linear", 1000))
        jloss = jsteps.make_diffusion_loss(jd, jgd, jgm, {"params": gparams},
                                           jdm, vvars, 0.1)
        (jl, jaux), jgrad = jax.jit(jax.value_and_grad(
            lambda p, b: jloss(p, {}, b, jax.random.PRNGKey(0)),
            has_aux=True))(dparams, batch)
    assert calls[0] >= 1           # JAX's consumer attention took the gate
    td_cfg = tcfg.DiffusionModelConfig.from_dict(DIFF_LONG.to_dict())
    tgm = tgpt.UnifiedVoice(tcfg.GPTConfig.from_dict(GPT_LONG.to_dict()))
    tgm.load_state_dict(convert.to_torch(convert.unified_voice_from_jax(
        {"params": gparams}, GPT_LONG.layers, GPT_LONG.cond_attn_blocks),
        "cpu"))
    tdm = tdv.DVAE(tcfg.DVAEConfig.from_dict(DVAE_CFG.to_dict()))
    tdm.load_state_dict(convert.to_torch(convert.dvae_from_jax(
        vvars, DVAE_CFG.num_layers, DVAE_CFG.num_resnet_blocks), "cpu"))
    sd = convert.to_torch(convert.aa_diffusion_from_jax(
        {"params": dparams}, td_cfg), "cpu")
    return dict(jl=float(jl), jaux={k: float(jaux[k]) for k in ("mse", "vb")},
                want=convert.aa_diffusion_from_jax(
                    {"params": jax.tree_util.tree_map(np.asarray, jgrad)},
                    td_cfg),
                cfg=td_cfg, sd=sd, tgm=tgm.eval(), tdm=tdm.eval(),
                batch=batch, draws=draws)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_flash_diffusion_loss_and_grads_match_jax(flash_case, monkeypatch,
                                                  remat):
    """make_diffusion_loss over the port's AADiffusion(flash=True) at
    600 | 900 (each consumer attention through flash_mha's autograd
    Function: the twins with lse on the CPU), against JAX's flash=True loss
    and jax.grad at the diffusion tolerances, rtol 1e-3 / atol 1e-4; once
    with remat="full" (the Function under torch.utils.checkpoint)."""
    c = flash_case
    calls = [0]
    inner = tad.flash_mha

    def counted(*a, **k):
        calls[0] += 1
        return inner(*a, **k)

    monkeypatch.setattr(tad, "flash_mha", counted)
    td = tad.AADiffusion(c["cfg"].replace(remat=remat), flash=True)
    td.load_state_dict(c["sd"])
    tgd = tg.GaussianDiffusion(betas=tg.get_named_beta_schedule("linear",
                                                                1000))
    tloss = tsteps.make_diffusion_loss(td, tgd, c["tgm"], c["tdm"], 0.1)
    tb = {k: torch.from_numpy(v).long() if v.dtype == np.int32
          else torch.from_numpy(v) for k, v in c["batch"].items()}
    d = c["draws"]
    draws = {"t": torch.from_numpy(d["t"]).long(), "w": torch.ones(2),
             "uncond": torch.from_numpy(d["uncond"]),
             "noise": torch.from_numpy(d["noise"]),
             "patch_rand": torch.from_numpy(d["patch_rand"])}
    tl, taux = tloss(tb, None, draws=draws)
    tl.backward()
    assert calls[0] >= 1
    tol = dict(rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(float(tl.detach()), c["jl"], **tol)
    for k in ("mse", "vb"):
        np.testing.assert_allclose(float(taux[k]), c["jaux"][k], **tol,
                                   err_msg=k)
    for n, p in td.named_parameters():
        g = (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
        np.testing.assert_allclose(g, c["want"][n], **tol, err_msg=n)
    attn = td.base_model.blocks[1][1].transformer_blocks[0].attn1
    assert float(attn.to_q.weight.grad.abs().sum()) > 0
