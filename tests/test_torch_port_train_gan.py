"""The CLVP, classifier and GAN trainers' parts against the JAX package's on
the CPU, f32, weights carried by utils.convert: the CLVP InfoNCE loss, the
classifier's logits and CE (with and without distribute_zero_label) and
the noise scorer, the HiFi-GAN discriminators' scores and features, each
GAN loss, and one GANTrainer step (the discriminator's update, then the
generator's against it, each with clip + AdamW(0.8, 0.99)) against JAX's
with optax; and the new converters both ways where JAX has the reference
direction.

Tolerances: logits, scores and features within 1e-4 (rtol and atol: f32
sums in another order); losses within 1e-4 relative (the STFT losses 1e-4
relative of a float32 FFT's); gradients within rtol 1e-4 / atol 1e-6
(test_torch_port_train_losses.py's), the generator's in the GAN step
within 1e-3 of each tensor's norm (the log-magnitude STFT loss; see
test_gan_trainer_step_matches_optax); parameters after the GAN step
within 1% of the largest possible move (atol 3 lr 1e-2,
test_torch_port_train_core.py's) plus what the gradient gap moves Adam's
first update."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xtts_tpu.core.config import ClassifierConfig, CLVPConfig  # noqa: E402
from xtts_tpu.models import classifier as jcls, clvp as jcl  # noqa: E402
from xtts_tpu.models import hifigan_discriminator as jdisc  # noqa: E402
from xtts_tpu.train import gan as jgan  # noqa: E402
from xtts_tpu.utils import convert as jconv  # noqa: E402
from xtts_tpu_torch.core import config as tcfg  # noqa: E402
from xtts_tpu_torch.models import classifier as tcls, clvp as tcl  # noqa: E402
from xtts_tpu_torch.models import hifigan_discriminator as tdisc  # noqa: E402
from xtts_tpu_torch.train import gan as tgan  # noqa: E402
from xtts_tpu_torch.utils import convert  # noqa: E402
from test_torch_port_e2e import one_torch_thread  # noqa: E402,F401
from test_torch_port_train_diffusion import _shapes, fill  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
GRAD = dict(rtol=1e-4, atol=1e-6)
MB = 8


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(a).long() if a.dtype == np.int32 else \
        torch.from_numpy(a)


# ---------------------------------------------------------------------------
# CLVP

CLVP_CFG = CLVPConfig(dim_text=32, dim_speech=32, dim_latent=16,
                      num_text_tokens=40, text_enc_depth=1, text_seq_len=24,
                      text_heads=2, num_speech_tokens=64, speech_enc_depth=1,
                      speech_heads=2)


def test_clvp_infonce_and_grads():
    jm = jcl.CLVP(CLVP_CFG)
    params = fill(_shapes(jm, jnp.zeros((1, 8), jnp.int32),
                          jnp.zeros((1, 8), jnp.int32))["params"],
                  np.random.default_rng(0))
    cfg_t = tcfg.CLVPConfig.from_dict(CLVP_CFG.to_dict())
    tm = tcl.CLVP(cfg_t)
    tm.load_state_dict(convert.to_torch(convert.clvp_from_jax(
        {"params": params}, cfg_t), "cpu"))
    rng = np.random.default_rng(1)
    batch = {"text": rng.integers(0, 40, (4, 20)).astype(np.int32),
             "codes": rng.integers(0, 64, (4, 30)).astype(np.int32),
             "text_mask": (np.arange(20)[None] < np.array(
                 [[20], [12], [17], [9]])).astype(np.int32),
             "code_mask": (np.arange(30)[None] < np.array(
                 [[30], [22], [8], [25]])).astype(np.int32)}
    (jl, _), jg = jax.jit(jax.value_and_grad(
        jcl.make_clvp_loss(jm), has_aux=True))(params, {}, batch, None)
    tl, _ = tcl.make_clvp_loss(tm)({k: _t(v) for k, v in batch.items()})
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-4)
    want = convert.clvp_from_jax({"params": _np(jg)}, cfg_t)
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[n], **GRAD,
                                   err_msg=n)
    # without return_loss: the similarity logits, outside autograd
    logits = tm(_t(batch["text"]), _t(batch["codes"]))
    assert logits.shape == (4, 4) and not logits.requires_grad


# ---------------------------------------------------------------------------
# classifier

CLS_CFG = ClassifierConfig(spec_dim=MB, base_channels=16, depth=2,
                           resnet_blocks=1, attn_blocks=2, num_attn_heads=2,
                           embedding_dim=32)


@pytest.fixture(scope="module")
def classifier():
    jm = jcls.AudioClassifier(CLS_CFG)
    params = fill(_shapes(jm, jnp.zeros((1, 64, MB)))["params"],
                  np.random.default_rng(2))
    cfg_t = tcfg.ClassifierConfig.from_dict(CLS_CFG.to_dict())
    tm = tcls.AudioClassifier(cfg_t)
    tm.load_state_dict(convert.to_torch(convert.classifier_from_jax(
        {"params": params}, cfg_t), "cpu"))
    return jm, params, tm


@pytest.mark.parametrize("zero_label", [False, True])
def test_classifier_ce_and_grads(classifier, zero_label):
    jm0, params, tm = classifier
    jm = jcls.AudioClassifier(CLS_CFG.replace(
        distribute_zero_label=zero_label, classes=2))
    tm.cfg = tm.cfg.replace(distribute_zero_label=zero_label)
    rng = np.random.default_rng(3)
    batch = {"mel": rng.standard_normal((5, 64, MB)).astype(np.float32),
             "label": np.array([0, 1, 0, 1, 1], np.int32)}
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        jcls.make_classifier_loss(jm), has_aux=True))(params, {}, batch,
                                                     None)
    tm.zero_grad(set_to_none=True)
    tl, taux = tcls.make_classifier_loss(tm)({k: _t(v)
                                              for k, v in batch.items()})
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-4)
    assert float(taux["acc"]) == float(jaux["acc"])
    want = convert.classifier_from_jax({"params": _np(jg)}, tm.cfg)
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[n], **GRAD,
                                   err_msg=n)
    logits = jm0.apply({"params": params}, batch["mel"])
    with torch.no_grad():
        np.testing.assert_allclose(tm(_t(batch["mel"])).numpy(),
                                   np.asarray(logits), **TOL)


def test_classifier_scorer_and_reference_names(classifier):
    """make_noise_scorer against JAX's on a short and a long mel; the
    port's state dict carried back through JAX's
    classifier_from_reference gives JAX's parameters."""
    jm, params, tm = classifier
    rng = np.random.default_rng(4)
    js = jcls.make_noise_scorer(jm, {"params": params}, crop_frames=48)
    ts = tcls.make_noise_scorer(tm, crop_frames=48)
    for t in (30, 70):
        mel = rng.standard_normal((MB, t)).astype(np.float32)
        np.testing.assert_allclose(ts(mel), js(mel), rtol=1e-4, atol=1e-6)
    back = jconv.classifier_from_reference(
        {k: v.numpy() for k, v in tm.state_dict().items()}, CLS_CFG)
    got = jax.tree_util.tree_leaves_with_path(back)
    want = dict(jax.tree_util.tree_leaves_with_path(params))
    assert len(got) == len(want)
    for path, v in got:
        np.testing.assert_array_equal(np.asarray(v), want[path])


# ---------------------------------------------------------------------------
# discriminators and GAN losses

def _disc_pair(periods=(2, 3, 5, 7, 11), scales=3, seed=5):
    jd = jdisc.HifiganDiscriminator(periods=periods, scales=scales)
    params = fill(_shapes(jd, jnp.zeros((1, 2048)))["params"],
                  np.random.default_rng(seed))
    td = tdisc.HifiganDiscriminator(periods, scales)
    td.load_state_dict(convert.to_torch(
        convert.hifigan_discriminator_from_jax({"params": params}, periods,
                                               scales), "cpu"))
    return jd, params, td


def test_discriminator_scores_and_features():
    """Every score and feature map of MPD (periods 2, 3, 5, 7, 11, a length
    that no period divides: the reflect pad) and MSD (x1, x2, x4)."""
    jd, params, td = _disc_pair()
    wav = (0.3 * np.random.default_rng(6).standard_normal((2, 1501))
           ).astype(np.float32)
    js, jf = jax.jit(lambda p, w: jd.apply({"params": p}, w))(params, wav)
    with torch.no_grad():
        ts, tf = td(torch.from_numpy(wav))
    assert len(ts) == len(js) == 8
    for i, (a, b) in enumerate(zip(ts, js)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL,
                                   err_msg=f"score {i}")
    for i, (fa, fb) in enumerate(zip(tf, jf)):
        for j, (a, b) in enumerate(zip(fa, fb)):
            # (B, C, T/p, p) / (B, C, T) against flax's channels-last
            b = np.moveaxis(np.asarray(b), -1, 1)
            np.testing.assert_allclose(a.numpy(), b, **TOL,
                                       err_msg=f"feature {i}.{j}")


def test_gan_losses():
    rng = np.random.default_rng(7)
    y = (0.3 * rng.standard_normal((2, 4096))).astype(np.float32)
    y_hat = (y + 0.1 * rng.standard_normal(y.shape)).astype(np.float32)
    want = float(jax.jit(jgan.multi_scale_stft_loss)(y_hat, y))
    got = float(tgan.multi_scale_stft_loss(torch.from_numpy(y_hat),
                                           torch.from_numpy(y)))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    sc = [rng.standard_normal((2, n)).astype(np.float32) for n in (5, 9, 3)]
    sf = [rng.standard_normal((2, n)).astype(np.float32) for n in (5, 9, 3)]
    feats = [[rng.standard_normal((2, 4, n)).astype(np.float32)
              for n in (6, 3)] for _ in range(3)]
    feats2 = [[f + 0.2 for f in fs] for fs in feats]
    tt = lambda xs: [torch.from_numpy(x) for x in xs]
    pairs = [
        (tgan.generator_adv_loss(tt(sf)), jgan.generator_adv_loss(sf)),
        (tgan.discriminator_adv_loss(tt(sc), tt(sf)),
         jgan.discriminator_adv_loss(sc, sf)),
        (tgan.feature_matching_loss([tt(f) for f in feats],
                                    [tt(f) for f in feats2]),
         jgan.feature_matching_loss(feats, feats2))]
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


STFT_RES = ((256,), (64,), (128,))


def adam_first_move_allowed(g, lr, dg):
    """What a gradient within dg of `g` (both after the clip) can move
    AdamW's first update, lr g / (|g| + eps): lr dg eps / (|g| - dg +
    eps)^2, at most 2 lr (near zero, eps turns rounding noise into a move
    of up to lr), plus 1% of the largest move (3 lr 1e-2, as
    test_torch_port_train_core.py holds the Trainer)."""
    du = np.minimum(dg * 1e-8 / (np.maximum(np.abs(g) - dg, 0) + 1e-8) ** 2,
                    2.0)
    return 3 * lr * 1e-2 + lr * du


def test_gan_trainer_step_matches_optax():
    """One GANTrainer step from the same weights and batch against JAX's
    GANTrainer: a one-layer generator (tanh of a dense map of the given
    latents to 64 samples a frame; the HifiDecoder's parity is
    test_torch_port_hifigan's), one period discriminator (period 2; the
    scale discriminators are held in test_discriminator_scores_and_
    features), one STFT resolution. JAX's grad_check gives the losses and
    both raw gradient sets (the generator's against the updated
    discriminator), and optax's update from them both parameter sets. The
    port's discriminator update (d_step) is held against them; its
    generator update (g_step) then runs against JAX's updated
    discriminator, whose near-zero gradients Adam's first update may turn
    either way. The discriminator's gradients element by element (rtol
    1e-4, atol 1e-6); the generator's within 1e-3 of each tensor's norm:
    the log-magnitude L1 divides by each STFT bin's magnitude, and in f32
    both frameworks' wave gradients of it lie 8.8e-4 (of the norm) from
    its float64 value and 2.3e-5 from each other (measured at these
    shapes). Each parameter after its update within what its gradient's
    tolerance, or its measured gap where larger, moves that update
    (adam_first_move_allowed)."""
    rng = np.random.default_rng(10)
    gparams = {"kernel": (0.3 * rng.standard_normal((16, 64))
                          ).astype(np.float32),
               "bias": (0.1 * rng.standard_normal(64)).astype(np.float32)}
    lin = torch.nn.Linear(16, 64)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(gparams["kernel"].T.copy()))
        lin.bias.copy_(torch.from_numpy(gparams["bias"]))
    jd, dparams, td = _disc_pair(periods=(2,), scales=0, seed=9)
    batch = {"wav": (0.3 * rng.standard_normal((2, 1024))).astype(np.float32),
             "latent": rng.standard_normal((2, 16, 16)).astype(np.float32)}
    lr = 1e-3

    def jgen(g, b, r):
        out = jnp.tanh(b["latent"] @ g["kernel"] + g["bias"])
        return out.reshape(out.shape[0], -1)[:, :b["wav"].shape[1]]

    jt = jgan.GANTrainer(jgen, lambda p, w: jd.apply({"params": p}, w),
                         g_lr=lr, d_lr=lr, grad_clip=1.0,
                         stft_resolutions=STFT_RES)
    jstate = jax.jit(jt.init_state)(gparams, dparams)
    d_loss, g_loss, d_grads, g_grads = jt.grad_check(
        jstate, jax.tree_util.tree_map(jnp.asarray, batch),
        jax.random.PRNGKey(0))
    # optax's update from those gradients (the step's own arithmetic)
    d_upd, _ = jax.jit(jt.d_tx.update)(d_grads, jstate.d_opt, jstate.d_params)
    g_upd, _ = jax.jit(jt.g_tx.update)(g_grads, jstate.g_opt, jstate.g_params)
    to_sd = {"d": lambda t: convert.hifigan_discriminator_from_jax(
                 {"params": _np(t)}, (2,), 0),
             "g": lambda t: {"weight": np.asarray(t["kernel"]).T,
                             "bias": np.asarray(t["bias"])}}
    want = {"d": to_sd["d"](jax.tree_util.tree_map(
                np.add, _np(jstate.d_params), _np(d_upd))),
            "g": to_sd["g"](jax.tree_util.tree_map(
                np.add, _np(jstate.g_params), _np(g_upd)))}
    jgrads = {"d": to_sd["d"](d_grads), "g": to_sd["g"](g_grads)}

    def tgen(b, latent=None):
        out = torch.tanh(lin(b["latent"]))
        return out.reshape(out.shape[0], -1)[:, :b["wav"].shape[1]]
    tt = tgan.GANTrainer(lin, td, tgen, g_lr=lr, d_lr=lr, grad_clip=1.0,
                         stft_resolutions=STFT_RES)
    tstate = tt.init_state()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    gnorm = {side: np.sqrt(sum(float((v.astype(np.float64) ** 2).sum())
                               for v in jgrads[side].values()))
             for side in ("d", "g")}

    def held(side, params, raw, norm):
        np.testing.assert_allclose(float(norm), gnorm[side], rtol=1e-4)
        clip = min(1.0, 1.0 / gnorm[side])
        for (n, p), g in zip(params.items(), raw):
            g, g_j = g.numpy(), jgrads[side][n]
            if side == "d":
                np.testing.assert_allclose(g, g_j, **GRAD,
                                           err_msg=f"{side} grad {n}")
            else:
                assert (np.linalg.norm(g - g_j)
                        <= 1e-3 * np.linalg.norm(g_j)), n
            dg = np.maximum(GRAD["rtol"] * np.abs(g_j) + GRAD["atol"],
                            np.abs(g - g_j))
            gap = np.abs(p.detach().numpy() - want[side][n])
            allowed = adam_first_move_allowed(clip * g_j, lr, clip * dg)
            assert (gap <= allowed).all(), (side, n, (gap - allowed).max())

    t_dloss, d_norm, d_raw = tt.d_step(tstate, tb, tb["latent"])
    np.testing.assert_allclose(float(t_dloss), float(d_loss), rtol=1e-4)
    held("d", tstate.d_params, d_raw, d_norm)
    with torch.no_grad():            # the discriminator JAX's g grads saw
        for n, p in tstate.d_params.items():
            p.copy_(torch.from_numpy(want["d"][n].copy()))
    t_gloss, _, g_norm, g_raw = tt.g_step(tstate, tb, tb["latent"])
    np.testing.assert_allclose(float(t_gloss), float(g_loss), rtol=1e-4)
    held("g", tstate.g_params, g_raw, g_norm)
    assert tstate.g_opt.count == tstate.d_opt.count == 1
