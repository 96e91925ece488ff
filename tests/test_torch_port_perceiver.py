"""Port parity for the perceiver conditioning (nn/blocks.py RMSNorm,
GEGLU feed-forward, MHAttention, PerceiverResampler; UnifiedVoice with
use_perceiver), xtts_tpu_torch against xtts_tpu, f32 on the CPU, weights
carried by utils.convert.unified_voice_from_jax.

Held: the resampler's 32 latents, the teacher-forced mel logits and
latents (the text slice landing on 31 conditioning positions, the
reference's quirk, kept on both sides), the generation prefix with its
32-token tail at mel positions 0..31 (decode_position_quirk), all within
rtol / atol 1e-4 (test_torch_port_gpt.py's); the gpt loss with its
gradients (loss within 1e-5 relative, every gradient within rtol 1e-4 /
atol 1e-6, test_torch_port_train_losses.py's); greedy codes at B=1
token-exact, through the plain model and through K1 (JAX's Pallas kernel
in interpret mode, the port's plain twin) over the 32-position prefix.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xtts_tpu.core.config import DVAEConfig, GPTConfig  # noqa: E402
from xtts_tpu.infer import qdecode as jq  # noqa: E402
from xtts_tpu.models import dvae as jdv, gpt as jgpt, gpt_infer as jgi  # noqa: E402
from xtts_tpu.train import steps as jsteps  # noqa: E402
from xtts_tpu_torch.core import config as tcfg  # noqa: E402
from xtts_tpu_torch.infer import qdecode as tq  # noqa: E402
from xtts_tpu_torch.models import dvae as tdv, gpt as tgpt  # noqa: E402
from xtts_tpu_torch.models import gpt_infer as tgi  # noqa: E402
from xtts_tpu_torch.train import steps as tsteps  # noqa: E402
from xtts_tpu_torch.utils import convert  # noqa: E402
from test_torch_port_e2e import one_torch_thread, shaped_zeros  # noqa: E402,F401
from test_torch_port_gpt import randomize  # noqa: E402

MB = 8
CFG = GPTConfig(layers=2, model_dim=128, heads=2, max_mel_tokens=64,
                max_text_tokens=32, number_mel_codes=200, start_mel_token=198,
                stop_mel_token=199, mel_bins=MB, use_perceiver=True)
TCFG = tcfg.GPTConfig.from_dict(CFG.to_dict())
DVAE_CFG = DVAEConfig(channels=MB, num_tokens=198, hidden_dim=16,
                      num_resnet_blocks=1, codebook_dim=16, num_layers=2)
TOL = dict(rtol=1e-4, atol=1e-4)
GRAD = dict(rtol=1e-4, atol=1e-6)


def _t(a):
    return (torch.from_numpy(a).long() if a.dtype == np.int32
            else torch.from_numpy(a))


@pytest.fixture(scope="module")
def models():
    jm = jgpt.UnifiedVoice(CFG)
    init = shaped_zeros(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, MB, 16)),
        jnp.zeros((1, 8), jnp.int32), jnp.array([8]),
        jnp.zeros((1, 16), jnp.int32), jnp.array([16384])))
    params = randomize(init["params"], np.random.default_rng(0))
    tm = tgpt.UnifiedVoice(TCFG).eval()
    tm.load_state_dict(convert.to_torch(convert.unified_voice_from_jax(
        params, CFG.layers), "cpu"))
    return jm, {"params": params}, tm


def _inputs(seed=1, b=2, t_text=12, t_codes=20):
    rng = np.random.default_rng(seed)
    cond = rng.standard_normal((b, MB, 30)).astype(np.float32)
    text = rng.integers(2, 250, (b, t_text)).astype(np.int32)
    codes = rng.integers(0, 198, (b, t_codes)).astype(np.int32)
    return cond, text, codes


def test_converter_carries_every_perceiver_weight(models):
    _, jv, tm = models
    names = {k for k in tm.state_dict() if k.startswith("perceiver_encoder.")}
    assert "perceiver_encoder.latents" in names
    assert "perceiver_encoder.layers.1.1.2.weight" in names
    assert not any(k.startswith("conditioning_encoder.")
                   for k in tm.state_dict())
    want = jv["params"]["perceiver_encoder"]["latents"]
    np.testing.assert_array_equal(
        tm.perceiver_encoder.latents.detach().numpy(), want)


def test_resampler_latents(models):
    jm, jv, tm = models
    cond, _, _ = _inputs()
    jc = jm.apply(jv, jnp.asarray(cond), method=jm.get_conditioning)
    with torch.no_grad():
        tc = tm.get_conditioning(torch.from_numpy(cond))
    assert tc.shape == (2, CFG.perceiver_latents, CFG.model_dim)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)


def test_multi_clip_refused(models):
    _, _, tm = models
    with pytest.raises(ValueError, match="one clip"):
        tm.get_conditioning(torch.zeros((1, 2, MB, 30)))


def test_teacher_forced_logits_and_latent(models):
    jm, jv, tm = models
    cond, text, codes = _inputs()
    tl = np.array([12, 9], np.int32)
    wl = np.array([20 * 1024, 13 * 1024 - 5], np.int32)
    jlt, jlm, jlog = jm.apply(jv, cond, text, tl, codes, wl,
                              return_logits=True)
    jlat = jm.apply(jv, cond, text, tl, codes, wl, return_latent=True)
    with torch.no_grad():
        args = [_t(a) for a in (cond, text, tl, codes, wl)]
        tlt, tlm, tlog = tm(*args, return_logits=True)
        tlat = tm(*args, return_latent=True)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat), **TOL)
    np.testing.assert_allclose([float(tlt), float(tlm)],
                               [float(jlt), float(jlm)], rtol=1e-5)


def test_prefix_tail_quirk(models):
    jm, jv, tm = models
    cond, text, _ = _inputs(2)
    jp, jn = jm.apply(jv, cond, text, method=jm.encode_prefix)
    with torch.no_grad():
        tp, tn = tm.encode_prefix(torch.from_numpy(cond),
                                  torch.from_numpy(text).long())
    assert tn == jn == CFG.perceiver_latents
    # conds + [start; text; stop] + the 32-token tail
    assert tp.shape[1] == 32 + text.shape[1] + 2 + 32
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)


def test_gpt_loss_and_gradients(models):
    """One training loss of the gpt family with the perceiver (the frozen
    DVAE's codes as targets) and its gradients, JAX's jax.grad against the
    port's backward."""
    jm, jv, tm = models
    jd = jdv.DVAE(DVAE_CFG)
    dvars = randomize(shaped_zeros(lambda: jd.init(
        jax.random.PRNGKey(1), jnp.zeros((1, MB, 32)))),
        np.random.default_rng(5))
    tdm = tdv.DVAE(tcfg.DVAEConfig.from_dict(DVAE_CFG.to_dict())).eval()
    tdm.load_state_dict(convert.to_torch(convert.dvae_from_jax(
        dvars, DVAE_CFG.num_layers, DVAE_CFG.num_resnet_blocks), "cpu"))
    rng = np.random.default_rng(6)
    batch = {"cond_mel": rng.standard_normal((2, MB, 30)).astype(np.float32),
             "text": rng.integers(2, 250, (2, 10)).astype(np.int32),
             "text_lengths": np.array([10, 6], np.int32),
             "mel": rng.standard_normal((2, MB, 48)).astype(np.float32),
             "wav_lengths": np.array([12 * 1024, 7 * 1024 - 3], np.int32)}
    jloss = jsteps.make_gpt_loss(jm, jd, dvars)
    (jl, _), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jv["params"], {}, jax.tree_util.tree_map(jnp.asarray, batch), None)
    tm.train()
    for p in tm.parameters():
        p.grad = None
    tl, _ = tsteps.make_gpt_loss(tm, tdm)({k: _t(v) for k, v in
                                          batch.items()}, None)
    tl.backward()
    tl = tl.detach()
    tm.eval()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    want = convert.unified_voice_from_jax(
        jax.tree_util.tree_map(np.asarray, jg), CFG.layers)
    held = 0
    for n, p in tm.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(g.numpy(), want[n], err_msg=n, **GRAD)
        held += n.startswith("perceiver_encoder.")
        p.grad = None
    assert held == 18


def test_greedy_codes_token_exact(models):
    jm, jv, tm = models
    cond, text, _ = _inputs(3, b=1)
    jr = jgi.generate_speech(jm, jv, cond, text, jax.random.PRNGKey(0),
                             max_gen=24, do_sample=False)
    with torch.no_grad():
        tr = tgi.generate_speech(tm, torch.from_numpy(cond),
                                 torch.from_numpy(text).long(), None,
                                 max_gen=24, do_sample=False)
    np.testing.assert_array_equal(tr.codes.numpy(), np.asarray(jr.codes))
    np.testing.assert_array_equal(tr.lengths.numpy(), np.asarray(jr.lengths))


def test_greedy_k1_codes_token_exact(models, monkeypatch):
    """B=1 through K1 over the perceiver's 32-position prefix and its
    32-token tail: JAX's Pallas kernel in interpret mode, the port's plain
    twin (its launches stay 0 on the CPU)."""
    from xtts_tpu_torch.ops import decode_step as tds
    monkeypatch.setenv("XTTS_FUSED_DECODE", "1")
    jm, jv, tm = models
    cond, text, _ = _inputs(4, b=1)
    jqt = jq.quantize_gpt_decode(jv, CFG)
    jr = jq.generate_speech_quantized(
        jm, jv, jqt, jnp.asarray(cond), jnp.asarray(text),
        jax.random.PRNGKey(0), max_gen=24, do_sample=False, use_fused=True)
    tqt = tq.quantize_gpt_decode(tm)
    before = tds.fused_decode_logits.launches
    with torch.no_grad():
        tr = tq.generate_speech_quantized(
            tm, tqt, torch.from_numpy(cond), torch.from_numpy(text).long(),
            None, max_gen=24, do_sample=False)
    assert tds.fused_decode_logits.launches == before
    np.testing.assert_array_equal(tr.codes.numpy(), np.asarray(jr.codes))
    np.testing.assert_array_equal(tr.lengths.numpy(), np.asarray(jr.lengths))


def test_greedy_k4_rows_token_exact(models):
    """8 rows through K4 over the perceiver's prefix (its int8 cache):
    JAX's Pallas kernel in interpret mode, the port's plain twin. The two
    sum the int8 cache's products in another order, so a greedy chain may
    turn at a near tie and differ from there on (test_torch_port_serving_
    step.py holds K4's picks teacher-forced, at most K4_CHAIN_PICKS apart):
    at most one row of the 8 differs, and only after its first 4 codes."""
    from xtts_tpu_torch.ops import serving_step as tss
    jm, jv, tm = models
    cond, text, _ = _inputs(5, b=8, t_text=10)
    jqt = jq.quantize_gpt_decode(jv, CFG)
    jr = jq.generate_speech_quantized(
        jm, jv, jqt, jnp.asarray(cond), jnp.asarray(text),
        jax.random.PRNGKey(0), max_gen=16, do_sample=False,
        use_fused_serving=True)
    tqt = tq.quantize_gpt_decode(tm)
    before = tss.fused_serving_logits.launches
    with torch.no_grad():
        tr = tq.generate_speech_quantized(
            tm, tqt, torch.from_numpy(cond), torch.from_numpy(text).long(),
            None, max_gen=16, do_sample=False, use_fused_serving=True)
    assert tss.fused_serving_logits.launches == before
    got, want = tr.codes.numpy(), np.asarray(jr.codes)
    differ = [r for r in range(8) if not np.array_equal(got[r], want[r])]
    assert len(differ) <= 1, differ
    for r in differ:
        np.testing.assert_array_equal(got[r, :4], want[r, :4])
