"""Port parity for the low-latency B=1 path: K1-int4 decode, the HiFi-GAN
render, sentence streaming, and the dpm++2m sampler behind the
"ultra_fast" preset. The port's TextToSpeech / synthesize_batch against
the JAX package's on one tiny configuration (f32, CPU), weights carried by
TextToSpeech.from_jax.

Greedy paths: the AR samplers run with a nucleus so narrow (top_p 1e-4)
and no repetition penalty that they keep only the top token, as in
tests/test_torch_port_serving.py. Bounds: codes token-exact; HiFi-GAN
waveforms within 1e-3 (the e2e render bound); the speaker mel within 1e-4
mean L1; dpm++2m from a shared x_T within rtol 1e-3 / atol 1e-4."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xtts_tpu.diffusion import gaussian as jg  # noqa: E402
from xtts_tpu.infer import api as japi  # noqa: E402
from xtts_tpu.infer import serving as jserv  # noqa: E402
from xtts_tpu.models.aa_diffusion import AADiffusion  # noqa: E402
from xtts_tpu.models.gpt import UnifiedVoice  # noqa: E402
from xtts_tpu.models.hifigan import HifiDecoder  # noqa: E402
from xtts_tpu.models.vocos import Vocos  # noqa: E402
from xtts_tpu_torch.core import config as tcfg  # noqa: E402
from xtts_tpu_torch.diffusion import gaussian as tg  # noqa: E402
from xtts_tpu_torch.infer import api as tapi  # noqa: E402
from xtts_tpu_torch.infer import serving as tserv  # noqa: E402
from xtts_tpu_torch.ops import decode_step as tds  # noqa: E402

from test_torch_port_e2e import (TINY_H, one_torch_thread,  # noqa: E402,F401
                                 randomize)

CFG_T = tcfg.XTTSConfig.from_dict(TINY_H.to_dict())
WAV_TOL = dict(rtol=1e-3, atol=1e-3)
NARROW = dict(top_p=1e-4, repetition_penalty=1.0, max_mel_tokens=16)


def _variables():
    """Random JAX variables for gpt, diffusion, vocos and hifigan, shaped by
    tracing the inits (no compile) and filled from numpy seeds."""
    c = TINY_H
    inits = {
        "gpt": lambda: UnifiedVoice(c.gpt).init(
            jax.random.PRNGKey(0), jnp.zeros((1, c.gpt.mel_bins, 64)),
            jnp.zeros((1, 8), jnp.int32), jnp.array([8]),
            jnp.zeros((1, 16), jnp.int32), jnp.array([16 * 1024])),
        "diffusion": lambda: AADiffusion(c.diffusion).init(
            jax.random.PRNGKey(1), jnp.zeros((1, c.diffusion.in_channels, 16)),
            jnp.array([0]),
            jnp.zeros((1, c.diffusion.in_latent_channels, 4)),
            jnp.zeros((1, c.diffusion.in_channels, 16))),
        "vocos": lambda: Vocos(c.vocos).init(
            jax.random.PRNGKey(2), jnp.zeros((1, c.vocos.input_channels, 16))),
        "hifigan": lambda: HifiDecoder(c.hifigan).init(
            jax.random.PRNGKey(3), jnp.zeros((1, 8, c.hifigan.decoder_input_dim)),
            ref_mel16k=jnp.zeros((1, 16, 64))),
    }
    rng = np.random.default_rng(0)
    out = {}
    for name, init in inits.items():
        shapes = jax.eval_shape(init)["params"]
        zeros = jax.tree_util.tree_map(
            lambda a: np.zeros(a.shape, np.float32), shapes)
        out[name] = {"params": randomize(zeros, rng)}
    return out


@pytest.fixture(scope="module")
def pair():
    variables = _variables()
    jtts = japi.TextToSpeech(TINY_H, variables=dict(variables),
                             quantized_decode=True, with_hifigan=True)
    # the port attaches K1's stack at requantize(): int4 from the start
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XTTS_DECODE_BITS", "4")
        ttts = tapi.TextToSpeech.from_jax(variables, CFG_T, device="cpu",
                                          quantized_decode=True,
                                          with_hifigan=True)
    assert ttts._qtree["fused"]["bits"] == 4
    return jtts, ttts


@pytest.fixture(scope="module")
def voice(pair):
    jtts, ttts = pair
    rng = np.random.default_rng(1)
    sr = TINY_H.mel.sample_rate
    t = np.arange(sr // 2) / sr
    wav = (0.3 * np.sin(2 * np.pi * 220 * t)
           + 0.1 * rng.standard_normal(t.shape[0])).astype(np.float32)
    return (wav, np.array(jtts.cond_mel_from_wav(wav)),
            np.array(jtts.speaker_mel_from_wav(wav)),
            ttts.speaker_mel_from_wav(wav))


def _texts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, 250, (n,)).astype(np.int32) for n in lens]


def test_speaker_mel_from_wav(voice):
    """24 k -> 16 k, 3 s bucket, 64-bin log-mel, (1, T, 64)."""
    _, _, jspk, tspk = voice
    assert tuple(tspk.shape) == jspk.shape == (1, 301, 64)
    assert np.abs(tspk.numpy() - jspk).mean() < 1e-4


def test_tts_tokens_int4_hifigan_matches_jax(pair, voice, monkeypatch):
    """B=1 through K1-int4 (JAX: the Pallas kernel's wbits=4 branch in
    interpret mode; the port: the int4 plain twins) and the HiFi-GAN
    render: codes token-exact, wav within 1e-3."""
    monkeypatch.setenv("XTTS_FUSED_DECODE", "1")
    monkeypatch.setenv("XTTS_DECODE_BITS", "4")
    jtts, ttts = pair
    _, cond, jspk, tspk = voice
    text = _texts(2, [16])[0]
    jtts._qtree.pop("fused", None)      # JAX attaches lazily: int4 now
    want = jtts.tts_tokens(text, jnp.asarray(cond), jax.random.PRNGKey(0),
                           japi.TTSSettings(**NARROW), use_hifigan=True,
                           spk_mel16=jnp.asarray(jspk))
    assert jtts._qtree["fused"]["w"].shape[-1] == TINY_H.gpt.model_dim // 2
    tds.reset_launch_counts()
    got = ttts.tts_tokens(text, torch.from_numpy(cond), None,
                          tapi.TTSSettings(**NARROW), use_hifigan=True,
                          spk_mel16=tspk)
    assert tds.int4_gemv.launches == 0          # CPU: the plain twins
    np.testing.assert_array_equal(got["codes"], want["codes"])
    n = max(int(got["lengths"][0]) - 2, 1)
    assert got["wav"].shape == want["wav"].shape == (
        1, tapi.hifigan_samples(CFG_T.hifigan, n))
    np.testing.assert_allclose(got["wav"], want["wav"], **WAV_TOL)
    assert np.abs(want["wav"]).max() > 1e-3


def test_synthesize_batch_hifigan_matches_jax(pair, voice):
    """Two rows, one with its own speaker mel and one on the batch's. (At
    two rows both packages run the per-layer int8 chain, whose bf16
    residual leaves ~2e-2 logit differences: random-weight greedy picks
    flip at near-ties for some texts, e.g. seeds 3, 8, 9, 11 here; the
    texts of seed 4 meet none.)"""
    jtts, ttts = pair
    wav, cond, jspk, tspk = voice
    other = np.random.default_rng(4).standard_normal(wav.shape[0]).astype(
        np.float32) * 0.2
    jspk2 = np.array(jtts.speaker_mel_from_wav(other))
    tspk2 = ttts.speaker_mel_from_wav(other)
    texts = _texts(4, [12, 16])
    want = jserv.synthesize_batch(
        jtts, [jserv.SynthesisRequest(texts[0], spk_mel16=jnp.asarray(jspk2)),
               jserv.SynthesisRequest(texts[1])], jnp.asarray(cond),
        japi.TTSSettings(**NARROW), key=jax.random.PRNGKey(0),
        use_hifigan=True, spk_mel16=jnp.asarray(jspk))
    got = tserv.synthesize_batch(
        ttts, [tserv.SynthesisRequest(texts[0], spk_mel16=tspk2),
               tserv.SynthesisRequest(texts[1])], torch.from_numpy(cond),
        tapi.TTSSettings(**NARROW), use_hifigan=True, spk_mel16=tspk)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == np.asarray(w).shape and g.dtype == np.float32
        np.testing.assert_allclose(g, np.asarray(w), **WAV_TOL)


def test_batch_server_hifigan(pair, voice):
    _, ttts = pair
    _, cond, _, tspk = voice
    settings = tapi.TTSSettings(**NARROW)
    texts = _texts(5, [9, 14])
    want = tserv.synthesize_batch(
        ttts, [tserv.SynthesisRequest(t) for t in texts],
        torch.from_numpy(cond), settings, use_hifigan=True, spk_mel16=tspk)
    server = tserv.BatchServer(ttts, torch.from_numpy(cond), settings,
                               window_ms=3000.0, use_hifigan=True,
                               spk_mel16=tspk)
    try:
        got = [f.result(timeout=300)
               for f in [server.submit(t) for t in texts]]
        stats = server.stats()
    finally:
        server.close()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert stats["completed"] == 2 and stats["waves"] == 1


@pytest.mark.parametrize("use_hifigan", [True, False])
def test_tts_stream_equals_sequential_tts(pair, voice, use_hifigan):
    """np.concatenate(tts_stream(...)) == tts(batch_sentences=False) with the
    same generator seed: one generator stream per sentence, sampled."""
    _, ttts = pair
    wav = voice[0]
    text = "你好，世界。今天天气真好！"
    settings = tapi.TTSSettings(max_mel_tokens=10, diffusion_steps=3)
    parts = list(ttts.tts_stream(text, wav, torch.Generator().manual_seed(7),
                                 settings, use_hifigan=use_hifigan))
    whole = ttts.tts(text, wav, torch.Generator().manual_seed(7), settings,
                     batch_sentences=False, use_hifigan=use_hifigan)
    assert len(parts) == 2 and all(p.ndim == 1 and p.size for p in parts)
    np.testing.assert_array_equal(np.concatenate(parts), whole)


def test_use_hifigan_needs_the_decoder(pair, voice):
    _, cond, _, tspk = voice
    plain = tapi.TextToSpeech(CFG_T, device="cpu", init=False)
    with pytest.raises(ValueError, match="with_hifigan"):
        plain.tts_tokens(_texts(1, [8])[0], torch.from_numpy(cond), None,
                         tapi.TTSSettings(max_mel_tokens=4), use_hifigan=True,
                         spk_mel16=tspk)


# ---------------------------------------------------------------------------
# dpm++2m and the presets
# ---------------------------------------------------------------------------

def test_presets_equal():
    for name in ("ultra_fast", "fast", "standard", "high_quality"):
        j, t = japi.TTSSettings.preset(name), tapi.TTSSettings.preset(name)
        for f in ("num_candidates", "diffusion_steps", "sampler", "top_p",
                  "temperature", "repetition_penalty", "max_mel_tokens",
                  "cond_free_k", "diffusion_temperature"):
            assert getattr(t, f) == getattr(j, f), (name, f)
    with pytest.raises(KeyError):
        tapi.TTSSettings.preset("slow")


@pytest.mark.parametrize("steps,cfg_pair", [(15, True), (15, False),
                                            (6, True)])
def test_dpmpp_2m_chain_from_shared_xt(steps, cfg_pair):
    """One deterministic model function in both frameworks: the paired CFG
    call (constant-k mix) or a single output."""
    xt = np.random.default_rng(8).standard_normal((2, 4, 12)).astype(
        np.float32)

    def fn(mod, x, t):
        tt = (t.astype(mod.float32) if mod is jnp else t.float())[:, None,
                                                                   None]
        eps = mod.tanh(0.7 * x + 1e-3 * tt) * 0.8
        var = mod.zeros_like(x) + 0.1
        c = mod.concatenate([eps, var], axis=1) if mod is jnp else \
            torch.cat([eps, var], dim=1)
        if not cfg_pair:
            return c
        u_eps = mod.tanh(-0.3 * x) * 0.5
        u = mod.concatenate([u_eps, var], axis=1) if mod is jnp else \
            torch.cat([u_eps, var], dim=1)
        return c, u

    jgd = jg.GaussianDiffusion.spaced(1000, steps,
                                      conditioning_free=cfg_pair,
                                      conditioning_free_k=2.0)
    tgd = tg.GaussianDiffusion.spaced(1000, steps, conditioning_free_k=2.0)
    want = jgd.dpmpp_2m_sample_loop(lambda x, t: fn(jnp, x, t), xt.shape,
                                    jax.random.PRNGKey(0),
                                    noise=jnp.asarray(xt))
    got = tgd.sample_loop(lambda x, t: fn(torch, x, t), xt.shape,
                          noise=torch.from_numpy(xt), sampler="dpm++2m")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                               atol=1e-4)
    assert float(np.abs(np.asarray(want)).max()) <= 1.0     # x0 clipped
