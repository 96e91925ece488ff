"""Batched serving (BASELINE config #5) and the DVAE shortcut render: the
port's TextToSpeech / synthesize_batch / BatchServer against the JAX
package's on one tiny configuration (f32, CPU), weights carried by
TextToSpeech.from_jax.

The batched AR engines run greedy (generate_speech_quantized) or with a
nucleus so narrow (top_p 1e-4) and no repetition penalty that sampling
keeps only the top token: greedy, so both packages draw the same codes
without sharing a generator. (With the penalty, near-ties of random-weight
logits flip at the chains' ~1e-3 bf16 logit differences.) Codes must
be token-exact (the K4 engine: token-exact or differing only at greedy
ties, counted); shortcut waveforms within 1e-3 (the e2e render bound)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xtts_tpu.core.config import CLVPConfig  # noqa: E402
from xtts_tpu.infer import api as japi, qdecode as jq  # noqa: E402
from xtts_tpu.infer import serving as jserv  # noqa: E402
from xtts_tpu_torch.core import config as tcfg  # noqa: E402
from xtts_tpu_torch.infer import api as tapi, qdecode as tq  # noqa: E402
from xtts_tpu_torch.infer import serving as tserv  # noqa: E402
from xtts_tpu_torch.ops import serving_step as tss  # noqa: E402

from test_torch_port_e2e import (TINY, jax_variables,  # noqa: E402,F401
                                 one_torch_thread, randomize)

CFG = TINY.replace(clvp=CLVPConfig(
    dim_text=32, dim_speech=32, dim_latent=16, num_text_tokens=256,
    text_enc_depth=1, text_seq_len=64, text_heads=2, num_speech_tokens=256,
    speech_enc_depth=1, speech_heads=2))
CFG_T = tcfg.XTTSConfig.from_dict(CFG.to_dict())
WAV_TOL = dict(rtol=1e-3, atol=1e-3)
NARROW = dict(top_p=1e-4, repetition_penalty=1.0, max_mel_tokens=20)


@pytest.fixture(scope="module")
def pair():
    jtts = japi.TextToSpeech(CFG, jax_variables(CFG, jax.random.PRNGKey(0),
                                                with_clvp=True),
                             quantized_decode=True, with_clvp=True)
    rng = np.random.default_rng(0)
    for name in ("gpt", "dvae", "diffusion", "vocos", "clvp"):
        jtts.vars[name] = dict(jtts.vars[name],
                               params=randomize(jtts.vars[name]["params"],
                                                rng))
    jtts.vars["dvae"]["codebook"] = {
        k: np.asarray(v) for k, v in jtts.vars["dvae"]["codebook"].items()}
    jtts._qtree = jq.quantize_gpt_decode(jtts.vars["gpt"], CFG.gpt,
                                         include_fused=True)
    ttts = tapi.TextToSpeech.from_jax(jtts.vars, CFG_T, device="cpu",
                                      quantized_decode=True, with_clvp=True)
    return jtts, ttts


@pytest.fixture(scope="module")
def voice(pair):
    jtts, ttts = pair
    rng = np.random.default_rng(1)
    sr = CFG.mel.sample_rate
    t = np.arange(sr // 2) / sr
    wav = (0.3 * np.sin(2 * np.pi * 220 * t)
           + 0.1 * rng.standard_normal(t.shape[0])).astype(np.float32)
    return wav, np.array(jtts.cond_mel_from_wav(wav))


def _texts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, 250, (n,)).astype(np.int32) for n in lens]


def _conds(seed, b):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, 8, 30)).astype(np.float32)


@pytest.mark.parametrize("engine", ["chain_ladder", "kv_quant"])
def test_batched_greedy_codes_token_exact(pair, engine):
    jtts, ttts = pair
    cond = _conds(2, 3)
    text = np.stack(_texts(3, [16] * 3))
    kw = dict(max_gen=16, do_sample=False, cache_ladder=(4, 9),
              quantize_kv_cache=engine == "kv_quant")
    jr = jq.generate_speech_quantized(
        jtts.gpt, jtts.vars["gpt"], jtts._qtree, jnp.asarray(cond),
        jnp.asarray(text), jax.random.PRNGKey(0), **kw)
    tr = tq.generate_speech_quantized(
        ttts.gpt, ttts._qtree, torch.from_numpy(cond),
        torch.from_numpy(text).long(), None, **kw)
    np.testing.assert_array_equal(tr.codes.numpy(), np.asarray(jr.codes))
    np.testing.assert_array_equal(tr.lengths.numpy(), np.asarray(jr.lengths))
    assert tr.steps == int(jr.steps)


def test_fused_serving_engine_codes(pair):
    """K4 (JAX: the Pallas kernel in interpret mode; port: the plain twin)
    at 8 rows, with a cache ladder."""
    jtts, ttts = pair
    cond = _conds(4, 8)
    text = np.stack(_texts(5, [16] * 8))
    kw = dict(max_gen=12, do_sample=False, cache_ladder=(6,))
    jr = jq.generate_speech_quantized(
        jtts.gpt, jtts.vars["gpt"], jtts._qtree, jnp.asarray(cond),
        jnp.asarray(text), jax.random.PRNGKey(0), use_fused_serving=True,
        **kw)
    tss.reset_launch_counts()
    tr = tq.generate_speech_quantized(
        ttts.gpt, ttts._qtree, torch.from_numpy(cond),
        torch.from_numpy(text).long(), None, use_fused_serving=True, **kw)
    assert tss.fused_serving_logits.launches == 0       # CPU: plain twins
    want, got = np.asarray(jr.codes), tr.codes.numpy()
    differ = [(r, int(np.argmax(want[r] != got[r])))
              for r in range(8) if (want[r] != got[r]).any()]
    print(f"K4 engine greedy codes: {8 - len(differ)}/8 rows token-exact; "
          f"first differences (row, step): {differ}")
    assert not differ, differ


def test_tts_tokens_rerank_and_shortcut(pair, voice):
    """num_candidates=2 through the DVAE shortcut render."""
    jtts, ttts = pair
    _, cond = voice
    text = _texts(6, [16])[0]
    settings = dict(NARROW, num_candidates=2)
    want = jtts.tts_tokens(text, jnp.asarray(cond), jax.random.PRNGKey(0),
                           japi.TTSSettings(**settings),
                           use_diffusion=False)
    got = ttts.tts_tokens(text, torch.from_numpy(cond), None,
                          tapi.TTSSettings(**settings), use_diffusion=False)
    np.testing.assert_array_equal(got["codes"], want["codes"])
    assert got["wav"].shape == want["wav"].shape
    np.testing.assert_allclose(got["wav"], want["wav"], **WAV_TOL)


@pytest.mark.parametrize("k", [1, 2])
def test_synthesize_batch_shortcut(pair, k):
    jtts, ttts = pair
    texts = _texts(7, [9, 16, 13])
    conds = _conds(8, 3)
    s = dict(NARROW, num_candidates=k)
    want = jserv.synthesize_batch(
        jtts, [jserv.SynthesisRequest(t, cond_mel=jnp.asarray(c[None]))
               for t, c in zip(texts, conds)], None, japi.TTSSettings(**s),
        key=jax.random.PRNGKey(0))
    got = tserv.synthesize_batch(
        ttts, [tserv.SynthesisRequest(t, cond_mel=torch.from_numpy(c[None]))
               for t, c in zip(texts, conds)], None, tapi.TTSSettings(**s))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, np.asarray(w), **WAV_TOL)


def test_batch_server_answers_like_synthesize_batch(pair, voice):
    _, ttts = pair
    _, cond = voice
    cond_t = torch.from_numpy(cond)
    settings = tapi.TTSSettings(**NARROW)
    texts = _texts(9, [12, 16, 7])
    want = tserv.synthesize_batch(
        ttts, [tserv.SynthesisRequest(t) for t in texts], cond_t, settings)
    server = tserv.BatchServer(ttts, cond_t, settings, max_batch=8,
                               window_ms=3000.0)
    try:
        futs = [server.submit(t) for t in texts]
        got = [f.result(timeout=300) for f in futs]
        stats = server.stats()
    finally:
        server.close()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert stats["completed"] == 3 and stats["waves"] == 1
    assert stats["pending"] == 0 and stats["failed"] == 0


def test_batch_server_backpressure_and_validation(pair, voice):
    _, ttts = pair
    _, cond = voice
    server = tserv.BatchServer(ttts, torch.from_numpy(cond),
                               tapi.TTSSettings(**NARROW), max_pending=0,
                               window_ms=1.0)
    try:
        with pytest.raises(tserv.ServerBusy):
            server.submit(np.ones(8, np.int32))
        with pytest.raises(ValueError, match="max_text_tokens"):
            server.submit(np.ones(CFG.gpt.max_text_tokens + 1, np.int32))
    finally:
        server.close()
    with pytest.raises(RuntimeError, match="closed"):
        server.submit(np.ones(8, np.int32))


def test_tts_batch_sentences_shortcut(pair, voice):
    jtts, ttts = pair
    wav, _ = voice
    text = "你好，世界。今天天气真好！我们去公园吧。"
    want = jtts.tts(text, wav, jax.random.PRNGKey(0),
                    japi.TTSSettings(**NARROW), use_diffusion=False)
    got = ttts.tts(text, wav, None, tapi.TTSSettings(**NARROW),
                   use_diffusion=False)
    assert got.shape == want.shape and got.shape[0] > 0
    np.testing.assert_allclose(got, np.asarray(want), **WAV_TOL)


def test_cond_mel_bucketed(pair, voice):
    jtts, ttts = pair
    wav, _ = voice
    for n in (len(wav), 30000):
        w = np.resize(wav, n)
        np.testing.assert_allclose(
            ttts.cond_mel_bucketed(w, (0.5, 1.0)).numpy(),
            np.asarray(jtts.cond_mel_bucketed(w, (0.5, 1.0))), atol=1e-3)
