"""Port parity: GPT (UnifiedVoice), sampling, int8 quantization and the
per-layer int8 chain (xtts_tpu_torch vs xtts_tpu), f32 on the CPU, weights
carried by utils.convert.unified_voice_from_jax."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xtts_tpu.core.config import GPTConfig  # noqa: E402
from xtts_tpu.infer import qdecode as jq, sampling as js  # noqa: E402
from xtts_tpu.models import gpt as jgpt, gpt_infer as jgi  # noqa: E402
from xtts_tpu.nn.transformer import KVCache as JKV  # noqa: E402
from xtts_tpu_torch.core import config as tcfg  # noqa: E402
from xtts_tpu_torch.infer import qdecode as tq, sampling as ts  # noqa: E402
from xtts_tpu_torch.models import gpt as tgpt, gpt_infer as tgi  # noqa: E402
from xtts_tpu_torch.nn.transformer import KVCache as TKV  # noqa: E402
from xtts_tpu_torch.utils import convert  # noqa: E402

CFG = GPTConfig(layers=2, model_dim=128, heads=2, max_mel_tokens=64,
                max_text_tokens=32, number_mel_codes=200, start_mel_token=198,
                stop_mel_token=199, mel_bins=8, cond_attn_blocks=2)
TCFG = tcfg.GPTConfig.from_dict(CFG.to_dict())
TOL = dict(rtol=1e-4, atol=1e-4)


def randomize(tree, rng):
    """Every leaf redrawn (no zero-init layers, non-trivial norms)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = randomize(v, rng)
            continue
        v = np.asarray(v)
        if k == "scale":
            x = 1.0 + 0.1 * rng.standard_normal(v.shape)
        elif k == "embedding":
            x = 0.3 * rng.standard_normal(v.shape)
        elif k == "bias" or v.ndim <= 1:
            x = 0.1 * rng.standard_normal(v.shape)
        else:
            x = rng.standard_normal(v.shape) / np.sqrt(np.prod(v.shape[:-1]))
        out[k] = x.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def models():
    jm = jgpt.UnifiedVoice(CFG)
    init = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8, 16)),
                            jnp.zeros((1, 8), jnp.int32), jnp.array([8]),
                            jnp.zeros((1, 16), jnp.int32), jnp.array([16384]))
    params = randomize(init["params"], np.random.default_rng(0))
    tm = tgpt.UnifiedVoice(TCFG).eval()
    tm.load_state_dict(convert.to_torch(device="cpu", sd=
        convert.unified_voice_from_jax(params, CFG.layers,
                                       CFG.cond_attn_blocks)))
    return jm, {"params": params}, tm


def _inputs(seed=1, t_text=12, t_codes=20):
    rng = np.random.default_rng(seed)
    cond = rng.standard_normal((2, 8, 30)).astype(np.float32)
    text = rng.integers(2, 250, (2, t_text)).astype(np.int32)
    codes = rng.integers(0, 198, (2, t_codes)).astype(np.int32)
    return cond, text, codes


def test_teacher_forced_logits_and_latent(models):
    jm, jv, tm = models
    cond, text, codes = _inputs()
    tl = np.array([12, 9], np.int32)
    wl = np.array([20 * 1024, 13 * 1024 - 5], np.int32)
    _, _, jlog = jm.apply(jv, cond, text, tl, codes, wl, return_logits=True)
    jlat = jm.apply(jv, cond, text, tl, codes, wl, return_latent=True)
    with torch.no_grad():
        args = [torch.from_numpy(a).long() if a.dtype == np.int32 else
                torch.from_numpy(a) for a in (cond, text, tl, codes)]
        tlog = tm(*args, torch.from_numpy(wl).long())
        tlat = tm(*args, torch.from_numpy(wl).long(), return_latent=True)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat), **TOL)


def test_capacity_guards(models):
    _, _, tm = models
    cond, _, codes = _inputs()
    long_text = torch.zeros((1, CFG.max_text_tokens + 1), dtype=torch.long)
    with pytest.raises(ValueError, match="max_text_tokens"):
        tm.encode_prefix(torch.from_numpy(cond[:1]), long_text)
    long_codes = torch.zeros((1, CFG.max_mel_tokens + 1), dtype=torch.long)
    with pytest.raises(ValueError, match="max_mel_tokens"):
        tm(torch.from_numpy(cond[:1]), long_text[:, :4], torch.tensor([4]),
           long_codes, torch.tensor([1024]))


def test_prefix_prefill_decode_one(models):
    jm, jv, tm = models
    cond, text, _ = _inputs(2)
    jp, jn = jm.apply(jv, cond, text, method=jm.encode_prefix)
    p_len = jp.shape[1]
    jl0, jc = jm.apply(jv, jp, JKV.zeros(2, 2, p_len + 4, 2, 64, jnp.float32),
                       method=jm.prefill)
    tok = np.array([5, 17], np.int32)
    jl1, _ = jm.apply(jv, jnp.asarray(tok), 1 + jn, jc, p_len,
                      method=jm.decode_one)
    with torch.no_grad():
        tp, tn = tm.encode_prefix(torch.from_numpy(cond),
                                  torch.from_numpy(text).long())
        cache = TKV.zeros(2, 2, p_len + 4, 2, 64, torch.float32,
                          device="cpu")
        tl0, cache = tm.prefill(tp, cache)
        tl1, _ = tm.decode_one(torch.from_numpy(tok).long(), 1 + tn, cache,
                               p_len)
    assert tn == jn
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)
    np.testing.assert_allclose(tl0.numpy(), np.asarray(jl0), **TOL)
    np.testing.assert_allclose(tl1.numpy(), np.asarray(jl1), **TOL)


def test_generate_speech_greedy_token_exact(models):
    jm, jv, tm = models
    cond, text, _ = _inputs(3)
    jr = jgi.generate_speech(jm, jv, cond[:1], text[:1], jax.random.PRNGKey(0),
                             max_gen=24, do_sample=False)
    tr = tgi.generate_speech(tm, torch.from_numpy(cond[:1]),
                             torch.from_numpy(text[:1]).long(), None,
                             max_gen=24, do_sample=False)
    np.testing.assert_array_equal(tr.codes.numpy(), np.asarray(jr.codes))
    np.testing.assert_array_equal(tr.lengths.numpy(), np.asarray(jr.lengths))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_dense_bit_exact(seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((96, 160)) * rng.uniform(0.01, 3.0)).astype(
        np.float32)
    w[:, 7] = 0.0                                      # all-zero column
    w[3, 11] = 127.5 * np.abs(w[:, 11]).max() / 127.0  # rounding edge
    jqd = jq.quantize_dense(jnp.asarray(w))
    tqd = tq.quantize_dense(torch.from_numpy(w))
    np.testing.assert_array_equal(tqd["w"].numpy(), np.asarray(jqd["w"]))
    np.testing.assert_array_equal(tqd["scale"].numpy(),
                                  np.asarray(jqd["scale"]))


def test_quantize_gpt_decode_matches(models):
    jm, jv, tm = models
    jt = jq.quantize_gpt_decode(jv, CFG, include_fused=False)
    tt = tq.quantize_gpt_decode(tm, include_fused=False)
    for jl, tl in zip(jt["layers"], tt["layers"]):
        for kind in ("qkv", "proj", "fc", "out"):
            np.testing.assert_array_equal(tl[kind]["w"].numpy(),
                                          np.asarray(jl[kind]["w"]))
            np.testing.assert_array_equal(tl[kind]["scale"].numpy(),
                                          np.asarray(jl[kind]["scale"]))
    np.testing.assert_array_equal(tt["mel_head"]["w"].numpy(),
                                  np.asarray(jt["mel_head"]["w"]))


def test_int8_chain_decode_logits(models):
    """The per-layer int8 chain (B > 1 engine) against JAX's."""
    jm, jv, tm = models
    jt = jq.quantize_gpt_decode(jv, CFG, include_fused=False)
    tt = tq.quantize_gpt_decode(tm, include_fused=False)
    rng = np.random.default_rng(4)
    k = (rng.standard_normal((2, 2, 40, 2, 64)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((2, 2, 40, 2, 64)) * 0.5).astype(np.float32)
    tok = np.array([3, 150], np.int32)
    jl, _ = jq._decode_logits(jt, 2, jnp.asarray(tok), 7,
                              JKV(jnp.asarray(k, jnp.bfloat16),
                                  jnp.asarray(v, jnp.bfloat16)), 25)
    tl, _ = tq._decode_logits(tt, 2, torch.from_numpy(tok).long(), 7,
                              TKV(torch.from_numpy(k).bfloat16(),
                                  torch.from_numpy(v).bfloat16()), 25)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-2,
                               atol=2e-2)
    np.testing.assert_array_equal(tl.numpy().argmax(-1),
                                  np.asarray(jl).argmax(-1))


@pytest.mark.parametrize("top_p", [0.1, 0.5, 0.8, 1.0])
def test_top_p_kept_set(top_p):
    rng = np.random.default_rng(5)
    logits = (rng.standard_normal((3, 500)) * 2).astype(np.float32)
    logits[1, 10:13] = logits[1].max() + 1.0      # ties at the top
    want = np.asarray(js.top_p_filter(jnp.asarray(logits), top_p)) > -1e8
    got = ts.top_p_filter(torch.from_numpy(logits), top_p).numpy() > -1e8
    np.testing.assert_array_equal(got, want)


def test_repetition_penalty_and_greedy():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((2, 50)).astype(np.float32)
    seen = rng.random((2, 50)) < 0.3
    want = np.asarray(js.apply_repetition_penalty(jnp.asarray(logits),
                                                  jnp.asarray(seen), 2.0))
    got = ts.apply_repetition_penalty(torch.from_numpy(logits),
                                      torch.from_numpy(seen), 2.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-7)
    np.testing.assert_array_equal(ts.greedy_token(torch.from_numpy(logits)),
                                  np.asarray(js.greedy_token(logits)))


def test_sample_token_stays_in_nucleus():
    rng = np.random.default_rng(7)
    logits = torch.from_numpy(rng.standard_normal((4, 300)).astype(np.float32))
    g = torch.Generator().manual_seed(0)
    kept = ts.top_p_filter(logits / 0.8, 0.5) > -1e8
    for _ in range(5):
        tok = ts.sample_token(g, logits, temperature=0.8, top_p=0.5)
        assert kept[torch.arange(4), tok].all()


def test_ladder_caps():
    assert tgi.ladder_caps((256, 64, 64, 900), 300) == jgi.ladder_caps(
        (256, 64, 64, 900), 300) == (64, 256, 300)
    assert tgi.ladder_caps(None, 50) == (50,)
