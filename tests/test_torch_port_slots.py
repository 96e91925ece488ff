"""Continuous batching (xtts_tpu_torch/infer/slots.py) against the JAX
package's xtts_tpu/infer/slots.py, on the CPU.

The cases of tests/test_slots.py, ported: greedy codes through the slot
pool, requests installed into recycled slots mid-stream included, are
token-exact with the port's B=1 chain and with JAX's SlotDecoder, over a
bf16 and a kv_quant cache (stop-biased weights give spread stop times, so
refill happens); codes do not depend on the segment length; empty slots
are inert; a seeded request's sampled codes and its diffusion waveform do
not depend on the pool's composition; the pipelined scheduler answers as
the sequential one; backpressure, the queue timeout and the CLVP refusal.
Then the port's own parts: typical_filter keeps JAX's set, ties included;
a row's per-row draw does not change with the other rows; a segment reads
nothing back to the host; per-row render noise at one row is the single
generator's.

Sampled codes are not compared with JAX's: torch and JAX draw different
numbers for a seed. Card tests of the pool's graphs are in
tests/test_torch_port_kernels.py."""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xtts_tpu.core.config import MelConfig, XTTSConfig  # noqa: E402
from xtts_tpu.infer import api as japi, qdecode as jq  # noqa: E402
from xtts_tpu.infer import sampling as jsampling  # noqa: E402
from xtts_tpu.infer import slots as jslots  # noqa: E402
from xtts_tpu.models.gpt import UnifiedVoice as JUnifiedVoice  # noqa: E402
from xtts_tpu_torch.core import config as tcfg  # noqa: E402
from xtts_tpu_torch.infer import api as tapi, qdecode as tq  # noqa: E402
from xtts_tpu_torch.infer import sampling as tsampling  # noqa: E402
from xtts_tpu_torch.infer import slots as tslots  # noqa: E402
from xtts_tpu_torch.infer.serving import ServerBusy  # noqa: E402
from xtts_tpu_torch.models.gpt import UnifiedVoice  # noqa: E402
from xtts_tpu_torch.utils import convert  # noqa: E402

from test_slots import CFG, MAX_GEN, _FakeTTS, _requests  # noqa: E402
from test_torch_port_e2e import (TINY_T, one_torch_thread,  # noqa: E402,F401
                                 traced_zeros)
from test_torch_port_gpt import randomize  # noqa: E402

XCFG = XTTSConfig(gpt=CFG, mel=MelConfig(n_mels=20))
TXCFG = tcfg.XTTSConfig.from_dict(XCFG.to_dict())


class _PortTTS:
    """The parts of TextToSpeech the SlotDecoder reads."""

    def __init__(self, gpt, qtree, cfg):
        self.gpt = gpt
        self._qtree = qtree
        self.cfg = cfg
        self.device = torch.device("cpu")


# Weights: the flax init of test_slots.py's CFG, every leaf redrawn
# (test_torch_port_gpt.randomize, seed 15) and the stop logit's head bias
# raised by 1.5: the six requests stop after 6, 3, 1, 3, 9 and 18 tokens
# (refill happens), and along their greedy paths the top-2 logit gap stays
# >= 0.018, above the 1e-3-1e-2 by which the JAX and torch chains' bf16
# roundings move a logit (the flax init's own logits sit closer than that:
# on it the two frameworks break near-ties differently).
SEED, STOP_BIAS = 15, 1.5


@pytest.fixture(scope="module")
def engine():
    model = JUnifiedVoice(CFG)
    # the eager init's shapes and key order by tracing alone (randomize
    # redraws every leaf: the same draws)
    variables = traced_zeros(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 20, 50)),
        jnp.zeros((2, 10), jnp.int32), jnp.array([8, 10]),
        jnp.zeros((2, 20), jnp.int32), jnp.array([20 * 1024, 15 * 1024])))
    p = randomize(variables["params"], np.random.default_rng(SEED))
    p["mel_head"]["bias"][CFG.stop_mel_token] += STOP_BIAS
    jvars = {"params": p}
    jqt = jq.quantize_gpt_decode(jvars, CFG, include_fused=False)
    tm = UnifiedVoice(TXCFG.gpt).eval()
    tm.load_state_dict(convert.to_torch(convert.unified_voice_from_jax(
        p, CFG.layers, CFG.cond_attn_blocks), "cpu"))
    tqt = tq.quantize_gpt_decode(tm, include_fused=False)
    return (_FakeTTS(model, jvars, jqt, CFG),
            _PortTTS(tm, tqt, TXCFG))


def _port_requests(n=6, seed=5):
    texts, conds = _requests(n, seed)
    return texts, [torch.from_numpy(np.array(c)) for c in conds], conds


def _port_settings(kv_quant=False):
    return tapi.TTSSettings(max_mel_tokens=MAX_GEN, kv_quant=kv_quant)


def _b1_chain(ptts, texts, conds, kv_quant=False):
    """The port's B=1 int8 chain (not K1), greedy, on the same padded text."""
    out = []
    for t, c in zip(texts, conds):
        r = tq.generate_speech_quantized(
            ptts.gpt, ptts._qtree, c, torch.from_numpy(t).long()[None],
            None, max_gen=MAX_GEN, do_sample=False, use_fused=False,
            quantize_kv_cache=kv_quant)
        out.append((r.codes[0].numpy(), int(r.lengths[0])))
    return out


def _drive_refill(dec, texts, conds, n_slots):
    """n_slots slots, len(texts) requests: each finished slot is refilled
    with the next request at once (recycled slots mid-stream)."""
    pending = list(range(len(texts)))
    slot_req, results = {}, {}
    for s in range(n_slots):
        i = pending.pop(0)
        dec.install(s, dec.pad_text(texts[i]), conds[i])
        slot_req[s] = i
    for _ in range(100):
        done, gen = dec.run_segment_greedy()
        finished = [s for s in slot_req if done[s]]
        if finished:
            codes = dec.fetch_codes()
            for s in finished:
                i = slot_req.pop(s)
                results[i] = (np.asarray(codes[s]), int(gen[s]))
                if pending:
                    j = pending.pop(0)
                    dec.install(s, dec.pad_text(texts[j]), conds[j])
                    slot_req[s] = j
        if not slot_req and not pending:
            break
    assert len(results) == len(texts)
    return results


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "kv_quant"])
def test_slot_greedy_exact_with_refill(engine, kv_quant):
    """3 slots, 6 requests: every request, the first three and the refills
    into recycled slots, equals the port's B=1 chain and JAX's slot pool
    token for token (test_slot_greedy_exact_with_refill and
    test_slot_kv_quant_greedy_exact of tests/test_slots.py)."""
    jtts, ptts = engine
    texts, conds, jconds = _port_requests()
    ref = _b1_chain(ptts, texts, conds, kv_quant)
    assert len({n for _, n in ref}) >= 3     # spread stops: refill happens
    dec = tslots.SlotDecoder(ptts, n_slots=3, max_gen=MAX_GEN, segment_len=4,
                             text_buckets=(5,),
                             settings=_port_settings(kv_quant))
    if kv_quant:
        assert len(dec.state.cache) == 4
        assert dec.state.cache[0].dtype == torch.int8
    got = _drive_refill(dec, texts, conds, 3)
    jdec = jslots.SlotDecoder(
        jtts, n_slots=3, max_gen=MAX_GEN, segment_len=4, text_buckets=(5,),
        settings=japi.TTSSettings(max_mel_tokens=MAX_GEN, kv_quant=kv_quant))
    want = _drive_refill(jdec, texts, jconds, 3)
    for i, (codes, length) in got.items():
        assert length == ref[i][1] == want[i][1], f"request {i}"
        np.testing.assert_array_equal(codes, ref[i][0], err_msg=f"req {i}")
        np.testing.assert_array_equal(codes, want[i][0], err_msg=f"req {i}")


def test_segment_length_invariance(engine):
    """Greedy codes do not depend on the segment length."""
    _, ptts = engine
    texts, conds, _ = _port_requests(n=2)
    outs = []
    for seg in (3, MAX_GEN):
        dec = tslots.SlotDecoder(ptts, n_slots=2, max_gen=MAX_GEN,
                                 segment_len=seg, text_buckets=(5,))
        for s in range(2):
            dec.install(s, dec.pad_text(texts[s]), conds[s])
        for _ in range(30):
            done, gen = dec.run_segment_greedy()
            if done.all():
                break
        outs.append((dec.fetch_codes(), gen.copy()))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])


def test_empty_slots_inert(engine):
    """Uninstalled slots idle as done and do not disturb a live row."""
    _, ptts = engine
    texts, conds, _ = _port_requests(n=1)
    ref = _b1_chain(ptts, texts, conds)[0]
    dec = tslots.SlotDecoder(ptts, n_slots=4, max_gen=MAX_GEN, segment_len=8,
                             text_buckets=(5,))
    dec.install(2, dec.pad_text(texts[0]), conds[0])   # middle slot only
    for _ in range(10):
        done, gen = dec.run_segment_greedy()
        if done[2]:
            break
    codes = dec.fetch_codes()
    assert int(gen[2]) == ref[1]
    np.testing.assert_array_equal(codes[2], ref[0])
    assert done.all()


def test_sampled_per_request_determinism(engine):
    """A seeded request's sampled codes, alone in a 2-slot pool and in
    another slot of a 3-slot pool beside other traffic, are identical."""
    _, ptts = engine
    texts, conds, _ = _port_requests(n=3)

    def drive(dec, slot):
        for _ in range(50):
            done, gen = dec.run_segment()
            if done[slot]:
                return dec.fetch_codes()[slot], int(gen[slot])
        raise AssertionError("request never finished")

    alone = tslots.SlotDecoder(ptts, n_slots=2, max_gen=MAX_GEN,
                               segment_len=4, text_buckets=(5,))
    alone.install(0, alone.pad_text(texts[0]), conds[0], seed=42)
    codes_a, gen_a = drive(alone, 0)

    crowd = tslots.SlotDecoder(ptts, n_slots=3, max_gen=MAX_GEN,
                               segment_len=3, text_buckets=(5,))
    crowd.install(0, crowd.pad_text(texts[1]), conds[1])   # busy neighbours
    crowd.install(1, crowd.pad_text(texts[2]), conds[2])
    crowd.install(2, crowd.pad_text(texts[0]), conds[0], seed=42)
    codes_c, gen_c = drive(crowd, 2)

    assert gen_a == gen_c
    np.testing.assert_array_equal(codes_a, codes_c)
    other = tslots.SlotDecoder(ptts, n_slots=2, max_gen=MAX_GEN,
                               segment_len=4, text_buckets=(5,))
    other.install(0, other.pad_text(texts[0]), conds[0], seed=43)
    codes_o, _ = drive(other, 0)
    assert not np.array_equal(codes_o, codes_a)      # the seed is read


def test_slot_decoder_needs_qtree(engine):
    _, ptts = engine
    with pytest.raises(ValueError, match="quantized_decode"):
        tslots.SlotDecoder(_PortTTS(ptts.gpt, None, TXCFG), n_slots=2)


@contextlib.contextmanager
def _no_host_reads(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("a slot step read a tensor back to the host")
    with monkeypatch.context() as m:
        for name in ("__bool__", "item", "__int__", "__index__",
                     "__float__", "tolist", "numpy"):
            m.setattr(torch.Tensor, name, refuse)
        yield


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "kv_quant"])
def test_a_segment_makes_no_host_read(engine, kv_quant, monkeypatch):
    """Every step of sampled and greedy segments runs with the
    tensor-to-host conversions patched to raise: what a CUDA graph of the
    pool's steps needs."""
    _, ptts = engine
    texts, conds, _ = _port_requests(n=2)
    step = tslots._slot_step
    calls = []

    def guarded(*a, **k):
        with _no_host_reads(monkeypatch):
            step(*a, **k)
        calls.append(1)
    monkeypatch.setattr(tslots, "_slot_step", guarded)
    dec = tslots.SlotDecoder(ptts, n_slots=3, max_gen=MAX_GEN, segment_len=4,
                             text_buckets=(5,),
                             settings=_port_settings(kv_quant))
    dec.install(0, dec.pad_text(texts[0]), conds[0], seed=1)
    dec.install(2, dec.pad_text(texts[1]), conds[1], seed=2)
    dec.run_segment()
    dec.run_segment_greedy()
    assert len(calls) == 8


@pytest.mark.parametrize("mass", [0.2, 0.5, 0.9])
@pytest.mark.parametrize("kind", ["distinct", "ties"])
def test_typical_filter_keeps_the_jax_set(kind, mass):
    """The kept set equals JAX's exactly; with tied logits the stable sort
    keeps the lower ids first, as jnp.argsort does."""
    rng = np.random.default_rng(3)
    if kind == "ties":
        logits = rng.integers(-3, 4, (6, 40)).astype(np.float32)
    else:
        logits = (2.0 * rng.standard_normal((6, 40))).astype(np.float32)
    want = np.asarray(jsampling.typical_filter(jnp.asarray(logits), mass))
    got = tsampling.typical_filter(torch.from_numpy(logits), mass).numpy()
    kept_w, kept_g = want > -1e8, got > -1e8
    np.testing.assert_array_equal(kept_g, kept_w)
    assert 0 < kept_g.sum() < kept_g.size
    np.testing.assert_array_equal(got[kept_g], logits[kept_g])


def test_sample_token_rows_draws_per_row():
    """A row's draw depends on its key, its counter and its logits alone:
    other rows' logits, keys and counters, its own position and the batch
    size change nothing. The draws follow the probabilities."""
    rng = np.random.default_rng(4)
    logits = torch.from_numpy(rng.standard_normal((5, 300)).astype(
        np.float32))
    keys = torch.tensor([tsampling.row_keys(s) for s in (7, 8, 9, 10, 11)])
    draws = torch.tensor([0, 3, 5, 2, 9])
    kw = dict(temperature=0.8, top_p=0.8, repetition_penalty=2.0,
              seen=torch.from_numpy(rng.random((5, 300)) < 0.1))
    tok = tsampling.sample_token_rows(keys, draws, logits, **kw)
    for r in range(5):
        one = tsampling.sample_token_rows(
            keys[r:r + 1], draws[r:r + 1], logits[r:r + 1],
            **dict(kw, seen=kw["seen"][r:r + 1]))
        assert one.item() == tok[r].item()
    perm = torch.tensor([3, 0, 4, 1, 2])
    other = logits.clone()
    other[perm != 2] = torch.randn(4, 300)
    again = tsampling.sample_token_rows(
        keys[perm], draws[perm], torch.where((perm == 2)[:, None],
                                             logits[perm], other),
        **dict(kw, seen=kw["seen"][perm]))
    assert again[4].item() == tok[2].item()
    # frequencies over counters 0..3999 of one key follow p
    p = torch.tensor([[0.1, 0.2, 0.3, 0.4]])
    n = 4000
    got = tsampling.sample_token_rows(
        torch.tensor([tsampling.row_keys(123)] * n), torch.arange(n),
        torch.log(p).repeat(n, 1))
    freq = torch.bincount(got, minlength=4).float() / n
    assert torch.allclose(freq, p[0], atol=0.03), freq


def test_unit_uniform_stays_inside_the_open_interval():
    """The largest 32-bit word gives a number below 1 (so -log u > 0), the
    smallest one above 0, and every number is an exact odd multiple of
    2**-24."""
    h = torch.tensor([0, 1, 511, 512, 0xFFFFFF00, 0xFFFFFFFF],
                     dtype=torch.int64)
    u = tsampling.unit_uniform(h)
    assert u.dtype == torch.float32
    assert bool((u > 0).all()) and bool((u < 1).all()), u
    assert bool((-torch.log(u) > 0).all())
    assert u[-1].item() == 1.0 - 2.0 ** -24
    k = (u.double() * 2 ** 24).numpy()
    np.testing.assert_array_equal(k, np.round(k))
    assert (np.round(k) % 2 == 1).all()


def test_sample_token_rows_never_draws_a_filtered_token(monkeypatch):
    """A token that the repetition penalty and top-p leave with probability
    0 is never drawn: at a vocabulary of the flagship's size over many
    counters, and with every hash word at its largest (a uniform at its
    top, where -log u must stay > 0, or p / q turns NaN at p = 0)."""
    rng = np.random.default_rng(5)
    n, v = 256, 8194
    logits = torch.from_numpy(rng.standard_normal((n, v)).astype(np.float32))
    seen = torch.from_numpy(rng.random((n, v)) < 0.05)
    kw = dict(temperature=0.8, top_p=0.5, repetition_penalty=2.0, seen=seen)
    probs = tsampling._probs(logits, 0.8, 0.5, seen, 2.0, None)
    keys = torch.tensor([tsampling.row_keys(77)] * n)
    got = tsampling.sample_token_rows(keys, torch.arange(n), logits, **kw)
    assert bool((probs.gather(1, got[:, None]) > 0).all())
    monkeypatch.setattr(tsampling, "_hash32",
                        lambda x: torch.full_like(x, 0xFFFFFFFF))
    got = tsampling.sample_token_rows(keys, torch.arange(n), logits, **kw)
    assert bool((probs.gather(1, got[:, None]) > 0).all())
    torch.testing.assert_close(got, probs.argmax(dim=-1))


def test_render_noise_per_row_at_one_row_is_the_single_generator():
    """At one row, one generator a row draws x_T and every step's noise as
    the single generator does from the same seed (so wave serving's draws
    are unchanged)."""
    tts = tapi.TextToSpeech(TINY_T, device="cpu", quantized_decode=True)
    rng = np.random.default_rng(0)
    lat = torch.from_numpy(rng.standard_normal((1, 128, 8)).astype(
        np.float32))
    cond = torch.from_numpy(rng.standard_normal((1, 8, 40)).astype(
        np.float32))
    one = tts._diffusion_mel_impl(lat, cond, torch.Generator().manual_seed(5),
                                  steps=3)
    rows = tts._diffusion_mel_impl(lat, cond,
                                   [torch.Generator().manual_seed(5)],
                                   steps=3)
    assert torch.equal(one, rows)


# ---------------------------------------------------------------------------
# ContinuousBatcher on the tiny pipeline
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    """TINY_T with the diffusion's weights drawn at random (the flax init
    zeroes its output layer, which would make every render the noise)."""
    tts = tapi.TextToSpeech(TINY_T, device="cpu", quantized_decode=True)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in tts.diffusion.parameters():
            p.copy_(torch.randn(p.shape, generator=g)
                    / max(1, p.shape[-1]) ** 0.5 * 0.5)
    rng = np.random.default_rng(0)
    cond = torch.from_numpy(rng.standard_normal(
        (1, TINY_T.mel.n_mels, 40)).astype(np.float32))
    return tts, cond


TEXTS = [np.array([1, 3, 4, 5, 2]), np.array([1, 6, 7, 2]),
         np.array([1, 8, 2]), np.array([1, 9, 10, 11, 2]),
         np.array([1, 12, 2])]


def test_continuous_batcher_e2e(tiny):
    """The host loop: more requests than slots, futures resolve to finite
    waveforms through the shared batched render; the stats count them."""
    tts, cond = tiny
    cb = tslots.ContinuousBatcher(tts, cond, tapi.TTSSettings(
        max_mel_tokens=12), n_slots=2, segment_len=4, render_min=2)
    try:
        futs = [cb.submit(t) for t in TEXTS]
        wavs = [f.result(timeout=300) for f in futs]
        st = cb.stats()
    finally:
        cb.close()
    assert len(wavs) == 5
    for w in wavs:
        assert w.size > 0 and np.isfinite(w).all()
    assert st["completed"] == 5 and st["failed"] == 0
    assert 0 < st["slot_occupancy"] <= 1 and st["tokens"] > 0


def test_continuous_batcher_rerank_needs_clvp(tiny):
    tts, cond = tiny
    with pytest.raises(ValueError, match="with_clvp"):
        tslots.ContinuousBatcher(tts, cond, tapi.TTSSettings(
            num_candidates=2), n_slots=2)


def test_continuous_batcher_rerank_e2e():
    """K=2 candidates a request run as two rows of the pool, the harvested
    pair is CLVP-scored and only the winner renders."""
    from test_torch_port_serving import CFG_T
    tts = tapi.TextToSpeech(CFG_T, device="cpu", quantized_decode=True,
                            with_clvp=True)
    cond = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, CFG_T.mel.n_mels, 40)).astype(np.float32))
    cb = tslots.ContinuousBatcher(tts, cond, tapi.TTSSettings(
        max_mel_tokens=10, num_candidates=2), n_slots=2, segment_len=4,
        render_min=1)
    try:
        futs = [cb.submit(TEXTS[0]), cb.submit(TEXTS[1])]
        wavs = [f.result(timeout=300) for f in futs]
    finally:
        cb.close()
    assert all(w.size > 0 and np.isfinite(w).all() for w in wavs)


def test_pipelined_scheduler_matches_sequential(tiny):
    """pipeline=True overlaps the done-mask read with the next segment;
    seeded requests give the same waveforms as without it. The render
    runs at one rung (4 rows), so its arithmetic is the same whichever
    requests share a render."""
    tts, cond = tiny
    outs = []
    for pipe in (False, True):
        cb = tslots.ContinuousBatcher(
            tts, cond, tapi.TTSSettings(max_mel_tokens=10), n_slots=2,
            segment_len=4, render_min=2, render_buckets=(4,), pipeline=pipe)
        try:
            futs = [cb.submit(t, seed=100 + i)
                    for i, t in enumerate(TEXTS[:4])]
            outs.append([f.result(timeout=300) for f in futs])
        finally:
            cb.close()
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def _keyed_diffusion(tts, cond, settings, buckets, seed=123):
    """Request X (seeded) alone in a 2-slot pool, then in a 3-slot pool
    between two unseeded neighbours: its two diffusion waveforms."""
    text_x = TEXTS[0]
    cb = tslots.ContinuousBatcher(tts, cond, settings, n_slots=2,
                                  segment_len=4, render_min=1,
                                  use_diffusion=True, render_buckets=buckets)
    try:
        alone = cb.submit(text_x, seed=seed).result(timeout=300)
    finally:
        cb.close()
    cb = tslots.ContinuousBatcher(tts, cond, settings, n_slots=3,
                                  segment_len=3, render_min=2,
                                  use_diffusion=True, render_buckets=buckets)
    try:
        futs = [cb.submit(TEXTS[1]), cb.submit(text_x, seed=seed),
                cb.submit(np.array([1, 8, 9, 10, 11, 2]))]
        crowd = futs[1].result(timeout=300)
        for f in (futs[0], futs[2]):
            f.result(timeout=300)
    finally:
        cb.close()
    return alone, crowd


def test_keyed_diffusion_render_traffic_independent(tiny):
    """A seeded request's diffusion waveform, alone in a 2-slot pool and
    crowded in a 3-slot pool (other neighbours, slot, segment length and
    render group), is byte-identical when every render runs at one rung.
    At JAX's rungs (1, 2, 4, 8, 16) its render batch differs between the
    two runs (1 row alone, 2-4 crowded), and torch's CPU matmuls round a
    row differently at another row count (MKL takes a gemv path at one
    row): there the two agree within 1e-4 of the waveform's peak, while
    another seed changes the waveform by more than half its peak."""
    tts, cond = tiny
    settings = tapi.TTSSettings(max_mel_tokens=12, diffusion_steps=4,
                                sampler="p")
    alone, crowd = _keyed_diffusion(tts, cond, settings, (4,))
    np.testing.assert_array_equal(alone, crowd)
    alone, crowd = _keyed_diffusion(tts, cond, settings, (1, 2, 4, 8, 16))
    peak = float(np.abs(alone).max())
    assert alone.shape == crowd.shape and peak > 0
    assert float(np.abs(alone - crowd).max()) <= 1e-4 * peak
    other, _ = _keyed_diffusion(tts, cond, settings, (4,), seed=124)
    assert float(np.abs(other - alone).max()) > 0.5 * peak


def test_continuous_batcher_backpressure_and_timeout(tiny):
    """max_pending=0 rejects every submit with ServerBusy; a fully queued
    request older than request_timeout_s fails with TimeoutError when a
    slot would take it."""
    tts, cond = tiny
    cb = tslots.ContinuousBatcher(tts, cond, tapi.TTSSettings(
        max_mel_tokens=8), n_slots=2, segment_len=4, max_pending=0)
    try:
        with pytest.raises(ServerBusy):
            cb.submit(np.array([1, 3, 2]))
        assert cb.stats()["completed"] == 0
    finally:
        cb.close()
    cb = tslots.ContinuousBatcher(tts, cond, tapi.TTSSettings(
        max_mel_tokens=8), n_slots=2, segment_len=4, request_timeout_s=0.0)
    try:
        fut = cb.submit(np.array([1, 3, 2]))
        with pytest.raises(TimeoutError):
            fut.result(timeout=120)
        assert cb.stats()["timed_out"] >= 1
    finally:
        cb.close()


def test_a_poisoned_pool_fails_its_requests_and_recovers(tiny, monkeypatch):
    """A segment that raises fails every in-flight request and resets the
    pool; the scheduler then serves the next request."""
    tts, cond = tiny
    cb = tslots.ContinuousBatcher(tts, cond, tapi.TTSSettings(
        max_mel_tokens=8), n_slots=2, segment_len=4)
    try:
        real = cb.dec.dispatch_segment
        monkeypatch.setattr(cb.dec, "dispatch_segment", lambda *a, **k: (
            _ for _ in ()).throw(RuntimeError("device lost")))
        with pytest.raises(RuntimeError, match="device lost"):
            cb.submit(TEXTS[0]).result(timeout=120)
        monkeypatch.setattr(cb.dec, "dispatch_segment", real)
        w = cb.submit(TEXTS[1]).result(timeout=120)
        assert w.size > 0 and np.isfinite(w).all()
        assert cb.stats()["failed"] >= 1
    finally:
        cb.close()
