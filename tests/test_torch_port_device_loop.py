"""The AR loop on the device (xtts_tpu_torch/infer/device_loop.py) against
the JAX package's lax.while_loop, on the CPU.

The port's loop keeps its state on the device and runs CHUNK steps between
two host reads (CUDA graphs on the card; here the same steps eagerly). Its
greedy codes, lengths and step counts must equal the JAX loop's for every
engine: K1 at one row (JAX: its Pallas kernel in interpret mode), K4 at 8
rows, the per-layer chain, the kv_quant chain and the full-precision
model, with rows that stop inside a chunk (the stop logit biased) and a
cache ladder that the chunk does not divide. Sampled codes must not depend
on the chunk, draw for draw, and neither may the generator's state after
the loop. A chunk must read nothing back to the host. The attention twins
take an int or a 0-d tensor index with the same result. Card tests of the
graphs are in tests/test_torch_port_kernels.py."""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xtts_tpu.infer import qdecode as jq  # noqa: E402
from xtts_tpu.models import gpt as jgpt, gpt_infer as jgi  # noqa: E402
from xtts_tpu_torch.infer import device_loop, qdecode as tq  # noqa: E402
from xtts_tpu_torch.models import gpt as tgpt, gpt_infer as tgi  # noqa: E402
from xtts_tpu_torch.ops import decode_step as tds  # noqa: E402
from xtts_tpu_torch.ops import serving_step as tss  # noqa: E402
from xtts_tpu_torch.utils import convert  # noqa: E402

from test_torch_port_e2e import one_torch_thread, shaped_zeros  # noqa: E402,F401
from test_torch_port_gpt import CFG, TCFG, randomize  # noqa: E402

STOP = CFG.stop_mel_token
# added to the stop token's head bias: the random-weight rows then stop
# at spread steps inside the 13-step runs (greedy)
STOP_BIAS = 3.0
ROWS = {"k1": 1, "k4": 8, "chain": 3, "kv_quant": 3, "full": 2}
CASES = {
    # rows that stop inside a chunk of 4
    "stops": dict(max_gen=13, chunk=4, cache_ladder=None, biased=True),
    # rungs of 6 and 7 steps: each ends in an eager tail of 2 and 3 steps
    "ladder": dict(max_gen=13, chunk=4, cache_ladder=(6,), biased=False),
    "stops_ladder": dict(max_gen=13, chunk=4, cache_ladder=(6,),
                         biased=True),
}


def _build(biased: bool):
    jm = jgpt.UnifiedVoice(CFG)
    # the compiled init's shapes and key order by tracing alone
    # (randomize redraws every leaf: the same draws)
    init = shaped_zeros(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 16)),
        jnp.zeros((1, 8), jnp.int32), jnp.array([8]),
        jnp.zeros((1, 16), jnp.int32), jnp.array([16384])))
    params = randomize(init["params"], np.random.default_rng(0))
    if biased:
        params["mel_head"]["bias"][STOP] += STOP_BIAS
    tm = tgpt.UnifiedVoice(TCFG).eval()
    tm.load_state_dict(convert.to_torch(device="cpu", sd=(
        convert.unified_voice_from_jax(params, CFG.layers,
                                       CFG.cond_attn_blocks))))
    jv = {"params": params}
    return (jm, jv, jq.quantize_gpt_decode(jv, CFG, include_fused=True),
            tm, tq.quantize_gpt_decode(tm))


@pytest.fixture(scope="module")
def models():
    return {biased: _build(biased) for biased in (False, True)}


def _inputs(b, seed=11):
    rng = np.random.default_rng(seed)
    cond = rng.standard_normal((b, 8, 30)).astype(np.float32)
    text = rng.integers(2, 250, (b, 12)).astype(np.int32)
    return cond, text


def _port(engine, tm, tqt, cond, text, **kw):
    args = (torch.from_numpy(cond), torch.from_numpy(text).long())
    if engine == "full":
        return tgi.generate_speech(tm, *args, **kw)
    return tq.generate_speech_quantized(
        tm, tqt, *args, quantize_kv_cache=engine == "kv_quant",
        use_fused_serving=engine == "k4", **kw)


def _jax(engine, jm, jv, jqt, cond, text, **kw):
    args = (jnp.asarray(cond), jnp.asarray(text), jax.random.PRNGKey(0))
    if engine == "full":
        return jgi.generate_speech(jm, jv, *args, **kw)
    return jq.generate_speech_quantized(
        jm, jv, jqt, *args, quantize_kv_cache=engine == "kv_quant",
        use_fused=engine == "k1", use_fused_serving=engine == "k4", **kw)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("engine", list(ROWS))
def test_greedy_codes_equal_the_jax_loop(models, engine, case, monkeypatch):
    c = CASES[case]
    monkeypatch.setattr(device_loop, "CHUNK", c["chunk"])
    jm, jv, jqt, tm, tqt = models[c["biased"]]
    cond, text = _inputs(ROWS[engine])
    kw = dict(max_gen=c["max_gen"], do_sample=False,
              cache_ladder=c["cache_ladder"])
    jr = _jax(engine, jm, jv, jqt, cond, text, **kw)
    tr = _port(engine, tm, tqt, cond, text, **kw)
    np.testing.assert_array_equal(tr.codes.numpy(), np.asarray(jr.codes))
    np.testing.assert_array_equal(tr.lengths.numpy(),
                                  np.asarray(jr.lengths))
    assert tr.steps == int(jr.steps)
    lengths = tr.lengths.numpy()
    if c["biased"]:     # the case is what it says: a stop inside a chunk
        assert (lengths < c["max_gen"]).any()
        assert (lengths % c["chunk"] != 0).any()
    else:
        assert tr.steps == c["max_gen"]


@pytest.mark.parametrize("engine", ["k1", "k4", "chain", "kv_quant", "full"])
def test_sampled_codes_do_not_depend_on_the_chunk(models, engine,
                                                  monkeypatch):
    """Seeded sampling with 1, 4 and 16 steps between host reads: equal
    codes, lengths and steps, and the generator left in the same state
    (the masked steps after the last live one draw nothing that stays)."""
    _, _, _, tm, tqt = models[True]
    cond, text = _inputs(ROWS[engine], seed=12)
    runs = []
    for chunk in (1, 4, 16):
        monkeypatch.setattr(device_loop, "CHUNK", chunk)
        g = torch.Generator().manual_seed(7)
        r = _port(engine, tm, tqt, cond, text, generator=g, max_gen=40,
                  cache_ladder=(6,))
        runs.append((r, g.get_state()))
    (r1, s1) = runs[0]
    # rows stop inside the run, past the first rung (every row at one and
    # two rows: then the last chunks hold masked steps)
    assert r1.steps > 6 and (r1.lengths < 40).any()
    assert r1.steps < 40 or ROWS[engine] > 2
    for r, s in runs[1:]:
        assert torch.equal(r.codes, r1.codes)
        assert torch.equal(r.lengths, r1.lengths)
        assert r.steps == r1.steps
        assert torch.equal(s, s1)


@contextlib.contextmanager
def _no_host_reads(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("a device loop step read a tensor back to the "
                             "host")
    with monkeypatch.context() as m:
        for name in ("__bool__", "item", "__int__", "__index__",
                     "__float__", "tolist", "numpy"):
            m.setattr(torch.Tensor, name, refuse)
        yield


@pytest.mark.parametrize("engine", ["k1", "k4", "chain", "kv_quant", "full"])
def test_a_chunk_makes_no_host_read(models, engine, monkeypatch):
    """Every step of a sampled run executes with the tensor-to-host
    conversions patched to raise: nothing in a step needs the host, which
    is what lets the card capture CHUNK of them into one graph."""
    _, _, _, tm, tqt = models[True]
    cond, text = _inputs(ROWS[engine], seed=13)
    step = device_loop.decode_step
    calls = []

    def guarded(*a, **k):
        with _no_host_reads(monkeypatch):
            step(*a, **k)
        calls.append(1)
    monkeypatch.setattr(device_loop, "decode_step", guarded)
    monkeypatch.setattr(device_loop, "CHUNK", 4)
    r = _port(engine, tm, tqt, cond, text,
              generator=torch.Generator().manual_seed(3), max_gen=9,
              cache_ladder=(4,))
    assert len(calls) >= r.steps > 0


def test_the_loop_state_survives_a_masked_step():
    """A step after every row is done, or at step == cap, changes nothing
    but the cache row it writes (slots.py:178-192)."""
    st = device_loop.LoopState(2, 5, 4, torch.float32, "cpu")
    st.reset(torch.randn(2, 5), p_len=3, pos_off=1, stop=4, start_token=0)
    st.cap.fill_(2)
    st.step.fill_(2)                                    # at the cap
    calls = []

    def engine(tok, mel_pos, index):
        calls.append(int(index))
        return torch.full((2, 5), 9.0)
    before = [t.clone() for t in (st.step, st.logits, st.done, st.seen,
                                  st.codes, st.lengths)]
    samp = device_loop.Sampling(False, 1.0, 1.0, 1.0)
    device_loop.decode_step(st, engine, samp, 4, 10, None)
    st.cap.fill_(4)
    st.done.fill_(True)                                 # every row done
    before[2] = st.done.clone()
    device_loop.decode_step(st, engine, samp, 4, 10, None)
    after = (st.step, st.logits, st.done, st.seen, st.codes, st.lengths)
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert calls == [5, 5]


@pytest.mark.parametrize("index", [0, 1, 39])
def test_decode_attention_twin_takes_a_tensor_index(index):
    rng = np.random.default_rng(index)
    heads, d, s_max = 2, 128, 40
    qkv = torch.from_numpy(rng.standard_normal(3 * d).astype(np.float32))
    kc = torch.from_numpy(rng.standard_normal((s_max, d)).astype(
        np.float32)).bfloat16()
    vc = torch.from_numpy(rng.standard_normal((s_max, d)).astype(
        np.float32)).bfloat16()
    k2, v2 = kc.clone(), vc.clone()
    got = tds.decode_attention(qkv, kc, vc, index, heads)
    at = torch.tensor(index, dtype=torch.int32)
    want = tds.decode_attention(qkv, k2, v2, at, heads)
    assert torch.equal(got, want)
    assert torch.equal(kc, k2) and torch.equal(vc, v2)
    assert torch.equal(kc[index], qkv[d:2 * d].bfloat16())


@pytest.mark.parametrize("index", [0, 1, 299])
def test_serving_attention_twin_takes_a_tensor_index(index):
    rng = np.random.default_rng(index)
    b, heads, d, s_max = 3, 2, 128, 300
    qkv = torch.from_numpy(rng.standard_normal((b, 3 * d)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((b, s_max, d)).astype(
        np.float32))
    one = tss.quantize_rows(k) + tss.quantize_rows(k.roll(1, 1))
    cache = (one[0], one[2], one[1], one[3])             # kc, vc, ks, vs
    other = [t.clone() for t in cache]
    got = tss.serving_attention(qkv, *cache, index, heads)
    at = torch.tensor(index, dtype=torch.int32)
    want = tss.serving_attention(qkv, *other, at, heads)
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(cache, other))


def test_wrappers_refuse_a_bad_index():
    kc = torch.zeros(8, 128, dtype=torch.bfloat16)
    for bad in (-1, 8):
        with pytest.raises(ValueError, match="outside the cache"):
            tds.decode_attention(torch.zeros(384), kc, kc.clone(), bad, 2)
    with pytest.raises(ValueError, match="integer tensor"):
        tds.cache_index(torch.tensor(1.0), torch.device("cpu"), 8, "x")
    with pytest.raises(ValueError, match="integer tensor"):
        tds.cache_index(torch.tensor([1, 2]), torch.device("cpu"), 8, "x")


def test_a_scratch_growth_drops_the_graphs(monkeypatch):
    """The gemv's partials grow (here on the CPU: the same allocation) and
    the growth count moves; a store then forgets every graph and warm
    mark, which held the freed partials' address, and keeps its buffers."""
    monkeypatch.setattr(tds, "_gv_scratch", {})
    monkeypatch.setattr(tds, "_gv_launch", {})
    cpu = torch.device("cpu")
    store = device_loop.Store()
    store.check_scratch()
    before = tds.gemv_scratch_epoch()
    store.state("s", lambda: "state")
    store.cache(("c", 128), lambda: "cache")
    store.graph((("c", 128), "s", "samp"), lambda: "graph")
    store.warm.add((("c", 128), "s", "samp"))
    tds._gemv_scratch(cpu, 64, 4)
    tds._gemv_scratch(cpu, 32, 4)               # fits: no growth
    assert tds.gemv_scratch_epoch() == before + 1
    store.check_scratch()
    assert not store.graphs and not store.warm
    assert list(store.states) == ["s"] and list(store.caches) == [("c", 128)]
    tds._gemv_scratch(cpu, 65, 4)
    assert tds.gemv_scratch_epoch() == before + 2
    assert tds._gv_scratch[cpu]["part"].numel() == 65


@pytest.mark.parametrize("table", ["states", "caches", "graphs"])
def test_the_store_keeps_the_recently_used(table, monkeypatch):
    """Each table of a store is an LRU of at most its MAX_: the least
    recently used goes first, and with a state or a cache every graph (and
    warm mark) that reads it (a graph's key is (cache key, rows, state key,
    ...))."""
    monkeypatch.setattr(device_loop, "MAX_" + table.upper(), 3)
    store = device_loop.Store()

    def gkey(i):
        return ("c", i, f"s{i}", "samp")
    keys = {"states": lambda i: f"s{i}", "caches": lambda i: ("c", i),
            "graphs": gkey}[table]
    get = getattr(store, table[:-1])
    if table != "graphs":
        for i in range(4):
            store.graph(gkey(i), lambda i=i: f"g{i}")
            store.warm.add(gkey(i))
    for i in (0, 1, 2, 0, 3):         # 0 used again: 1 is the least recent
        assert get(keys(i), lambda i=i: f"v{i}") == f"v{i}"
    kept = getattr(store, table)
    assert list(kept) == [keys(2), keys(0), keys(3)]
    if table != "graphs":
        assert gkey(1) not in store.graphs and gkey(1) not in store.warm
        assert all(gkey(i) in store.graphs and gkey(i) in store.warm
                   for i in (0, 2, 3))
