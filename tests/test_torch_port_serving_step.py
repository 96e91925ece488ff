"""K4 (ops/serving_step.py): the port's plain twin of the B-row int8-KV
serving step against the JAX Pallas kernel in interpret mode
(_fused_serving_logits), and the kv_quant per-layer chain against JAX's, on
the CPU, from the same numpy weights and caches.

Tolerances: logits within 2e-2 x max(1, |logits|) (tests/test_serving_step
.py's chunked-vs-single bound: the two sides round the bf16 products and
probabilities at the same places but sum in another order); the new int8
cache rows within +-1 (a rounding tie may fall either way; counted); the
row scales within 1e-6 relative at layer 0 and 2e-2 deeper; a greedy pick that differs must be a tie
within 2x the step's logit error."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from xtts_tpu.infer import qdecode as jq  # noqa: E402
from xtts_tpu.nn.transformer import KVCache as JKV  # noqa: E402
from xtts_tpu.ops import decode_step as jds, serving_step as jss  # noqa
from xtts_tpu_torch.infer import qdecode as tq  # noqa: E402
from xtts_tpu_torch.nn.transformer import KVCache as TKV  # noqa: E402
from xtts_tpu_torch.ops import decode_step as tds  # noqa: E402
from xtts_tpu_torch.ops import serving_step as tss  # noqa: E402

LAYERS, D, HEADS, S_MAX, VOCAB, B = 2, 128, 2, 128, 200, 8
TOL = 2e-2


def make_qtree(seed):
    """The JAX test suite's qtree recipe (tests/test_decode_step.py)."""
    rng = np.random.default_rng(seed)

    def qd(i, o):
        return jq.quantize_dense(jnp.asarray(
            rng.standard_normal((i, o)).astype(np.float32) * 0.1))

    def vec(n):
        return jnp.asarray(rng.uniform(-0.2, 0.2, n).astype(np.float32))

    def ln():
        return {"scale": 1.0 + vec(D), "bias": vec(D)}

    return {
        "layers": [{"ln_1": ln(), "ln_2": ln(), "qkv": qd(D, 3 * D),
                    "qkv_b": vec(3 * D), "proj": qd(D, D), "proj_b": vec(D),
                    "fc": qd(D, 4 * D), "fc_b": vec(4 * D),
                    "out": qd(4 * D, D), "out_b": vec(D)}
                   for _ in range(LAYERS)],
        "ln_f": ln(), "final_norm": ln(),
        "mel_head": qd(D, VOCAB), "mel_head_b": vec(VOCAB),
        "mel_embedding": jnp.asarray(rng.standard_normal(
            (VOCAB, D)).astype(np.float32) * 0.3, jnp.bfloat16),
        "mel_pos_embedding": jnp.asarray(rng.standard_normal(
            (S_MAX, D)).astype(np.float32) * 0.1, jnp.bfloat16),
    }


def to_port(tree):
    if isinstance(tree, dict):
        return {k: to_port(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_port(v) for v in tree]
    a = np.asarray(tree)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    return torch.from_numpy(np.array(a))


def make_cache(seed, prefix_len, s_max=S_MAX):
    rng = np.random.default_rng(seed)
    shape = (LAYERS, B, s_max, HEADS, D // HEADS)
    k, v = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    for a in (k, v):
        a[:, :, :prefix_len] = rng.standard_normal(
            (LAYERS, B, prefix_len, HEADS, D // HEADS)) * 0.5
    jc = JKV(jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16))
    tc = TKV(torch.from_numpy(k).bfloat16(), torch.from_numpy(v).bfloat16())
    return jc, tc


def jax_step(jqt, jcache, tok, mel_pos, index, s_max=S_MAX):
    stacked = jds.stack_qtree(jqt, VOCAB)
    kc, vc, ks, vs = jss.quantize_kv_rowwise(jcache, s_max)
    x = jqt["mel_embedding"][tok] + jqt["mel_pos_embedding"][
        jnp.atleast_1d(mel_pos)]
    out = jss.fused_serving_logits(stacked, x, kc, vc, ks, vs, index,
                                   LAYERS, HEADS, interpret=True)
    return [np.asarray(o, np.float32) for o in out]


def port_step(tqt, cache4, tok, mel_pos, index):
    st = tds.stack_qtree(tqt, VOCAB)
    x = tqt["mel_embedding"][tok] + tqt["mel_pos_embedding"][mel_pos][None]
    return tss.fused_serving_logits(st, x, *cache4, index, LAYERS, HEADS)


def test_quantize_kv_rowwise_identical():
    jc, tc = make_cache(3, 50)
    want = jss.quantize_kv_rowwise(jc, S_MAX)
    got = tss.quantize_kv_rowwise(tc)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("index", [3, 40, S_MAX - 1])
def test_single_step_matches_jax_kernel(index):
    _single_step(index, S_MAX)


def test_single_step_across_chunks_matches_jax_kernel(monkeypatch):
    """A cache of two 128-position chunks: the online softmax's merge
    across chunks (both sides rescale by exp(m_old - m_new)) against the
    JAX kernel's, at the same tolerances. At this width the JAX kernel
    would take the whole cache as one chunk (_pick_chunk); its test
    override XTTS_SERVING_CHUNK holds it to the port's 128."""
    monkeypatch.setenv("XTTS_SERVING_CHUNK", "128")
    jss._fused_serving_logits.clear_cache()
    try:
        _single_step(200, 2 * S_MAX)
    finally:
        jss._fused_serving_logits.clear_cache()


def _single_step(index, s_max):
    jqt = make_qtree(0)
    tqt = to_port(jqt)
    jc, tc = make_cache(7 + index, index, s_max)
    tok = np.arange(B) % 5 + 1
    jl, jkc, jvc, jks, jvs = jax_step(jqt, jc, jnp.asarray(tok, jnp.int32),
                                      4, index, s_max)
    cache4 = tss.quantize_kv_rowwise(tc)
    before = [t.clone() for t in cache4]
    tss.reset_launch_counts()
    tl, tkc, tvc, tks, tvs = port_step(tqt, cache4, torch.from_numpy(tok),
                                       4, index)
    assert tss.fused_serving_logits.launches == 0      # CPU: plain twins
    got, want = tl.numpy()[:, :VOCAB], jl[:, :VOCAB]
    err = np.abs(got - want).max()
    print(f"index {index}: logits within {err:.3e} of the JAX kernel's")
    assert err <= TOL * max(1.0, np.abs(want).max()), err
    assert tl.numpy()[:, VOCAB:].max() < -1e8
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    # the new rows at `index`: int8 within +-1, scales equal
    for g, w in ((tkc, jkc), (tvc, jvc)):
        diff = np.abs(g[:, :, index].numpy().astype(np.int32)
                      - w[:, :, index].astype(np.int32))
        assert diff.max() <= 1
        print(f"index {index}: {int((diff > 0).sum())} of {diff.size} int8 "
              f"values off by one")
    for g, w in ((tks, jks), (tvs, jvs)):
        # layer 0 quantizes the same rows; deeper layers' rows carry the
        # upstream summation-order differences
        np.testing.assert_allclose(g[0, :, index].numpy(), w[0, :, index],
                                   rtol=1e-6)
        np.testing.assert_allclose(g[1:, :, index].numpy(), w[1:, :, index],
                                   rtol=TOL)
    # nothing else moved
    mask = torch.arange(s_max) != index
    for g, b0 in zip((tkc, tvc, tks, tvs), before):
        assert torch.equal(g[:, :, mask], b0[:, :, mask])


def test_padding_is_inert():
    """Garbage at positions >= index must not change the logits (ladder
    growth relies on this)."""
    tqt = to_port(make_qtree(2))
    idx = 30
    _, tc = make_cache(5, idx)
    tok = torch.ones(B, dtype=torch.long)
    clean = port_step(tqt, tss.quantize_kv_rowwise(tc), tok, 3, idx)[0]
    dirty = tss.quantize_kv_rowwise(tc)
    for t, val in zip(dirty, (77, -55, 3.0, 9.0)):
        t[:, :, idx:] = val
    noisy = port_step(tqt, dirty, tok, 3, idx)[0]
    assert torch.equal(clean, noisy)


# Greedy picks of test_teacher_forced_chain's 8 steps x 8 rows that may
# differ a seed. Noise floor (the port's twin step against itself with
# int8_gemm_rows' products summed in float64), seeds 0-15: 0 picks in
# every seed; JAX's Pallas step against the twin: 0 in every seed. Bound:
# the floor's largest count plus one (XLA's CPU dot may sum in another
# order on another CPU).
K4_CHAIN_PICKS = 1


@pytest.mark.parametrize("seed", range(16))
def test_teacher_forced_chain(seed):
    """8 steps with the same forced tokens on both sides, each side keeping
    its own int8 cache: logits within TOL every step, and at most
    K4_CHAIN_PICKS differing greedy picks."""
    jqt = make_qtree(seed)
    tqt = to_port(jqt)
    p_len = 20
    jc, tc = make_cache(100 + seed, p_len)
    jkc, jvc, jks, jvs = jss.quantize_kv_rowwise(jc, S_MAX)
    cache4 = tss.quantize_kv_rowwise(tc)
    stacked_j = jds.stack_qtree(jqt, VOCAB)
    rng = np.random.default_rng(200 + seed)
    differ = 0
    for step in range(8):
        tok = rng.integers(0, VOCAB, B)
        x = jqt["mel_embedding"][jnp.asarray(tok)] + jqt[
            "mel_pos_embedding"][jnp.atleast_1d(step + 2)]
        jl, jkc, jvc, jks, jvs = jss.fused_serving_logits(
            stacked_j, x, jkc, jvc, jks, jvs, p_len + step, LAYERS, HEADS,
            interpret=True)
        tl = port_step(tqt, cache4, torch.from_numpy(tok), step + 2,
                       p_len + step)[0]
        want, got = np.asarray(jl)[:, :VOCAB], tl.numpy()[:, :VOCAB]
        err = np.abs(got - want).max()
        assert err <= TOL * max(1.0, np.abs(want).max()), (step, err)
        differ += int((got.argmax(-1) != want.argmax(-1)).sum())
    print(f"teacher-forced greedy picks differing: {differ}/{8 * B}")
    assert differ <= K4_CHAIN_PICKS


def test_kv_quant_chain_step_matches_jax():
    """The kv_quant engine's per-layer step (_decode_step_qkv)."""
    jqt = make_qtree(3)
    tqt = to_port(jqt)
    jc, tc = make_cache(12, 33)
    tok = np.arange(B) % 7 + 2
    jl, jcache = jq._decode_logits(jqt, HEADS, jnp.asarray(tok, jnp.int32),
                                   5, jq.quantize_kv(jc), 33)
    tcache = tq.quantize_kv(tc)
    tl, tcache = tq._decode_logits(tqt, HEADS, torch.from_numpy(tok), 5,
                                   tcache, 33)
    want = np.asarray(jl)
    err = np.abs(tl.numpy() - want).max()
    assert err <= TOL * max(1.0, np.abs(want).max()), err
    np.testing.assert_array_equal(tl.numpy().argmax(-1), want.argmax(-1))
    for g, w in zip(tcache, jcache):
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        np.testing.assert_allclose(g[:, :, :33], w[:, :, :33], rtol=0,
                                   atol=0)
        np.testing.assert_allclose(g[:, :, 33], w[:, :, 33], rtol=1e-2,
                                   atol=1.0)


@pytest.mark.parametrize("rows", [1, 5, 16, 32])
def test_any_row_count(rows):
    """The step takes any B from 1 to 32 (the API gate is {8, 16})."""
    tqt = to_port(make_qtree(4))
    st = tds.stack_qtree(tqt, VOCAB)
    g = torch.Generator().manual_seed(rows)
    kc = torch.randint(-127, 128, (LAYERS, rows, 40, D), generator=g,
                       dtype=torch.int8)
    vc = kc.flip(1).clone()
    ks = torch.rand(LAYERS, rows, 40, generator=g) * 0.01
    vs = ks.flip(1).clone()
    x = tqt["mel_embedding"][torch.arange(rows) % VOCAB]
    logits, *_ = tss.fused_serving_logits(st, x, kc, vc, ks, vs, 17, LAYERS,
                                          HEADS)
    assert logits.shape == (rows, st["head_tiles"] * D)
    assert torch.isfinite(logits[:, :VOCAB]).all()


@pytest.mark.parametrize("two", [False, True])
@pytest.mark.parametrize("rows", [1, 8, 16, 32])
def test_fused_norm_equals_layer_norm_then_product(rows, two):
    """ln= on CPU tensors: exactly layer_norm_rows_ordered of every row
    (the kernels' statistics in their order), then the plain product."""
    st = tds.stack_qtree(to_port(make_qtree(5)), VOCAB)
    rng = np.random.default_rng(rows)
    x32 = torch.from_numpy(rng.standard_normal((rows, D)).astype(np.float32)
                           * 3 + 1)
    ln = tuple(st["lnf"]) if two else (st["ln"][1][0], st["ln"][1][1])
    h = tds.layer_norm_rows_ordered(x32, *ln)
    tss.reset_launch_counts()
    for kind, kw in (("qkv", {}), ("fc", dict(gelu=True,
                                              out_dtype=torch.bfloat16))):
        w, s, b = (st[p + kind][1] for p in "wsb")
        got = tss.int8_gemm_rows(x32, w, s, b, ln=ln, **kw)
        want = tss.int8_gemm_rows_plain(h, w, s, b, **kw)
        assert got.shape == (rows, w.shape[1]) and torch.equal(got, want)
    base = torch.from_numpy(rng.standard_normal((rows, D)).astype(np.float32))
    got, want = base.clone(), base.clone()
    w, s, b = st["wproj"][0], st["sproj"][0], st["bproj"][0]
    tss.int8_gemm_rows(x32, w, s, b, out=got, ln=ln)
    tss.int8_gemm_rows_plain(h, w, s, b, out=want)
    assert torch.equal(got, want)
    assert tss.int8_gemm_rows.launches == tss.int8_gemm_rows.ln_launches == 0


def test_step_with_prologues_equals_unfused_chain():
    """The K4 step through the plain twins equals the chain as it ran before
    the prologues (the standalone norm's twin layer_norm_rows_ordered,
    then the product)."""
    tqt = to_port(make_qtree(6))
    st = tds.stack_qtree(tqt, VOCAB)
    _, tc = make_cache(13, 25)
    c1 = tss.quantize_kv_rowwise(tc)
    c2 = [t.clone() for t in c1]
    x = tqt["mel_embedding"][torch.arange(B) + 3] + tqt[
        "mel_pos_embedding"][4][None]
    got = tss.fused_serving_logits(st, x, *c1, 25, LAYERS, HEADS)[0]
    kc, vc, ks, vs = c2
    x32 = x.float().clone()
    gemm = tss.int8_gemm_rows_plain
    for li in range(LAYERS):
        ln = st["ln"][li]
        qkv = gemm(tds.layer_norm_rows_ordered(x32, ln[0], ln[1]),
                   st["wqkv"][li], st["sqkv"][li], st["bqkv"][li])
        att = tss.serving_attention_plain(qkv, kc[li], vc[li], ks[li],
                                          vs[li], 25, HEADS)
        gemm(att, st["wproj"][li], st["sproj"][li], st["bproj"][li], out=x32)
        m = gemm(tds.layer_norm_rows_ordered(x32, ln[2], ln[3]),
                 st["wfc"][li], st["sfc"][li], st["bfc"][li], gelu=True,
                 out_dtype=torch.bfloat16)
        gemm(m, st["wout"][li], st["sout"][li], st["bout"][li], out=x32)
    want = gemm(tds.layer_norm_rows_ordered(x32, *st["lnf"]), st["whead"],
                st["shead"], st["bhead"])
    assert torch.equal(got, want)
    for a, b in zip(c1, c2):
        assert torch.equal(a, b)


def _two_pass_attention(qkv, kc, vc, ks, vs, index, heads):
    """The TPU kernel's attention in float64 with one softmax over all
    positions: each q.k product rounded to bf16 (q rounded to bf16 first;
    the current token's k q product from f32), the k scale folded into the
    scores, the v scale into the values, the current token exact."""
    b, d = qkv.shape[0], kc.shape[-1]
    hd = d // heads
    q, knew, vnew = qkv.float().split(d, dim=-1)
    qb = q.bfloat16().float().reshape(b, 1, heads, hd)
    kk = kc[:, :index].float().reshape(b, index, heads, hd)
    s = ((kk * qb).bfloat16().double().sum(-1)
         * ks[:, :index, None].double() / math.sqrt(hd))
    self_s = ((knew * q).bfloat16().double().reshape(b, heads, hd).sum(-1)
              / math.sqrt(hd))
    p = torch.softmax(torch.cat([s, self_s[:, None]], 1), 1)
    vv = (vc[:, :index].double().reshape(b, index, heads, hd)
          * vs[:, :index, None, None].double())
    vv = torch.cat([vv, vnew.double().reshape(b, 1, heads, hd)], 1)
    return (p[..., None] * vv).sum(1).reshape(b, d)


@pytest.mark.parametrize("index", [0, 1, 127, 128, 129, 300])
def test_serving_attention_plain_matches_one_softmax(index):
    """The twin's online softmax over 128-position chunks (the kernel's
    order: probabilities rounded to bf16 against the running max, chunk
    sums merged as acc * alpha + contrib) against one float64 softmax over
    all positions, at index 0, 1 and the chunk edges. Bound: 1e-2 x max(1,
    |out|), the single ops' bound (bf16 probabilities and output)."""
    rng = np.random.default_rng(index)
    b, s_max, heads = 3, 320, 2
    d = heads * 64
    qkv = torch.from_numpy(rng.standard_normal((b, 3 * d)).astype(
        np.float32))
    kc = torch.from_numpy(rng.integers(-127, 128, (b, s_max, d)).astype(
        np.int8))
    vc = torch.from_numpy(rng.integers(-127, 128, (b, s_max, d)).astype(
        np.int8))
    ks = torch.from_numpy(rng.uniform(1e-3, 1e-2, (b, s_max)).astype(
        np.float32))
    vs = torch.from_numpy(rng.uniform(1e-3, 1e-2, (b, s_max)).astype(
        np.float32))
    want = _two_pass_attention(qkv, kc, vc, ks, vs, index, heads)
    kq, ksc = tss.quantize_rows(qkv[:, d:2 * d])
    got = tss.serving_attention(qkv, kc, vc, ks, vs, index, heads)
    assert got.dtype == torch.bfloat16 and got.shape == (b, d)
    err = (got.double() - want).abs().max().item()
    assert err <= 1e-2 * max(1.0, want.abs().max().item()), err
    assert torch.equal(kc[:, index], kq) and torch.equal(ks[:, index], ksc)
