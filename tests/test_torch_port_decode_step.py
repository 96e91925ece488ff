"""Port parity: K1, the B=1 int8 decode step.

The port's step (xtts_tpu_torch/ops/decode_step.py, plain twin on the CPU)
against the JAX Pallas kernel run in interpret mode
(xtts_tpu/ops/decode_step.fused_decode_logits(..., interpret=True)), at
tests/test_decode_step.py's sizes and (index, mel_pos) cases, with the same
2e-2 tolerance. The kernels themselves are held against these twins on the
card in tests/test_torch_port_kernels.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from xtts_tpu.infer import qdecode as jq  # noqa: E402
from xtts_tpu.ops import decode_step as jds  # noqa: E402
from xtts_tpu_torch.infer import qdecode as tq  # noqa: E402
from xtts_tpu_torch.ops import decode_step as tds  # noqa: E402

LAYERS, D, HEADS, S_MAX, VOCAB = 2, 128, 2, 128, 200


def make_qtrees(seed=0):
    """The same random f32 weights quantized by both packages."""
    rng = np.random.default_rng(seed)

    def w(i, o):
        return rng.standard_normal((i, o)).astype(np.float32) * 0.1

    def vec(n, lo=-0.2, hi=0.2):
        return rng.uniform(lo, hi, n).astype(np.float32)

    raw = {"layers": []}
    for _ in range(LAYERS):
        raw["layers"].append({
            "ln_1": {"scale": 1.0 + vec(D), "bias": vec(D)},
            "ln_2": {"scale": 1.0 + vec(D), "bias": vec(D)},
            "qkv": w(D, 3 * D), "qkv_b": vec(3 * D),
            "proj": w(D, D), "proj_b": vec(D),
            "fc": w(D, 4 * D), "fc_b": vec(4 * D),
            "out": w(4 * D, D), "out_b": vec(D)})
    raw.update(
        ln_f={"scale": 1.0 + vec(D), "bias": vec(D)},
        final_norm={"scale": 1.0 + vec(D), "bias": vec(D)},
        mel_head=w(D, VOCAB), mel_head_b=vec(VOCAB),
        mel_embedding=rng.standard_normal((VOCAB, D)).astype(np.float32) * 0.3,
        mel_pos_embedding=rng.standard_normal((S_MAX, D)).astype(
            np.float32) * 0.1)

    def build(quant, arr, bf16):
        out = {"layers": []}
        for l in raw["layers"]:
            out["layers"].append({
                k: (quant(v) if k in ("qkv", "proj", "fc", "out") else
                    {kk: arr(vv) for kk, vv in v.items()}
                    if isinstance(v, dict) else arr(v))
                for k, v in l.items()})
        for k in ("ln_f", "final_norm"):
            out[k] = {kk: arr(vv) for kk, vv in raw[k].items()}
        out["mel_head"] = quant(raw["mel_head"])
        out["mel_head_b"] = arr(raw["mel_head_b"])
        out["mel_embedding"] = bf16(raw["mel_embedding"])
        out["mel_pos_embedding"] = bf16(raw["mel_pos_embedding"])
        return out

    jt = build(lambda a: jq.quantize_dense(jnp.asarray(a)), jnp.asarray,
               lambda a: jnp.asarray(a, jnp.bfloat16))
    tt = build(lambda a: tq.quantize_dense(torch.from_numpy(a)),
               torch.from_numpy, lambda a: torch.from_numpy(a).bfloat16())
    return jt, tt


def make_cache(seed, prefix_len):
    """Random bf16 (L, S, D) cache with the first prefix_len rows set."""
    rng = np.random.default_rng(seed)
    k = np.zeros((LAYERS, S_MAX, D), np.float32)
    v = np.zeros_like(k)
    k[:, :prefix_len] = rng.standard_normal((LAYERS, prefix_len, D)) * 0.5
    v[:, :prefix_len] = rng.standard_normal((LAYERS, prefix_len, D)) * 0.5
    return k, v


def _x(qt, tok, mel_pos, mod):
    return qt["mel_embedding"][tok] + qt["mel_pos_embedding"][mel_pos][None]


@pytest.mark.parametrize("index,mel_pos", [(0, 1), (17, 5), (100, 36),
                                           (S_MAX - 1, 60)])
def test_step_matches_pallas_kernel(index, mel_pos):
    jt, tt = make_qtrees()
    jst = jds.stack_qtree(jt, VOCAB)
    tst = tds.stack_qtree(tt, VOCAB)
    k, v = make_cache(7 + index, index)
    jlog, jkc, jvc = jds.fused_decode_logits(
        jst, _x(jt, jnp.asarray([3]), mel_pos, jnp),
        jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16), index,
        LAYERS, HEADS, interpret=True)
    tkc = torch.from_numpy(k).bfloat16()
    tvc = torch.from_numpy(v).bfloat16()
    tlog, tkc2, tvc2 = tds.fused_decode_logits(
        tst, _x(tt, torch.tensor([3]), mel_pos, torch), tkc, tvc, index,
        LAYERS, HEADS)
    assert tlog.shape == jlog.shape
    np.testing.assert_allclose(tlog[:, :VOCAB].numpy(),
                               np.asarray(jlog[:, :VOCAB]),
                               rtol=2e-2, atol=2e-2)
    assert int(tlog.argmax()) < VOCAB
    assert float(tlog[:, VOCAB:].max()) < -1e8
    # new k/v rows land at index (in place), nothing else moves
    assert tkc2 is tkc
    np.testing.assert_allclose(tkc[:, index].float().numpy(),
                               np.asarray(jkc[:, index], np.float32),
                               rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(tvc[:, index].float().numpy(),
                               np.asarray(jvc[:, index], np.float32),
                               rtol=3e-2, atol=3e-2)
    mask = np.arange(S_MAX) != index
    np.testing.assert_array_equal(
        tkc[:, mask].float().numpy(),
        torch.from_numpy(k).bfloat16()[:, mask].float().numpy())


def test_greedy_chain_matches_pallas_kernel():
    """20-token greedy chains agree at every step."""
    jt, tt = make_qtrees(1)
    jst = jds.stack_qtree(jt, VOCAB)
    tst = tds.stack_qtree(tt, VOCAB)
    prefix = 11
    k, v = make_cache(3, prefix)
    jkc, jvc = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
    tkc, tvc = torch.from_numpy(k).bfloat16(), torch.from_numpy(v).bfloat16()
    jtok = ttok = 5
    for step in range(20):
        jlog, jkc, jvc = jds.fused_decode_logits(
            jst, _x(jt, jnp.asarray([jtok]), step + 1, jnp), jkc, jvc,
            prefix + step, LAYERS, HEADS, interpret=True)
        tlog, tkc, tvc = tds.fused_decode_logits(
            tst, _x(tt, torch.tensor([ttok]), step + 1, torch), tkc, tvc,
            prefix + step, LAYERS, HEADS)
        jtok, ttok = int(jnp.argmax(jlog)), int(tlog.argmax())
        assert jtok == ttok, f"step {step}: pallas {jtok} vs port {ttok}"


def test_stack_shapes():
    _, tt = make_qtrees(2)
    st = tds.stack_qtree(tt, VOCAB)
    ht = -(-VOCAB // D)
    assert st["head_tiles"] == ht
    assert st["wqkv"].shape == (LAYERS, D, 3 * D)
    assert st["wout"].shape == (LAYERS, 4 * D, D)
    assert st["whead"].shape == (D, ht * D) and st["whead"].dtype == torch.int8
    assert st["ln"].shape == (LAYERS, 4, D) and st["lnf"].shape == (4, D)
    assert float(st["bhead"][VOCAB:].max()) == tds.NEG_INF


def test_cpu_tensors_take_the_plain_twin():
    _, tt = make_qtrees(3)
    st = tds.stack_qtree(tt, VOCAB)
    k, v = make_cache(4, 9)
    tds.reset_launch_counts()
    tds.fused_decode_logits(st, _x(tt, torch.tensor([1]), 2, torch),
                            torch.from_numpy(k).bfloat16(),
                            torch.from_numpy(v).bfloat16(), 9, LAYERS, HEADS)
    assert all(fn.launches == 0 for fn in tds.KERNELS)
    assert tds.fused_decode_logits.launches == 0


# ---------------------------------------------------------------------------
# The norm prologue (ln=): on CPU tensors a fused call is exactly
# layer_norm_rows_ordered (the kernels' statistics in their order) then the
# plain product, and the step built on it is exactly the unfused chain
# (layer_norm_rows_ordered before each product).
# ---------------------------------------------------------------------------

def _prologue_kwargs(mode):
    return {"f32": {}, "bf16+gelu": dict(gelu=True, out_dtype=torch.bfloat16),
            "acc": {}}[mode]


@pytest.mark.parametrize("mode", ["f32", "bf16+gelu", "acc"])
@pytest.mark.parametrize("two", [False, True])
def test_fused_norm_equals_layer_norm_then_product(two, mode):
    _, tt = make_qtrees(5)
    st = tds.stack_qtree(tt, VOCAB)
    rng = np.random.default_rng(11)
    x32 = torch.from_numpy(rng.standard_normal(D).astype(np.float32) * 3 + 1)
    ln = tuple(st["lnf"]) if two else (st["ln"][0][2], st["ln"][0][3])
    w, s, b = st["wfc"][0], st["sfc"][0], st["bfc"][0]
    h = tds.layer_norm_rows_ordered(x32[None], *ln)[0]
    tds.reset_launch_counts()
    if mode == "acc":
        base = torch.from_numpy(rng.standard_normal(w.shape[1]).astype(
            np.float32))
        got, want = base.clone(), base.clone()
        tds.int8_gemv(x32, w, s, b, out=got, ln=ln)
        tds.int8_gemv_plain(h, w, s, b, out=want)
    else:
        kw = _prologue_kwargs(mode)
        got = tds.int8_gemv(x32, w, s, b, ln=ln, **kw)
        want = tds.int8_gemv_plain(h, w, s, b, **kw)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert tds.int8_gemv.launches == tds.int8_gemv.ln_launches == 0


def _unfused_step(st, x, kc, vc, index):
    """The step as it ran before the prologues: the standalone norm's twin
    (layer_norm_rows_ordered) then the plain product."""
    gemv = (tds.int4_gemv_plain if st.get("bits") == 4
            else tds.int8_gemv_plain)
    x32 = x.float().reshape(1, -1).clone()
    h_res = x32[0]
    for li in range(LAYERS):
        ln = st["ln"][li]
        h = tds.layer_norm_rows_ordered(x32, ln[0], ln[1])[0]
        qkv = gemv(h, st["wqkv"][li], st["sqkv"][li], st["bqkv"][li])
        att = tds.decode_attention_plain(qkv, kc[li], vc[li], index, HEADS)
        gemv(att, st["wproj"][li], st["sproj"][li], st["bproj"][li],
             out=h_res)
        h2 = tds.layer_norm_rows_ordered(x32, ln[2], ln[3])[0]
        m = gemv(h2, st["wfc"][li], st["sfc"][li], st["bfc"][li], gelu=True,
                 out_dtype=torch.bfloat16)
        gemv(m, st["wout"][li], st["sout"][li], st["bout"][li], out=h_res)
    xh = tds.layer_norm_rows_ordered(x32, *st["lnf"])[0]
    return gemv(xh, st["whead"], st["shead"], st["bhead"])[None]


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("index", [0, 40])
def test_step_with_prologues_equals_unfused_chain(bits, index):
    _, tt = make_qtrees(6)
    st = (tds.stack_qtree(tt, VOCAB) if bits == 8
          else tds.stack_qtree_int4(tt, VOCAB))
    k, v = make_cache(8 + index, index)
    x = _x(tt, torch.tensor([4]), 3, torch)
    kc, vc = torch.from_numpy(k).bfloat16(), torch.from_numpy(v).bfloat16()
    kc2, vc2 = kc.clone(), vc.clone()
    got, _, _ = tds.fused_decode_logits(st, x, kc, vc, index, LAYERS, HEADS)
    want = _unfused_step(st, x, kc2, vc2, index)
    assert torch.equal(got, want)
    assert torch.equal(kc, kc2) and torch.equal(vc, vc2)


@pytest.mark.parametrize("k,n", [(128, 384), (100, 64), (512, 128),
                                 (1024, 96), (2048, 64), (3000, 32)])
@pytest.mark.parametrize("acc", [False, True])
def test_int8_gemv_plain_within_one_rounding_a_term(k, n, acc):
    """int8_gemv_plain sums in int8_gemv's order (int8_gemv_plan's chunks;
    in each, 64 lanes of strided rows folded 8 at a time, then the folds
    and the chunks in order) and rounds the epilogue's product and sum
    separately: the result equals the float64 (x . W) * scale + bias (+ out)
    within one f32 rounding a term (bf16 x int8 products are exact in f32;
    each of at most k adds rounds once relative to the running sum, bounded
    by sum |x w|) and one for each epilogue operation."""
    rng = np.random.default_rng(k * n)
    w = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8))
    x = torch.from_numpy(rng.standard_normal(k).astype(np.float32)).bfloat16()
    scale = torch.from_numpy(rng.uniform(1e-3, 1e-2, n).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    base = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    u = 2.0 ** -24
    xw = x.double()[:, None] * w.double()
    want = xw.sum(0) * scale.double() + bias.double()
    bound = (k * u * xw.abs().sum(0) * scale.double()
             + 2 * u * (want.abs() + bias.double().abs()))
    if acc:
        got = base.clone()
        tds.int8_gemv_plain(x, w, scale, bias, out=got)
        want = want + base.double()
        bound = bound + u * want.abs()
    else:
        got = tds.int8_gemv_plain(x, w, scale, bias)
    assert got.dtype == torch.float32 and got.shape == (n,)
    assert ((got.double() - want).abs() <= bound).all()


# ---------------------------------------------------------------------------
# P2: layer_norm_rows_ordered, the twin of the kernels' norm statistics
# ---------------------------------------------------------------------------

def _norm_params(rng, d, two):
    return tuple(torch.from_numpy(rng.uniform(0.5, 1.5, d).astype(np.float32))
                 if i % 2 == 0 else
                 torch.from_numpy(rng.uniform(-0.2, 0.2, d).astype(np.float32))
                 for i in range(4 if two else 2))


@pytest.mark.parametrize("d,two", [(128, False), (128, True), (100, True),
                                   (1024, True)])
def test_layer_norm_rows_ordered_matches_jax_ln(d, two):
    """The ordered twin against the JAX kernels' `_ln` (f32 statistics,
    eps 1e-5; two norms: the second over the first's f32 output), both
    rounded to bf16 once at the end. The two sum in other orders and take
    rsqrt differently, so a value may round to the neighbouring bf16: the
    bound is one bf16 step, 2^-7 |y|, plus 1e-6 for values near 0."""
    rng = np.random.default_rng(d + two)
    x = rng.standard_normal((3, d)).astype(np.float32) * 3 + 1
    ln = _norm_params(rng, d, two)
    got = tds.layer_norm_rows_ordered(torch.from_numpy(x), *ln).float()
    y = jds._ln(jnp.asarray(x), jnp.asarray(ln[0].numpy()),
                jnp.asarray(ln[1].numpy()))
    if two:
        y = jds._ln(y, jnp.asarray(ln[2].numpy()), jnp.asarray(ln[3].numpy()))
    want = torch.from_numpy(np.asarray(y.astype(jnp.bfloat16), np.float32))
    torch.testing.assert_close(got, want, rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("d,two", [(128, False), (100, True), (1024, True)])
def test_layer_norm_rows_ordered_matches_plain(d, two):
    """The ordered twin against layer_norm_rows_plain (torch's reductions),
    within the same one bf16 step."""
    rng = np.random.default_rng(7 * d + two)
    x = torch.from_numpy(rng.standard_normal((5, d)).astype(np.float32) * 3
                         + 1)
    ln = _norm_params(rng, d, two)
    got = tds.layer_norm_rows_ordered(x, *ln).float()
    want = tds.layer_norm_rows_plain(x, *ln).float()
    torch.testing.assert_close(got, want, rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("d", [100, 256, 1024, 1500])
def test_sum256_repeats_block_sum256(d):
    """_sum256 equals block_sum256's order written out one f32 add at a
    time (numpy float32): virtual thread t adds elements t, t + 256, ...;
    the 32 lanes of each virtual warp fold by a butterfly (xor 16, 8, 4, 2,
    1); the 8 warp sums, lanes 8..31 zero, by the same butterfly."""
    rng = np.random.default_rng(d)
    v = rng.standard_normal((2, d)).astype(np.float32) * 10

    def butterfly(lanes):
        lanes = list(lanes)
        for o in (16, 8, 4, 2, 1):
            lanes = [np.float32(lanes[i] + lanes[i ^ o]) for i in range(32)]
        return lanes[0]

    for r in range(2):
        acc = [np.float32(0)] * 256
        for t in range(256):
            for i in range(t, d, 256):
                acc[t] = np.float32(acc[t] + v[r, i])
        warps = [butterfly(acc[32 * w:32 * w + 32]) for w in range(8)]
        want = butterfly(warps + [np.float32(0)] * 24)
        got = tds._sum256(torch.from_numpy(v))[r, 0].item()
        assert np.float32(got) == want
