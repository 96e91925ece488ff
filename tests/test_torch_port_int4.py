"""Port parity: K1's int4 mode (XTTS_DECODE_BITS=4) and the quality gate.

The port's packed int4 stack (xtts_tpu_torch/ops/decode_step.py
stack_qtree_int4) against the JAX package's stack_qtree_int4, whose
even||odd column order and out-row permutation are undone here; the port's
int4 step through its plain twins against the JAX Pallas kernel's wbits=4
branch run in interpret mode, at test_torch_port_decode_step.py's sizes and
2e-2 bound; requantize_int4_tree and quantization_quality_gate against the
JAX package's. int4_gemv itself is held against its plain twin on the card
in tests/test_torch_port_kernels.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xtts_tpu.infer import qdecode as jq  # noqa: E402
from xtts_tpu.ops import decode_step as jds  # noqa: E402
from xtts_tpu_torch.infer import qdecode as tq  # noqa: E402
from xtts_tpu_torch.ops import decode_step as tds  # noqa: E402

from test_torch_port_decode_step import (D, HEADS, LAYERS, S_MAX,  # noqa: E402
                                         VOCAB, _x, make_cache, make_qtrees)
from test_torch_port_e2e import one_torch_thread  # noqa: E402,F401

TOL = 2e-2      # tests/test_decode_step.py's bound, relative to max(1, |.|)


def _jax_tiles(j4):
    """JAX int4 stack -> canonical (T, D, D) int values and (T, D) scales:
    undo the even||odd column order (decode_step.py:434-437) and the out
    tiles' row permutation (:438-442)."""
    perm = np.concatenate([np.arange(0, D, 2), np.arange(1, D, 2)])
    inv = np.argsort(perm)
    b = np.asarray(j4["w"]).astype(np.int32)
    w = np.concatenate([((b & 0xF) ^ 8) - 8, b >> 4], axis=-1)[:, :, inv]
    out_idx = [li * 12 + ti for li in range(LAYERS) for ti in (5, 7, 9, 11)]
    w[out_idx] = w[out_idx][:, inv, :]
    return w, np.asarray(j4["s"])[:, inv], np.asarray(j4["b"])[:, inv]


def _port_tiles(t4):
    """Port int4 stack -> the same (T, D, D) tiles in the TPU kernel's
    order: per layer q, k, v, proj, (fc_i, out_i) x 4; then the head."""
    w, s, b = [], [], []

    def add(wt, st, bt):
        w.append(tds.unpack_int4(wt).numpy())
        s.append(st.numpy())
        b.append(bt.numpy())

    for li in range(LAYERS):
        for i in range(3):
            sl = slice(i * D, (i + 1) * D)
            add(t4["wqkv"][li][:, i * D // 2:(i + 1) * D // 2],
                t4["sqkv"][li][0, sl], t4["bqkv"][li][sl])
        add(t4["wproj"][li], t4["sproj"][li][0], t4["bproj"][li])
        for i in range(4):
            sl = slice(i * D, (i + 1) * D)
            add(t4["wfc"][li][:, i * D // 2:(i + 1) * D // 2],
                t4["sfc"][li][0, sl], t4["bfc"][li][sl])
            add(t4["wout"][li][sl], t4["sout"][li][i],
                t4["bout"][li] if i == 0 else torch.zeros(D))
    for i in range(t4["head_tiles"]):
        sl = slice(i * D, (i + 1) * D)
        add(t4["whead"][:, i * D // 2:(i + 1) * D // 2], t4["shead"][0, sl],
            t4["bhead"][sl])
    return np.stack(w), np.stack(s), np.stack(b)


@pytest.mark.parametrize("seed", [0, 4])
def test_int4_stack_bit_exact(seed):
    jt, tt = make_qtrees(seed)
    jw, js, jb = _jax_tiles(jds.stack_qtree_int4(jt, VOCAB))
    t4 = tds.stack_qtree_int4(tt, VOCAB)
    tw, ts, tb = _port_tiles(t4)
    assert t4["bits"] == 4 and t4["wout"].dtype == torch.int8
    assert t4["sout"].shape == (LAYERS, 4, D)     # four groups along K
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tb, jb)
    assert np.abs(tw).max() <= 7


def test_pack_unpack_round_trip():
    rng = np.random.default_rng(5)
    w4 = torch.from_numpy(rng.integers(-7, 8, (6, 40)).astype(np.int8))
    packed = tds.pack_int4(w4)
    assert packed.shape == (6, 20) and packed.dtype == torch.int8
    assert torch.equal(tds.unpack_int4(packed), w4)
    # low nibble holds the even column, high nibble the odd one
    b = int(packed[0, 0]) & 0xFF
    assert ((b & 0xF) ^ 8) - 8 == int(w4[0, 0])
    assert ((b >> 4) ^ 8) - 8 == int(w4[0, 1])


@pytest.mark.parametrize("gelu", [False, True])
def test_int4_gemv_plain_group_math(gelu):
    """Four groups along K: each group's output rounded to bf16 (not before
    gelu), summed in order, bias once."""
    rng = np.random.default_rng(6)
    k, n, g = 64, 32, 4
    w4 = torch.from_numpy(rng.integers(-7, 8, (k, n)).astype(np.int8))
    x = torch.from_numpy(rng.standard_normal(k)).bfloat16()
    s = torch.from_numpy(rng.uniform(0.01, 0.1, (g, n))).float()
    b = torch.from_numpy(rng.standard_normal(n)).float()
    got = tds.int4_gemv_plain(x, tds.pack_int4(w4), s, b, gelu=gelu)
    want = torch.zeros(n)
    for i in range(g):
        rows = slice(i * k // g, (i + 1) * k // g)
        y = (x.float()[rows] @ w4[rows].float()) * s[i] + (b if i == 0 else 0)
        want = want + (y if gelu else y.bfloat16().float())
    if gelu:
        want = tds.gelu_new_ordered(want)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    acc = torch.ones(n)
    tds.int4_gemv_plain(x, tds.pack_int4(w4), s, b, out=acc, gelu=gelu)
    torch.testing.assert_close(acc, 1 + want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("index,mel_pos", [(0, 1), (17, 5), (S_MAX - 1, 60)])
def test_int4_step_matches_pallas_kernel(index, mel_pos):
    jt, tt = make_qtrees(0)
    jst = jds.stack_qtree_int4(jt, VOCAB)
    tst = tds.stack_qtree_int4(tt, VOCAB)
    k, v = make_cache(7 + index, index)
    jlog, jkc, jvc = jds.fused_decode_logits(
        jst, _x(jt, jnp.asarray([3]), mel_pos, jnp),
        jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16), index,
        LAYERS, HEADS, interpret=True)
    tkc, tvc = torch.from_numpy(k).bfloat16(), torch.from_numpy(v).bfloat16()
    tds.reset_launch_counts()
    tlog, _, _ = tds.fused_decode_logits(
        tst, _x(tt, torch.tensor([3]), mel_pos, torch), tkc, tvc, index,
        LAYERS, HEADS)
    assert tds.int4_gemv.launches == 0 and tds.int8_gemv.launches == 0
    want = np.asarray(jlog[:, :VOCAB])
    np.testing.assert_allclose(tlog[:, :VOCAB].numpy(), want, rtol=0,
                               atol=TOL * max(1.0, np.abs(want).max()))
    assert float(tlog[:, VOCAB:].max()) < -1e8
    for got, ref in ((tkc, jkc), (tvc, jvc)):
        r = np.asarray(ref[:, index], np.float32)
        np.testing.assert_allclose(got[:, index].float().numpy(), r, rtol=0,
                                   atol=TOL * max(1.0, np.abs(r).max()))


# Greedy picks of the 20-step int4 chains that may differ a seed. int4
# logits are rounded to bf16, so exact top-2 ties occur, and a tie turns
# under any rounding difference: the floor is the twin's own count of
# exact top-2 ties, seeds 0-15: 0 (7 seeds), 1 (7), 2 (2). The float64
# product sums alone turn no pick (0 in every seed). JAX's Pallas kernel
# against the twin, seeds 0-15: 1 pick in 4 seeds (10, 11, 13, 15; each at
# an exact tie of the twin), 0 in the rest. Bound: the floor's largest
# count.
INT4_CHAIN_PICKS = 2


@pytest.mark.parametrize("seed", range(16))
def test_int4_greedy_chain_matches_pallas_kernel(seed):
    """20-token greedy chains, both sides fed the reference's pick: logits
    within TOL every step, and at most INT4_CHAIN_PICKS differing picks."""
    jt, tt = make_qtrees(seed)
    jst = jds.stack_qtree_int4(jt, VOCAB)
    tst = tds.stack_qtree_int4(tt, VOCAB)
    prefix = 11
    k, v = make_cache(100 + seed, prefix)
    jkc, jvc = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
    tkc, tvc = torch.from_numpy(k).bfloat16(), torch.from_numpy(v).bfloat16()
    tok, differ = 5, 0
    for step in range(20):
        jlog, jkc, jvc = jds.fused_decode_logits(
            jst, _x(jt, jnp.asarray([tok]), step + 1, jnp), jkc, jvc,
            prefix + step, LAYERS, HEADS, interpret=True)
        tlog, tkc, tvc = tds.fused_decode_logits(
            tst, _x(tt, torch.tensor([tok]), step + 1, torch), tkc, tvc,
            prefix + step, LAYERS, HEADS)
        jl = np.asarray(jlog[0, :VOCAB])
        tl = tlog[0, :VOCAB].numpy()
        assert np.abs(jl - tl).max() <= TOL * max(1.0, np.abs(jl).max())
        differ += int(jl.argmax() != tl.argmax())
        tok = int(jl.argmax())  # both chains go on with the reference's pick
    assert differ <= INT4_CHAIN_PICKS


# ---------------------------------------------------------------------------
# the quality gate (xtts_tpu/infer/qdecode.py:274-408)
# ---------------------------------------------------------------------------

def test_requantize_int4_tree_bit_exact():
    jt, tt = make_qtrees(2)
    j4, t4 = jq.requantize_int4_tree(jt), tq.requantize_int4_tree(tt)
    for li in range(LAYERS):
        for kind in ("qkv", "proj", "fc", "out"):
            for f in ("w", "scale"):
                np.testing.assert_array_equal(
                    t4["layers"][li][kind][f].numpy(),
                    np.asarray(j4["layers"][li][kind][f]))
    np.testing.assert_array_equal(t4["mel_head"]["w"].numpy(),
                                  np.asarray(j4["mel_head"]["w"]))


def test_r4_gate_grid_is_not_the_kernel_grid():
    """ROADMAP R4: the gate's int4 grid takes one scale per column over the
    whole K axis; K1-int4 one per (D-row group, column). For qkv (K = D)
    the two agree; for the MLP out matrix (K = 4D) they differ."""
    _, tt = make_qtrees(0)
    gate = tq.requantize_int4_tree(tt)["layers"][0]
    kern = tds.stack_qtree_int4(tt, VOCAB)
    torch.testing.assert_close(gate["qkv"]["scale"], kern["sqkv"][0, 0],
                               rtol=0, atol=0)
    g_out, k_out = gate["out"]["scale"], kern["sout"][0]       # (D,), (4, D)
    torch.testing.assert_close(g_out, k_out.amax(dim=0), rtol=0, atol=0)
    rel = ((k_out - g_out).abs() / g_out).max()
    assert rel > 0.05, rel


@pytest.fixture(scope="module")
def gate_pair():
    from test_torch_port_e2e import TINY, TINY_T, randomize, traced_zeros
    from xtts_tpu.models.gpt import UnifiedVoice as JVoice
    from xtts_tpu_torch.models.gpt import UnifiedVoice as TVoice
    from xtts_tpu_torch.utils import convert
    model = JVoice(TINY.gpt)
    # the eager init's shapes and key order by tracing alone (randomize
    # redraws every leaf: the same draws)
    variables = traced_zeros(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, TINY.gpt.mel_bins, 16)),
        jnp.zeros((1, 8), jnp.int32), jnp.array([8]),
        jnp.zeros((1, 16), jnp.int32), jnp.array([16 * 1024])))
    variables = {"params": randomize(variables["params"],
                                     np.random.default_rng(0))}
    tmodel = TVoice(TINY_T.gpt).eval()
    tmodel.load_state_dict(convert.to_torch(convert.unified_voice_from_jax(
        variables, TINY.gpt.layers, TINY.gpt.cond_attn_blocks), "cpu"))
    rng = np.random.default_rng(3)
    cond = rng.standard_normal((1, TINY.gpt.mel_bins, 24)).astype(np.float32)
    text = rng.integers(3, 250, (1, 12)).astype(np.int32)
    codes = rng.integers(0, 198, (1, 16)).astype(np.int32)
    return model, variables, tmodel, cond, text, codes


@pytest.mark.parametrize("bits,kv_quant", [(8, False), (4, False),
                                           (4, True)])
def test_quality_gate_matches_jax(gate_pair, bits, kv_quant):
    """Agreement equal to JAX's, except at positions whose top-2 logits (of
    either arm) lie within the engines' logit error."""
    model, variables, tmodel, cond, text, codes = gate_pair
    want = jq.quantization_quality_gate(model, variables, cond, text, codes,
                                        bits=bits, kv_quant=kv_quant)
    got = tq.quantization_quality_gate(tmodel, torch.from_numpy(cond), text,
                                       codes, bits=bits, kv_quant=kv_quant)
    assert got["n_positions"] == want["n_positions"] == codes.size
    assert (got["bits"], got["kv_quant"]) == (bits, kv_quant)
    qt = tq.quantize_gpt_decode(tmodel, include_fused=False)
    if bits == 4:
        qt = tq.requantize_int4_tree(qt)
    _, _, margin = tq._teacher_forced_agreement(
        tmodel, qt, torch.from_numpy(cond), torch.from_numpy(text).long(),
        torch.from_numpy(codes).long(), kv_quant=kv_quant)
    near = int((margin <= TOL).sum())
    diff = abs(got["agreement"] - want["agreement"]) * codes.size
    assert diff <= near + 1e-6, (got, want, near)


def test_quality_gate_fused_serving_engine(gate_pair):
    """The K4 arm (plain twins on the CPU) over 8 rows, as the JAX
    package's gate runs it (tests/test_qdecode.py)."""
    _, _, tmodel, cond, text, codes = gate_pair
    res = tq.quantization_quality_gate(
        tmodel, torch.from_numpy(cond).repeat(8, 1, 1),
        np.tile(text, (8, 1)), np.tile(codes, (8, 1)), fused_serving=True)
    assert res["fused_serving"] and res["n_positions"] == 8 * codes.shape[1]
    assert 0.5 <= res["agreement"] <= 1.0
    with pytest.raises(ValueError, match="separate engines"):
        tq.quantization_quality_gate(tmodel, cond, text, codes,
                                     kv_quant=True, fused_serving=True)


def test_r5_int4_stack_refused_by_k4(gate_pair, monkeypatch):
    """ROADMAP R5: K4 reads int8 tiles; with XTTS_DECODE_BITS=4 the port
    refuses instead of handing it the packed int4 stack."""
    _, _, tmodel, cond, text, codes = gate_pair
    monkeypatch.setenv("XTTS_DECODE_BITS", "4")
    qt = tq.quantize_gpt_decode(tmodel)
    assert qt["fused"]["bits"] == 4
    cond8 = torch.from_numpy(cond).repeat(8, 1, 1)
    text8 = torch.from_numpy(text).long().repeat(8, 1)
    with pytest.raises(ValueError, match="int4"):
        tq.generate_speech_quantized(tmodel, qt, cond8, text8, None,
                                     max_gen=4, do_sample=False,
                                     use_fused_serving=True)
    with pytest.raises(ValueError, match="int4"):
        tq.quantization_quality_gate(tmodel, cond8, text8,
                                     np.tile(codes, (8, 1)),
                                     fused_serving=True)
    monkeypatch.delenv("XTTS_DECODE_BITS")
    assert "bits" not in tq.quantize_gpt_decode(tmodel)["fused"]


@pytest.mark.parametrize("mode", ["f32", "bf16+gelu", "acc"])
@pytest.mark.parametrize("two", [False, True])
@pytest.mark.parametrize("groups", [1, 4])
def test_int4_fused_norm_equals_layer_norm_then_product(groups, two, mode):
    """ln= on CPU tensors: exactly layer_norm_rows_ordered (the kernels'
    statistics in their order) then the plain int4 product, with one scale
    group or four along K."""
    rng = np.random.default_rng(12 + groups)
    n = 3 * D
    w4 = torch.from_numpy(rng.integers(-7, 8, (D, n)).astype(np.int8))
    s = torch.from_numpy(rng.uniform(0.01, 0.1, (groups, n))).float()
    b = torch.from_numpy(rng.standard_normal(n)).float()
    x32 = torch.from_numpy(rng.standard_normal(D).astype(np.float32) * 3 + 1)
    ln = tuple(torch.from_numpy(rng.uniform(0.5, 1.5, D)).float()
               if i % 2 == 0 else
               torch.from_numpy(rng.uniform(-0.2, 0.2, D)).float()
               for i in range(4 if two else 2))
    w = tds.pack_int4(w4)
    h = tds.layer_norm_rows_ordered(x32[None], *ln)[0]
    tds.reset_launch_counts()
    if mode == "acc":
        base = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
        got, want = base.clone(), base.clone()
        tds.int4_gemv(x32, w, s, b, out=got, ln=ln)
        tds.int4_gemv_plain(h, w, s, b, out=want)
    else:
        kw = ({} if mode == "f32"
              else dict(gelu=True, out_dtype=torch.bfloat16))
        got = tds.int4_gemv(x32, w, s, b, ln=ln, **kw)
        want = tds.int4_gemv_plain(h, w, s, b, **kw)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert tds.int4_gemv.launches == tds.int4_gemv.ln_launches == 0
