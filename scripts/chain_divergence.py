#!/usr/bin/env python3
"""How far K1's kernel chain and its plain chain drift apart, on one card.

    python3 scripts/chain_divergence.py --tree DIR [--seeds 0-35] [--bits 4]

imports `xtts_tpu_torch` from DIR and, for each seed, runs the 15-layer
flagship chain of tests/test_torch_port_kernels.py::test_decode_step_chain
(random int8 weights from the seed, a 54-row prefix, 16 teacher-forced
steps; with --bits 4 on the packed int4 stack of the same weights, as
test_decode_step_chain_int4) twice, op by op side by side: through the
kernels and through their plain twins, each on
its own copy of the cache. Both chains are f32 with bf16 intermediates
that sum in other orders, so rounding flips compound over the steps. Per
seed it counts the k-cache elements outside the test's bound (2e-2 + 2e-2
|x|) and the largest difference, and, for each seed that crosses, the
first op of the chain (step, layer, op) whose kernel and twin outputs
differ, and for a product with the norm prologue whether its normalised
input already differs. It also holds one decode_attention call
(kernel and plain twin) against an f64 softmax at index 60 and 300: bf16
outputs that differ from the rounded f64 result. Prints one JSON line.

    python3 scripts/chain_divergence.py --tree DIR --k4 [--seeds 0-7]

runs instead, for each seed, the K4 chain of
tests/test_torch_port_kernels.py::test_serving_step_chain at its flagship
case (15 layers, 16 rows, a 54-row int8 prefix, 16 teacher-forced steps;
seed 0 is the test's own input) through the kernels and through the plain
step, and counts the greedy picks that differ (the test allows 2 of 256),
with each one's logit gap beside the step's largest logit difference.
With --k4-f64 the first chain is the plain step again with
int8_gemm_rows' products summed in float64: the picks that rounding
noise in the products alone turns, the floor for the kernel chain.
--steps sets the chain's length (16; chip_smoke.py's K4 chain is 64).

    python3 scripts/chain_divergence.py --tree DIR --picks [--f64]
        [--bits 4] [--seeds 0-15] [--steps 64]

counts instead, for each seed, the greedy picks that differ between K1's
kernel step (with --f64: the plain step with the gemv's products summed in
float64, each int4 group's on its own) and the plain step over
chip_smoke.py's K1 chain: random flagship int8 weights from the seed (its
int4 stack with --bits 4), a 54-row prefix, 64 teacher-forced random
tokens at B=1. The --f64 counts are the noise floor that rounding alone
sets, from which chip_smoke.py's count bounds on its K1, K1-int4 and K4
chains are taken.
Imports no JAX; needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path


def lockstep(torch, ds, st, x, kernel_cache, plain_cache, index, layers,
             heads):
    """One step of the kernel chain and of the plain chain side by side,
    op by op as ops/decode_step._step runs them (each chain on its own
    cache, updated in place). Returns where the two first differ in this
    step, or None: the layer, the op, the elements that differ and the
    largest difference, and, for a product with the norm prologue, whether
    the prologue's bf16 input already differs (layer_norm_rows, which the
    fused kernel equals bit for bit, against the twin's prologue,
    normed_input)."""
    bits4 = st.get("bits") == 4
    gemv = (ds.int4_gemv, ds.int8_gemv)[not bits4]
    plain = (ds.int4_gemv_plain, ds.int8_gemv_plain)[not bits4]
    (kc, vc), (kc2, vc2) = kernel_cache, plain_cache
    res = [x.float().reshape(-1).clone() for _ in range(2)]
    found = []

    def compare(layer, op, a, b, ln_input=None):
        if found or torch.equal(a, b):
            return
        diff = (a.float() - b.float()).abs()
        at = dict(layer=layer, op=op, elements=int((diff > 0).sum()),
                  max_diff=diff.max().item())
        if ln_input is not None:
            h, ln = ln_input
            at["prologue_input_differs"] = not torch.equal(
                ds.layer_norm_rows(h[None], *ln)[0],
                ds.normed_input(h[None], ln)[0])
        found.append(at)

    def both(layer, op, w, s, b, xs, ln=None, **kw):
        outs = []
        for fn, xin, r in ((gemv, xs[0], res[0]), (plain, xs[1], res[1])):
            if kw.get("out") is not None:
                fn(xin, w, s, b, out=r, ln=ln)
                outs.append(r)
            else:
                outs.append(fn(xin, w, s, b, ln=ln, **kw))
        compare(layer, op, outs[0], outs[1],
                None if ln is None else (xs[0], ln))
        return outs

    for li in range(layers):
        ln = st["ln"][li]
        qkv = both(li, "qkv+ln_1", st["wqkv"][li], st["sqkv"][li],
                   st["bqkv"][li], res, ln=(ln[0], ln[1]))
        att = [ds.decode_attention(qkv[0], kc[li], vc[li], index, heads),
               ds.decode_attention_plain(qkv[1], kc2[li], vc2[li], index,
                                         heads)]
        compare(li, "attention", att[0], att[1])
        both(li, "proj", st["wproj"][li], st["sproj"][li], st["bproj"][li],
             att, out=True)
        m = both(li, "fc+ln_2", st["wfc"][li], st["sfc"][li], st["bfc"][li],
                 res, ln=(ln[2], ln[3]), gelu=True,
                 out_dtype=torch.bfloat16)
        both(li, "out", st["wout"][li], st["sout"][li], st["bout"][li], m,
             out=True)
    both(layers, "head+lnf", st["whead"], st["shead"], st["bhead"], res,
         ln=tuple(st["lnf"]))
    return found[0] if found else None


def make_qtree(torch, g, layers, d, vocab, s_max):
    """The card tests' random int8 tree (tests/test_torch_port_kernels.py
    _qtree), drawn from g in the same order."""
    from xtts_tpu_torch.infer.qdecode import quantize_dense

    def w(i, o):
        return quantize_dense(torch.randn(i, o, generator=g, device="cuda")
                              / math.sqrt(i))

    def vec(n):
        return torch.randn(n, generator=g, device="cuda") * 0.1

    def ln():
        return {"scale": 1.0 + vec(d), "bias": vec(d)}

    return {"layers": [{"ln_1": ln(), "ln_2": ln(), "qkv": w(d, 3 * d),
                        "qkv_b": vec(3 * d), "proj": w(d, d),
                        "proj_b": vec(d), "fc": w(d, 4 * d),
                        "fc_b": vec(4 * d), "out": w(4 * d, d),
                        "out_b": vec(d)} for _ in range(layers)],
            "ln_f": ln(), "final_norm": ln(), "mel_head": w(d, vocab),
            "mel_head_b": vec(vocab),
            "mel_embedding": (torch.randn(vocab, d, generator=g,
                                          device="cuda") * 0.3).bfloat16(),
            "mel_pos_embedding": (torch.randn(s_max, d, generator=g,
                                              device="cuda")
                                  * 0.1).bfloat16()}


def gemm_rows_f64(torch, ds):
    """int8_gemm_rows' plain twin with its products summed in float64."""
    from xtts_tpu_torch.nn.transformer import gelu_new

    def gemm(x, w, scale, bias, out=None, gelu=False,
             out_dtype=torch.float32, ln=None):
        if ln is not None:
            x = ds.normed_input(x, ln)
        y = (x.double() @ w.double()).float() * scale + bias
        if gelu:
            y = gelu_new(y)
        if out is not None:
            out += y
            return out
        return y.to(out_dtype)
    return gemm


def gemv_f64(torch, ds, bits):
    """The K1 gemv's plain twin with its products summed in float64 (each
    int4 group's on its own, then the twin's group rounding and order)."""
    def gemv(x, w, scale, bias, out=None, gelu=False,
             out_dtype=torch.float32, ln=None):
        if ln is not None:
            x = ds.normed_input(x, ln)
        if bits == 8:
            return ds._store((x.double() @ w.double()).float() * scale + bias,
                             out, gelu, out_dtype)
        groups = scale.shape[0]
        wv = ds.unpack_int4(w).double()
        kg = wv.shape[0] // groups
        y = (x.double().reshape(groups, kg, 1)
             * wv.reshape(groups, kg, -1)).sum(1).float() * scale
        y[0] = y[0] + bias
        if not gelu:
            y = y.to(torch.bfloat16).float()
        total = torch.zeros_like(y[0])
        for i in range(groups):
            total = total + y[i]
        return ds._store(total, out, gelu, out_dtype)
    return gemv


def k1_picks(torch, seeds, bits=8, f64=False, steps=64, layers=15, d=1024,
             heads=16, vocab=8194, p_len=54):
    """chip_smoke.py's K1 chain (step_chain) for each seed: {seed:
    {"differ": greedy picks that differ of `steps`, "picks": [[step, logit
    gap in the plain step, the step's largest logit difference], ...]}}."""
    from xtts_tpu_torch.infer.qdecode import quantize_dense
    from xtts_tpu_torch.ops import decode_step as ds
    from chip_smoke import random_qtree
    s_max = -(-(p_len + steps + 1) // 8) * 8
    if f64:
        ops = (gemv_f64(torch, ds, bits), ds.decode_attention_plain)

        def first(*a):
            return ds._step(ops, *a)
    else:
        first = ds.fused_decode_logits
    out = {}
    for seed in seeds:
        g = torch.Generator(device="cuda").manual_seed(seed)
        qt = random_qtree(torch, quantize_dense, layers, d, vocab, s_max, g)
        st = (ds.stack_qtree_int4(qt, vocab) if bits == 4
              else ds.stack_qtree(qt, vocab))
        kc = torch.zeros(layers, s_max, d, dtype=torch.bfloat16,
                         device="cuda")
        kc[:, :p_len] = (torch.randn(layers, p_len, d, generator=g,
                                     device="cuda") * 0.5).bfloat16()
        vc = kc.roll(1, dims=0).clone()
        c1, c2 = (kc, vc), (kc.clone(), vc.clone())
        toks = torch.randint(0, vocab, (steps,), generator=g,
                             device="cuda").tolist()
        picks = []
        with torch.no_grad():
            for step, tok in enumerate(toks):
                x = (qt["mel_embedding"][tok][None]
                     + qt["mel_pos_embedding"][step + 2][None])
                got = first(st, x, *c1, p_len + step, layers,
                            heads)[0][:, :vocab]
                want = ds.fused_decode_logits_plain(
                    st, x, *c2, p_len + step, layers, heads)[0][:, :vocab]
                ka, pa = int(got.argmax()), int(want.argmax())
                if ka != pa:
                    picks.append([step, (want[0, pa] - want[0, ka]).item(),
                                  (got - want).abs().max().item()])
        out[seed] = dict(differ=len(picks), picks=picks)
    return out


def k4_agreement(torch, seeds, f64=False, layers=15, d=1024, heads=16,
                 vocab=8194, rows=16, s_max=96, p_len=54, steps=16):
    """test_serving_step_chain's K4 chain for each seed (with f64, the
    plain step with float64 product sums in place of the kernels): {seed:
    {"differ": greedy picks that differ of 16 x rows, "picks": [[step,
    row, logit gap in the plain step, the step's largest logit
    difference], ...]}}."""
    from xtts_tpu_torch.nn.transformer import KVCache
    from xtts_tpu_torch.ops import decode_step as ds
    from xtts_tpu_torch.ops import serving_step as ss
    if f64:
        ops = (gemm_rows_f64(torch, ds), ss.serving_attention_plain)

        def first(*a):
            return ss._step(ops, *a)
    else:
        first = ss.fused_serving_logits
    s_max = max(s_max, p_len + steps)
    out = {}
    for seed in seeds:
        g = torch.Generator(device="cuda").manual_seed(seed)
        qt = make_qtree(torch, g, layers, d, vocab, s_max)
        st = ds.stack_qtree(qt, vocab)
        shape = (layers, rows, s_max, d // 64, 64)
        k = torch.zeros(shape, device="cuda")
        v = torch.zeros(shape, device="cuda")
        for t in (k, v):
            t[:, :, :p_len] = torch.randn(layers, rows, p_len, d // 64, 64,
                                          generator=g, device="cuda") * 0.5
        c1 = ss.quantize_kv_rowwise(KVCache(k.bfloat16(), v.bfloat16()))
        c2 = [t.clone() for t in c1]
        picks = []
        with torch.no_grad():
            for step in range(steps):
                tok = (torch.arange(rows, device="cuda") * 37 + step) % vocab
                x = (qt["mel_embedding"][tok]
                     + qt["mel_pos_embedding"][step][None])
                got = first(st, x, *c1, p_len + step, layers,
                            heads)[0][:, :vocab]
                want = ss.fused_serving_logits_plain(
                    st, x, *c2, p_len + step, layers, heads)[0][:, :vocab]
                err = (got - want).abs().max().item()
                ka, pa = got.argmax(-1), want.argmax(-1)
                for r in (ka != pa).nonzero().flatten().tolist():
                    picks.append([step, r, (want[r, pa[r]]
                                            - want[r, ka[r]]).item(), err])
        out[seed] = dict(differ=len(picks), picks=picks)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True)
    ap.add_argument("--seeds", default="0-35")
    ap.add_argument("--bits", type=int, choices=(8, 4), default=8,
                    help="4: the chain on the packed int4 stack (int4_gemv)")
    ap.add_argument("--k4", action="store_true",
                    help="count the K4 chain test's differing greedy picks")
    ap.add_argument("--k4-f64", action="store_true",
                    help="--k4 with the plain step on float64 product sums "
                         "in place of the kernels")
    ap.add_argument("--picks", action="store_true",
                    help="count the K1 chain's differing greedy picks "
                         "(chip_smoke.py's step_chain)")
    ap.add_argument("--f64", action="store_true",
                    help="--picks with the plain step on float64 product "
                         "sums in place of the kernels")
    ap.add_argument("--steps", type=int, default=None,
                    help="chain length (--k4: 16, --picks: 64)")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    sys.path.insert(0, str(tree))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chain_divergence: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    from xtts_tpu_torch.ops import decode_step as ds
    assert Path(ds.__file__).resolve().is_relative_to(tree)
    lo_seed, hi_seed = (int(v) for v in args.seeds.split("-"))
    if args.picks or args.f64:
        per_seed = k1_picks(torch, range(lo_seed, hi_seed + 1),
                            bits=args.bits, f64=args.f64,
                            steps=args.steps or 64)
        print(json.dumps(dict(tree=str(tree), seeds=args.seeds, k1=True,
                              bits=args.bits, f64=args.f64,
                              steps=args.steps or 64,
                              differ={s: r["differ"]
                                      for s, r in per_seed.items()},
                              per_seed=per_seed)), flush=True)
        return
    if args.k4 or args.k4_f64:
        per_seed = k4_agreement(torch, range(lo_seed, hi_seed + 1),
                                f64=args.k4_f64, steps=args.steps or 16)
        print(json.dumps(dict(tree=str(tree), seeds=args.seeds, k4=True,
                              f64=args.k4_f64, steps=args.steps or 16,
                              differ={s: r["differ"]
                                      for s, r in per_seed.items()},
                              per_seed=per_seed)), flush=True)
        return
    layers, d, heads, vocab, s_max, p_len = 15, 1024, 16, 8194, 96, 54
    per_seed, first_difference = {}, {}
    for seed in range(lo_seed, hi_seed + 1):
        g = torch.Generator(device="cuda").manual_seed(seed)
        qt = make_qtree(torch, g, layers, d, vocab, s_max)
        st = (ds.stack_qtree_int4(qt, vocab) if args.bits == 4
              else ds.stack_qtree(qt, vocab))
        kc = torch.zeros(layers, s_max, d, dtype=torch.bfloat16,
                         device="cuda")
        kc[:, :p_len] = (torch.randn(layers, p_len, d, generator=g,
                                     device="cuda") * 0.5).bfloat16()
        vc = kc.roll(1, dims=0).clone()
        kc2, vc2 = kc.clone(), vc.clone()
        first = None
        with torch.no_grad():
            for step in range(16):
                tok = (step * 37) % vocab
                x = (qt["mel_embedding"][tok][None]
                     + qt["mel_pos_embedding"][step][None])
                at = lockstep(torch, ds, st, x, (kc, vc), (kc2, vc2),
                              p_len + step, layers, heads)
                if first is None and at is not None:
                    first = dict(step=step, **at)
        diff = (kc.float() - kc2.float()).abs()
        over = int((diff > 2e-2 + 2e-2 * kc2.float().abs()).sum())
        per_seed[seed] = [over, diff.max().item()]
        first_difference[seed] = first

    g = torch.Generator(device="cuda").manual_seed(5)
    attention = {}
    for idx in (60, 300):
        flips = {"kernel": 0, "plain": 0}
        for _ in range(20):
            qkv = torch.randn(3 * d, generator=g, device="cuda")
            k1 = (torch.randn(360, d, generator=g, device="cuda")
                  * 0.5).bfloat16()
            v1 = (torch.randn(360, d, generator=g, device="cuda")
                  * 0.5).bfloat16()
            k2, v2 = k1.clone(), v1.clone()
            got = {"kernel": ds.decode_attention(qkv, k1, v1, idx, heads),
                   "plain": ds.decode_attention_plain(qkv, k2, v2, idx,
                                                      heads)}
            q = qkv[:d].bfloat16().double().reshape(heads, 64)
            kk = k1[:idx + 1].double().reshape(-1, heads, 64)
            vv = v1[:idx + 1].double().reshape(-1, heads, 64)
            p = torch.softmax(torch.einsum("hd,shd->hs", q, kk) / 8, -1)
            ref = torch.einsum("hs,shd->hd", p, vv).reshape(d)
            ref = ref.float().bfloat16()
            for name, out in got.items():
                flips[name] += int((out != ref).sum())
        attention[idx] = dict(flips, of=20 * d)
    failing = [s for s, (over, _) in per_seed.items() if over]
    print(json.dumps(dict(tree=str(tree), seeds=args.seeds, bits=args.bits,
                          failing_seeds=failing, per_seed=per_seed,
                          first_difference={s: first_difference[s]
                                            for s in failing},
                          attention_bf16_flips_vs_f64=attention)),
          flush=True)


if __name__ == "__main__":
    main()
