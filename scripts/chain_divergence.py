#!/usr/bin/env python3
"""How far K1's kernel chain and its plain chain drift apart, on one card.

    python3 scripts/chain_divergence.py --tree DIR [--seeds 0-35]

imports `xtts_tpu_torch` from DIR and, for each seed, runs the 15-layer
flagship chain of tests/test_torch_port_kernels.py::test_decode_step_chain
(random int8 weights from the seed, a 54-row prefix, 16 teacher-forced
steps) twice: through the kernels and through their plain twins, each on
its own copy of the cache. Both chains are f32 with bf16 intermediates
that sum in other orders, so rounding flips compound over the steps. Per
seed it counts the k-cache elements outside the test's bound (2e-2 + 2e-2
|x|) and the largest difference. It also holds one decode_attention call
(kernel and plain twin) against an f64 softmax at index 60 and 300: bf16
outputs that differ from the rounded f64 result. Prints one JSON line.
Imports no JAX; needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True)
    ap.add_argument("--seeds", default="0-35")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chain_divergence: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    from xtts_tpu_torch.infer.qdecode import quantize_dense
    from xtts_tpu_torch.ops import decode_step as ds
    assert Path(ds.__file__).resolve().is_relative_to(tree)
    first, last = (int(v) for v in args.seeds.split("-"))
    layers, d, heads, vocab, s_max, p_len = 15, 1024, 16, 8194, 96, 54
    per_seed = {}
    for seed in range(first, last + 1):
        g = torch.Generator(device="cuda").manual_seed(seed)

        def w(i, o):
            return quantize_dense(torch.randn(i, o, generator=g,
                                              device="cuda") / math.sqrt(i))

        def vec(n):
            return torch.randn(n, generator=g, device="cuda") * 0.1

        def ln():
            return {"scale": 1.0 + vec(d), "bias": vec(d)}

        qt = {"layers": [{"ln_1": ln(), "ln_2": ln(), "qkv": w(d, 3 * d),
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
        st = ds.stack_qtree(qt, vocab)
        kc = torch.zeros(layers, s_max, d, dtype=torch.bfloat16,
                         device="cuda")
        kc[:, :p_len] = (torch.randn(layers, p_len, d, generator=g,
                                     device="cuda") * 0.5).bfloat16()
        vc = kc.roll(1, dims=0).clone()
        kc2, vc2 = kc.clone(), vc.clone()
        with torch.no_grad():
            for step in range(16):
                tok = (step * 37) % vocab
                x = (qt["mel_embedding"][tok][None]
                     + qt["mel_pos_embedding"][step][None])
                ds.fused_decode_logits(st, x, kc, vc, p_len + step, layers,
                                       heads)
                ds.fused_decode_logits_plain(st, x, kc2, vc2, p_len + step,
                                             layers, heads)
        diff = (kc.float() - kc2.float()).abs()
        over = int((diff > 2e-2 + 2e-2 * kc2.float().abs()).sum())
        per_seed[seed] = [over, diff.max().item()]

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
    print(json.dumps(dict(tree=str(tree), seeds=args.seeds,
                          failing_seeds=failing, per_seed=per_seed,
                          attention_bf16_flips_vs_f64=attention)),
          flush=True)


if __name__ == "__main__":
    main()
