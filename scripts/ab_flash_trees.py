#!/usr/bin/env python3
"""Device time of K2's kernels at the main bucket, from one tree's sources.

    python3 scripts/ab_flash_trees.py --tree DIR --tag T [--widths 64,256]
                                      [--dtypes bf16,f32]

DIR is the root of a checkout. The script imports that tree's
xtts_tpu_torch (building its flash_attn library under DIR/build/ if it is
not built yet), and times flash_mha's forward, flash_mha_bwd_dkv and
flash_mha_bwd_dq at the main bucket (2, 1280 | 1562) as device us a call
(chip_smoke.device_us: 100 calls captured in one CUDA graph, the median of
five replays): at head width 64 (8 heads) in bf16 and f32, at every other
width of --widths in each dtype of --dtypes (default bf16) over 512
channels (512 / width heads; one head where 512 does not divide, as
chip_smoke's K2_WIDTHS), keys "<kind>_<width>_<kernel>_us" there; "pair"
is the two backward kernels as flash_mha_bwd launches them
(flash_mha_bwd_pair where the tree has it, else dkv then dq);
"sdpa_forward" is torch's scaled_dot_product_attention on the same
inputs, the yardstick the port never calls. Prints
one JSON line with the tag and the card's name and power limit. To
compare two trees, run them in turns (a, b, b, a) on one card, each in a
process of its own.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True)
    ap.add_argument("--tag", required=True)
    ap.add_argument("--widths", default="64",
                    help="comma-separated head widths (default 64)")
    ap.add_argument("--dtypes", default="bf16",
                    help="comma-separated dtypes (bf16, f32) at the widths "
                         "other than 64 (default bf16)")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import torch
    from chip_smoke import device_us
    from xtts_tpu_torch.nn import flash_attn as fa
    if not torch.cuda.is_available():
        raise SystemExit("ab_flash_trees: no CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    g = torch.Generator(device="cuda").manual_seed(0)
    b, tq, tk = 2, 1280, 1562
    out = {"tag": args.tag, "tree": str(tree), "card": card}
    for w in (int(x) for x in args.widths.split(",")):
        h = 512 // w if 512 % w == 0 else 1
        sc = w ** -0.5
        named = {"bf16": torch.bfloat16, "f32": torch.float32}
        kinds = [(named[x], x) for x in
                 ("bf16,f32" if w == 64 else args.dtypes).split(",")]
        for dt, kind in kinds:
            key = kind if w == 64 else f"{kind}_{w}"
            q, k, v, do = (torch.randn(b, t, h, w, generator=g,
                                       device="cuda").to(dt)
                           for t in (tq, tk, tk, tq))
            o, lse = fa._flash_fwd_cuda(q, k, v, sc, True)
            delta = fa._delta(o, do)
            out[f"{key}_forward_us"] = device_us(
                torch, lambda: fa.flash_mha(q, k, v, sc))
            out[f"{key}_dkv_us"] = device_us(
                torch, lambda: fa.flash_mha_bwd_dkv(q, k, v, do, lse, delta,
                                                    sc))
            out[f"{key}_dq_us"] = device_us(
                torch, lambda: fa.flash_mha_bwd_dq(q, k, v, do, lse, delta,
                                                   sc))
            qs, ks, vs = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            out[f"{key}_sdpa_forward_us"] = device_us(
                torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                    qs, ks, vs, scale=sc))
            pair = getattr(fa, "flash_mha_bwd_pair", None) or (
                lambda *a: (fa.flash_mha_bwd_dkv(*a), fa.flash_mha_bwd_dq(*a)))
            out[f"{key}_pair_us"] = device_us(
                torch, lambda: pair(q, k, v, do, lse, delta, sc))
            del q, k, v, do, o, lse, delta, qs, ks, vs
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
