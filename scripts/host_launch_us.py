#!/usr/bin/env python3
"""The host's cost of launching K1's kernels, one checkout at a time.

    python3 scripts/host_launch_us.py --tree DIR --tag NAME

imports `xtts_tpu_torch` from DIR (builds its decode_step kernels there)
and measures on the card, at the flagship widths (D 1024, 16 heads, 15
layers, random int8 weights from seed 0), the host's microseconds a launch:
  - for each K1 gemv product (qkv + ln_1, proj += residual, fc + ln_2 +
    gelu, out += residual, head + ln_f + final_norm) through the Python
    wrapper `int8_gemv` ("wrapper") and through its C entry point called
    with ready-made arguments ("c": the launch itself, the floor a wrapper
    can reach), so wrapper - c is the wrapper's own Python;
  - decode_attention through its wrapper (a control: the same code in
    both trees of an A/B);
  - where the tree keeps per-shape gemv entries (`_gv_launch`), what one
    saves a launch: its lookup ("entry lookup") against planning the
    product and finding its scratch again ("plan + scratch"), at out;
  - a whole K1 step (`fused_decode_logits`, 76 launches) a step.
Each reading is n launches back to back between two perf_counter reads,
no sync inside (fewer than the launch queue holds, so the device keeps up
and the host's cost is what is timed), 15 rounds, the kinds in turns
inside each round; it prints the min and the median of the rounds. Run
two trees in turns (p c c p ...) in one machine call: the host's speed
drifts between calls and processes. Prints one JSON line. Imports no JAX;
needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True)
    ap.add_argument("--tag", required=True)
    ap.add_argument("--rounds", type=int, default=15)
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("host_launch_us: no CUDA card")
    from xtts_tpu_torch.infer.qdecode import quantize_dense
    from xtts_tpu_torch.ops import decode_step as ds
    from xtts_tpu_torch.ops.build import build_all
    assert Path(ds.__file__).resolve().is_relative_to(tree)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    build_all(("decode_step",))
    layers, d, heads, vocab, s_max = 15, 1024, 16, 8194, 256
    g = torch.Generator(device="cuda").manual_seed(0)

    def w(i, o):
        return quantize_dense(torch.randn(i, o, generator=g, device="cuda")
                              / math.sqrt(i))

    def vec(n):
        return torch.randn(n, generator=g, device="cuda") * 0.1

    def ln():
        return {"scale": 1.0 + vec(d), "bias": vec(d)}

    qt = {"layers": [{"ln_1": ln(), "ln_2": ln(), "qkv": w(d, 3 * d),
                      "qkv_b": vec(3 * d), "proj": w(d, d), "proj_b": vec(d),
                      "fc": w(d, 4 * d), "fc_b": vec(4 * d),
                      "out": w(4 * d, d), "out_b": vec(d)}
                     for _ in range(layers)],
          "ln_f": ln(), "final_norm": ln(), "mel_head": w(d, vocab),
          "mel_head_b": vec(vocab)}
    st = ds.stack_qtree(qt, vocab)
    x32 = torch.randn(d, generator=g, device="cuda")
    xb = torch.randn(d, generator=g, device="cuda").bfloat16()
    x4 = torch.randn(4 * d, generator=g, device="cuda").bfloat16()
    res = torch.zeros(d, device="cuda")
    kc = (torch.randn(layers, s_max, d, generator=g, device="cuda")
          * 0.5).bfloat16()
    vc = kc.roll(1, dims=0).clone()
    qkv = torch.randn(3 * d, generator=g, device="cuda")
    lnl = st["ln"][0]
    lnf = tuple(st["lnf"])

    def layer(kind):
        return st["w" + kind][0], st["s" + kind][0], st["b" + kind][0]

    # name: (x, (w, scale, bias), kwargs)
    products = {
        "qkv_ln": (x32, layer("qkv"), dict(ln=(lnl[0], lnl[1]))),
        "proj": (xb, layer("proj"), dict(out=res)),
        "fc_ln": (x32, layer("fc"), dict(gelu=True, out_dtype=torch.bfloat16,
                                         ln=(lnl[2], lnl[3]))),
        "out": (x4, layer("out"), dict(out=res)),
        "head_lnf": (x32, (st["whead"], st["shead"], st["bhead"]),
                     dict(ln=lnf))}
    lib = ds._lib()
    part = torch.empty(1 << 22, device="cuda")
    count = torch.zeros(4096, dtype=torch.int32, device="cuda")
    calls = {}
    for name, (x, (wt, sc, b), kw) in products.items():
        calls[name + " wrapper"] = (
            lambda x=x, wt=wt, sc=sc, b=b, kw=kw: ds.int8_gemv(x, wt, sc, b,
                                                               **kw))
        kw_ln = kw.get("ln")
        fn = lib.xt_int8_gemv_ln if kw_ln else lib.xt_int8_gemv
        # the tree's own C signature: the scratch pointers where it takes
        # them (a split K merges through them)
        n_ptr = len(fn.argtypes) - (11 if kw_ln else 6)
        dst = kw.get("out")
        if dst is None:
            dst = torch.empty(wt.shape[1], device="cuda",
                              dtype=kw.get("out_dtype", torch.float32))
        mode = 2 if "out" in kw else (1 if dst.dtype == torch.bfloat16
                                      else 0)
        ptrs = [wt.data_ptr(), sc.data_ptr(), b.data_ptr(), dst.data_ptr()]
        ptrs += [part.data_ptr(), count.data_ptr()][:n_ptr - 4]
        norm = []
        if kw_ln:
            s2 = kw_ln[2:] or kw_ln
            norm = [kw_ln[0].data_ptr(), kw_ln[1].data_ptr(),
                    s2[0].data_ptr(), s2[1].data_ptr(), len(kw_ln) // 2]
        ds.int8_gemv(x, wt, sc, b, **kw)     # the wrapper's own first-use
        stream = torch.cuda.current_stream().cuda_stream
        a = ([x.data_ptr()] + norm + ptrs
             + [wt.shape[0], wt.shape[1], int(kw.get("gelu", False)), mode,
                stream])
        calls[name + " c"] = lambda fn=fn, a=a: fn(*a)
    calls["decode_attention wrapper"] = lambda: ds.decode_attention(
        qkv, kc[0], vc[0], 200, heads)
    if hasattr(ds, "_gv_launch"):
        wo, so = layer("out")[:2]
        key = (wo.device, 8, wo.shape, so.shape, False)
        tiles = -(-d // ds.I8_COLS)

        def plan_scratch():
            splits = ds.int8_gemv_plan(*wo.shape)[0]
            return ds._gemv_scratch(wo.device, tiles * splits * ds.I8_COLS,
                                    tiles)
        calls["entry lookup"] = lambda: ds._gv_launch.get(key)
        calls["plan + scratch"] = plan_scratch
    step = (lambda: ds.fused_decode_logits(st, xb[None], kc, vc, 200,
                                           layers, heads))
    n_of = {name: 200 for name in calls}
    calls["k1_step"] = step
    n_of["k1_step"] = 10

    for name, fn in calls.items():
        rc = fn()
        if name.endswith(" c") and rc:
            raise SystemExit(f"host_launch_us: {name}: CUDA error")
    torch.cuda.synchronize()
    reads = {name: [] for name in calls}
    for _ in range(args.rounds):
        for name, fn in calls.items():
            n = n_of[name]
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            reads[name].append((time.perf_counter() - t0) * 1e6 / n)
            torch.cuda.synchronize()
    out = {name: dict(min_us=min(v), median_us=statistics.median(v))
           for name, v in reads.items()}
    print(json.dumps(dict(tag=args.tag, card=card, rounds=args.rounds,
                          host_us=out)), flush=True)


if __name__ == "__main__":
    main()
