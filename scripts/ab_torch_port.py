#!/usr/bin/env python3
"""A/B the PyTorch port of two checkouts on one card, one process a run.

    python3 scripts/ab_torch_port.py --tree DIR --tag NAME

imports `xtts_tpu_torch` from DIR (build its kernels there), then measures
on the card, at the flagship XTTSConfig() widths with random weights from
fixed seeds (chip_smoke.py's [main] inputs: 3 s sine + noise reference, 50
text tokens from numpy seed 0, the stop logit pinned low so every request
decodes 300 codes):
  - three B=1 `tts_tokens` requests after one warm-up: latency, AR
    seconds and tokens/s, render seconds, and (where the tree has the
    device loop, infer/device_loop.py) the loop's host reads, graph
    replays and eager steps a request;
  - one `synthesize_batch` wave of 8 requests x 2 candidates through K4
    (XTTS_FUSED_SERVING=1, shortcut render, CLVP rerank) after one
    warm-up: wall seconds;
  - the K1 step (`fused_decode_logits` on the model's own int8 stack) and
    the K4 step at 16 rows, each as 100 back-to-back steps between two CUDA
    events (the rate the host can launch them at), five times: min and
    median ms a step, and the median of this process's CPU time a step
    (time.process_time: the host's own launch cost, which other tenants of
    a shared host move less than the wall clock); the CUDA-event median of
    single K2 calls
    (`flash_mha` at (2, 1280 | 1562, 8, 64));
  - device time a call (us; calls captured in one CUDA graph and replayed
    between CUDA events, so the host launch is out), the host's us a
    launch (500 launches back to back) and the single-call
    CUDA-event ms of int8_gemv at every K1 shape on the model's layer-0
    weights (qkv + ln_1, proj += residual, fc + ln_2 + gelu, out +=
    residual, head + ln_f + final_norm), serving_attention (16 rows x 16
    heads, index 353 of a random 360-position int8 cache), decode_attention
    (16 heads, rows 0..300 of 360),
    int8_gemm_rows fc + gelu, proj += residual and out += residual at 16
    rows, and int8_gemm_rows head + ln_f +
    final_norm at 16 rows fused and as layer_norm_rows + product; device
    time a call of int4_gemv (K1-int4) at fc + gelu and out += residual and
    of vq_nearest (K3) at (3008, 512, 8192); device time a step (100 steps
    in one graph) of the K1 step on the int8 stack and on the int4 stack
    (stack_qtree_int4 of the same tree) and of the K4 step at 16 rows.
The cache index goes to the attention kernels as a device int64 where the
tree takes one (a captured launch cannot copy an int to the card), else
as an int. Prints one JSON line. Compare two trees only inside one machine
call, in turns (A, B, B, A): host launch times differ between calls.
Imports no JAX; needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import device_us, time_ms  # noqa: E402


def step_ms(torch, fn, steps=100, rounds=5):
    """Over `rounds` of `steps` back-to-back calls: (min, median) of the ms
    a call between CUDA events, and the median CPU ms a call."""
    fn()
    torch.cuda.synchronize()
    out, cpu = [], []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        c0 = time.process_time()
        a.record()
        for _ in range(steps):
            fn()
        b.record()
        b.synchronize()
        cpu.append((time.process_time() - c0) * 1e3 / steps)
        out.append(a.elapsed_time(b) / steps)
    return min(out), statistics.median(out), statistics.median(cpu)


def host_us(torch, fn, n=500):
    """The host's us a launch: the wall time of n calls back to back, no
    sync between them (fewer than the launch queue holds; the device keeps
    up, so this is the launch cost the AR loop pays), median of five
    rounds. (process_time ticks in 10 ms steps on the card's machine.)"""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out.append((time.perf_counter() - t0) * 1e6 / n)
        torch.cuda.synchronize()
    return statistics.median(out)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True)
    ap.add_argument("--tag", required=True)
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("ab_torch_port: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from xtts_tpu_torch.infer.api import TextToSpeech, TTSSettings, XTTSConfig
    from xtts_tpu_torch.infer.serving import (SynthesisRequest,
                                              synthesize_batch)
    from xtts_tpu_torch.nn import flash_attn as fa
    from xtts_tpu_torch.ops import decode_step as ds
    from xtts_tpu_torch.ops import serving_step as ss
    from xtts_tpu_torch.ops import vq as vq_mod
    from xtts_tpu_torch.ops.build import build_all
    import xtts_tpu_torch
    assert Path(xtts_tpu_torch.__file__).resolve().is_relative_to(tree)
    try:
        from xtts_tpu_torch.infer import device_loop
    except ImportError:         # a tree from before the device loop
        device_loop = None

    def at(i):
        """The index as the tree's kernels take it in a captured graph."""
        if hasattr(ds, "cache_index"):
            return torch.tensor(i, dtype=torch.long, device="cuda")
        return i

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    build_all(("decode_step", "flash_attn", "vq", "serving_step"))
    cfg = XTTSConfig()
    sr = 24000
    tts = TextToSpeech(cfg, device="cuda", dtype=torch.bfloat16,
                       quantized_decode=True, with_clvp=True,
                       generator=torch.Generator(device="cuda").manual_seed(0))
    with torch.no_grad():
        tts.gpt.mel_head.bias[cfg.gpt.stop_mel_token] = -30.0
        tts.requantize()
    rng = np.random.default_rng(0)
    t = np.arange(3 * sr) / sr
    wav = (0.3 * np.sin(2 * np.pi * 220 * t)
           + 0.1 * rng.standard_normal(3 * sr)).astype(np.float32)
    text = rng.integers(3, 250, (1, 50)).astype(np.int32)
    cond = tts.cond_mel_from_wav(wav)
    settings = TTSSettings(max_mel_tokens=300)

    def request(seed):
        if device_loop is not None:
            device_loop.STATS.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = tts.tts_tokens(text, cond, torch.Generator(
            device="cuda").manual_seed(seed), settings)
        return time.perf_counter() - t0, out

    request(0)
    reqs = []
    for seed in (1, 2, 3):
        lat, out = request(seed)
        reqs.append(dict(latency_s=lat, ar_s=out["ar_seconds"],
                         ar_tokens_per_s=out["steps"] / out["ar_seconds"],
                         render_s=out["render_seconds"]))
        if device_loop is not None:
            reqs[-1].update(host_reads=device_loop.STATS.syncs,
                            replays=device_loop.STATS.replays,
                            eager_steps=device_loop.STATS.eager_steps)

    os.environ["XTTS_FUSED_SERVING"] = "1"
    batch = [SynthesisRequest(text[0]) for _ in range(8)]
    wave = TTSSettings(max_mel_tokens=300, num_candidates=2)
    for i in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        synthesize_batch(tts, batch, cond, wave, use_diffusion=False,
                         generator=torch.Generator(device="cuda")
                         .manual_seed(9))
        torch.cuda.synchronize()
        wave_s = time.perf_counter() - t0
    os.environ.pop("XTTS_FUSED_SERVING")

    with torch.no_grad():
        st = tts._qtree["fused"]
        L, D, H = cfg.gpt.layers, cfg.gpt.model_dim, cfg.gpt.heads
        kc = torch.zeros(L, 360, D, dtype=torch.bfloat16, device="cuda")
        vc = torch.zeros_like(kc)
        x = torch.randn(1, D, device="cuda").bfloat16()
        i200, i300, i353 = at(200), at(300), at(353)
        k1 = step_ms(torch, lambda: ds.fused_decode_logits(
            st, x, kc, vc, i200, L, H))
        kq = torch.zeros(L, 16, 360, D, dtype=torch.int8, device="cuda")
        vq = torch.zeros_like(kq)
        ks = torch.full((L, 16, 360), 0.01, device="cuda")
        vs = ks.clone()
        x16 = torch.randn(16, D, device="cuda").bfloat16()
        k4 = step_ms(torch, lambda: ss.fused_serving_logits(
            st, x16, kq, vq, ks, vs, i200, L, H))
        g = torch.Generator(device="cuda").manual_seed(99)
        q, k, v = (torch.randn(2, n, 8, 64, generator=g,
                               device="cuda").bfloat16()
                   for n in (1280, 1562, 1562))
        flash_ms = time_ms(torch, lambda: fa.flash_mha(q, k, v, 0.125))

        kern = {}
        qkv = torch.randn(3 * D, generator=g, device="cuda")
        kc1, vc1 = ((torch.randn(360, D, generator=g, device="cuda") * 0.5)
                    .bfloat16() for _ in range(2))
        x16b = torch.randn(16, D, generator=g, device="cuda").bfloat16()
        x32 = torch.randn(16, D, generator=g, device="cuda") * 3 + 1
        x16o = torch.randn(16, 4 * D, generator=g, device="cuda").bfloat16()
        res16 = torch.zeros(16, D, device="cuda")
        head = (st["whead"], st["shead"], st["bhead"])
        lnf = tuple(st["lnf"])
        ln0 = st["ln"][0]
        xd = torch.randn(D, generator=g, device="cuda").bfloat16()
        x32d = torch.randn(D, generator=g, device="cuda") * 3 + 1
        x4d = torch.randn(4 * D, generator=g, device="cuda").bfloat16()
        resd = torch.zeros(D, device="cuda")
        kq1, vq1 = (torch.randint(-127, 128, (16, 360, D), generator=g,
                                  device="cuda").to(torch.int8)
                    for _ in range(2))
        ks1, vs1 = (torch.rand(16, 360, generator=g, device="cuda") * 0.01
                    for _ in range(2))
        q16 = torch.randn(16, 3 * D, generator=g, device="cuda")

        def layer(kind):
            return st["w" + kind][0], st["s" + kind][0], st["b" + kind][0]
        calls = {
            "int8_gemv_qkv_ln": lambda: ds.int8_gemv(
                x32d, *layer("qkv"), ln=(ln0[0], ln0[1])),
            "int8_gemv_proj": lambda: ds.int8_gemv(xd, *layer("proj"),
                                                   out=resd),
            "int8_gemv_fc_ln": lambda: ds.int8_gemv(
                x32d, *layer("fc"), gelu=True, out_dtype=torch.bfloat16,
                ln=(ln0[2], ln0[3])),
            "int8_gemv_out": lambda: ds.int8_gemv(x4d, *layer("out"),
                                                  out=resd),
            "int8_gemv_head_lnf": lambda: ds.int8_gemv(x32d, *head, ln=lnf),
            "serving_attention": lambda: ss.serving_attention(
                q16, kq1, vq1, ks1, vs1, i353, H),
            "decode_attention": lambda: ds.decode_attention(qkv, kc1, vc1,
                                                            i300, H),
            "int8_gemm_rows_fc16": lambda: ss.int8_gemm_rows(
                x16b, st["wfc"][0], st["sfc"][0], st["bfc"][0], gelu=True,
                out_dtype=torch.bfloat16),
            "int8_gemm_rows_proj16": lambda: ss.int8_gemm_rows(
                x16b, st["wproj"][0], st["sproj"][0], st["bproj"][0],
                out=res16),
            "int8_gemm_rows_out16": lambda: ss.int8_gemm_rows(
                x16o, st["wout"][0], st["sout"][0], st["bout"][0],
                out=res16),
            "int8_gemm_rows_head_lnf16": lambda: ss.int8_gemm_rows(
                x32, *head, ln=lnf),
            "head_lnf16_pair": lambda: ss.int8_gemm_rows(
                ds.layer_norm_rows(x32, *lnf), *head)}
        for name, fn in calls.items():
            kern[name] = dict(device_us=device_us(torch, fn),
                              ms=time_ms(torch, fn),
                              host_us=host_us(torch, fn))
        # K1-int4: int4_gemv at fc + gelu and the whole int4 step; K3:
        # vq_nearest at the DVAE round trip's shape
        st4 = ds.stack_qtree_int4(tts._qtree, cfg.gpt.number_mel_codes)
        xfc = torch.randn(D, generator=g, device="cuda").bfloat16()
        calls4 = {
            "int4_gemv_fc": lambda: ds.int4_gemv(
                xfc, st4["wfc"][0], st4["sfc"][0], st4["bfc"][0], gelu=True,
                out_dtype=torch.bfloat16),
            "int4_gemv_out": lambda: ds.int4_gemv(
                x16o[0], st4["wout"][0], st4["sout"][0], st4["bout"][0],
                out=res16[0])}
        for name, fn in calls4.items():
            kern[name] = dict(device_us=device_us(torch, fn),
                              ms=time_ms(torch, fn))
        xv = torch.randn(3008, 512, generator=g, device="cuda")
        emb = torch.randn(512, 8192, generator=g, device="cuda")
        kern["vq_nearest"] = dict(device_us=device_us(
            torch, lambda: vq_mod.vq_nearest(xv, emb), n=20))
        kern["k1_step"] = dict(device_us=device_us(
            torch, lambda: ds.fused_decode_logits(st, x, kc, vc, i200, L, H),
            n=100))
        kern["k1_int4_step"] = dict(device_us=device_us(
            torch, lambda: ds.fused_decode_logits(st4, x, kc, vc, i200, L,
                                                  H), n=100))
        kern["k4_step16"] = dict(device_us=device_us(
            torch, lambda: ss.fused_serving_logits(st, x16, kq, vq, ks, vs,
                                                   i200, L, H), n=20))
    print(json.dumps(dict(
        tag=args.tag, card=smi, requests=reqs,
        ar_tokens_per_s_median=statistics.median(
            r["ar_tokens_per_s"] for r in reqs),
        latency_s_median=statistics.median(r["latency_s"] for r in reqs),
        render_s_median=statistics.median(r["render_s"] for r in reqs),
        k4_wave_s=wave_s, k1_step_ms_min=k1[0], k1_step_ms_median=k1[1],
        k1_step_cpu_ms=k1[2], k4_step_ms_min=k4[0], k4_step_ms_median=k4[1],
        k4_step_cpu_ms=k4[2],
        flash_ms=flash_ms, kernels=kern)), flush=True)


if __name__ == "__main__":
    main()
