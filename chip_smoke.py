#!/usr/bin/env python3
"""Run the PyTorch port's main paths once on one NVIDIA H100.

    python3 chip_smoke.py

From the root of a checkout, on a machine with a CUDA card (sm_90), the
CUDA toolkit (nvcc) and PyTorch built for CUDA. No network; imports no JAX.
Random weights from fixed seeds, the flagship XTTSConfig() widths (GPT
15 x 1024, UNet 512, CLIP 6 x 512, Vocos 8 x 512, DVAE 512/1024 with an
8192 x 512 codebook, CLVP 2 x 20 x 768, HiFi-GAN 1024 -> 512 ch with the
SE-ResNet speaker encoder).

Phases, each reported on its own lines:
  1. device: card name and power limit (nvidia-smi), torch / CUDA versions;
     TF32 off for matmuls and cuDNN.
  2. build: nvcc compiles xtts_tpu_torch/csrc/*.cu into build/xtts_tpu_torch/,
     one process per source, all at once.
  3. kernels: each kernel against its plain PyTorch twin on the same card
     tensors at the main paths' shapes, with median CUDA-event times of the
     kernel, the plain twin and, where one exists, the one PyTorch call
     that computes the same function (a yardstick the port never calls),
     each kernel and library call also as device time a call (100 calls
     captured in one CUDA graph and replayed: no host launch in it), and
     the bound (bytes over 3.35 TB/s or operations over the peak for
     their type, whichever is larger):
     K1 (layer_norm_rows (equal to its ordered twin bit for bit, on 4096
     rows too: the card's rsqrtf against torch.rsqrt), int8_gemv (equal
     to its plain twin bit for bit where no gelu is involved, at every K1
     shape and a K split in 16 ragged chunks; its split plan equal to the
     kernel's), decode_attention (a cluster of 8
     blocks a head), the 15-layer step, a
     64-step teacher-forced greedy chain at 76 launches a token, and the
     step's device time a step: 100 steps in one CUDA graph); K1-int4
     (int4_gemv at the qkv, proj, fc, out (four K groups) and head shapes,
     equal to its twin bit for bit without gelu, the int4 step and chain
     and its device time a step); the products of K1 and K1-int4 also with
     their weights rotating through >= 32 copies (>= 100 MB, more than
     the 50 MB L2), beside matmul on as many dequantised bf16 copies; K2
     (flash_mha at (2, 1280 | 1562, 8, 64) and
     (2, 300 | 583, 8, 64)); K3 (vq_nearest on the DVAE's own 3008 x 512
     logits against its 8192-code codebook, a ragged shape and a planted
     tie, also on 4 rotating copies of rows and codebook); K4
     (int8_gemm_rows (split over K across a cluster),
     serving_attention (equal to its twin bit for bit at index 0, 1 and
     353 of the path's 354 positions and at 2047 of 2048; timed with the
     cache rotating through the 15 layers too), the 16-row step at S 354,
     a 64-step teacher-forced chain, step times at 8/16/32 rows, the
     step's device time a step). Each
     product with the norm prologue (int8_gemv, int4_gemv, int8_gemm_rows
     at the qkv + ln_1, fc + ln_2 and head + ln_f/final_norm shapes) is held
     against layer_norm_rows then the unfused product (bit for bit) and
     against its plain twin (bit for bit for int8_gemv and int4_gemv
     without gelu), and timed beside the two launches it replaces.
     Then the paths on a small configuration, card against CPU with the
     same weights: identical greedy int8 codes through K1 and through K4,
     identical DVAE codes, renders within 1e-3; identical greedy codes
     through K1-int4 and their HiFi-GAN render within 1e-3.
     The 64-step teacher-forced chains (K1, K1-int4, K4) may differ from
     the plain chain in at most PICKS_BOUND greedy picks: the largest
     count that rounding alone turns over the seeds of the noise floor
     (scripts/chain_divergence.py, the plain step against itself on
     float64 sums).
  4. main: TextToSpeech(quantized_decode=True, dtype=bf16) on the bench's
     canonical inputs (3 s 220 Hz sine + noise reference, 50 text tokens
     from numpy seed 0), tts_tokens with max_mel_tokens=300, three requests
     (seeds 1, 2, 3), each through K1 for every token and K2 for every
     consumer attention, the AR loop on the device in CUDA graphs of 16
     steps (infer/device_loop.py): host reads, replays, eager steps and
     capture time a request, the reads held to ceil(300 / 16) + rungs + 2.
     loop: on [main]'s model and inputs, the graph loop's codes against the
     same loop run eagerly on the card, for K1, K1-int4 and K4 (16 rows of
     distinct text), greedy and seeded sampling, launch counts equal; one
     greedy graph run of each under torch.profiler, every counted kernel
     in its trace as many times as counted.
  5. vqvae (BASELINE config #1): DVAE round trip, 8 x 1504 mel frames ->
     get_codebook_indices (K3) -> decode; audio-s/s.
  6. serving (BASELINE config #5): BatchServer(max_batch=8), 8 concurrent
     submits a wave, num_candidates=2 (16 AR rows through K4 with
     XTTS_FUSED_SERVING=1), CLVP rerank, full-quality render (K2); one warm
     and two timed waves; then one synthesize_batch wave with the DVAE
     shortcut render and one with the default engine (the per-layer chain,
     cache_ladder "auto") as K4's in-program comparator.
  7. stream (the low-latency B=1 path): TextToSpeech(bf16, HiFi-GAN) with
     XTTS_DECODE_BITS=4 at requantize(); three 50-token sentences (numpy
     seeds 10, 11, 12) through stream_tokens (tts_stream's loop on token
     ids), every token through K1-int4, rendered by the HifiDecoder: time
     to first audio, per-sentence AR tokens/s, render s, RTF, peak memory.
     Then one preset("ultra_fast") request (dpm++2m, 15 steps, K2) and the
     first sentence again on the int8 stack (AR tokens/s comparator).
  8. profile: one more warm B=1 request (seed 4), bare and then under
     torch.profiler: the device's busy share over the request and over its
     AR and render stages, every counted kernel in the trace against the
     launches counted (graph replays included), the host time of one
     sample_token call and its device time a token (50 calls in one CUDA
     graph), the kernels with the most device time, the flash kernel's
     device time a call (trace in build/xtts_tpu_torch/request_trace.json).
  9. a JSON line of the kernels, the total wall time, then the result line.

Before each path of phases 4-7 every launch count is set to 0, and read
after it; a path that did not launch each of its kernels fails, and so
does a K1 or K4 step that is not 76 launches or that launches
layer_norm_rows (its norms run as the products' prologue). A graph replay
runs no wrapper: the device loop takes back the launches counted while it
captured and adds them once a replay, so the counts are what ran, which
the traces of [loop] and [profile] hold to the kernels the card ran (a
mismatch is traced once more: a trace can lose records). Any failure
raises and exits non-zero. Without a CUDA card, or outside a checkout, it
exits non-zero before printing any result.
"""
from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SR = 24000
K1_TOL = 2e-2          # logits / rows (tests/test_decode_step.py's bound)
OP_TOL = 1e-2          # single ops: one bf16 rounding of O(1) values
K2_TOL = 1e-2          # flash vs f32 attention on the same bf16 inputs
SMALL_WAV_TOL = 1e-3   # small-config render, card vs CPU (the e2e test's)
HBM_BPS = 3.35e12      # H100 SXM device memory rate
PEAK = {"fp32": 67e12, "bf16": 989e12, "tf32": 495e12}   # dense (data sheet)
# Greedy picks of the 64-step teacher-forced chains (kernel chain against
# the plain chain) that may differ: random weights give near-flat logits
# over 8194 codes, so rounding alone turns some picks. The bounds are the
# largest count of the noise floor over its seeds: the plain step against
# itself with the products summed in float64 (scripts/chain_divergence.py
# --picks --f64 [--bits 4] and --k4-f64 --steps 64, these chains' shapes
# at seeds 0-15, on an NVIDIA H100 80GB HBM3 at 700 W).
PICKS_BOUND = {"k1": 2, "k1-int4": 4, "k4": 16}
PICKS_FLOOR = {
    "k1": "floor 0-2 a seed of 64, 12 of 1024 over seeds 0-15",
    "k1-int4": "floor 0-4 a seed of 64, 19 of 1024 over seeds 0-15",
    "k4": "floor 7-16 a seed of 1024, 180 of 16384 over seeds 0-15"}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def require_card():
    if not (ROOT / "xtts_tpu_torch").is_dir():
        raise SystemExit("chip_smoke: xtts_tpu_torch/ not found next to this "
                         "script; run it from a checkout of the repository")
    try:
        import torch
    except ImportError:
        raise SystemExit("chip_smoke: PyTorch is not installed")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA card available")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs an sm_90 card, found "
                         f"{torch.cuda.get_device_name(0)} (sm_{cap[0]}{cap[1]})")
    return torch


def time_ms(torch, fn, reps: int = 25, warmup: int = 3) -> float:
    """Median of `reps` single-call CUDA-event timings."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_us(torch, fn, n: int = 100, replays: int = 5) -> float:
    """Device time a call in us: n back-to-back calls captured in one CUDA
    graph, the graph replayed between two CUDA events (median of
    `replays`). The host's launch cost, which single-call timings carry,
    is out of this reading."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):        # warm up off the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / n)
    del graph
    return statistics.median(times)


def rotating(calls):
    """One callable that runs `calls` in turn, one each call: n calls
    captured in device_us's graph cycle through them (weights rotating
    through more than the L2 cache)."""
    turn = [0]

    def call():
        fn = calls[turn[0] % len(calls)]
        turn[0] += 1
        return fn()
    return call


def rotating_pair(torch, call, w, w_bf16, x2):
    """Device us a call with the weights rotating through more than the L2
    cache: `call(wt)` (the kernel on weights wt) over clones of w, and
    matmul(x2, .) over as many clones of the dequantised bf16 weights; at
    least 32 copies and 100 MB of w, each copy read once a replay."""
    copies = max(32, -(-100_000_000 // (w.numel() * w.element_size())))
    ws = [w.clone() for _ in range(copies)]
    k = device_us(torch, rotating([lambda t=t: call(t) for t in ws]),
                  n=copies)
    del ws
    wbs = [w_bf16.clone() for _ in range(copies)]
    lib = device_us(torch, rotating([lambda t=t: torch.matmul(x2, t)
                                     for t in wbs]), n=copies)
    return k, lib


def dev_index(torch, i: int):
    """A cache index as the AR loop hands it to the attention kernels: a
    0-d int64 on the card (an int would be copied there at every call, which
    a captured graph cannot hold)."""
    return torch.tensor(i, dtype=torch.long, device="cuda")


def fmt_us(us: float) -> str:
    return f"{us:.2f} us"


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def bound(nbytes: float, ops: float, kind: str):
    """The least time the card could take: bytes over the memory rate or
    operations over the peak for their type, whichever is larger (ms)."""
    tb, to = nbytes / HBM_BPS * 1e3, ops / PEAK[kind] * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def record(results, name, err, ms, plain_ms, lib_ms, bnd, dev_us,
           lib_dev_us, **extra):
    results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bnd[0], bound_by=bnd[1],
                         device_us=dev_us, library_device_us=lib_dev_us,
                         **extra)


def fmt_lib(lib_ms) -> str:
    return "n/a" if lib_ms is None else f"{lib_ms:.4f} ms"


def random_qtree(torch, quantize_dense, layers, d, vocab, s_max, g):
    """Full-width int8 decode tree with random weights, biases and norms."""
    dev = "cuda"

    def w(i, o):
        return quantize_dense(torch.randn(i, o, generator=g, device=dev)
                              / math.sqrt(i))

    def vec(n, s=0.1):
        return torch.randn(n, generator=g, device=dev) * s

    def ln():
        return {"scale": 1.0 + vec(d), "bias": vec(d)}

    qt = {"layers": [{"ln_1": ln(), "ln_2": ln(),
                      "qkv": w(d, 3 * d), "qkv_b": vec(3 * d),
                      "proj": w(d, d), "proj_b": vec(d),
                      "fc": w(d, 4 * d), "fc_b": vec(4 * d),
                      "out": w(4 * d, d), "out_b": vec(d)}
                     for _ in range(layers)],
          "ln_f": ln(), "final_norm": ln(),
          "mel_head": w(d, vocab), "mel_head_b": vec(vocab),
          "mel_embedding": (torch.randn(vocab, d, generator=g, device=dev)
                            * 0.3).bfloat16(),
          "mel_pos_embedding": (torch.randn(s_max, d, generator=g, device=dev)
                                * 0.1).bfloat16()}
    return qt


def k1_cache(torch, cfg, s_max, p_len):
    """(L, S, D) bf16 k and v caches with the first p_len rows random."""
    L, D = cfg.layers, cfg.model_dim
    gc = torch.Generator(device="cuda").manual_seed(7)
    kc = torch.zeros(L, s_max, D, dtype=torch.bfloat16, device="cuda")
    kc[:, :p_len] = (torch.randn(L, p_len, D, generator=gc,
                                 device="cuda") * 0.5).bfloat16()
    vc = torch.zeros_like(kc)
    vc[:, :p_len] = (torch.randn(L, p_len, D, generator=gc,
                                 device="cuda") * 0.5).bfloat16()
    return kc, vc


def k1_checks(torch, ds, quantize_dense, cfg, s_max, p_len, results, card):
    F = torch.nn.functional
    L, D, H, V = cfg.layers, cfg.model_dim, cfg.heads, cfg.number_mel_codes
    g = torch.Generator(device="cuda").manual_seed(1234)
    qt = random_qtree(torch, quantize_dense, L, D, V, s_max, g)
    st = ds.stack_qtree(qt, V)

    def cache():
        return k1_cache(torch, cfg, s_max, p_len)

    # --- single ops at the main path's shapes ---
    from xtts_tpu_torch.ops import build
    x32 = torch.randn(1, D, generator=g, device="cuda") * 3 + 1
    ln0 = st["ln"][0]
    e_ln = max(max_err(ds.layer_norm_rows(x32, ln0[0], ln0[1]),
                       ds.layer_norm_rows_plain(x32, ln0[0], ln0[1])),
               max_err(ds.layer_norm_rows(x32, *st["lnf"]),
                       ds.layer_norm_rows_plain(x32, *st["lnf"])))
    check(e_ln <= OP_TOL, f"layer_norm_rows err {e_ln}")
    # the twin of the kernels' statistics (every prologue's twin): equal bit
    # for bit, on 4096 rows too (8192 rsqrtf against torch.rsqrt)
    x_many = torch.randn(4096, D, generator=g, device="cuda") * 3 + 1
    for xs, ln in ((x32, (ln0[0], ln0[1])), (x32, tuple(st["lnf"])),
                   (x_many, tuple(st["lnf"]))):
        got, want = ds.layer_norm_rows(xs, *ln), ds.layer_norm_rows_ordered(
            xs, *ln)
        check(torch.equal(got, want), f"layer_norm_rows != its ordered twin "
              f"on {xs.shape[0]} rows ({len(ln) // 2} norms): "
              f"{int((got != want).sum())} values differ")

    def ln_uncached():            # every launch asks for the capability
        build._hopper.cache_clear()
        ds.layer_norm_rows(x32, ln0[0], ln0[1])

    t_ln_q = time_ms(torch, ln_uncached)
    t_ln = time_ms(torch, lambda: ds.layer_norm_rows(x32, ln0[0], ln0[1]))
    p_ln = time_ms(torch, lambda: ds.layer_norm_rows_plain(x32, ln0[0],
                                                           ln0[1]))
    l_ln = time_ms(torch, lambda: F.layer_norm(x32, (D,), ln0[0], ln0[1],
                                               1e-5))
    b_ln = bound(4 * D + 8 * D + 2 * D, 8 * D, "fp32")
    d_ln = device_us(torch, lambda: ds.layer_norm_rows(x32, ln0[0], ln0[1]))
    dl_ln = device_us(torch, lambda: F.layer_norm(
        x32, (D,), ln0[0], ln0[1], 1e-5))
    record(results, "layer_norm_rows", e_ln, t_ln, p_ln, l_ln, b_ln, d_ln,
           dl_ln)
    log(f"[k1] layer_norm_rows equal to layer_norm_rows_ordered bit for bit "
        f"on 1 row (one and two norms) and on 4096 rows (two norms: 8192 "
        f"rsqrtf results equal to torch.rsqrt's)  [{card}]")
    log(f"[k1] layer_norm_rows (1, {D}) max_abs_err {e_ln:.3e}  "
        f"kernel {t_ln:.4f} ms, device {fmt_us(d_ln)} (capability query "
        f"each launch, as before: {t_ln_q:.4f} ms)  plain {p_ln:.4f} ms  "
        f"F.layer_norm {l_ln:.4f} ms, device {fmt_us(dl_ln)}  bound "
        f"{b_ln[0]:.5f} ms ({b_ln[1]}); launched on no path: the "
        f"comparator of the norm prologues  [{card}]")

    gemv_cases = [
        ("qkv", "wqkv", "sqkv", "bqkv", dict()),
        ("proj+res", "wproj", "sproj", "bproj", dict(acc=True)),
        ("fc+gelu", "wfc", "sfc", "bfc", dict(gelu=True,
                                               out_dtype=torch.bfloat16)),
        ("out+res", "wout", "sout", "bout", dict(acc=True)),
        ("head", "whead", "shead", "bhead", dict()),
    ]
    e_gemv, fc_times = 0.0, None
    for name, wk, sk, bk, kw in gemv_cases:
        w = st[wk][0] if st[wk].dim() == 3 else st[wk]
        s = st[sk][0] if st[sk].dim() == 2 else st[sk]
        b = st[bk][0] if st[bk].dim() == 2 else st[bk]
        xin = (torch.randn(w.shape[0], generator=g, device="cuda")).bfloat16()
        acc = kw.pop("acc", False)
        if acc:
            base = torch.randn(w.shape[1], generator=g, device="cuda")
            o1, o2 = base.clone(), base.clone()
            ds.int8_gemv(xin, w, s, b, out=o1)
            ds.int8_gemv_plain(xin, w, s, b, out=o2)
            fw = lambda wt: ds.int8_gemv(xin, wt, s, b, out=o1)
            fp = lambda: ds.int8_gemv_plain(xin, w, s, b, out=o2)
        else:
            o1 = ds.int8_gemv(xin, w, s, b, **kw)
            o2 = ds.int8_gemv_plain(xin, w, s, b, **kw)
            fw = lambda wt: ds.int8_gemv(xin, wt, s, b, **kw)
            fp = lambda: ds.int8_gemv_plain(xin, w, s, b, **kw)
        fk = lambda: fw(w)
        if not kw.get("gelu"):
            # the plain twin repeats the kernel's order: the same bits
            check(torch.equal(o1, o2), f"int8_gemv {name}: kernel != its "
                  f"twin (max diff {max_err(o1, o2):.3e})")
        err = max_err(o1, o2)
        rel = err / max(1.0, o2.float().abs().max().item())
        check(rel <= OP_TOL, f"int8_gemv {name} err {err}")
        plan = ds.int8_gemv_plan(*w.shape)
        check(ds.kernel_int8_gemv_plan(*w.shape) == plan,
              f"int8_gemv {name}: the plan's copy differs from the kernel's")
        e_gemv = max(e_gemv, err)
        w_bf16 = (w.float() * s).bfloat16()
        x2 = xin[None]
        tk, tp = time_ms(torch, fk), time_ms(torch, fp)
        tl = time_ms(torch, lambda: torch.matmul(x2, w_bf16))
        kk, nn_ = w.shape
        bnd = bound(kk * nn_ + 2 * kk + 8 * nn_ + 4 * nn_, 2 * kk * nn_,
                    "bf16")
        gbs = w.numel() / (tk * 1e-3) / 1e9
        dk = device_us(torch, fk)
        dl = device_us(torch, lambda: torch.matmul(x2, w_bf16))
        dkr, dlr = rotating_pair(torch, fw, w, w_bf16, x2)
        log(f"[k1] int8_gemv {name} ({kk} x {nn_}, {plan[0]} chunk"
            f"{'s' if plan[0] > 1 else ''} of K, "
            f"{plan[0] * nn_ // ds.I8_COLS} blocks) max_abs_err {err:.3e}  "
            f"kernel {tk:.4f} ms ({gbs:.0f} GB/s weights), device "
            f"{fmt_us(dk)}, rotating {fmt_us(dkr)}  plain {tp:.4f} ms  "
            f"matmul(bf16 W) {tl:.4f} ms, device {fmt_us(dl)}, rotating "
            f"{fmt_us(dlr)}  bound {bnd[0]:.5f} ms ({bnd[1]})  [{card}]")
        if name == "fc+gelu":
            fc_times = (tk, tp, tl, bnd, dk, dl)
            fc_rot = dict(device_us_rotating=dkr,
                          library_device_us_rotating=dlr)
    record(results, "int8_gemv", e_gemv, *fc_times, **fc_rot)
    # the plan's edges: K split in 16 ragged chunks, equal to the twin
    from xtts_tpu_torch.infer.qdecode import quantize_dense as qd
    q_edge = qd(torch.randn(3000, 32, generator=g, device="cuda") / 55.0)
    x_edge = torch.randn(3000, generator=g, device="cuda").bfloat16()
    b_edge = torch.randn(32, generator=g, device="cuda")
    check(torch.equal(ds.int8_gemv(x_edge, q_edge["w"], q_edge["scale"],
                                   b_edge),
                      ds.int8_gemv_plain(x_edge, q_edge["w"],
                                         q_edge["scale"], b_edge))
          and ds.kernel_int8_gemv_plan(3000, 32) == ds.int8_gemv_plan(3000,
                                                                     32),
          "int8_gemv (3000 x 32, K in 16 ragged chunks) != its twin")
    log(f"[k1] int8_gemv (3000 x 32, K in "
        f"{ds.int8_gemv_plan(3000, 32)[0]} chunks of 176-192 rows): equal to "
        f"its twin, plan equal to the kernel's  [{card}]")
    prologue_checks(torch, ds, st, ds.int8_gemv, ds.int8_gemv_plain, x32[0],
                    "k1", "int8_gemv+ln", results, card)

    idx = s_max - 60
    qkv = torch.randn(3 * D, generator=g, device="cuda")
    kc1, vc1 = cache()
    kc1[:, :idx] = (torch.randn(L, idx, D, generator=g, device="cuda")
                    * 0.5).bfloat16()
    vc1[:, :idx] = (torch.randn(L, idx, D, generator=g, device="cuda")
                    * 0.5).bfloat16()
    kc2, vc2 = kc1.clone(), vc1.clone()
    a1 = ds.decode_attention(qkv, kc1[0], vc1[0], idx, H)
    a2 = ds.decode_attention_plain(qkv, kc2[0], vc2[0], idx, H)
    e_att = max(max_err(a1, a2), max_err(kc1[0], kc2[0]),
                max_err(vc1[0], vc2[0]))
    check(e_att <= OP_TOL, f"decode_attention err {e_att}")
    at = dev_index(torch, idx)        # as the AR loop passes it (a graph)
    t_att = time_ms(torch, lambda: ds.decode_attention(qkv, kc1[0], vc1[0],
                                                       at, H))
    p_att = time_ms(torch, lambda: ds.decode_attention_plain(
        qkv, kc2[0], vc2[0], idx, H))
    hd = D // H
    q_l = qkv[:D].bfloat16().reshape(1, H, 1, hd)
    k_l = kc1[0, :idx + 1].reshape(1, idx + 1, H, hd).transpose(1, 2)
    v_l = vc1[0, :idx + 1].reshape(1, idx + 1, H, hd).transpose(1, 2)
    k_l, v_l = k_l.contiguous(), v_l.contiguous()
    l_att = time_ms(torch, lambda: F.scaled_dot_product_attention(q_l, k_l,
                                                                  v_l))
    b_att = bound(12 * D + 4 * idx * D + 4 * D + 2 * D, 4 * (idx + 1) * D,
                  "bf16")
    d_att = device_us(torch, lambda: ds.decode_attention(qkv, kc1[0], vc1[0],
                                                         at, H))
    dl_att = device_us(torch, lambda: F.scaled_dot_product_attention(
        q_l, k_l, v_l))
    record(results, "decode_attention", e_att, t_att, p_att, l_att, b_att,
           d_att, dl_att)
    log(f"[k1] decode_attention ({H} heads x 64, rows 0..{idx} of {s_max}, "
        f"cluster of {ds.ATT_SPLITS} blocks a head) "
        f"max_abs_err {e_att:.3e}  kernel {t_att:.4f} ms, device "
        f"{fmt_us(d_att)}  plain {p_att:.4f} ms  sdpa {l_att:.4f} ms, device "
        f"{fmt_us(dl_att)}  bound {b_att[0]:.5f} ms ({b_att[1]})  [{card}]")

    t_step, p_step, b_step, d_step = step_chain(
        torch, ds, qt, st, cfg, s_max, p_len, cache, g, "k1", card)
    results["int8_gemv"]["step_device_us"] = d_step
    return qt, st


def prologue_cases(st):
    """The fused products of a K1 / K4 step: (name, weight, scale, bias
    keys, norm, output kwargs) at layer 0 and the head."""
    import torch
    ln = st["ln"][0]
    return [("qkv+ln_1", "wqkv", "sqkv", "bqkv", (ln[0], ln[1]), dict()),
            ("fc+ln_2", "wfc", "sfc", "bfc", (ln[2], ln[3]),
             dict(gelu=True, out_dtype=torch.bfloat16)),
            ("head+lnf", "whead", "shead", "bhead", tuple(st["lnf"]),
             dict())]


def prologue_checks(torch, ds, st, kernel, plain, x32, tag, key, results,
                    card):
    """Each product with the norm prologue against layer_norm_rows then the
    unfused product (bit for bit: both fold the statistics in one order)
    and against its plain twin (OP_TOL relative to max(1, |y|)); the fused
    call timed beside the two launches it replaces. x32: the f32 residual,
    (D,) or (rows, D)."""
    d = x32.shape[-1]
    rows = x32.numel() // d
    e_max, fc = 0.0, None
    for name, wk, sk, bk, ln, kw in prologue_cases(st):
        layer = wk != "whead"                # stacked (L, ...) or the head
        w, s, b = (st[k][0] if layer else st[k] for k in (wk, sk, bk))

        def unfused():
            h = ds.layer_norm_rows(x32.reshape(rows, d), *ln).reshape(
                x32.shape)
            return kernel(h, w, s, b, **kw)

        got = kernel(x32, w, s, b, ln=ln, **kw)
        ref = unfused()
        want = plain(x32, w, s, b, ln=ln, **kw)
        check(torch.equal(got, ref), f"{key} {name}: fused != layer_norm_rows"
              f" then the product (max diff {max_err(got, ref):.3e})")
        # the gemv twins repeat their kernels' order, the prologue and the
        # gelu too
        exact = key != "int8_gemm_rows+ln"
        if exact:
            check(torch.equal(got, want), f"{key} {name}: kernel != its twin "
                  f"(max diff {max_err(got, want):.3e})")
        err = max_err(got, want)
        check(err <= OP_TOL * max(1.0, want.float().abs().max().item()),
              f"{key} {name} err {err}")
        e_max = max(e_max, err)
        t_f = time_ms(torch, lambda: kernel(x32, w, s, b, ln=ln, **kw))
        t_2 = time_ms(torch, unfused)
        t_p = time_ms(torch, lambda: plain(x32, w, s, b, ln=ln, **kw))
        d_f = device_us(torch, lambda: kernel(x32, w, s, b, ln=ln, **kw))
        d_2 = device_us(torch, unfused)
        n = got.shape[-1]
        bnd = bound(w.numel() + 4 * s.numel() + 4 * n + 4 * x32.numel()
                    + 4 * d * len(ln) + got.element_size() * got.numel(),
                    2 * rows * d * n, "bf16")
        log(f"[{tag}] {key} {name} ({rows} x {d} -> {n}): equal to "
            f"layer_norm_rows + product{' and to its twin' if exact else ''}"
            f"; vs plain max_abs_err {err:.3e}  "
            f"fused {t_f:.4f} ms, device {fmt_us(d_f)}  layer_norm_rows + "
            f"product {t_2:.4f} ms, device {fmt_us(d_2)} (two launches)  "
            f"plain {t_p:.4f} ms  bound {bnd[0]:.5f} ms ({bnd[1]})  [{card}]")
        if name == "fc+ln_2":
            fc = (t_f, t_p, None, bnd, d_f, None)
            pair = dict(pair_ms=t_2, pair_device_us=d_2)
    record(results, key, e_max, *fc, **pair)


def step_chain(torch, ds, qt, st, cfg, s_max, p_len, cache, g, tag, card):
    """The whole K1 step (int8 or int4 stack) against the plain step over a
    64-step teacher-forced greedy chain, then both timed at the index after
    the chain, beside the bound (packed weights, scales, cache rows)."""
    L, D, H, V = cfg.layers, cfg.model_dim, cfg.heads, cfg.number_mel_codes
    emb, pos = qt["mel_embedding"], qt["mel_pos_embedding"]
    toks = torch.randint(0, V, (64,), generator=g, device="cuda").tolist()
    kc_k, vc_k = cache()
    kc_p, vc_p = cache()
    agree, e_step, l_max = 0, 0.0, 0.0
    ds.reset_launch_counts()
    for step, tok in enumerate(toks):
        x = emb[tok][None] + pos[step + 2][None]
        lk, _, _ = ds.fused_decode_logits(st, x, kc_k, vc_k, p_len + step,
                                          L, H)
        lp, _, _ = ds.fused_decode_logits_plain(st, x, kc_p, vc_p,
                                                p_len + step, L, H)
        err = max_err(lk[:, :V], lp[:, :V])
        e_step = max(e_step, err)
        agree += int(int(lk[:, :V].argmax()) == int(lp[:, :V].argmax()))
        check(lk[:, V:].max().item() < -1e8, "padded head columns reachable")
        l_max = max(l_max, lp[:, :V].abs().max().item())
    per_token = sum(fn.launches for fn in ds.KERNELS) / 64
    check(per_token == 5 * L + 1 and ds.layer_norm_rows.launches == 0,
          f"{tag} step: {per_token} launches a token, layer_norm_rows "
          f"{ds.layer_norm_rows.launches}")
    e_rows = max(max_err(kc_k, kc_p), max_err(vc_k, vc_p))
    r_max = max(kc_p.float().abs().max().item(),
                vc_p.float().abs().max().item())
    check(e_step <= K1_TOL * max(1.0, l_max),
          f"{tag} step logits err {e_step}")
    check(e_rows <= K1_TOL * max(1.0, r_max),
          f"{tag} step k/v rows err {e_rows}")
    bound_picks = PICKS_BOUND[tag]
    check(64 - agree <= bound_picks, f"{tag} chain: {64 - agree} of 64 "
          f"greedy picks differ, bound {bound_picks}")
    x = emb[toks[0]][None] + pos[2][None]
    at = dev_index(torch, p_len + 64)
    t_step = time_ms(torch, lambda: ds.fused_decode_logits(
        st, x, kc_k, vc_k, at, L, H), reps=20)
    p_step = time_ms(torch, lambda: ds.fused_decode_logits_plain(
        st, x, kc_p, vc_p, p_len + 64, L, H), reps=20)
    w_bytes = sum(st[k].numel() for k in ("wqkv", "wproj", "wfc", "wout",
                                          "whead"))
    s_bytes = 4 * sum(st[k].numel() for k in ("sqkv", "sproj", "sfc",
                                              "sout", "shead"))
    d_step = device_us(torch, lambda: ds.fused_decode_logits(
        st, x, kc_k, vc_k, at, L, H), n=100)
    kind = "packed int4" if st.get("bits") == 4 else "int8"
    b_step = bound(w_bytes + s_bytes + 2 * L * (p_len + 65) * D * 2,
                   2 * 2 * w_bytes if st.get("bits") == 4 else 2 * w_bytes,
                   "bf16")
    log(f"[{tag}] step bound at index {p_len + 64}: {w_bytes / 1e6:.1f} MB "
        f"of {kind} weights + {s_bytes / 1e6:.2f} MB of scales + the bf16 "
        f"cache rows: {b_step[0]:.4f} ms ({b_step[1]})  [{card}]")
    log(f"[{tag}] step ({L} layers, D {D}, S {s_max}) vs plain step: logits "
        f"max_abs_err {e_step:.3e} (bound {K1_TOL} x max(1, |logits| "
        f"{l_max:.2f})), k/v rows {e_rows:.3e} (bound {K1_TOL} x max(1, "
        f"|rows| {r_max:.2f})), greedy agreement {agree}/64 teacher-forced "
        f"({64 - agree} differ, bound {bound_picks}: {PICKS_FLOOR[tag]}); "
        f"kernel chain "
        f"{t_step:.3f} ms/token at {per_token:.0f} launches a token, device "
        f"{fmt_us(d_step)} a step (100 steps in one CUDA graph), plain "
        f"{p_step:.3f} ms/token  [{card}]")
    return t_step, p_step, b_step, d_step


def k1_int4_checks(torch, ds, qt, cfg, s_max, p_len, results, card):
    """K1's int4 mode: int4_gemv against its plain twin at the flagship
    shapes (qkv, fc + gelu, out in four K groups into the residual, the
    head), then the int4 step and chain as K1's."""
    L, D, V = cfg.layers, cfg.model_dim, cfg.number_mel_codes
    g = torch.Generator(device="cuda").manual_seed(4321)
    st = ds.stack_qtree_int4(qt, V)
    check(st["bits"] == 4 and tuple(st["sout"].shape) == (L, 4, D),
          "int4 stack layout")
    cases = [("qkv", "wqkv", "sqkv", "bqkv", dict()),
             ("proj+res", "wproj", "sproj", "bproj", dict(acc=True)),
             ("fc+gelu", "wfc", "sfc", "bfc",
              dict(gelu=True, out_dtype=torch.bfloat16)),
             ("out+res", "wout", "sout", "bout", dict(acc=True)),
             ("head", "whead", "shead", "bhead", dict())]
    e_max, fc_times = 0.0, None
    for name, wk, sk, bk, kw in cases:
        w = st[wk][0] if st[wk].dim() == 3 else st[wk]
        s = st[sk][0] if st[sk].dim() == 3 else st[sk]
        b = st[bk][0] if st[bk].dim() == 2 else st[bk]
        kk, nn_ = w.shape[0], 2 * w.shape[1]
        xin = torch.randn(kk, generator=g, device="cuda").bfloat16()
        if kw.pop("acc", False):
            base = torch.randn(nn_, generator=g, device="cuda")
            o1, o2 = base.clone(), base.clone()
            ds.int4_gemv(xin, w, s, b, out=o1)
            ds.int4_gemv_plain(xin, w, s, b, out=o2)
            fw = lambda wt: ds.int4_gemv(xin, wt, s, b, out=o1)
            fp = lambda: ds.int4_gemv_plain(xin, w, s, b, out=o2)
        else:
            o1 = ds.int4_gemv(xin, w, s, b, **kw)
            o2 = ds.int4_gemv_plain(xin, w, s, b, **kw)
            fw = lambda wt: ds.int4_gemv(xin, wt, s, b, **kw)
            fp = lambda: ds.int4_gemv_plain(xin, w, s, b, **kw)
        fk = lambda: fw(w)
        if not kw.get("gelu"):
            # the plain twin repeats the kernel's split-K order
            check(torch.equal(o1, o2), f"int4_gemv {name}: kernel != its "
                  f"twin (max diff {max_err(o1, o2):.3e})")
        err = max_err(o1, o2)
        check(err <= OP_TOL * max(1.0, o2.float().abs().max().item()),
              f"int4_gemv {name} err {err}")
        e_max = max(e_max, err)
        groups = s.shape[0]
        w_bf16 = (ds.unpack_int4(w).float().reshape(groups, -1, nn_)
                  * s[:, None, :]).reshape(kk, nn_).bfloat16()
        x2 = xin[None]
        tk, tp = time_ms(torch, fk), time_ms(torch, fp)
        tl = time_ms(torch, lambda: torch.matmul(x2, w_bf16))
        bnd = bound(kk * nn_ // 2 + 2 * kk + 4 * groups * nn_ + 4 * nn_
                    + 4 * nn_, 2 * kk * nn_, "bf16")
        dk = device_us(torch, fk)
        dl = device_us(torch, lambda: torch.matmul(x2, w_bf16))
        dkr, dlr = rotating_pair(torch, fw, w, w_bf16, x2)
        splits = ds.int4_gemv_plan(kk, nn_, groups)[0]
        log(f"[k1-int4] int4_gemv {name} ({kk} x {nn_}, {groups} group"
            f"{'s' if groups > 1 else ''}, split {splits} a group) "
            f"max_abs_err {err:.3e}  kernel {tk:.4f} ms, device "
            f"{fmt_us(dk)}, rotating {fmt_us(dkr)} "
            f"({kk * nn_ / 2 / (dkr * 1e-6) / 1e9:.0f} GB/s packed weights)"
            f"  plain {tp:.4f} ms  matmul(bf16 W) {tl:.4f} ms, device "
            f"{fmt_us(dl)}, rotating {fmt_us(dlr)}  bound {bnd[0]:.5f} ms "
            f"({bnd[1]})  [{card}]")
        if name == "fc+gelu":
            fc_times = (tk, tp, tl, bnd, dk, dl)
            fc_rot = dict(device_us_rotating=dkr,
                          library_device_us_rotating=dlr)
    record(results, "int4_gemv", e_max, *fc_times, **fc_rot)
    x32 = torch.randn(D, generator=g, device="cuda") * 3 + 1
    prologue_checks(torch, ds, st, ds.int4_gemv, ds.int4_gemv_plain, x32,
                    "k1-int4", "int4_gemv+ln", results, card)

    ds.reset_launch_counts()
    d_step = step_chain(torch, ds, qt, st, cfg, s_max, p_len,
                        lambda: k1_cache(torch, cfg, s_max, p_len), g,
                        "k1-int4", card)[3]
    results["int4_gemv"]["step_device_us"] = d_step
    check(ds.int8_gemv.launches == 0, "the int4 step launched int8_gemv")
    ds.reset_launch_counts()


def k2_checks(torch, fa, results, card):
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(99)
    e_max, main_times = 0.0, None
    for b, tq, tk in ((2, 1280, 1562), (2, 300, 583)):
        q, k, v = (torch.randn(b, t, 8, 64, generator=g,
                               device="cuda").bfloat16()
                   for t in (tq, tk, tk))
        out = fa.flash_mha(q, k, v, 0.125)
        ref = fa.flash_mha_plain(q.float(), k.float(), v.float(), 0.125)
        err = max_err(out, ref)
        check(err <= K2_TOL, f"flash_mha {(b, tq, tk)} err {err}")
        e_max = max(e_max, err)
        tkn = time_ms(torch, lambda: fa.flash_mha(q, k, v, 0.125))
        tpl = time_ms(torch, lambda: fa.flash_mha_plain(q, k, v, 0.125))
        qs, ks, vs = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        tlib = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, ks, vs, scale=0.125))
        flops = 4 * b * 8 * tq * tk * 64
        bnd = bound(2 * b * 8 * 64 * (2 * tq + 2 * tk), flops, "bf16")
        dk = device_us(torch, lambda: fa.flash_mha(q, k, v, 0.125))
        dl = device_us(torch, lambda: F.scaled_dot_product_attention(
            qs, ks, vs, scale=0.125))
        log(f"[k2] flash_mha (B {b}, Tq {tq}, Tk {tk}, 8 x 64, bf16) "
            f"max_abs_err vs f32 {err:.3e} (bound {K2_TOL})  kernel "
            f"{tkn:.4f} ms ({flops / (tkn * 1e-3) / 1e12:.1f} TFLOP/s), "
            f"device {fmt_us(dk)} ({flops / (dk * 1e-6) / 1e12:.1f} "
            f"TFLOP/s)  plain bf16 {tpl:.4f} ms  sdpa {tlib:.4f} ms, device "
            f"{fmt_us(dl)}  bound {bnd[0]:.5f} ms ({bnd[1]})  [{card}]")
        if tq == 1280:
            main_times = (tkn, tpl, tlib, bnd, dk, dl)
    record(results, "flash_mha", e_max, *main_times)


def small_reference_check(torch, np, TextToSpeech, TTSSettings):
    """The whole path on a small configuration: the card (kernels) against
    the CPU (the plain twins, which tests/test_torch_port_e2e.py holds
    against the JAX package) with the same perturbed weights, f32 modules.
    Greedy int8 codes must be identical, through K1 at one row and through
    K4 at 8 rows; the DVAE codes of one mel must be identical (K3); the DDIM
    render of one set of codes from one shared x_T and the DVAE shortcut
    render must agree within SMALL_WAV_TOL."""
    from xtts_tpu_torch.core.config import (CLIPRefConfig, DVAEConfig,
                                            DiffusionModelConfig, GPTConfig,
                                            HiFiGANConfig, MelConfig,
                                            VocosConfig, XTTSConfig)
    from xtts_tpu_torch.infer.qdecode import generate_speech_quantized
    from xtts_tpu_torch.models.hifigan import hifigan_samples
    from xtts_tpu_torch.ops import decode_step as ds
    from xtts_tpu_torch.ops import serving_step as ss
    from xtts_tpu_torch.ops import vq

    mb = 8
    small = XTTSConfig(
        mel=MelConfig(n_mels=mb),
        vqvae=DVAEConfig(channels=mb, num_tokens=30, hidden_dim=16,
                         num_resnet_blocks=1, codebook_dim=16, num_layers=2),
        gpt=GPTConfig(layers=2, model_dim=128, heads=2, max_mel_tokens=604,
                      max_text_tokens=64, number_mel_codes=200,
                      start_mel_token=198, stop_mel_token=199, mel_bins=mb,
                      cond_attn_blocks=1),
        diffusion=DiffusionModelConfig(
            in_channels=mb, out_channels=2 * mb, model_channels=64,
            num_res_blocks=1, channel_mult=(1,), num_heads=2, context_dim=32,
            in_latent_channels=128,
            clip=CLIPRefConfig(embed_dim=32, width=32, layers=1,
                               head_width=16, patch_size=4, in_channels=mb,
                               max_patches=64)),
        vocos=VocosConfig(input_channels=mb, dim=32, intermediate_dim=64,
                          num_layers=1, n_fft=64, hop_length=16),
        hifigan=HiFiGANConfig(decoder_input_dim=128, upsample_rates=(4, 2),
                              upsample_kernel_sizes=(8, 4),
                              upsample_initial_channel=32,
                              resblock_kernel_sizes=(3,),
                              resblock_dilation_sizes=((1, 3),),
                              d_vector_dim=32))
    g = torch.Generator().manual_seed(0)
    cpu = TextToSpeech(small, device="cpu", quantized_decode=True,
                       with_hifigan=True, generator=g)
    with torch.no_grad():
        # the flax init zeroes every output projection; perturb all weights
        # so that every layer shapes the result
        for m in cpu.modules().values():
            for p in m.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=g))
    cpu.requantize()
    card = TextToSpeech(small, device="cuda", quantized_decode=True,
                        with_hifigan=True, init=False)
    for name, m in card.modules().items():
        m.load_state_dict(cpu.modules()[name].state_dict())
    card.requantize()

    rng = np.random.default_rng(1)
    sr = small.mel.sample_rate
    t = np.arange(sr // 2) / sr
    wav = (0.3 * np.sin(2 * np.pi * 220 * t)
           + 0.1 * rng.standard_normal(t.shape[0])).astype(np.float32)
    text = torch.from_numpy(rng.integers(3, 250, (1, 16))).long()
    n, n_b = 50, 64
    codes = torch.full((1, n_b), small.gpt.stop_mel_token, dtype=torch.long)
    codes[0, :n] = torch.from_numpy(rng.integers(0, 198, n))
    xt = torch.from_numpy(rng.standard_normal((1, mb, 4 * n_b))).float()
    settings = TTSSettings(sampler="ddim", diffusion_steps=4)
    text8 = torch.from_numpy(rng.integers(3, 250, (8, 16))).long()
    mel = torch.from_numpy(rng.standard_normal((2, mb, 64))).float()

    out, more = {}, {}
    for name, tts in (("cpu", cpu), ("card", card)):
        dev = tts.device
        cond = tts.cond_mel_from_wav(wav)
        before = ds.fused_decode_logits.launches
        res = generate_speech_quantized(tts.gpt, tts._qtree, cond,
                                        text.to(dev), None, max_gen=24,
                                        do_sample=False)
        launched = ds.fused_decode_logits.launches - before
        w = tts._render(cond, text.to(dev), codes.to(dev),
                        torch.tensor([n], device=dev), None, settings,
                        noise=xt.to(dev))
        out[name] = (res.codes.cpu(), res.lengths.cpu(), res.steps, launched,
                     w.cpu())
        before = (ss.fused_serving_logits.launches, vq.vq_nearest.launches)
        r8 = generate_speech_quantized(tts.gpt, tts._qtree,
                                       cond.repeat(8, 1, 1), text8.to(dev),
                                       None, max_gen=24, do_sample=False,
                                       use_fused_serving=True)
        dv = tts.dvae.get_codebook_indices(mel.to(dev))
        sw, _ = tts._render_shortcut(codes.to(dev))
        more[name] = (r8.codes.cpu(), r8.steps, dv.cpu(), sw.cpu(),
                      ss.fused_serving_logits.launches - before[0],
                      vq.vq_nearest.launches - before[1])
    c_codes, c_len, c_steps, c_launched, c_wav = out["cpu"]
    k_codes, k_len, k_steps, k_launched, k_wav = out["card"]
    check(c_launched == 0, "the CPU run launched a kernel")
    check(k_launched == k_steps, f"card run: {k_launched} K1 steps for "
          f"{k_steps} tokens")
    check(torch.equal(c_codes, k_codes) and torch.equal(c_len, k_len),
          f"greedy codes differ: card {k_codes.tolist()} vs cpu "
          f"{c_codes.tolist()}")
    err = max_err(k_wav, c_wav)
    check(bool(torch.isfinite(k_wav).all()) and err <= SMALL_WAV_TOL,
          f"small render wav err {err}")
    log(f"[ref] small config (GPT 2 x 128, UNet 64, f32): card kernels vs "
        f"CPU plain twins, same weights: greedy int8 codes identical over "
        f"{k_steps} tokens ({k_launched} K1 steps on the card), DDIM-4 "
        f"render wav {tuple(k_wav.shape)} max_abs_err {err:.3e} (bound "
        f"{SMALL_WAV_TOL}, |wav| max {c_wav.abs().max().item():.3f})")
    c8, c_steps8, c_dv, c_sw, c_k4, c_k3 = more["cpu"]
    k8, k_steps8, k_dv, k_sw, k_k4, k_k3 = more["card"]
    check(c_k4 == 0 and c_k3 == 0, "the CPU run launched a kernel")
    check(k_k4 == k_steps8 and k_k3 == 1,
          f"card run: {k_k4} K4 steps for {k_steps8} tokens, {k_k3} K3")
    check(torch.equal(c8, k8), f"K4 greedy codes differ: card "
          f"{k8.tolist()} vs cpu {c8.tolist()}")
    check(torch.equal(c_dv, k_dv), f"DVAE codes differ: card "
          f"{k_dv.tolist()} vs cpu {c_dv.tolist()}")
    e_sw = max_err(k_sw, c_sw)
    check(bool(torch.isfinite(k_sw).all()) and e_sw <= SMALL_WAV_TOL,
          f"small shortcut wav err {e_sw}")
    log(f"[ref] small config, slice B: greedy int8 codes through K4 "
        f"identical over 8 rows x {k_steps8} tokens ({k_k4} K4 steps on the "
        f"card); DVAE codes {tuple(k_dv.shape)} identical (K3); shortcut "
        f"render wav {tuple(k_sw.shape)} max_abs_err {e_sw:.3e} (bound "
        f"{SMALL_WAV_TOL})")

    # slice C0: K1's int4 stack (XTTS_DECODE_BITS=4 read at requantize())
    # and the HiFi-GAN render of the greedy codes. (The int4 head rounds
    # logits to bf16, so sampled paths meet exact ties, which each
    # device's generator breaks its own way: the render is compared on
    # shared codes, and tts_tokens(use_hifigan=True) runs on the card.)
    os.environ["XTTS_DECODE_BITS"] = "4"
    try:
        for tts in (cpu, card):
            tts.requantize()
            check(tts._qtree["fused"]["bits"] == 4, "int4 stack not built")
    finally:
        os.environ.pop("XTTS_DECODE_BITS")
    out4 = {}
    for name, tts in (("cpu", cpu), ("card", card)):
        dev = tts.device
        cond = tts.cond_mel_from_wav(wav)
        spk = tts.speaker_mel_from_wav(wav)
        before = (ds.int4_gemv.launches, ds.int8_gemv.launches)
        r4 = generate_speech_quantized(tts.gpt, tts._qtree, cond,
                                       text.to(dev), None, max_gen=24,
                                       do_sample=False)
        n4 = max(int(r4.lengths[0]) - 2, 1)
        lens4 = torch.clamp(r4.lengths - 2, 1, 64)
        hw = tts._render_hifigan(cond, text.to(dev),
                                 tts._pad_codes(r4.codes, lens4, 64), lens4,
                                 spk)
        out4[name] = (r4.codes.cpu(), r4.steps, n4, hw.cpu(),
                      ds.int4_gemv.launches - before[0],
                      ds.int8_gemv.launches - before[1])
    c4, _, _, c_hw, c_i4, _ = out4["cpu"]
    k4c, k_steps4, n4, k_hw, k_i4, k_i8 = out4["card"]
    check(c_i4 == 0, "the CPU run launched int4_gemv")
    check(k_i4 == (4 * small.gpt.layers + 1) * k_steps4 and k_i8 == 0,
          f"card run: int4_gemv {k_i4}, int8_gemv {k_i8} for {k_steps4} "
          f"tokens")
    check(torch.equal(c4, k4c), f"int4 greedy codes differ: card "
          f"{k4c.tolist()} vs cpu {c4.tolist()}")
    e_hf = max_err(k_hw, c_hw)
    check(bool(torch.isfinite(k_hw).all()) and e_hf <= SMALL_WAV_TOL,
          f"small HiFi-GAN wav err {e_hf}")
    hf = card.tts_tokens(text[0].numpy(), card.cond_mel_from_wav(wav),
                         card._generator(0), TTSSettings(max_mel_tokens=24),
                         use_hifigan=True,
                         spk_mel16=card.speaker_mel_from_wav(wav))
    n_hf = max(int(hf["lengths"][0]) - 2, 1)
    check(hf["wav"].shape == (1, hifigan_samples(small.hifigan, n_hf))
          and bool(np.isfinite(hf["wav"]).all()),
          f"tts_tokens(use_hifigan=True) wav {hf['wav'].shape}")
    log(f"[ref] small config, slice C0: greedy codes through K1-int4 "
        f"identical over {k_steps4} tokens ({k_i4} int4_gemv, {k_i8} "
        f"int8_gemv launches on the card); HiFi-GAN render of those codes "
        f"{tuple(k_hw.shape)} max_abs_err {e_hf:.3e} (bound "
        f"{SMALL_WAV_TOL}, |wav| max {c_hw.abs().max().item():.3f}); "
        f"tts_tokens(use_hifigan=True) on the card: wav {hf['wav'].shape} "
        f"finite")


class Launches:
    """The launch counters of every kernel wrapper, the step counters of the
    K1 and K4 chains, and, as "<kernel>+ln", the launches of a product with
    the norm prologue (also counted in its kernel's total). Around one main
    path every count is set to 0 before it (`reset`) and read after it."""

    def __init__(self, wrappers):
        self.wrappers = wrappers
        self.total = {name: 0 for name in self.read(add=False)}

    def reset(self):
        for fn in self.wrappers:
            fn.launches = 0
            if hasattr(fn, "ln_launches"):
                fn.ln_launches = 0

    def read(self, add: bool = True):
        got = {fn.__name__: fn.launches for fn in self.wrappers}
        got.update({fn.__name__ + "+ln": fn.ln_launches
                    for fn in self.wrappers if hasattr(fn, "ln_launches")})
        if add:
            for k, v in got.items():
                self.total[k] += v
        return got


def k3_checks(torch, vq, x, emb, results, card):
    """K3 on the DVAE's own logits (N 3008 x D 512) and codebook (E 8192),
    a ragged shape, and a planted tie. Codes must equal the plain twin's,
    except where the two picks' distances recomputed in f64 lie within the
    fp32 error bound of one D-term dot product, 4 D 2^-24 (2 sum|x||e| +
    |e|^2) (tests/test_torch_port_kernels.py:_vq_agree): the two sum in
    another order (the kernel's products in 3xTF32 on the tensor cores), so
    a near tie may break either way. Counted."""
    def agree(xx, ee, got, want):
        x64, e64 = xx.double(), ee.double()
        bad = (got != want).nonzero().flatten().tolist()
        worst = 0.0
        for r in bad:
            picks = torch.tensor([int(got[r]), int(want[r])], device="cuda")
            ep = e64[:, picks]
            dist = (ep * ep).sum(0) - 2 * x64[r] @ ep
            lim = 4 * xx.shape[1] * 2.0 ** -24 * (
                2 * (x64[r].abs()[:, None] * ep.abs()).sum(0)
                + (ep * ep).sum(0)).max()
            gap = (dist[0] - dist[1]).abs().item()
            check(gap <= lim, f"K3 row {r}: picks {picks.tolist()} differ "
                  f"by {gap:.3e} in f64 > bound {lim.item():.3e}")
            worst = max(worst, gap)
        return len(bad), worst

    g = torch.Generator(device="cuda").manual_seed(31)
    cases = [("path", x, emb),
             ("ragged", torch.randn(1001, 512, generator=g, device="cuda"),
              torch.randn(512, 8000, generator=g, device="cuda"))]
    for name, xx, ee in cases:
        got = vq.vq_nearest(xx, ee)
        want = vq.vq_nearest_plain(xx, ee)
        n_diff, gap = agree(xx, ee, got, want)
        n, d = xx.shape
        e = ee.shape[1]
        tk = time_ms(torch, lambda: vq.vq_nearest(xx, ee))
        tp = time_ms(torch, lambda: vq.vq_nearest_plain(xx, ee))
        et = ee.t().contiguous()
        tl = time_ms(torch, lambda: torch.cdist(xx, et).argmin(1))
        # the kernel's operations: 3 tf32 products (3xTF32) an f32 one
        bnd = bound(4 * (n * d + d * e + e) + 8 * n, 3 * 2 * n * d * e,
                    "tf32")
        dk = device_us(torch, lambda: vq.vq_nearest(xx, ee), n=20)
        dl = device_us(torch, lambda: torch.cdist(xx, et).argmin(1))
        # rows and codebook rotating through 4 copies (> the 50 MB L2)
        cps = [(xx.clone(), ee.clone(), et.clone()) for _ in range(4)]
        dkr = device_us(torch, rotating([lambda c=c: vq.vq_nearest(c[0], c[1])
                                         for c in cps]), n=20)
        dlr = device_us(torch, rotating([
            lambda c=c: torch.cdist(c[0], c[2]).argmin(1) for c in cps]),
            n=20)
        del cps
        log(f"[k3] vq_nearest {name} (N {n}, D {d}, E {e}): codes equal on "
            f"{n - n_diff}/{n} rows, {n_diff} within the fp32 tie bound "
            f"(largest f64 gap {gap:.3e})  kernel {tk:.4f} ms "
            f"({2 * n * d * e / (tk * 1e-3) / 1e12:.1f} TFLOP/s), device "
            f"{fmt_us(dk)} ({2 * n * d * e / (dk * 1e-6) / 1e12:.1f} "
            f"TFLOP/s), rotating {fmt_us(dkr)}  plain {tp:.4f} ms  "
            f"cdist+argmin {tl:.4f} ms, device {fmt_us(dl)}, rotating "
            f"{fmt_us(dlr)}  bound {bnd[0]:.4f} ms ({bnd[1]})  [{card}]")
        if name == "path":
            # codes: max_abs_err is the largest f64 distance gap between
            # differing picks (0 when every code is equal)
            record(results, "vq_nearest", gap, tk, tp, tl, bnd, dk, dl,
                   device_us_rotating=dkr, library_device_us_rotating=dlr)
    emb_t = torch.zeros(8, 3000, device="cuda")
    emb_t[:, [5, 1500, 2999]] = 1.0
    tie = vq.vq_nearest(torch.ones(70, 8, device="cuda"), emb_t)
    check(bool((tie == 5).all()), f"K3 tie: picked {tie.unique().tolist()}")
    log("[k3] planted exact tie (one code at 5, 1500, 2999): first index 5 "
        "on all 70 rows")


def k4_checks(torch, ds, ss, qt, st, cfg, p_len, s_max, results, card):
    """K4 at the serving path's shape: 16 rows, S = prefix + 300 = 354."""
    from xtts_tpu_torch.nn.transformer import KVCache
    L, D, H, V = cfg.layers, cfg.model_dim, cfg.heads, cfg.number_mel_codes
    g = torch.Generator(device="cuda").manual_seed(77)
    idx = s_max - 1

    def cache(rows, filled):
        shape = (L, rows, s_max, H, D // H)
        k = torch.zeros(shape, device="cuda", dtype=torch.bfloat16)
        v = torch.zeros_like(k)
        k[:, :, :filled] = (torch.randn(L, rows, filled, H, D // H,
                                        generator=g, device="cuda")
                            * 0.5).bfloat16()
        v[:, :, :filled] = (torch.randn(L, rows, filled, H, D // H,
                                        generator=g, device="cuda")
                            * 0.5).bfloat16()
        return ss.quantize_kv_rowwise(KVCache(k, v))

    def cache_long(rows, length, filled):
        """One layer's (1, rows, length, D) cache, positions < filled set."""
        k = torch.zeros(1, rows, length, H, D // H, device="cuda",
                        dtype=torch.bfloat16)
        k[:, :, :filled] = (torch.randn(1, rows, filled, H, D // H,
                                        generator=g, device="cuda")
                            * 0.5).bfloat16()
        return ss.quantize_kv_rowwise(KVCache(k, k.roll(1, dims=2)))

    def tokens(rows, step):
        return (torch.arange(rows, device="cuda") * 37 + step * 11) % V

    emb, pos = qt["mel_embedding"], qt["mel_pos_embedding"]
    # --- one step at the last index, 16 rows ---
    rows = 16
    c_k = cache(rows, idx)
    c_p = [t.clone() for t in c_k]
    x = emb[tokens(rows, 0)] + pos[300][None]
    lk = ss.fused_serving_logits(st, x, *c_k, idx, L, H)[0][:, :V]
    lp = ss.fused_serving_logits_plain(st, x, *c_p, idx, L, H)[0][:, :V]
    e_log = max_err(lk, lp)
    l_max = lp.abs().max().item()
    check(e_log <= K1_TOL * max(1.0, l_max), f"K4 step logits err {e_log}")
    n_off = 0
    for a, b in zip(c_k[:2], c_p[:2]):
        diff = (a[:, :, idx].int() - b[:, :, idx].int()).abs()
        check(diff.max().item() <= 1, f"K4 int8 rows differ by "
              f"{diff.max().item()}")
        n_off += int((diff > 0).sum())
    e_sc = max(((a[0, :, idx] - b[0, :, idx]).abs() / b[0, :, idx]).max()
               .item() for a, b in zip(c_k[2:], c_p[2:]))
    check(e_sc <= 1e-6, f"K4 layer-0 row scales rel err {e_sc}")
    log(f"[k4] step (16 rows, {L} layers, S {s_max}, index {idx}) vs plain "
        f"step: logits max_abs_err {e_log:.3e} (bound {K1_TOL} x max(1, "
        f"{l_max:.2f})), new int8 rows {n_off} of {2 * L * rows * D} values "
        f"off by one (bound 1), layer-0 scales rel err {e_sc:.2e}  [{card}]")

    # --- 64 teacher-forced steps from the prefix, greedy tie rule ---
    c_k = cache(rows, p_len)
    c_p = [t.clone() for t in c_k]
    agree = 0
    ss.reset_launch_counts()
    ds.reset_launch_counts()
    e_chain = 0.0
    for step in range(64):
        x = emb[tokens(rows, step)] + pos[step + 2][None]
        lk = ss.fused_serving_logits(st, x, *c_k, p_len + step, L, H)[0][:, :V]
        lp = ss.fused_serving_logits_plain(st, x, *c_p, p_len + step, L,
                                           H)[0][:, :V]
        err = max_err(lk, lp)
        check(err <= K1_TOL * max(1.0, lp.abs().max().item()),
              f"K4 chain step {step} logits err {err}")
        e_chain = max(e_chain, err)
        agree += int((lk.argmax(-1) == lp.argmax(-1)).sum())
    per_step = (ss.int8_gemm_rows.launches + ss.serving_attention.launches
                + ds.layer_norm_rows.launches) / 64
    check(per_step == 5 * L + 1 and ds.layer_norm_rows.launches == 0
          and ss.int8_gemm_rows.ln_launches == 64 * (2 * L + 1),
          f"K4 step: {per_step} launches a step, layer_norm_rows "
          f"{ds.layer_norm_rows.launches}")
    check(64 * rows - agree <= PICKS_BOUND["k4"], f"K4 chain: "
          f"{64 * rows - agree} of {64 * rows} greedy picks differ, bound "
          f"{PICKS_BOUND['k4']}")
    log(f"[k4] 64-step teacher-forced chain, 16 rows: logits max_abs_err "
        f"{e_chain:.3e}, greedy agreement {agree}/{64 * rows} "
        f"({64 * rows - agree} differ, bound {PICKS_BOUND['k4']}: "
        f"{PICKS_FLOOR['k4']}); {per_step:.0f} launches a step "
        f"(int8_gemm_rows with the norm prologue "
        f"{ss.int8_gemm_rows.ln_launches // 64})  [{card}]")

    # --- ops at 16 rows: the fc product and the attention at the index ---
    F = torch.nn.functional
    w, sc, b = st["wfc"][0], st["sfc"][0], st["bfc"][0]
    xin = torch.randn(rows, D, generator=g, device="cuda").bfloat16()
    # with small integer inputs the sums are exact in any order: the
    # epilogue and gelu_new then equal the twin's bit for bit
    xint = torch.randint(-4, 5, (rows, D), generator=g,
                         device="cuda").bfloat16()
    o1 = ss.int8_gemm_rows(xint, w, sc, b, gelu=True,
                           out_dtype=torch.bfloat16)
    o2 = ss.int8_gemm_rows_plain(xint, w, sc, b, gelu=True,
                                 out_dtype=torch.bfloat16)
    check(torch.equal(o1, o2), f"int8_gemm_rows fc+gelu on exact sums: "
          f"kernel != its twin (max diff {max_err(o1, o2):.3e})")
    o1 = ss.int8_gemm_rows(xin, w, sc, b, gelu=True, out_dtype=torch.bfloat16)
    o2 = ss.int8_gemm_rows_plain(xin, w, sc, b, gelu=True,
                                 out_dtype=torch.bfloat16)
    e_g = max_err(o1, o2)
    check(e_g <= OP_TOL * max(1.0, o2.float().abs().max().item()),
          f"int8_gemm_rows err {e_g}")
    w_bf16 = (w.float() * sc).bfloat16()
    kk, nn_ = w.shape
    t_g = time_ms(torch, lambda: ss.int8_gemm_rows(
        xin, w, sc, b, gelu=True, out_dtype=torch.bfloat16))
    p_g = time_ms(torch, lambda: ss.int8_gemm_rows_plain(
        xin, w, sc, b, gelu=True, out_dtype=torch.bfloat16))
    l_g = time_ms(torch, lambda: torch.matmul(xin, w_bf16))
    b_g = bound(kk * nn_ + 2 * rows * kk + 8 * nn_ + 2 * rows * nn_,
                2 * rows * kk * nn_, "bf16")
    d_g = device_us(torch, lambda: ss.int8_gemm_rows(
        xin, w, sc, b, gelu=True, out_dtype=torch.bfloat16))
    dl_g = device_us(torch, lambda: torch.matmul(xin, w_bf16))
    record(results, "int8_gemm_rows", e_g, t_g, p_g, l_g, b_g, d_g, dl_g)
    log(f"[k4] int8_gemm_rows fc+gelu (16 x {kk} x {nn_}, split "
        f"{ss.gemm_rows_plan(kk, nn_)[0]} ways over K) max_abs_err "
        f"{e_g:.3e}  kernel {t_g:.4f} ms ({w.numel() / (t_g * 1e-3) / 1e9:.0f}"
        f" GB/s weights), device {fmt_us(d_g)} "
        f"({w.numel() / (d_g * 1e-6) / 1e9:.0f} GB/s)  plain {p_g:.4f} ms  "
        f"matmul(bf16 W) {l_g:.4f} ms, device {fmt_us(dl_g)}  bound "
        f"{b_g[0]:.5f} ms ({b_g[1]})  [{card}]")
    x32 = torch.randn(rows, D, generator=g, device="cuda") * 3 + 1
    prologue_checks(torch, ds, st, ss.int8_gemm_rows, ss.int8_gemm_rows_plain,
                    x32, "k4", "int8_gemm_rows+ln", results, card)

    # serving_attention == its twin bit for bit (output, new rows, scales)
    # at index 0, 1 and the path's last (S - 1 of 354), and at S - 1 of a
    # longer cache (the chunk ring refilled)
    qkv = torch.randn(rows, 3 * D, generator=g, device="cuda")
    full = cache(rows, idx)               # (L, rows, S, D): rotating below
    for s_at, at in ((s_max, 0), (s_max, 1), (s_max, idx), (2048, 2047)):
        src = full if s_at == s_max else cache_long(rows, s_at, at)
        k1_ = [t[0].clone() for t in src]
        k2_ = [t.clone() for t in k1_]
        a1 = ss.serving_attention(qkv, *k1_, at, H)
        a2 = ss.serving_attention_plain(qkv, *k2_, at, H)
        check(torch.equal(a1, a2)
              and all(torch.equal(u, v) for u, v in zip(k1_, k2_)),
              f"serving_attention at index {at} of {s_at}: kernel != its "
              f"twin (max diff {max_err(a1, a2):.3e})")
        del src, k1_, k2_
    c1 = [t[0].contiguous() for t in full]
    c2 = [t.clone() for t in c1]
    a1 = ss.serving_attention(qkv, *c1, idx, H)
    a2 = ss.serving_attention_plain(qkv, *c2, idx, H)
    e_a = max_err(a1, a2)
    check(e_a <= OP_TOL, f"serving_attention err {e_a}")
    at = dev_index(torch, idx)
    t_a = time_ms(torch, lambda: ss.serving_attention(qkv, *c1, at, H))
    p_a = time_ms(torch, lambda: ss.serving_attention_plain(qkv, *c2, idx,
                                                            H))
    b_a = bound(rows * (12 * D + 2 * idx * (D + 4) + 2 * D + 2 * (D + 4)),
                4 * rows * idx * D, "bf16")
    d_a = device_us(torch, lambda: ss.serving_attention(qkv, *c1, at, H))
    d_ar = device_us(torch, rotating([
        lambda li=li: ss.serving_attention(qkv, full[0][li], full[1][li],
                                           full[2][li], full[3][li], at, H)
        for li in range(L)]), n=4 * L)
    record(results, "serving_attention", e_a, t_a, p_a, None, b_a, d_a, None,
           device_us_rotating=d_ar)
    log(f"[k4] serving_attention (16 rows x {H} heads x 64, positions "
        f"0..{idx - 1} + self, {ss.SA_CHUNK}-position chunks) equal to its "
        f"twin bit for bit at index 0, 1, {idx} of {s_max} and 2047 of 2048; "
        f"max_abs_err {e_a:.3e}  kernel {t_a:.4f} ms, device {fmt_us(d_a)}, "
        f"rotating through the {L} layers {fmt_us(d_ar)}  plain "
        f"{p_a:.4f} ms  library n/a (no one call takes an int8 cache)  bound "
        f"{b_a[0]:.5f} ms ({b_a[1]})  [{card}]")
    del full, c1, c2

    # --- the whole step at 8, 16 and 32 rows ---
    parts = []
    for r in (8, 16, 32):
        c_k = cache(r, idx)
        c_p = [t.clone() for t in c_k]
        x = emb[tokens(r, 1)] + pos[300][None]
        t_k = time_ms(torch, lambda: ss.fused_serving_logits(
            st, x, *c_k, at, L, H), reps=10)
        t_p = time_ms(torch, lambda: ss.fused_serving_logits_plain(
            st, x, *c_p, idx, L, H), reps=10)
        w_bytes = sum(st[k].numel() for k in ("wqkv", "wproj", "wfc", "wout",
                                              "whead"))
        b_s = bound(w_bytes + 2 * L * r * idx * (D + 4), 2 * r * w_bytes,
                    "bf16")
        parts.append(f"{r} rows {t_k:.3f} ms (plain {t_p:.3f}, bound "
                     f"{b_s[0]:.4f})")
        del c_k, c_p
    c_k = cache(16, idx)
    x = emb[tokens(16, 1)] + pos[300][None]
    d_step = device_us(torch, lambda: ss.fused_serving_logits(
        st, x, *c_k, at, L, H), n=20)
    results["serving_attention"]["step_device_us"] = d_step
    del c_k
    log(f"[k4] whole step at S {s_max}, index {idx}: " + "; ".join(parts)
        + f"; device {fmt_us(d_step)} a step at 16 rows (20 steps in one "
        f"CUDA graph)  [{card}]")


def vqvae_phase(torch, np, vq, launches, card):
    """BASELINE config #1: the DVAE round trip at flagship DVAEConfig,
    B=8 x 1504 mel frames -> get_codebook_indices (K3) -> decode."""
    from xtts_tpu_torch.core.config import DVAEConfig
    from xtts_tpu_torch.models.dvae import DVAE
    from xtts_tpu_torch.nn.blocks import init_flax_like

    cfg = DVAEConfig()
    dvae = DVAE(cfg).to("cuda").eval()
    init_flax_like(dvae, torch.Generator(device="cuda").manual_seed(11))
    b, frames, reps = 8, 1504, 3
    mel = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (b, cfg.channels, frames)).astype(np.float32)).cuda()

    def round_trip():
        codes = dvae.get_codebook_indices(mel)
        rec, _ = dvae.decode(codes)
        return codes, rec

    round_trip()                                   # warm: cuDNN plans
    torch.cuda.synchronize()
    launches.reset()
    t0 = time.perf_counter()
    for _ in range(reps):
        codes, rec = round_trip()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = launches.read()
    check(got["vq_nearest"] == reps, f"K3 launches {got['vq_nearest']} for "
          f"{reps} round trips")
    check(tuple(codes.shape) == (b, frames // 4)
          and tuple(rec.shape) == (b, cfg.channels, frames)
          and bool(torch.isfinite(rec).all()),
          f"round trip codes {tuple(codes.shape)} mel {tuple(rec.shape)}")
    audio = reps * b * frames * 256 / SR
    log(f"[vqvae] DVAE round trip (8 x 1504 frames, codebook 8192 x 512, "
        f"f32): {reps} round trips in {dt:.3f} s = {audio / dt:.1f} "
        f"audio-s/s; codes {tuple(codes.shape)}, mel {tuple(rec.shape)} "
        f"finite; K3 launches {got['vq_nearest']}  [{card}]")
    x = dvae.encode(mel).reshape(-1, cfg.codebook_dim).contiguous()
    return x, dvae.codebook.embed


def serving_phase(torch, np, tts, text, cond_mel, launches, cfg, card):
    """BASELINE config #5: BatchServer waves of 8 requests x 2 CLVP
    candidates (16 AR rows through K4), full-quality render; then a
    shortcut wave and a default-engine wave."""

    from xtts_tpu_torch.infer.api import TTSSettings
    from xtts_tpu_torch.infer.serving import (BatchServer, SynthesisRequest,
                                              synthesize_batch)

    settings = TTSSettings(max_mel_tokens=300, num_candidates=2)
    L = cfg.gpt.layers
    expect = (300 - 2) * cfg.vqvae.compression * cfg.vocos.hop_length
    stage = {}

    def timed(name, fn):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            stage[name] = time.perf_counter() - t0
            return out
        return wrapper

    # instrumentation of this script only: stage times around the AR pass
    # and the render of each wave
    tts._generate = timed("ar", tts._generate)
    tts._render = timed("render", tts._render)
    tts._render_shortcut = timed("render", tts._render_shortcut)

    from xtts_tpu_torch.infer import device_loop as dl

    def check_wave(name, wavs, got, full):
        check(len(wavs) == 8 and all(
            w.shape == (expect,) and w.dtype == np.float32
            and bool(np.isfinite(w).all()) for w in wavs),
            f"{name}: wavs {[w.shape for w in wavs]}, expected ({expect},)")
        steps = 300
        check(got["layer_norm_rows"] == 0, f"{name}: layer_norm_rows "
              f"launched {got['layer_norm_rows']} times")
        if got["fused_serving_logits"]:
            check(got["fused_serving_logits"] == steps
                  and got["int8_gemm_rows"] == steps * (4 * L + 1)
                  and got["int8_gemm_rows+ln"] == steps * (2 * L + 1)
                  and got["serving_attention"] == steps * L,
                  f"{name}: K4 launches {got} for {steps} steps")
        if full:
            check(got["flash_mha"] >= 200, f"{name}: K2 launches "
                  f"{got['flash_mha']} < 200")

    os.environ["XTTS_FUSED_SERVING"] = "1"
    server = BatchServer(tts, cond_mel, settings, max_batch=8,
                         window_ms=200.0, use_diffusion=True)
    try:
        for wave in range(3):
            launches.reset()
            dl.STATS.reset()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            futs = [server.submit(text[0]) for _ in range(8)]
            wavs = [f.result(timeout=900) for f in futs]
            lat = time.perf_counter() - t0
            got = launches.read(add=wave > 0)
            check_wave(f"wave {wave}", wavs, got, True)
            check(got["fused_serving_logits"] == 300,
                  f"wave {wave}: K4 steps {got['fused_serving_logits']}")
            # 16 rows: the "auto" cache ladder (128, 256), three rungs
            loop = loop_stats(dl, 300, rungs=3)
            audio = sum(w.size for w in wavs) / SR
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            log(f"[serving] {'warm' if wave == 0 else 'timed'} wave {wave}: "
                f"8 requests x 2 candidates (16 AR rows, K4), 300 steps, "
                f"full-quality render: {audio:.2f} s audio in {lat:.3f} s = "
                f"{audio / lat:.2f} audio-s/s; AR {stage['ar']:.3f} s "
                f"({300 / stage['ar']:.1f} steps/s), render "
                f"{stage['render']:.3f} s, rest (CLVP rerank, queue) "
                f"{lat - stage['ar'] - stage['render']:.3f} s; peak "
                f"{peak:.2f} GiB; launches K4 steps "
                f"{got['fused_serving_logits']} (int8_gemm_rows "
                f"{got['int8_gemm_rows']}, {got['int8_gemm_rows+ln']} of them "
                f"with the norm prologue, serving_attention "
                f"{got['serving_attention']}, layer_norm_rows "
                f"{got['layer_norm_rows']}: "
                f"{(got['int8_gemm_rows'] + got['serving_attention']) / 300:.0f}"
                f" a step), K2 {got['flash_mha']}; {loop}  [{card}]")
        st = server.stats()
        check(st["completed"] == 24 and st["failed"] == 0
              and st["waves"] == 3, f"server stats {st}")
        log(f"[serving] BatchServer.stats: {json.dumps(st)}")
    finally:
        server.close()

    reqs = [SynthesisRequest(text[0]) for _ in range(8)]
    for name, env in (("shortcut, K4", "1"), ("shortcut, default engine",
                                              None)):
        if env is None:
            os.environ.pop("XTTS_FUSED_SERVING", None)
        launches.reset()
        dl.STATS.reset()
        t0 = time.perf_counter()
        wavs = synthesize_batch(tts, reqs, cond_mel, settings,
                                use_diffusion=False,
                                generator=torch.Generator(
                                    device="cuda").manual_seed(9))
        lat = time.perf_counter() - t0
        got = launches.read()
        check_wave(name, wavs, got, False)
        if env is not None:
            check(got["fused_serving_logits"] == 300, f"{name}: K4 steps")
        else:
            check(got["fused_serving_logits"] == 0, f"{name}: K4 launched")
        loop = loop_stats(dl, 300, rungs=3)
        audio = sum(w.size for w in wavs) / SR
        log(f"[serving] synthesize_batch, {name}: 8 x 2 candidates, 300 "
            f"steps: {audio:.2f} s audio in {lat:.3f} s = {audio / lat:.2f} "
            f"audio-s/s; AR {stage['ar']:.3f} s ({300 / stage['ar']:.1f} "
            f"steps/s), render {stage['render']:.3f} s; {loop}  [{card}]")
    for name in ("_generate", "_render", "_render_shortcut"):
        del tts.__dict__[name]



def stream_phase(torch, np, cfg, cond_wav, main_render, launches, card):
    """The low-latency B=1 path: TextToSpeech(bf16, int8 decode tree,
    HiFi-GAN) with XTTS_DECODE_BITS=4 set when its stack is built, so every
    token runs K1-int4. Three 50-token sentences (numpy seeds 10, 11, 12)
    through tts_stream's per-sentence loop on token ids (stream_tokens),
    rendered by the HifiDecoder; one warm-up sentence first. Then one
    preset("ultra_fast") request (dpm++2m, 15 steps, K2) on the same
    stack, and the first sentence again on the int8 stack as the
    in-program comparator of AR tokens/s."""
    from xtts_tpu_torch.infer import device_loop as dl
    from xtts_tpu_torch.infer.api import TextToSpeech, TTSSettings
    from xtts_tpu_torch.models.hifigan import hifigan_samples
    from xtts_tpu_torch.ops import decode_step as ds

    t0 = time.perf_counter()
    os.environ["XTTS_DECODE_BITS"] = "4"
    try:
        tts = TextToSpeech(cfg, device="cuda", dtype=torch.bfloat16,
                           quantized_decode=True, with_hifigan=True,
                           generator=torch.Generator(device="cuda")
                           .manual_seed(0))
        with torch.no_grad():
            tts.gpt.mel_head.bias[cfg.gpt.stop_mel_token] = -30.0
        tts.requantize()
    finally:
        os.environ.pop("XTTS_DECODE_BITS")
    check(tts._qtree["fused"]["bits"] == 4, "the stream TTS has no int4 stack")
    torch.cuda.synchronize()
    log(f"[stream] TextToSpeech(XTTSConfig(), bf16, int4 K1 stack, HiFi-GAN "
        f"{cfg.hifigan.upsample_initial_channel} ch) random init "
        f"{time.perf_counter() - t0:.1f} s")
    cond_mel = tts.cond_mel_from_wav(cond_wav)
    spk = tts.speaker_mel_from_wav(cond_wav)
    check(tuple(spk.shape) == (1, 301, 64), f"speaker mel {spk.shape}")
    sents = [np.random.default_rng(s).integers(3, 250, 50).astype(np.int32)
             for s in (10, 11, 12)]
    settings = TTSSettings(max_mel_tokens=300)
    L = cfg.gpt.layers
    samples = hifigan_samples(cfg.hifigan, 298)

    def stream(seed, token_lists):
        return tts.stream_tokens(
            token_lists, cond_mel,
            torch.Generator(device="cuda").manual_seed(seed), settings,
            use_hifigan=True, spk_mel16=spk)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = next(stream(0, sents[:1]))
    log(f"[stream] warm-up sentence: {time.perf_counter() - t0:.3f} s "
        f"(AR {warm['ar_seconds']:.3f} s, render "
        f"{warm['render_seconds']:.3f} s)  [{card}]")

    launches.reset()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    t_prev, ttfa, steps, audio = t_start, None, 0, 0.0
    dl.STATS.reset()
    for i, out in enumerate(stream(1, sents)):
        now = time.perf_counter()
        loop = loop_stats(dl, out["steps"], rungs=1)
        dl.STATS.reset()
        wav = out["wav"]
        check(wav.shape == (1, samples) and wav.dtype == np.float32
              and bool(np.isfinite(wav).all()),
              f"sentence {i} wav {wav.shape}, expected (1, {samples})")
        ttfa = now - t_start if ttfa is None else ttfa
        sec = wav.shape[1] / SR
        wall = now - t_prev
        steps += out["steps"]
        audio += sec
        log(f"[stream] sentence {i}: {out['steps']} AR tokens in "
            f"{out['ar_seconds']:.3f} s = "
            f"{out['steps'] / out['ar_seconds']:.1f} tokens/s (int4), "
            f"HiFi-GAN render {out['render_seconds']:.3f} s, wall "
            f"{wall:.3f} s for {sec:.2f} s audio, RTF {wall / sec:.4f}; "
            f"{loop}  [{card}]")
        t_prev = now
    total = time.perf_counter() - t_start
    d = launches.read()
    k1 = d["fused_decode_logits"]
    check(d["int4_gemv"] == (4 * L + 1) * k1 and d["int8_gemv"] == 0
          and d["int4_gemv+ln"] == (2 * L + 1) * k1
          and d["decode_attention"] == L * k1 and k1 >= steps
          and d["layer_norm_rows"] == 0 and d["flash_mha"] == 0,
          f"[stream] launches {d} for {steps} tokens")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[stream] 3 sentences: time to first audio {ttfa:.3f} s; "
        f"{audio:.2f} s audio in {total:.3f} s, RTF {total / audio:.4f}; "
        f"peak {peak:.2f} GiB; launches int4_gemv {d['int4_gemv']} "
        f"({d['int4_gemv+ln']} with the norm prologue), int8_gemv "
        f"{d['int8_gemv']}, decode_attention {d['decode_attention']}, "
        f"layer_norm_rows {d['layer_norm_rows']}: "
        f"{(d['int4_gemv'] + d['decode_attention']) / k1:.0f} a token over "
        f"{k1} K1 steps for {steps} tokens  [{card}]")

    launches.reset()
    fast = TTSSettings.preset("ultra_fast")
    fast.max_mel_tokens = 300
    t0 = time.perf_counter()
    out = tts.tts_tokens(sents[0], cond_mel,
                         torch.Generator(device="cuda").manual_seed(1), fast)
    lat = time.perf_counter() - t0
    d = launches.read()
    check(out["wav"].shape == (1, 298 * 1024)
          and bool(np.isfinite(out["wav"]).all()), "ultra_fast wav")
    check(d["flash_mha"] >= 60 and d["int4_gemv"] > 0
          and d["int8_gemv"] == 0 and d["layer_norm_rows"] == 0,
          f"ultra_fast launches {d}")
    log(f"[stream] preset ultra_fast (dpm++2m, 15 steps, int4 AR): latency "
        f"{lat:.3f} s, RTF {lat / (298 * 1024 / SR):.4f}; AR "
        f"{out['steps'] / out['ar_seconds']:.1f} tokens/s, render "
        f"{out['render_seconds']:.3f} s against [main]'s 50-step renders "
        f"{', '.join(f'{r:.3f}' for r in main_render)} s; K2 "
        f"{d['flash_mha']} launches  [{card}]")

    tts.requantize()                      # XTTS_DECODE_BITS unset: int8
    check("bits" not in tts._qtree["fused"], "the comparator stack is int4")
    launches.reset()
    out8 = next(stream(1, sents[:1]))
    d = launches.read(add=False)
    check(d["int8_gemv"] >= (4 * L + 1) * out8["steps"]
          and d["int4_gemv"] == 0 and d["layer_norm_rows"] == 0,
          f"int8 comparator launches {d}")
    log(f"[stream] comparator: sentence 0 on the int8 stack, "
        f"{out8['steps']} AR tokens at "
        f"{out8['steps'] / out8['ar_seconds']:.1f} tokens/s, render "
        f"{out8['render_seconds']:.3f} s  [{card}]")


def loop_stats(dl, steps: int, rungs: int) -> str:
    """The device loop's counts since the last reset, for one request:
    host reads of the loop state must stay within ceil(steps / CHUNK) +
    rungs + 2 (a read a replay or eager tail, one a rung, the ends)."""
    st = dl.STATS
    limit = -(-steps // dl.CHUNK) + rungs + 2
    check(st.syncs <= limit, f"the AR loop read its state {st.syncs} times "
          f"for {steps} steps (limit {limit})")
    return (f"loop: {st.syncs} host reads (limit {limit}), {st.replays} "
            f"graph replays of {dl.CHUNK} steps, {st.eager_steps} eager "
            f"steps, {st.captures} captures in {st.capture_ms:.1f} ms")


# A kernel's name in a torch.profiler trace (demangled, or mangled as
# CUPTI may give it) -> the wrapper's launch counter; a captured group is
# the template argument that says the norm prologue ran ("+ln").
TRACE_KERNELS = (
    ("int8_gemv", r"gemv_kernel(?:<\s*|ILi)8(?:\s*,\s*|ELi)(\d+)"),
    ("int4_gemv", r"gemv_kernel(?:<\s*|ILi)4(?:\s*,\s*|ELi)(\d+)"),
    ("decode_attention", r"decode_attention_kernel()"),
    ("int8_gemm_rows", r"int8_gemm_rows_kernel(?:<\s*|ILi)\d+"
                       r"(?:\s*,\s*|ELb)(true|false|1|0)"),
    ("serving_attention", r"serving_attention_kernel()"),
    ("layer_norm_rows", r"layer_norm_rows_kernel()"),
    ("flash_mha", r"flash_fwd_kernel()"),
    ("vq_nearest", r"vq_merge_kernel()"),      # the last of its 3 launches
)


def traced_launches(events) -> dict:
    """Each counted kernel's launches in a trace's device events."""
    got = {}
    for name, _ in TRACE_KERNELS:
        got[name] = got[name + "+ln"] = 0
    for e in events:
        if e.get("cat") != "kernel":
            continue
        for name, pat in TRACE_KERNELS:
            m = re.search(pat, e["name"])
            if m:
                got[name] += 1
                got[name + "+ln"] += m.group(1) not in ("", "0", "false")
                break
    return got


def trace_mismatch(events, counted: dict):
    """None if every kernel of TRACE_KERNELS ran in the trace as many times
    as its wrapper counted, else what differs and, for each launch call
    the counted kernels came from, how many it holds."""
    traced = traced_launches(events)
    wrong = {k: (n, counted.get(k, 0)) for k, n in traced.items()
             if n != counted.get(k, 0)}
    if not any(traced.values()):
        return "no counted kernel in the trace"
    if not wrong:
        return None
    api = {e["args"].get("correlation"): e["name"] for e in events
           if e.get("cat") == "cuda_runtime" and "args" in e}
    per = {}
    for e in events:
        if e.get("cat") == "kernel" and any(
                re.search(p, e["name"]) for _, p in TRACE_KERNELS):
            c = e.get("args", {}).get("correlation")
            per[c] = per.get(c, 0) + 1
    shapes = {}
    for c, n in per.items():
        key = f"{api.get(c, '?')} x {n}"
        shapes[key] = shapes.get(key, 0) + 1
    return (f"(traced, counted) {wrong}; launch calls by counted kernels "
            f"they hold: {shapes}")


def hold_counts_to_trace(torch, run, launches, what: str, card,
                         first=None) -> None:
    """run() under torch.profiler (or `first`, the (events, counts) of such
    a run already made): every kernel of TRACE_KERNELS must be in the trace
    as many times as its wrapper counted. Replays add the counts of their
    capture, so this holds those counts to what the card ran. A trace can
    lose records (on an H100 one trace lacked three whole steps' kernels
    while the run's codes were right): a mismatch is traced once more, and
    only a second one fails, since a wrong count repeats and a lost record
    does not."""
    for attempt in (1, 2):
        if first is None:
            launches.reset()
            _, events = traced_run(torch, run, "counts")
            counted = launches.read(add=False)
        else:
            (events, counted), first = first, None
        bad = trace_mismatch(events, counted)
        if bad is None:
            traced = traced_launches(events)
            log(f"{what}: kernels in the trace == launches counted "
                f"(trace {attempt}), "
                + ", ".join(f"{k} {n}" for k, n in traced.items() if n)
                + f"  [{card}]")
            return
        log(f"{what}: trace {attempt} differs from the counts: {bad}  "
            f"[{card}]")
    check(False, f"{what}: kernels in two traces != launches counted")


def traced_run(torch, fn, label: str):
    """fn() under torch.profiler; returns (its result, the trace's
    events). The trace goes to build/xtts_tpu_torch/<label>_trace.json."""
    from torch.profiler import ProfilerActivity, profile

    from xtts_tpu_torch.ops.build import BUILD_DIR
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    trace = BUILD_DIR / f"{label}_trace.json"
    prof.export_chrome_trace(str(trace))
    return out, json.loads(trace.read_text())["traceEvents"]


def loop_phase(torch, dl, tts, cond_mel, text, launches, card):
    """The AR loop's CUDA graphs against the same loop run eagerly on the
    card (`device_loop.eager()`), at the flagship width on [main]'s model
    and inputs: K1 (its int8 stack), K1-int4 (stack_qtree_int4 of the same
    tree) and K4 (16 rows, each its own text: ids shifted by 7 a row),
    greedy and seeded sampling, 300 steps each: codes, lengths and steps
    must be equal, and the graph run's kernel launches (counted at capture,
    added a replay) equal the eager run's. One more greedy graph run of
    each engine runs under torch.profiler: the kernels its trace holds
    must equal the counted launches (int8_gemv, int4_gemv, decode_attention,
    int8_gemm_rows, serving_attention and their "+ln")."""
    import contextlib

    from xtts_tpu_torch.infer.qdecode import generate_speech_quantized
    from xtts_tpu_torch.ops import decode_step as ds
    cfg = tts.cfg.gpt
    qt = tts._qtree
    qt4 = dict(qt, fused=ds.stack_qtree_int4(qt, cfg.number_mel_codes))
    tok = torch.as_tensor(text, dtype=torch.long, device="cuda")
    for name, tree, rows in (("K1", qt, 1), ("K1-int4", qt4, 1),
                             ("K4", qt, 16)):
        shift = 7 * torch.arange(rows, device="cuda")[:, None]
        texts = 3 + (tok - 3 + shift) % 247         # ids stay in [3, 250)

        def run(seed=21, sampled=False):
            return generate_speech_quantized(
                tts.gpt, tree, cond_mel.repeat(rows, 1, 1), texts,
                torch.Generator(device="cuda").manual_seed(seed),
                max_gen=300, do_sample=sampled, use_fused_serving=rows > 1)
        for sampled in (False, True):
            runs = []
            for graphs in (False, True):
                launches.reset()
                dl.STATS.reset()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with contextlib.nullcontext() if graphs else dl.eager():
                    r = run(sampled=sampled)
                torch.cuda.synchronize()
                runs.append((r, time.perf_counter() - t0,
                             launches.read(add=False), loop_stats(
                                 dl, r.steps, rungs=1)))
            (r_e, te, de, _), (rg, tg, dg, loop) = runs
            check(torch.equal(r_e.codes, rg.codes)
                  and torch.equal(r_e.lengths, rg.lengths)
                  and r_e.steps == rg.steps,
                  f"[loop] {name} ({'sampled' if sampled else 'greedy'}): "
                  f"graph codes != eager codes")
            check(de == dg, f"[loop] {name}: launches eager {de}, graphs "
                  f"{dg}")
            distinct = len({tuple(c) for c in rg.codes.tolist()})
            check(rows == 1 or distinct > 1, f"[loop] {name}: every row "
                  f"gave the same codes, so the rows are not told apart")
            log(f"[loop] {name} {rows} row(s) ({distinct} distinct), "
                f"{'seeded sampling' if sampled else 'greedy'}, "
                f"{rg.steps} steps: graph codes == eager device-loop codes; "
                f"eager {te:.3f} s ({r_e.steps / te:.1f} tokens/s), graphs "
                f"{tg:.3f} s ({rg.steps / tg:.1f} tokens/s); graph run "
                f"{loop}  [{card}]")
        hold_counts_to_trace(torch, run, launches,
                             f"[loop] {name} greedy, traced graph run", card)


def consumer_attention_check(torch, fa, tts):
    """The model's own consumer attn1 projections at bucket 320: the flash
    kernel against plain attention on the same q/k/v."""
    attn = tts.diffusion.base_model.blocks[1][1].transformer_blocks[0].attn1
    g = torch.Generator(device="cuda").manual_seed(5)
    xa = torch.randn(2, 1280 + 282, 512, generator=g,
                     device="cuda").bfloat16()
    q = attn.to_q(xa[:, :1280]).unflatten(-1, (8, 64))
    k = attn.to_k(xa).unflatten(-1, (8, 64))
    v = attn.to_v(xa).unflatten(-1, (8, 64))
    check(fa.use_flash(q.shape[1], k.shape[1]), "consumer gate closed")
    o_k = attn.to_out[0](fa.flash_mha(q, k, v, 0.125).flatten(-2))
    o_p = attn.to_out[0](fa.flash_mha_plain(q, k, v, 0.125).flatten(-2))
    err = max_err(o_k, o_p)
    scale = o_p.float().abs().max().item()
    check(err <= 2 * K2_TOL * max(1.0, scale), f"consumer attn1 err {err}")
    log(f"[k2] consumer attn1 (model weights, Tq 1280, Tk 1562): flash vs "
        f"plain after to_out max_abs_err {err:.3e} (|out| max {scale:.3f})")


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def busy_us(intervals, lo: float, hi: float) -> float:
    """Length of the union of sorted (start, end) intervals within [lo, hi]."""
    total, cur = 0.0, None
    for s, e in intervals:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur is None or s > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    return total + (cur[1] - cur[0] if cur is not None else 0.0)


def profile_request(torch, tts, text, cond_mel, settings, launches, card):
    """One warm request (seed 4) timed bare, then again under torch.profiler.

    The busy share is the union of device intervals (kernels, memcpy,
    memset) over a host-clock span, divided by the span: the request's own
    record_function span, and its AR and render parts, split at the span's
    start plus the profiled request's `ar_seconds`. Every counted kernel
    in the trace (int8_gemv, decode_attention, flash_mha, ...) is held
    against the request's launch counts (most of the K1 launches ran
    inside CUDA graph replays). The sampler's device time a token: 50
    sample_token calls captured in one graph, replayed."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from xtts_tpu_torch.infer.sampling import sample_token
    from xtts_tpu_torch.ops.build import BUILD_DIR

    def request():
        return tts.tts_tokens(text, cond_mel,
                              torch.Generator(device="cuda").manual_seed(4),
                              settings)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    request()
    bare = time.perf_counter() - t0
    launches.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("chip_smoke.request"):
            out = request()
    counted = launches.read(add=False)
    trace = BUILD_DIR / "request_trace.json"
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    span = next(e for e in events if e.get("cat") == "user_annotation"
                and e.get("name") == "chip_smoke.request")
    lo, hi = float(span["ts"]), float(span["ts"]) + float(span["dur"])
    split = lo + out["ar_seconds"] * 1e6
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    ivs = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                 for e in dev)
    check(len(ivs) > 0, "the profiled request traced no device work")
    shares = {name: busy_us(ivs, a, b) / (b - a)
              for name, a, b in (("request", lo, hi), ("ar", lo, split),
                                 ("render", split, hi))}
    log(f"[profile] request seed 4: {out['steps']} AR tokens, latency bare "
        f"{bare:.3f} s, under the profiler {(hi - lo) / 1e6:.3f} s (AR "
        f"{out['ar_seconds']:.3f} s, render {out['render_seconds']:.3f} s); "
        f"device busy share: request {shares['request']:.3f}, AR "
        f"{shares['ar']:.3f}, render {shares['render']:.3f}  [{card}]")

    hold_counts_to_trace(torch, request, launches, "[profile] request "
                         "(graph replays included)", card,
                         first=(events, counted))

    g = torch.Generator(device="cuda").manual_seed(6)
    v = tts.cfg.gpt.number_mel_codes
    logits = torch.randn(1, v, generator=g, device="cuda")
    seen = torch.zeros(1, v, dtype=torch.bool, device="cuda")
    seen[0, :50] = True

    def sample():
        return sample_token(g, logits, temperature=settings.temperature,
                            top_p=settings.top_p, seen=seen,
                            repetition_penalty=settings.repetition_penalty)
    t_samp = time_ms(torch, sample)
    for _ in range(3):
        sample()
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(g)
    with torch.cuda.graph(graph):
        for _ in range(50):
            sample()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) * 1e3 / 50)
    d_samp = statistics.median(times)
    log(f"[profile] sample_token (1, {v}) one call {t_samp:.4f} ms (CUDA "
        f"events around a single call: mostly host launch time); device "
        f"{fmt_us(d_samp)} a token (50 calls in one CUDA graph)  [{card}]")

    by_name = {}
    for e in dev:
        tot, n = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (tot + float(e["dur"]), n + 1)
    total = sum(t for t, _ in by_name.values())
    log(f"[profile] device time in the request {total / 1e3:.1f} ms over "
        f"{len(dev)} device events; top kernels:")
    for name, (tot, n) in sorted(by_name.items(),
                                 key=lambda kv: -kv[1][0])[:12]:
        log(f"[profile]   {tot / 1e3:9.2f} ms {n:7d} calls "
            f"{tot / n:9.2f} us/call  {name[:90]}")
    flash = [(t, n) for name, (t, n) in by_name.items()
             if "flash_fwd_kernel" in name]
    check(len(flash) == 1, f"flash kernel in the profile: {flash}")
    t_fl, n_fl = flash[0]
    log(f"[k2] flash kernel device time in [profile]'s request: "
        f"{t_fl / n_fl:.2f} us a call over {n_fl} calls "
        f"({4 * 2 * 8 * 1280 * 1562 * 64 / (t_fl / n_fl * 1e-6) / 1e12:.1f} "
        f"TFLOP/s at (2, 1280 | 1562, 8, 64))  [{card}]")


def main() -> None:
    t_start = time.perf_counter()
    torch = require_card()
    sys.path.insert(0, str(ROOT))
    import numpy as np

    # ---- 1. device ----
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    log(card)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} cards {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 2. build ----
    from xtts_tpu_torch.ops.build import BUILD_DIR, build_all
    t0 = time.perf_counter()
    names = ("decode_step", "flash_attn", "vq", "serving_step")
    build_all(names)
    log(f"[build] nvcc sm_90a into {BUILD_DIR}: {', '.join(names)} in "
        f"{time.perf_counter() - t0:.1f} s (one process each, in parallel)")

    from xtts_tpu_torch.infer import device_loop as dl
    from xtts_tpu_torch.infer.api import TextToSpeech, TTSSettings, XTTSConfig
    from xtts_tpu_torch.infer.qdecode import quantize_dense
    from xtts_tpu_torch.nn import flash_attn as fa
    from xtts_tpu_torch.ops import decode_step as ds
    from xtts_tpu_torch.ops import serving_step as ss
    from xtts_tpu_torch.ops import vq

    cfg = XTTSConfig()
    text_len, max_gen = 50, 300
    p_len = 1 + (text_len + 2) + 1            # cond + [start; text; stop] + start
    s_max = -(-(p_len + max_gen) // 8) * 8    # K1's cache (8-aligned)
    launches = Launches(ds.KERNELS + (fa.flash_mha,) + vq.KERNELS
                        + ss.KERNELS + (ds.fused_decode_logits,
                                        ss.fused_serving_logits))

    # ---- 3. kernels vs their plain twins ----
    results = {}
    with torch.no_grad():
        qt, st = k1_checks(torch, ds, quantize_dense, cfg.gpt, s_max, p_len,
                           results, card)
        k1_int4_checks(torch, ds, qt, cfg.gpt, s_max, p_len, results, card)
        k2_checks(torch, fa, results, card)
        k4_checks(torch, ds, ss, qt, st, cfg.gpt, p_len, p_len + max_gen,
                  results, card)
        del qt, st
    small_reference_check(torch, np, TextToSpeech, TTSSettings)

    # ---- 4. main path (B=1, K1 + K2) ----
    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(0)
    tts = TextToSpeech(cfg, device="cuda", dtype=torch.bfloat16,
                       quantized_decode=True, with_clvp=True, generator=g)
    with torch.no_grad():
        # random weights stop at a random step; pinning the stop logit low
        # makes every request decode the full max_mel_tokens and render
        # the 320-code bucket, the bench's canonical workload
        tts.gpt.mel_head.bias[cfg.gpt.stop_mel_token] = -30.0
        tts.requantize()
        consumer_attention_check(torch, fa, tts)
    torch.cuda.synchronize()
    log(f"[main] TextToSpeech(XTTSConfig(), bf16, int8 decode, CLVP) random "
        f"init {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(0)
    t = np.arange(3 * SR) / SR
    cond_wav = (0.3 * np.sin(2 * np.pi * 220 * t)
                + 0.1 * rng.standard_normal(3 * SR)).astype(np.float32)
    text = rng.integers(3, 250, (1, text_len)).astype(np.int32)
    cond_mel = tts.cond_mel_from_wav(cond_wav)
    check(tuple(cond_mel.shape) == (1, 100, 282), f"cond mel {cond_mel.shape}")
    settings = TTSSettings(max_mel_tokens=max_gen)

    torch.cuda.reset_peak_memory_stats()
    main_render = []
    for seed in (1, 2, 3):
        launches.reset()
        dl.STATS.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = tts.tts_tokens(text, cond_mel,
                             torch.Generator(device="cuda").manual_seed(seed),
                             settings)
        latency = time.perf_counter() - t0
        d = launches.read()
        wav, steps = out["wav"], out["steps"]
        n = max(int(out["lengths"][0]) - 2, 1)
        check(wav.shape == (1, n * 1024), f"wav shape {wav.shape}, n {n}")
        check(wav.dtype == np.float32 and bool(np.isfinite(wav).all()),
              "wav not finite float32")
        check(d["fused_decode_logits"] >= steps,
              f"K1 steps {d['fused_decode_logits']} < tokens {steps}")
        nl, k1 = cfg.gpt.layers, d["fused_decode_logits"]
        check(d["int8_gemv"] == (4 * nl + 1) * k1
              and d["int8_gemv+ln"] == (2 * nl + 1) * k1
              and d["decode_attention"] == nl * k1
              and d["layer_norm_rows"] == 0,
              f"K1 op launches {d} for {k1} steps")
        check(d["flash_mha"] >= 200, f"K2 launches {d['flash_mha']} < 200")
        loop = loop_stats(dl, steps, rungs=1)
        audio_s = wav.shape[1] / SR
        main_render.append(out["render_seconds"])
        log(f"[main] request seed {seed}: {steps} AR tokens, wav {wav.shape} "
            f"({audio_s:.2f} s audio), latency {latency:.3f} s, RTF "
            f"{latency / audio_s:.4f}, AR {out['ar_seconds']:.3f} s = "
            f"{steps / out['ar_seconds']:.1f} tokens/s, render "
            f"{out['render_seconds']:.3f} s; launches K1 step {k1} (gemv "
            f"{d['int8_gemv']}, {d['int8_gemv+ln']} of them with the norm "
            f"prologue, attention {d['decode_attention']}, layer_norm "
            f"{d['layer_norm_rows']}: "
            f"{(d['int8_gemv'] + d['decode_attention']) / k1:.0f} a token), "
            f"K2 {d['flash_mha']}; {loop} [{card}]")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[main] peak device memory {peak:.2f} GiB [{card}]")

    # ---- 4b. the AR loop's graphs against the same loop run eagerly ----
    with torch.no_grad():
        loop_phase(torch, dl, tts, cond_mel, text, launches, card)

    # ---- 5. vqvae (config #1, K3) ----
    with torch.no_grad():
        x_path, emb_path = vqvae_phase(torch, np, vq, launches, card)
        k3_checks(torch, vq, x_path, emb_path, results, card)
        del x_path, emb_path

    # ---- 6. serving (config #5, K4 + CLVP + K2) ----
    serving_phase(torch, np, tts, text, cond_mel, launches, cfg, card)

    # ---- 7. stream (B=1: K1-int4, HiFi-GAN, ultra_fast) ----
    stream_phase(torch, np, cfg, cond_wav, main_render, launches, card)

    # ---- 8. profile (B=1), last: once torch.profiler has run, the
    # process's host-bound loops read slower ----
    profile_request(torch, tts, text, cond_mel, settings, launches, card)
    leaked = [m for m in ("jax", "flax", "xtts_tpu") if m in sys.modules]
    check(not leaked, f"imported {leaked}")

    # ---- 9. results ----
    src = {"decode_step": ("xtts_tpu_torch/csrc/decode_step.cu",
                           "xtts_tpu/ops/decode_step.py:299"),
           "flash_attn": ("xtts_tpu_torch/csrc/flash_attn.cu",
                          "xtts_tpu/nn/flash_attn.py:54"),
           "vq": ("xtts_tpu_torch/csrc/vq.cu", "xtts_tpu/ops/vq.py:69"),
           "serving_step": ("xtts_tpu_torch/csrc/serving_step.cu",
                            "xtts_tpu/ops/serving_step.py:315")}
    of = {"layer_norm_rows": "decode_step", "int8_gemv": "decode_step",
          "int8_gemv+ln": "decode_step", "int4_gemv": "decode_step",
          "int4_gemv+ln": "decode_step",
          "decode_attention": "decode_step", "flash_mha": "flash_attn",
          "vq_nearest": "vq", "int8_gemm_rows": "serving_step",
          "int8_gemm_rows+ln": "serving_step",
          "serving_attention": "serving_step"}
    kernels = []
    for name, lib in of.items():
        r = results[name]
        if name == "layer_norm_rows":        # the prologues' comparator
            check(launches.total[name] == 0, "layer_norm_rows launched on a "
                  "path")
        else:
            check(launches.total[name] > 0, f"{name} never launched on a "
                  f"path")
        replaces = (src[lib][1] if not name.startswith("int4_gemv")
                    else "xtts_tpu/ops/decode_step.py:157")
        kernels.append({"name": name, "route": "cuda",
                        "source": src[lib][0], "replaces": replaces,
                        "launches": launches.total[name], **r})
    log(f"[done] total wall time {time.perf_counter() - t_start:.1f} s "
        f"[{card}]")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
