#!/usr/bin/env python3
"""Run the PyTorch port's zero-shot main path once on one NVIDIA H100.

    python3 chip_smoke.py

From the root of a checkout, on a machine with a CUDA card (sm_90), the
CUDA toolkit (nvcc) and PyTorch built for CUDA. No network; imports no JAX.
Random weights from a fixed seed, the flagship XTTSConfig() widths
(GPT 15 x 1024, UNet 512, CLIP 6 x 512, Vocos 8 x 512).

Phases, each reported on its own lines:
  1. device: card name and power limit (nvidia-smi), torch / CUDA versions;
     TF32 off for matmuls and cuDNN.
  2. build: nvcc compiles xtts_tpu_torch/csrc/*.cu into build/xtts_tpu_torch/.
  3. kernels: each kernel against its plain PyTorch twin on the same card
     tensors at the main path's shapes — K1 (layer_norm_rows, int8_gemv,
     decode_attention, the whole 15-layer step, a 64-step teacher-forced
     greedy chain) and K2 (flash_mha at (2, 1280 | 1562, 8, 64) and the
     ragged (2, 300 | 583, 8, 64)); max error and median CUDA-event times.
     Then the whole path on a small configuration, card against CPU with
     the same weights: identical greedy int8 codes, render within 1e-3.
  4. main path: TextToSpeech(quantized_decode=True, dtype=bf16) on the
     bench's canonical inputs (3 s 220 Hz sine + noise reference, 50 text
     tokens from numpy seed 0), tts_tokens with max_mel_tokens=300, three
     requests with generator seeds 1, 2, 3. Each request must return a
     finite (1, n * 1024) wav and go through K1 for every generated token
     and K2 for every consumer attention (>= 50 steps x 4 blocks).
  5. profile: one more warm request (seed 4), bare and then under
     torch.profiler. Prints the device's busy share over the request and
     over its AR and render stages (the union of kernel, memcpy and memset
     intervals over the stage's host-clock span), the request's latency with
     and without the profiler, the host time of one sample_token call, and
     the kernels with the most device time. The trace is written to
     build/xtts_tpu_torch/request_trace.json.
  6. a JSON line of the kernels, then the result line.

Any failure raises and exits non-zero. Without a CUDA card, or outside a
checkout, it exits non-zero before printing any result.
"""
from __future__ import annotations

import json
import math
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


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


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


def k1_checks(torch, ds, quantize_dense, cfg, s_max, p_len, results, card):
    L, D, H, V = cfg.layers, cfg.model_dim, cfg.heads, cfg.number_mel_codes
    g = torch.Generator(device="cuda").manual_seed(1234)
    qt = random_qtree(torch, quantize_dense, L, D, V, s_max, g)
    st = ds.stack_qtree(qt, V)

    def cache():
        kc = torch.zeros(L, s_max, D, dtype=torch.bfloat16, device="cuda")
        gc = torch.Generator(device="cuda").manual_seed(7)
        kc[:, :p_len] = (torch.randn(L, p_len, D, generator=gc,
                                     device="cuda") * 0.5).bfloat16()
        vc = torch.zeros_like(kc)
        vc[:, :p_len] = (torch.randn(L, p_len, D, generator=gc,
                                     device="cuda") * 0.5).bfloat16()
        return kc, vc

    # --- single ops at the main path's shapes ---
    x32 = torch.randn(1, D, generator=g, device="cuda") * 3 + 1
    ln0 = st["ln"][0]
    e_ln = max(max_err(ds.layer_norm_rows(x32, ln0[0], ln0[1]),
                       ds.layer_norm_rows_plain(x32, ln0[0], ln0[1])),
               max_err(ds.layer_norm_rows(x32, *st["lnf"]),
                       ds.layer_norm_rows_plain(x32, *st["lnf"])))
    check(e_ln <= OP_TOL, f"layer_norm_rows err {e_ln}")
    t_ln = time_ms(torch, lambda: ds.layer_norm_rows(x32, ln0[0], ln0[1]))
    p_ln = time_ms(torch, lambda: ds.layer_norm_rows_plain(x32, ln0[0],
                                                           ln0[1]))
    results["layer_norm_rows"] = dict(max_abs_err=e_ln, ms=t_ln, plain_ms=p_ln)
    log(f"[k1] layer_norm_rows (1, {D}) max_abs_err {e_ln:.3e}  "
        f"kernel {t_ln:.4f} ms  plain {p_ln:.4f} ms  [{card}]")

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
            fk = lambda: ds.int8_gemv(xin, w, s, b, out=o1)
            fp = lambda: ds.int8_gemv_plain(xin, w, s, b, out=o2)
        else:
            o1 = ds.int8_gemv(xin, w, s, b, **kw)
            o2 = ds.int8_gemv_plain(xin, w, s, b, **kw)
            fk = lambda: ds.int8_gemv(xin, w, s, b, **kw)
            fp = lambda: ds.int8_gemv_plain(xin, w, s, b, **kw)
        err = max_err(o1, o2)
        rel = err / max(1.0, o2.float().abs().max().item())
        check(rel <= OP_TOL, f"int8_gemv {name} err {err}")
        e_gemv = max(e_gemv, err)
        tk, tp = time_ms(torch, fk), time_ms(torch, fp)
        gbs = w.numel() / (tk * 1e-3) / 1e9
        log(f"[k1] int8_gemv {name} ({w.shape[0]} x {w.shape[1]}) "
            f"max_abs_err {err:.3e}  kernel {tk:.4f} ms ({gbs:.0f} GB/s "
            f"weights)  plain {tp:.4f} ms  [{card}]")
        if name == "fc+gelu":
            fc_times = (tk, tp)
    results["int8_gemv"] = dict(max_abs_err=e_gemv, ms=fc_times[0],
                                plain_ms=fc_times[1])

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
    t_att = time_ms(torch, lambda: ds.decode_attention(qkv, kc1[0], vc1[0],
                                                       idx, H))
    p_att = time_ms(torch, lambda: ds.decode_attention_plain(
        qkv, kc2[0], vc2[0], idx, H))
    results["decode_attention"] = dict(max_abs_err=e_att, ms=t_att,
                                       plain_ms=p_att)
    log(f"[k1] decode_attention ({H} heads x 64, rows 0..{idx} of {s_max}) "
        f"max_abs_err {e_att:.3e}  kernel {t_att:.4f} ms  plain {p_att:.4f} ms"
        f"  [{card}]")

    # --- the whole step, and a 64-step teacher-forced greedy chain ---
    emb, pos = qt["mel_embedding"], qt["mel_pos_embedding"]
    toks = torch.randint(0, V, (64,), generator=g, device="cuda").tolist()
    kc_k, vc_k = cache()
    kc_p, vc_p = cache()
    agree, ties, e_step, l_max = 0, 0, 0.0, 0.0
    for step, tok in enumerate(toks):
        x = emb[tok][None] + pos[step + 2][None]
        lk, _, _ = ds.fused_decode_logits(st, x, kc_k, vc_k, p_len + step,
                                          L, H)
        lp, _, _ = ds.fused_decode_logits_plain(st, x, kc_p, vc_p,
                                                p_len + step, L, H)
        err = max_err(lk[:, :V], lp[:, :V])
        e_step = max(e_step, err)
        ka, pa = int(lk[:, :V].argmax()), int(lp[:, :V].argmax())
        if ka == pa:
            agree += 1
        else:
            # random weights give near-flat logits over 8194 codes: a
            # differing pick must be a tie within this step's logit error
            gap = (lp[0, pa] - lp[0, ka]).item()
            check(gap <= 2 * err, f"K1 greedy step {step}: kernel picks "
                  f"{ka}, plain {pa}, gap {gap:.3e} > 2 x err {err:.3e}")
            ties += 1
        check(lk[:, V:].max().item() < -1e8, "padded head columns reachable")
        l_max = max(l_max, lp[:, :V].abs().max().item())
    e_rows = max(max_err(kc_k, kc_p), max_err(vc_k, vc_p))
    r_max = max(kc_p.float().abs().max().item(),
                vc_p.float().abs().max().item())
    check(e_step <= K1_TOL * max(1.0, l_max), f"K1 step logits err {e_step}")
    check(e_rows <= K1_TOL * max(1.0, r_max), f"K1 step k/v rows err {e_rows}")
    x = emb[toks[0]][None] + pos[2][None]
    t_step = time_ms(torch, lambda: ds.fused_decode_logits(
        st, x, kc_k, vc_k, p_len + 64, L, H), reps=20)
    p_step = time_ms(torch, lambda: ds.fused_decode_logits_plain(
        st, x, kc_p, vc_p, p_len + 64, L, H), reps=20)
    log(f"[k1] step ({L} layers, D {D}, S {s_max}) vs plain step: logits "
        f"max_abs_err {e_step:.3e} (bound {K1_TOL} x max(1, |logits| "
        f"{l_max:.2f})), k/v rows {e_rows:.3e} (bound {K1_TOL} x max(1, "
        f"|rows| {r_max:.2f})), greedy agreement {agree}/64 teacher-forced "
        f"(+{ties} ties within the step error); kernel chain "
        f"{t_step:.3f} ms/token, plain {p_step:.3f} ms/token  [{card}]")


def k2_checks(torch, fa, results, card):
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
        tflops = 4 * b * 8 * tq * tk * 64 / (tkn * 1e-3) / 1e12
        log(f"[k2] flash_mha (B {b}, Tq {tq}, Tk {tk}, 8 x 64, bf16) "
            f"max_abs_err vs f32 {err:.3e} (bound {K2_TOL})  kernel "
            f"{tkn:.4f} ms ({tflops:.1f} TFLOP/s)  plain bf16 {tpl:.4f} ms  "
            f"[{card}]")
        if tq == 1280:
            main_times = (tkn, tpl)
    results["flash_mha"] = dict(max_abs_err=e_max, ms=main_times[0],
                                plain_ms=main_times[1])


def small_reference_check(torch, np, TextToSpeech, TTSSettings):
    """The whole path on a small configuration: the card (kernels) against
    the CPU (the plain twins, which tests/test_torch_port_e2e.py holds
    against the JAX package) with the same perturbed weights, f32 modules.
    Greedy int8 codes must be identical; the DDIM render of one set of
    codes from one shared x_T must agree within SMALL_WAV_TOL."""
    from xtts_tpu_torch.core.config import (CLIPRefConfig, DVAEConfig,
                                            DiffusionModelConfig, GPTConfig,
                                            MelConfig, VocosConfig,
                                            XTTSConfig)
    from xtts_tpu_torch.infer.qdecode import generate_speech_quantized
    from xtts_tpu_torch.ops import decode_step as ds

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
                          num_layers=1, n_fft=64, hop_length=16))
    g = torch.Generator().manual_seed(0)
    cpu = TextToSpeech(small, quantized_decode=True, generator=g)
    with torch.no_grad():
        # the flax init zeroes every output projection; perturb all weights
        # so that every layer shapes the result
        for m in cpu.modules().values():
            for p in m.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=g))
    cpu.requantize()
    card = TextToSpeech(small, device="cuda", quantized_decode=True,
                        init=False)
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

    out = {}
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


def profile_request(torch, tts, text, cond_mel, settings, card):
    """One warm request (seed 4) timed bare, then again under torch.profiler.

    The busy share is the union of device intervals (kernels, memcpy,
    memset) over a host-clock span, divided by the span: the request's own
    record_function span, and its AR and render parts, split at the span's
    start plus the profiled request's `ar_seconds`."""
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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("chip_smoke.request"):
            out = request()
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

    g = torch.Generator(device="cuda").manual_seed(6)
    v = tts.cfg.gpt.number_mel_codes
    logits = torch.randn(1, v, generator=g, device="cuda")
    seen = torch.zeros(1, v, dtype=torch.bool, device="cuda")
    seen[0, :50] = True
    t_samp = time_ms(torch, lambda: sample_token(
        g, logits, temperature=settings.temperature, top_p=settings.top_p,
        seen=seen, repetition_penalty=settings.repetition_penalty))
    log(f"[profile] sample_token (1, {v}) one call {t_samp:.4f} ms (CUDA "
        f"events around a single call: mostly host launch time)  [{card}]")

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


def main() -> None:
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
    from xtts_tpu_torch.ops.build import BUILD_DIR, load_library
    built = []
    for name in ("decode_step", "flash_attn"):
        t0 = time.perf_counter()
        load_library(name)
        built.append(f"{name} {time.perf_counter() - t0:.1f} s")
    log(f"[build] nvcc sm_90a into {BUILD_DIR}: " + ", ".join(built))

    from xtts_tpu_torch.infer.api import TextToSpeech, TTSSettings, XTTSConfig
    from xtts_tpu_torch.infer.qdecode import quantize_dense
    from xtts_tpu_torch.nn import flash_attn as fa
    from xtts_tpu_torch.ops import decode_step as ds

    cfg = XTTSConfig()
    text_len, max_gen = 50, 300
    p_len = 1 + (text_len + 2) + 1            # cond + [start; text; stop] + start
    s_max = -(-(p_len + max_gen) // 8) * 8

    # ---- 3. kernels vs their plain twins ----
    results = {}
    with torch.no_grad():
        k1_checks(torch, ds, quantize_dense, cfg.gpt, s_max, p_len, results,
                  card)
        k2_checks(torch, fa, results, card)
    small_reference_check(torch, np, TextToSpeech, TTSSettings)

    # ---- 4. main path ----
    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(0)
    tts = TextToSpeech(cfg, device="cuda", dtype=torch.bfloat16,
                       quantized_decode=True, generator=g)
    with torch.no_grad():
        # random weights stop at a random step; pinning the stop logit low
        # makes every request decode the full max_mel_tokens and render
        # the 320-code bucket, the bench's canonical workload
        tts.gpt.mel_head.bias[cfg.gpt.stop_mel_token] = -30.0
        tts.requantize()
        consumer_attention_check(torch, fa, tts)
    torch.cuda.synchronize()
    log(f"[main] TextToSpeech(XTTSConfig(), bf16, int8 decode) random init "
        f"{time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(0)
    t = np.arange(3 * SR) / SR
    cond_wav = (0.3 * np.sin(2 * np.pi * 220 * t)
                + 0.1 * rng.standard_normal(3 * SR)).astype(np.float32)
    text = rng.integers(3, 250, (1, text_len)).astype(np.int32)
    cond_mel = tts.cond_mel_from_wav(cond_wav)
    check(tuple(cond_mel.shape) == (1, 100, 282), f"cond mel {cond_mel.shape}")
    settings = TTSSettings(max_mel_tokens=max_gen)

    counted = ds.KERNELS + (ds.fused_decode_logits, fa.flash_mha)
    for fn in counted:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    for seed in (1, 2, 3):
        before = {fn.__name__: fn.launches for fn in counted}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = tts.tts_tokens(text, cond_mel,
                             torch.Generator(device="cuda").manual_seed(seed),
                             settings)
        latency = time.perf_counter() - t0
        wav, steps = out["wav"], out["steps"]
        n = max(int(out["lengths"][0]) - 2, 1)
        d = {fn.__name__: fn.launches - before[fn.__name__] for fn in counted}
        check(wav.shape == (1, n * 1024), f"wav shape {wav.shape}, n {n}")
        check(wav.dtype == np.float32 and bool(np.isfinite(wav).all()),
              "wav not finite float32")
        check(d["fused_decode_logits"] >= steps,
              f"K1 steps {d['fused_decode_logits']} < tokens {steps}")
        nl = cfg.gpt.layers
        check(d["int8_gemv"] >= (4 * nl + 1) * steps
              and d["decode_attention"] >= nl * steps
              and d["layer_norm_rows"] >= (2 * nl + 1) * steps,
              f"K1 op launches {d} for {steps} tokens")
        check(d["flash_mha"] >= 200, f"K2 launches {d['flash_mha']} < 200")
        audio_s = wav.shape[1] / SR
        log(f"[main] request seed {seed}: {steps} AR tokens, wav {wav.shape} "
            f"({audio_s:.2f} s audio), latency {latency:.3f} s, RTF "
            f"{latency / audio_s:.4f}, AR {out['ar_seconds']:.3f} s = "
            f"{steps / out['ar_seconds']:.1f} tokens/s, render "
            f"{out['render_seconds']:.3f} s; launches K1 step "
            f"{d['fused_decode_logits']} (gemv {d['int8_gemv']}, attention "
            f"{d['decode_attention']}, layer_norm {d['layer_norm_rows']}), "
            f"K2 {d['flash_mha']} [{card}]")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[main] peak device memory {peak:.2f} GiB [{card}]")
    launches = {fn.__name__: fn.launches for fn in counted}

    # ---- 5. profile ----
    profile_request(torch, tts, text, cond_mel, settings, card)
    check("jax" not in sys.modules and "flax" not in sys.modules,
          "JAX was imported")

    # ---- 6. results ----
    sources = {"layer_norm_rows": "decode_step", "int8_gemv": "decode_step",
               "decode_attention": "decode_step", "flash_mha": "flash_attn"}
    replaces = {"decode_step": "xtts_tpu/ops/decode_step.py:68",
                "flash_attn": "xtts_tpu/nn/flash_attn.py:99"}
    kernels = []
    for fn in ds.KERNELS + (fa.flash_mha,):
        src = sources[fn.__name__]
        r = results[fn.__name__]
        kernels.append({"name": fn.__name__, "route": "cuda",
                        "source": f"xtts_tpu_torch/csrc/{src}.cu",
                        "replaces": replaces[src],
                        "launches": launches[fn.__name__],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"]})
        check(launches[fn.__name__] > 0,
              f"{fn.__name__} never launched on the path")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
