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
     (flash_mha at (2, 1280 | 1562, 8, 64), (2, 300 | 583, 8, 64) and the
     604-code cap bucket's (2, 2416 | 2698, 8, 64); the same bits and
     device us with and without the lse output, in turns; the f32
     forward (3xTF32 tiles) at the main bucket, its lse too, beside SDPA
     f32 and both bounds (f32 FMA, 3xTF32); the backward kernels
     flash_mha_bwd_dkv and flash_mha_bwd_dq against the f32 plain
     backward at the main bucket, the cap bucket and a [train] flash
     step's (8, 1200 | 1600), bf16, and at the main bucket in f32, each
     twice to the same bits, beside SDPA's backward; each kernel's
     TFLOP/s, share of its bound (f32: of both), registers and local
     memory, no spill below width 128; the head widths 32, 128 and 256
     (512 channels; 256 on the wide kernels), 384 (one head, the wide
     kernels) and 48 (zero-padded to 64, counted), bf16 and f32, forward
     and backward against the f32 twins, the same bits twice, beside SDPA
     and the bounds); K3 (vq_nearest on
     the DVAE's own 3008 x 512 logits against its 8192-code codebook, a
     ragged shape and a planted tie, also on 4 rotating copies of rows
     and codebook); K4
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
     through K1-int4 and their HiFi-GAN render within 1e-3; a speculative
     greedy request (DDIM from x_T = 0) whose greedy picks, teacher-forced
     on the card along the CPU's codes, follow P3's rule (greedy_rule: K1
     logits within K1_TOL, differing picks within 2 x the float64 floor +
     2), the CPU's codes rendered on both within 1e-3; refnet_interval 1
     and 2 (k 2 unequal to k 1 on the card), unipc and dpm++3m renders
     within 1e-3, and identical evaluate_dvae codes; one f32 optimizer
     step of each trainer: vqvae, gpt, diffusion (the draws made once on
     a CPU generator), clvp, classifier and the GAN's discriminator and
     generator updates (hold_train_step: metrics within 1e-4 relative,
     gradients within rtol 1e-4 / atol 1e-6 or, where f32 conditions
     them, by their norm, parameters within 3 lr 1e-2 plus what the
     gradient gap moves Adam's first update after the clip, every margin
     printed; frozen and trained DVAE codes by vq_agree, the EMA codebook
     within 1e-5); one f32 diffusion step through K2's backward (UNet heads
     of 64, 640 | 1040) with flash=True against flash=False on the card,
     by the same rule.
     The perceiver GPT on the small configuration (32 latents): greedy int8
     codes of one B=1 request, card (K1 over the 32-position prefix and its
     32-token tail) against CPU, held by P3's rule (greedy_rule).
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
  4a. p9: TextToSpeech(XTTSConfig()) at its defaults (f32): a request at
     code bucket 320 through K2's f32 forward (200 launches, all f32),
     its consumer attention against f32 plain attention.
  4c. perceiver: [main]'s three requests on a flagship GPT with
     use_perceiver=True (bf16, int8 decode): K1 every token over the
     116-position prefix, K2 in the render, latency beside [main]'s.
  5. vqvae (BASELINE config #1): DVAE round trip, 8 x 1504 mel frames ->
     get_codebook_indices (K3) -> decode; audio-s/s.
  6. serving (BASELINE config #5): BatchServer(max_batch=8), 8 concurrent
     submits a wave, num_candidates=2 (16 AR rows through K4 with
     XTTS_FUSED_SERVING=1), CLVP rerank, full-quality render (K2); one warm
     and two timed waves; then one synthesize_batch wave with the DVAE
     shortcut render and one with the default engine (the per-layer chain,
     cache_ladder "auto") as K4's in-program comparator. Then
     place_on_mesh([cuda:0, cuda:0]): a wave of 3 requests padded to 4,
     two rows a replica, sampled at TTSSettings' defaults: codes equal to
     the unplaced wave's over the same padded rows (the replicas draw the
     whole wave's numbers for their rows).
  6a. compact (compacting waves, infer/compact.py, on [main]'s model):
     synthesize_batch of 8 requests of distinct text x 2 CLVP candidates
     (16 AR rows through the int8 chain; K1 and K4 off) with
     compact_rows=(1, 2, 4, 8, 16) over the rungs (64, 128, 256), the
     stop logit raised so rows stop at spread steps, greedy (top_p 1e-4),
     full-quality render (K2), beside the same wave without compaction in
     turns (plain, compacting, compacting, plain): the rows at each take,
     AR and wave seconds, graph replays, K2 launches; greedy codes equal.
  6b. slots (continuous serving, infer/slots.py, on [main]'s model): a
     pool of 16 slots, segments of 32 steps, max_gen 300, 24 requests of
     distinct text (token ids) with the stop logit raised so they stop at
     spread steps and refill recycled slots mid-stream. Greedy: the pool's
     CUDA graphs against the same segments run eagerly (codes equal), and
     the B=1 int8 chain teacher-forced along each request's first 64 codes
     (differing picks <= 2 x the float64 floor + 2). Seeded sampling through
     ContinuousBatcher.submit with the diffusion render (K2): requests/s,
     audio-s/s, AR tokens/s, occupancy, latency, host reads a segment,
     capture ms, peak memory; the longest request again among two others
     in a fresh 16-slot pool, traced (flash_mha == the trace): codes
     identical, waveform within 1e-3 of its peak. The HTTP layer
     (backend="slots") on loopback: /healthz and /metrics. BatchServer
     (the chain, waves of 16) on the same requests as the comparator.
  6c. rest (the rest of the serving side, on [main]'s model): a
     speculative request (max_mel_tokens 300, seed 1) equal to the default
     one bit for bit (cap bucket 320 = length bucket); with the stop bias
     raised (SLOTS_STOP_BIAS sampled), a request under the default 600
     cap, speculative (K2 200 at the 604 bucket) and default (K2 as the
     size gate decides for its own bucket), both render times; at B=1,
     with the diffusion model's zero-initialised output projections drawn
     (t_dependent_refnet; restored after), refnet_interval 1 equal to the
     default bit for bit (the render run stage by stage), k 2 and 5
     unequal to it, timed, with their difference from k 1 over its peak;
     serving.render_rows on 16 rows at k 1 (not hoisted) and k 2
     (hoisted), timed; the ten sampler names from one x_T at 15 steps,
     model calls counted and K2 = 4 x calls; the Vocos variants
     (imdct_symexp, imdct_cos, the ResBlock and AdaLayerNorm backbones
     under the iSTFT head) at the flagship widths on the k 1 render's mel,
     card vs CPU within 1e-3 of the peak, audio-s/s; evaluate_dvae over 8
     clips of 6 s written under build/ (K3 once a clip, codes equal to
     get_codebook_indices on the same mels), the early-stop renders'
     mel_l1 and mcd; the phase's seconds.
  6d. diffusion_tts: load_model("diffusion_tts") on the card in f32 (the
     reference ctor's defaults: 512 channels, 8 layers, 16 heads), its
     zero-initialised parameters drawn; a forward at B 2, 944 mel frames
     through the latent, code and conditioning-free branches against the
     CPU port with the same weights (DTTS_TOL of the peak), ms a call.
  7. stream (the low-latency B=1 path): TextToSpeech(bf16, HiFi-GAN) with
     XTTS_DECODE_BITS=4 at requantize(); three 50-token sentences (numpy
     seeds 10, 11, 12) through stream_tokens (tts_stream's loop on token
     ids), every token through K1-int4, rendered by the HifiDecoder: time
     to first audio, per-sentence AR tokens/s, render s, RTF, peak memory.
     Then one preset("ultra_fast") request (dpm++2m, 15 steps, K2) and the
     first sentence again on the int8 stack (AR tokens/s comparator).
  7b. train (the training path, xtts_tpu_torch.train.cli at the flagship
     widths, bf16 compute, f32 parameters, batch 8): a corpus of 16 seeded
     wavs of 2-12 s with a 6-field filelist under build/train_corpus/
     (mels cached by prepare.cache_mels), 30 vqvae steps, then 30 gpt
     steps on the vqvae export with a stand-in tokenizer (characters ->
     ids 3-250), each evaluating every 10 steps on 8 held-out wavs: K3 once
     a step plus the eval passes; finite losses; step ms (median), samples
     /s, mel tokens/s, peak memory and the model FLOPs share of 989
     TFLOP/s bf16 (gpt_step_flops, dvae_step_flops). The gpt checkpoint
     restored on the card equal to the saved one bit for bit, 40 gpt steps
     on one repeated batch (the loss falls below OVERFIT_RATIO of its
     start), a --resume run from step 30 to 32, cache_vq_codes over the
     corpus (K3 a file), the exports through TextToSpeech.from_pretrained,
     and K3 at the trainers' row counts (N 400 and 2400) against its twin.
     Then 10 steps each of diffusion (loss_second_moment, one eval with a
     DDIM render through a random Vocos export), clvp, classifier (noisy
     copies of the corpus as the noise list) and hifigan (one eval wav):
     K3 counted against the expected count, step ms, samples/s, model
     FLOPs (FlopCounterMode; diffusion and hifigan) and MFU, peak memory;
     the diffusion checkpoint restored bit for bit with the sampler's
     state, a --resume run, 30 steps on one repeated batch (its loss at
     fixed draws falls below DIFF_OVERFIT_RATIO of its start), and K3 at
     the diffusion and hifigan trainers' rows. Then FLASH_STEPS diffusion
     steps with flash=True at render lengths (DiffusionDataset(max_mel=
     1280, max_refer=300) over the 8-12 s wavs, batch 8): K2's forward
     and both backward kernels once a gated attention every step, beside
     the same steps with flash=False: step ms, samples/s, MFU (K2's
     FLOPs added: FlopCounterMode cannot see them), peak memory; then
     FLASH_WARM + 2 such steps at 2 heads of 256, the same way: in bf16
     (K2's wgmma wide backward pair) and in f32 (its f32 wide pair).
  7c. parallel (parallel/mesh.py, the flagship GPT and DVAE whole, f32, global batch 8 with lengths falling
     across the rows): two gloo ranks spawned on the one card, dp 2 (one
     gpt and one vqvae step) and tp 2 (one gpt step, GPT_PARAM_RULES),
     each held against the one-rank step on the same card by
     hold_train_step (the EMA codebook within TRAIN_CB_TOL), K3 once a
     step on every rank, step ms a rank beside the one-rank step; then one
     NCCL rank: its group, an all_reduce on the card, one dp step at world
     size 1. A rank that fails or outlasts PAR_TIMEOUT fails the run.
  8. profile: one more warm B=1 request (seed 4), bare and then under
     torch.profiler: the device's busy share over the request and over its
     AR and render stages, every counted kernel in the trace against the
     launches counted (graph replays included), the host time of one
     sample_token call and its device time a token (50 calls in one CUDA
     graph), the kernels with the most device time, the flash kernel's
     device time a call (trace in build/xtts_tpu_torch/request_trace.json).
  9. a JSON line of the kernels, the total wall time, then the result line.

Before each path of phases 4-7 (each item of 6c) every launch count is
set to 0, and read after it; a path that did not launch each of its
kernels fails, and so
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

import contextlib
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
# K2's f32 forward against f32 attention: exp2's argument rounding (~1e-6
# relative) and sums over up to 2698 terms in another order (sqrt(Tk)
# 2^-24), on outputs up to max |v| ~ 4.5
K2_F32_TOL = 5e-5
# K2's backward against the f32 plain backward on the same inputs, relative
# to each gradient's largest element: bf16 rounds P, dS and the result
# (three roundings of 2^-9); f32 sums in another order
K2_BWD_TOL = {"bf16": 1e-2, "f32": 1e-5}
# K2's lse against the plain twin's (the card tests' bound)
K2_LSE_TOL = 1e-5
# [k2]'s other head widths (B, Tq, Tk, heads, width) at the main bucket:
# 512 channels in 16 heads of 32, 4 of 128 and 2 of 256 (the wide
# kernels); 48 (8 heads) runs zero-padded to 64; 384 (the wide kernels at
# three chunks) in one head, 384 channels, as 512 does not divide by it
K2_WIDTHS = ((2, 1280, 1562, 16, 32), (2, 1280, 1562, 8, 48),
             (2, 1280, 1562, 4, 128), (2, 1280, 1562, 2, 256),
             (2, 1280, 1562, 1, 384))
# a [train] flash=True step's consumer attention (B, Tq, Tk): 8-12 s wavs
# cropped to 1280 frames, the mel bucket 1200 and the refer bucket 400
K2_TRAIN_SHAPE = (8, 1200, 1600)
# rounds of (none, lse, lse, none) in the bf16 forward's lse A/B
K2_LSE_ROUNDS = 4
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
# [slots]: a seeded request's waveform in two pool compositions, whose
# render batches (and so the GEMMs' row counts) may differ, relative to its
# peak (another request's waveform differs by more than its peak)
WAV_SLOTS_TOL = 1e-3
# [slots]: the stop logit's head bias, raised so that rows stop at spread
# steps and slots refill mid-stream. At the flagship random weights greedy
# rows fall into loops, so each stops early or never. The phase checks the
# spread these give and prints it: the greedy lengths and installs into
# recycled slots, the sampled lengths.
SLOTS_STOP_BIAS = {"greedy": 1.0, "sampled": 2.0}
CHAIN_PICKS = 64      # teacher-forced picks a request held against B=1
# [ref] training, card against CPU after one f32 step: relative loss error
# (the CPU parity tests' bound against JAX) and the EMA codebook buffers
TRAIN_LOSS_TOL = 1e-4
TRAIN_CB_TOL = 1e-5
TRAIN_GRAD_RTOL, TRAIN_GRAD_ATOL = 1e-4, 1e-6
# gradients held by each tensor's norm where f32 conditions them: the
# generator's through the log-magnitude STFT loss (it divides by each bin's
# magnitude: in f32 both implementations lie ~9e-4 of the norm from its
# float64 value), the diffusion output conv's variance rows at a t = 0
# draw (the decoder NLL's bin masses, decided by one ulp of tanh); the
# CPU parity tests against JAX hold these tensors the same way
TRAIN_GRAD_NORM_TOL = 1e-3
# the HiFi-GAN step's gradients (the discriminator's, and the generator's,
# which run back through it): LeakyReLU makes them piecewise in every
# activation, and f32 rounding flips kinks. Against a float64 CPU
# reference, the CPU's own f32 discriminator gradients lie up to 1.02e-3
# of their norm away and the card's up to 7.9e-4, ~5e-7 where nothing
# flips (a diagnostic chip run, NVIDIA H100 80GB HBM3, 700 W); card
# against CPU read 3.6e-3 at the first scale discriminator's first conv
TRAIN_GRAD_KINK_TOL = 1e-2
# the least scale a norm-held gradient is measured against, as a share of
# the whole step's gradient norm (a gradient zero in exact arithmetic is
# rounding noise on both devices)
TRAIN_GRAD_FLOOR = 1e-5
# [train]: the corpus, the steps of each trainer, the eval cadence, the
# steps left out of the step-time statistics (warm-up: the allocator and
# cuDNN's plans), and the repeated-batch overfitting check
TRAIN_WAVS = 16
TRAIN_STEPS = 30
TRAIN_VAL_FREQ = 10
TRAIN_WARM = 5
OVERFIT_STEPS = 40
# the loss ratio (last / first) the 40 steps must reach: the first
# measurement read 0.143 (NVIDIA H100 80GB HBM3, 700 W); the bound leaves
# a 3.5x margin
OVERFIT_RATIO = 0.5
# [train], the later families (diffusion, clvp, classifier, hifigan): the
# steps of each, the steps left out of the step-time median, and the
# diffusion model's repeated-batch check (its loss at fixed draws after
# DIFF_OVERFIT_STEPS steps against before; a provisional bound until the
# first measurement)
NEW_STEPS = 10
NEW_WARM = 3
DIFF_OVERFIT_STEPS = 30
DIFF_OVERFIT_RATIO = 0.9
# [train], K2's backward: the flash=True diffusion steps at render lengths
# (and as many flash=False steps on the same batches), the steps left out
# of the step-time median
FLASH_STEPS = 8
FLASH_WARM = 2
# the f32 flash run's losses against flash=False's, relative: the
# gradients agree within K2_BWD_TOL, and Adam moves each parameter by at
# most lr a step whatever its gradient's size, so four steps' losses agree
# far within this
FLASH_F32_LOSS_TOL = 1e-3
SLOTS_EAGER_SEGMENTS = 3   # greedy segments run eagerly against the graphs


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
    # the main path's bucket 320, a small bucket, and the 604-code cap
    # bucket (the speculative render at TTSSettings' default cap)
    for b, tq, tk in ((2, 1280, 1562), (2, 300, 583), (2, 2416, 2698)):
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
            lse_ab = k2_lse_ab(torch, fa, q, k, v)
    record(results, "flash_mha", e_max, *main_times, lse_ab=lse_ab)


def k2_lse_ab(torch, fa, q, k, v):
    """The bf16 forward without and with the lse output on the same inputs:
    the same bits, and device us a call in turns (none, lse, lse, none)."""
    o, lse = fa._flash_fwd_cuda(q, k, v, 0.125, True)
    o2, _ = fa._flash_fwd_cuda(q, k, v, 0.125, False)
    check(torch.equal(o, o2), "flash_mha output differs with lse")
    turns = [("none", False), ("lse", True), ("lse", True), ("none", False)]
    got = {"none": [], "lse": []}
    for tag, with_lse in turns * K2_LSE_ROUNDS:
        got[tag].append(device_us(torch, lambda w=with_lse: fa._flash_fwd_cuda(
            q, k, v, 0.125, w)))
    log(f"[k2] flash_mha bf16 (2, 1280 | 1562, 8, 64) with and without lse: "
        f"output equal bit for bit; device us in turns (none, lse, lse, "
        f"none) x {K2_LSE_ROUNDS}: without lse "
        f"{', '.join(f'{x:.2f}' for x in got['none'])} (median "
        f"{statistics.median(got['none']):.2f}), with lse "
        f"{', '.join(f'{x:.2f}' for x in got['lse'])} (median "
        f"{statistics.median(got['lse']):.2f})")
    return got


def f32_bounds(nbytes, ops):
    """The f32 kernels' two bounds (ms, what binds): the f32 operations at
    the FMA peak, and the 3xTF32 route's three tf32 operations each at the
    tf32 tensor-core peak (what the kernels run: the bound_ms of their
    JSON entries)."""
    return bound(nbytes, ops, "fp32"), bound(nbytes, 3 * ops, "tf32")


def fmt_bounds(us, fma, tc) -> str:
    return (f"bounds: f32 FMA {fma[0]:.5f} ms ({fma[1]}; "
            f"{fma[0] * 1e3 / us:.3f} of it), 3xTF32 {tc[0]:.5f} ms "
            f"({tc[1]}; {tc[0] * 1e3 / us:.3f} of it)")


def k2_f32_checks(torch, fa, results, card):
    """K2's f32 forward (the default TextToSpeech's dtype; 3xTF32 tiles)
    at the main bucket against f32 plain attention: error (K2_F32_TOL),
    lse (K2_LSE_TOL), card ms, device us and TFLOP/s, plain ms, SDPA in
    f32, and the share of both bounds (f32 FMA; 3xTF32)."""
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(98)
    b, tq, tk = 2, 1280, 1562
    q, k, v = (torch.randn(b, t, 8, 64, generator=g, device="cuda")
               for t in (tq, tk, tk))
    fa.flash_mha.f32_launches = 0
    out = fa.flash_mha(q, k, v, 0.125)
    check(fa.flash_mha.f32_launches == 1, "the f32 forward did not launch")
    want, lse_want = fa.flash_mha_plain_lse(q, k, v, 0.125)
    err = max_err(out, want)
    check(err <= K2_F32_TOL, f"flash_mha f32 err {err}")
    lse_err = max_err(fa._flash_fwd_cuda(q, k, v, 0.125, True)[1], lse_want)
    check(lse_err <= K2_LSE_TOL, f"flash_mha f32 lse err {lse_err}")
    tkn = time_ms(torch, lambda: fa.flash_mha(q, k, v, 0.125))
    tpl = time_ms(torch, lambda: fa.flash_mha_plain(q, k, v, 0.125))
    qs, ks, vs = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    tlib = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qs, ks, vs, scale=0.125))
    flops = 4 * b * 8 * tq * tk * 64
    fma, tc = f32_bounds(4 * b * 8 * 64 * (2 * tq + 2 * tk), flops)
    dk = device_us(torch, lambda: fa.flash_mha(q, k, v, 0.125))
    dl = device_us(torch, lambda: F.scaled_dot_product_attention(
        qs, ks, vs, scale=0.125))
    regs, local = fa.kernel_attrs()[("flash_mha", "f32", 64)]
    log(f"[k2] flash_mha f32 (B {b}, Tq {tq}, Tk {tk}, 8 x 64) max_abs_err "
        f"vs f32 plain {err:.3e} (bound {K2_F32_TOL}), lse {lse_err:.3e} "
        f"(bound {K2_LSE_TOL})  kernel {tkn:.4f} ms, device {fmt_us(dk)} "
        f"({flops / (dk * 1e-6) / 1e12:.1f} TFLOP/s)  plain f32 "
        f"{tpl:.4f} ms  sdpa f32 {tlib:.4f} ms, device {fmt_us(dl)} "
        f"(kernel / sdpa {dk / dl:.3f}); {fmt_bounds(dk, fma, tc)}; "
        f"{regs} registers, {local} bytes of local memory a thread  "
        f"[{card}]")
    record(results, "flash_mha+f32", err, tkn, tpl, tlib, tc, dk, dl,
           bound_fma_ms=fma[0], lse_err=lse_err)


def k2_backward_checks(torch, fa, results, card):
    """K2's backward kernels against the f32 plain backward on the same
    inputs at the main bucket, the 604 cap bucket and a [train] flash step's
    shape, bf16 (and f32 at the main bucket): each gradient within
    K2_BWD_TOL of its largest element; card ms and device us of
    flash_mha_bwd_dkv and flash_mha_bwd_dq, of the whole backward (D =
    rowsum(dO * O) included), of the plain backward; SDPA's backward
    (forward + backward with grad, less the forward); the bounds (dkv: 4
    products, dq: 3, the backward: 5, 2 B H Tq Tk 64 operations each), and
    for each kernel its TFLOP/s and share of its bound by device time and
    its registers and local-memory bytes a thread (local memory: spills).
    Two backward passes give the same bits."""
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(97)
    kinds = {torch.bfloat16: "bf16", torch.float32: "f32"}
    attrs = fa.bwd_kernel_attrs()
    shapes = [(2, 1280, 1562, torch.bfloat16),
              (2, 2416, 2698, torch.bfloat16),
              (*K2_TRAIN_SHAPE, torch.bfloat16),
              (2, 1280, 1562, torch.float32)]
    for b, tq, tk, dt in shapes:
        kind, esz = kinds[dt], (2 if dt == torch.bfloat16 else 4)
        q, k, v, do = (torch.randn(b, t, 8, 64, generator=g,
                                   device="cuda").to(dt)
                       for t in (tq, tk, tk, tq))
        o, lse = fa._flash_fwd_cuda(q, k, v, 0.125, True)
        delta = fa._delta(o, do)
        fa.flash_mha_bwd_dkv.launches = fa.flash_mha_bwd_dq.launches = 0
        got = fa.flash_mha_bwd(q, k, v, o, lse, do, 0.125)
        check(fa.flash_mha_bwd_dkv.launches == 1
              and fa.flash_mha_bwd_dq.launches == 1, "K2 backward launches")
        again = fa.flash_mha_bwd(q, k, v, o, lse, do, 0.125)
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              "K2 backward differs between two runs")
        o32, lse32 = fa.flash_mha_plain_lse(q.float(), k.float(), v.float(),
                                            0.125)
        want = fa.flash_mha_bwd_plain(q.float(), k.float(), v.float(), o32,
                                      lse32, do.float(), 0.125)
        errs = {}
        for name, x, w in zip(("dq", "dk", "dv"), got, want):
            errs[name] = max_err(x, w) / w.abs().max().item()
            check(errs[name] <= K2_BWD_TOL[kind], f"K2 backward {kind} "
                  f"{(b, tq, tk)} {name} {errs[name]:.3e}")
        del want, o32, lse32, again
        t_dkv = time_ms(torch, lambda: fa.flash_mha_bwd_dkv(
            q, k, v, do, lse, delta, 0.125))
        t_dq = time_ms(torch, lambda: fa.flash_mha_bwd_dq(
            q, k, v, do, lse, delta, 0.125))
        t_all = time_ms(torch, lambda: fa.flash_mha_bwd(
            q, k, v, o, lse, do, 0.125))
        t_pl = time_ms(torch, lambda: fa.flash_mha_bwd_plain(
            q, k, v, o, lse, do, 0.125), reps=5)
        d_dkv = device_us(torch, lambda: fa.flash_mha_bwd_dkv(
            q, k, v, do, lse, delta, 0.125))
        d_dq = device_us(torch, lambda: fa.flash_mha_bwd_dq(
            q, k, v, do, lse, delta, 0.125))
        qs, ks, vs = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        dos = do.transpose(1, 2).contiguous()
        with torch.enable_grad():
            def sdpa():
                return F.scaled_dot_product_attention(qs, ks, vs, scale=0.125)

            def sdpa_grad():
                return torch.autograd.grad(sdpa(), (qs, ks, vs), dos)
            t_sf, t_sfb = time_ms(torch, sdpa), time_ms(torch, sdpa_grad)
            d_sf, d_sfb = device_us(torch, sdpa), device_us(torch, sdpa_grad)
        t_sb, d_sb = t_sfb - t_sf, d_sfb - d_sf
        unit = 2 * b * 8 * tq * tk * 64          # one product's operations
        qb, kb = b * 8 * 64 * tq * esz, b * 8 * 64 * tk * esz
        stats = 2 * b * 8 * tq * 4               # lse and D
        fma = {}             # f32: the FMA bounds beside the 3xTF32 ones
        if kind == "bf16":
            b_dkv = bound(2 * qb + 4 * kb + stats, 4 * unit, "bf16")
            b_dq = bound(3 * qb + 2 * kb + stats, 3 * unit, "bf16")
            b_all = bound(4 * qb + 4 * kb + stats, 5 * unit, "bf16")
        else:
            fma["dkv"], b_dkv = f32_bounds(2 * qb + 4 * kb + stats, 4 * unit)
            fma["dq"], b_dq = f32_bounds(3 * qb + 2 * kb + stats, 3 * unit)
            fma["all"], b_all = f32_bounds(4 * qb + 4 * kb + stats, 5 * unit)
        log(f"[k2] backward {kind} (B {b}, Tq {tq}, Tk {tk}, 8 x 64): rel "
            f"err vs f32 plain dq {errs['dq']:.2e} dk {errs['dk']:.2e} dv "
            f"{errs['dv']:.2e} (bound {K2_BWD_TOL[kind]}), same bits twice; "
            f"dkv {t_dkv:.4f} ms, device {fmt_us(d_dkv)} (bound "
            f"{b_dkv[0]:.5f} ms, {b_dkv[1]}); dq {t_dq:.4f} ms, device "
            f"{fmt_us(d_dq)} (bound {b_dq[0]:.5f} ms); whole backward "
            f"{t_all:.4f} ms ({5 * unit / (t_all * 1e-3) / 1e12:.1f} "
            f"TFLOP/s of the 5 products; bound {b_all[0]:.5f} ms, "
            f"{b_all[1]}); plain backward {t_pl:.4f} ms; sdpa backward "
            f"{t_sb:.4f} ms (fwd + bwd {t_sfb:.4f} less fwd {t_sf:.4f}), "
            f"device {fmt_us(d_sb)} ({fmt_us(d_sfb)} less {fmt_us(d_sf)}); "
            f"kernels' device {fmt_us(d_dkv + d_dq)} against sdpa's "
            f"{fmt_us(d_sb)}  [{card}]")
        for name, d, n, bn in (("flash_mha_bwd_dkv", d_dkv, 4, b_dkv),
                               ("flash_mha_bwd_dq", d_dq, 3, b_dq)):
            regs, local = attrs[(name, kind, 64)]
            share = (f"{bn[0] * 1e3 / d:.3f} of its bound ({bn[1]})"
                     if kind == "bf16" else
                     fmt_bounds(d, fma[name.split("_")[-1]], bn))
            log(f"[k2] {name} {kind} (B {b}, Tq {tq}, Tk {tk}): "
                f"{n * unit / (d * 1e-6) / 1e12:.1f} TFLOP/s of its {n} "
                f"products by device time, {share}; {regs} registers and "
                f"{local} bytes of local memory a thread  [{card}]")
            check(local == 0, f"{name} {kind} spills: {local} bytes of "
                  f"local memory a thread")
        if (tq, dt) == (1280, torch.bfloat16):
            for name, t, d, bn in (("flash_mha_bwd_dkv", t_dkv, d_dkv, b_dkv),
                                   ("flash_mha_bwd_dq", t_dq, d_dq, b_dq)):
                record(results, name, max(errs.values()), t, t_pl, t_sb, bn,
                       d, d_sb, library_covers="dq, dk and dv (sdpa's "
                       "backward: forward + backward less forward)",
                       whole_backward_ms=t_all)
        if (tq, dt) == (1280, torch.float32):
            # the f32 kernels at the main bucket, beside the bf16 entry
            for name, t, d, bn in (("flash_mha_bwd_dkv", t_dkv, d_dkv, b_dkv),
                                   ("flash_mha_bwd_dq", t_dq, d_dq, b_dq)):
                results[name]["f32"] = dict(
                    max_abs_err=max(errs.values()), ms=t, device_us=d,
                    library_device_us=d_sb, bound_ms=bn[0],
                    bound_fma_ms=fma[name.split("_")[-1]][0])
        del q, k, v, do, o, lse, delta, got, qs, ks, vs, dos
        torch.cuda.empty_cache()


def k2_width_checks(torch, fa, results, launches, card):
    """K2 at the other head widths (K2_WIDTHS: 32 and 128 run as they are,
    48 zero-padded to 64 and counted in flash_mha.pads, 256 and 384 on the
    wide kernels; bf16 from 128 the wgmma wide forward, whose split R of
    the keys over a cluster, resident clusters of R, TFLOP/s and share of
    the forward bound are printed, and one of whose width-256 forwards is
    held to its launch count in a torch.profiler trace), bf16 and f32:
    the forward and its lse against the f32 plain forward (K2_TOL /
    K2_F32_TOL, K2_LSE_TOL), the backward against
    the f32 plain backward (K2_BWD_TOL of each gradient's largest), the
    same bits twice; device us of the forward, dkv and dq beside SDPA's
    forward and backward on the same inputs and the bounds (tensor-core
    operations: 4 B H Tq Tk D a forward, 10 a backward, bf16 at 989
    TFLOP/s, f32's 3xTF32 three times as many at 495); each kernel's
    registers and local memory (a spill is printed, and refused in every
    kernel but the f32 forwards from width 128: the tile family's at 128,
    the wide forward above); at the wide pairs' widths (128 and above) the
    backward's TFLOP/s and share of its bound by device time and the
    clusters of each kernel that can be resident at once."""
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(96)
    attrs = fa.kernel_attrs()
    rows = {}
    for dt, kind in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        for b, tq, tk, h, w in K2_WIDTHS:
            sc = w ** -0.5
            q, k, v, do = (torch.randn(b, t, h, w, generator=g,
                                       device="cuda").to(dt)
                           for t in (tq, tk, tk, tq))
            for fn in fa.KERNELS:
                fn.launches = 0
            fa.flash_mha.pads = 0
            o, lse = fa._flash_fwd_cuda(q, k, v, sc, True)
            got = fa.flash_mha_bwd(q, k, v, o, lse, do, sc)
            again = fa.flash_mha_bwd(q, k, v, o, lse, do, sc)
            native = fa.native_width(w)
            check([fn.launches for fn in fa.KERNELS] == [1, 2, 2]
                  and fa.flash_mha.pads == (0 if native == w else 5),
                  f"[k2] width {w}: launches "
                  f"{[fn.launches for fn in fa.KERNELS]}, pads "
                  f"{fa.flash_mha.pads}")
            check(all(torch.equal(x, y) for x, y in zip(got, again)),
                  f"[k2] {kind} width {w}: backward differs between runs")
            qf, kf, vf = (t.float() for t in (q, k, v))
            o32, lse32 = fa.flash_mha_plain_lse(qf, kf, vf, sc)
            e_o, e_l = max_err(o, o32), max_err(lse, lse32)
            tol = K2_TOL if kind == "bf16" else K2_F32_TOL
            check(e_o <= tol and e_l <= K2_LSE_TOL, f"[k2] {kind} width "
                  f"{w}: forward err {e_o}, lse {e_l}")
            want = fa.flash_mha_bwd_plain(qf, kf, vf, o32, lse32,
                                          do.float(), sc)
            errs = [max_err(x, y) / y.abs().max().item()
                    for x, y in zip(got, want)]
            check(max(errs) <= K2_BWD_TOL[kind], f"[k2] {kind} width {w}: "
                  f"backward errs {errs}")
            del want, o32, lse32, again
            delta = fa._delta(o, do)
            d_f = device_us(torch, lambda: fa.flash_mha(q, k, v, sc))
            d_kv = device_us(torch, lambda: fa.flash_mha_bwd_dkv(
                q, k, v, do, lse, delta, sc))
            d_q = device_us(torch, lambda: fa.flash_mha_bwd_dq(
                q, k, v, do, lse, delta, sc))
            d_b = device_us(torch, lambda: fa.flash_mha_bwd_pair(
                q, k, v, do, lse, delta, sc))
            qs, ks, vs = (t.transpose(1, 2).contiguous().requires_grad_()
                          for t in (q, k, v))
            dos = do.transpose(1, 2).contiguous()
            with torch.enable_grad():
                def sdpa():
                    return F.scaled_dot_product_attention(qs, ks, vs,
                                                          scale=sc)
                s_f = device_us(torch, sdpa)
                s_b = device_us(torch, lambda: torch.autograd.grad(
                    sdpa(), (qs, ks, vs), dos)) - s_f
            unit = 2 * b * h * tq * tk * w
            nbytes = (4 if kind == "f32" else 2) * b * h * w * (2 * tq
                                                                 + 2 * tk)
            if kind == "f32":
                b_f = bound(nbytes, 3 * 2 * unit, "tf32")[0]
                b_b = bound(2 * nbytes, 3 * 5 * unit, "tf32")[0]
            else:
                b_f = bound(nbytes, 2 * unit, "bf16")[0]
                b_b = bound(2 * nbytes, 5 * unit, "bf16")[0]
            spills = []
            key = native if native <= 128 else fa.WIDE
            for name in ("flash_mha", "flash_mha_bwd_dkv",
                         "flash_mha_bwd_dq"):
                regs, local = attrs[(name, kind, fa.fwd_block_width(native)
                                     if name == "flash_mha" and kind == "bf16"
                                     and native % 128 == 0 else key)]
                spills.append(f"{name} {regs} registers, {local} local "
                              f"bytes")
                # left alone: the f32 forwards at 128 (the tile family's)
                # and above (the wide forward)
                check(local == 0 or (kind == "f32" and native >= 128
                                     and name == "flash_mha"),
                      f"[k2] {name} {kind} width {native} spills {local} "
                      f"bytes")
            pair, resident, plan, fwd = "", None, None, ""
            if kind == "bf16" and native % 128 == 0:
                plan = fa.fwd_plan(b, tq, tk, h, native)
                fwd = (f"; the wgmma wide forward: R {plan['split']} ranks "
                       f"a cluster over the keys, at most "
                       f"{plan['resident']} clusters of R resident, "
                       f"{plan['slices']} slice(s), {plan['rows']} query "
                       f"rows a block, {b_f * 1e3 / d_f:.3f} of the "
                       f"forward bound, {d_f / s_f:.2f}x SDPA's forward")
                if w == 256:
                    hold_counts_to_trace(
                        torch, lambda: fa._flash_fwd_cuda(q, k, v, sc, True),
                        launches, f"[k2] bf16 width {w} forward", card)
            if native % 128 == 0:
                nc = native // 128
                cs = -(-nc // -(-nc // 8))       # csrc wgw_cs
                resident = fa.bwd_clusters(dt, native)
                ops = 5 * unit * (3 if kind == "f32" else 1)
                pair = (f"; the wide pair as flash_mha_bwd_pair runs it "
                        f"{fmt_us(d_b)}: {ops / (d_b * 1e-6) / 1e12:.1f} "
                        f"TFLOP/s of its {'3xTF32 ' * (kind == 'f32')}"
                        f"operations by device time, {b_b * 1e3 / d_b:.3f} "
                        f"of the backward bound, {d_b / s_b:.2f}x SDPA's "
                        f"backward; clusters of {cs}, at most {resident[0]} "
                        f"(dkv) / {resident[1]} (dq) resident")
            log(f"[k2] width {w} ({kind}, B {b}, Tq {tq}, Tk {tk}, {h} x {w}"
                f"{'' if native == w else f', zero-padded to {native}'}): "
                f"forward err {e_o:.2e} (bound {tol}), lse {e_l:.2e}; "
                f"backward rel errs dq {errs[0]:.2e} dk {errs[1]:.2e} dv "
                f"{errs[2]:.2e} (bound {K2_BWD_TOL[kind]}), same bits twice; "
                f"device: forward {fmt_us(d_f)} "
                f"({2 * unit / (d_f * 1e-6) / 1e12:.1f} TFLOP/s), dkv "
                f"{fmt_us(d_kv)}, dq {fmt_us(d_q)} (sum "
                f"{fmt_us(d_kv + d_q)}, the pair {fmt_us(d_b)}); bounds "
                f"forward {b_f:.5f} ms, "
                f"backward {b_b:.5f} ms ({'3xTF32' if kind == 'f32' else 'bf16'}"
                f" tensor-core operations); sdpa forward {fmt_us(s_f)}, "
                f"backward {fmt_us(s_b)}{fwd}{pair}; {'; '.join(spills)}  "
                f"[{card}]")
            rows[f"{kind} {w}"] = dict(
                forward_err=e_o, lse_err=e_l, backward_rel_errs=errs,
                forward_device_us=d_f, dkv_device_us=d_kv, dq_device_us=d_q,
                pair_device_us=d_b,
                sdpa_forward_device_us=s_f, sdpa_backward_device_us=s_b,
                bound_forward_ms=b_f, bound_backward_ms=b_b,
                resident_clusters=resident, forward_plan=plan)
            del q, k, v, do, o, lse, delta, got, qs, ks, vs, dos
            torch.cuda.empty_cache()
    results["flash_mha"]["widths"] = rows


def qdot64(torch):
    """The int8 chain's product (infer/qdecode.qdot) with its sums in
    float64: the noise floor's arm (P3: the plain step against itself on
    float64 sums)."""
    def qdot(x, q, bias=None):
        y = (x.to(torch.bfloat16).double() @ q["w"].double()) \
            * q["scale"].double()
        if bias is not None:
            y = y + bias.double()
        return y.float()
    return qdot


def forced_picks(torch, tts, cond_mel, text, codes, engine: str = "k1",
                 cap: int = 100):
    """Greedy picks teacher-forced along `codes` (1, n) of a B=1 request
    made with max_mel_tokens `cap`: pick 0 is the prefill's argmax, pick
    t + 1 the argmax after code t is fed, eagerly, on a cache of the
    request's rung length. engine: "k1" (the fused step: K1 on the card,
    its plain twin on the CPU), "chain" (the per-layer int8 chain) or
    "chain64" (the chain on float64 sums). Returns {"picks": (n,) numpy,
    "logits": (n, V) f32 on the host}."""
    from xtts_tpu_torch.infer import device_loop as dl
    from xtts_tpu_torch.infer import qdecode as qd
    from xtts_tpu_torch.models.gpt_infer import mel_pos_offset
    from xtts_tpu_torch.nn.transformer import KVCache
    from xtts_tpu_torch.ops import decode_step as ds
    g = tts.cfg.gpt
    L, H, D, V = g.layers, g.heads, g.model_dim, g.number_mel_codes
    qt = tts._qtree
    if engine == "k1" and "fused" not in qt:
        qd.attach_fused_stack(qt, g)
    orig = qd.qdot
    with torch.no_grad():
        prefix, n_cond = tts.gpt.encode_prefix(cond_mel, text)
        p_len, n = prefix.shape[1], codes.shape[1]
        cache = KVCache.zeros(L, 1, dl.cache_rows(p_len, cap), H, D // H,
                              dtype=torch.bfloat16, device=prefix.device)
        logits, cache = tts.gpt.prefill(prefix, cache)
        off = mel_pos_offset(g, n_cond)
        out = [logits[0].float()]
        if engine == "chain64":
            qd.qdot = qdot64(torch)        # instrumentation: the floor arm
        try:
            for t in range(n - 1):
                tok = codes[:, t]
                if engine == "k1":
                    lg = ds.fused_decode_logits(
                        qt["fused"], qd._embed(qt, tok, t + off),
                        cache.k.view(L, -1, D), cache.v.view(L, -1, D),
                        p_len + t, L, H)[0][:, :V]
                else:
                    lg, _ = qd._decode_logits(qt, H, tok, t + off, cache,
                                              p_len + t)
                out.append(lg[0].float())
        finally:
            qd.qdot = orig
    logits = torch.stack(out).cpu()
    return {"picks": logits.argmax(-1).numpy(), "logits": logits}


def greedy_rule(torch, codes, cpu, card, tag: str) -> str:
    """P3's rule for a greedy request, card against CPU: along the CPU's
    codes, the card's teacher-forced K1 logits within K1_TOL x max(1,
    |logits|) of the CPU's, and its picks differing from the codes in at
    most 2 x floor + 2 places, the floor being the picks that float64 sums
    alone turn in the CPU's int8 chain along the same codes. A change of
    weights or length then cannot make the check flaky by a near tie."""
    n = len(codes)
    diff = int((card["picks"] != codes).sum())
    own = int((cpu["k1"]["picks"] != codes).sum())
    floor = int((cpu["chain"]["picks"] != cpu["chain64"]["picks"]).sum())
    bound = 2 * floor + 2
    err = max_err(card["logits"], cpu["k1"]["logits"])
    lmax = cpu["k1"]["logits"].abs().max().item()
    check(err <= K1_TOL * max(1.0, lmax),
          f"{tag}: K1 logits err {err} along the CPU's codes")
    check(diff <= bound, f"{tag}: {diff} of {n} teacher-forced greedy picks "
          f"differ from the CPU's codes, bound {bound}")
    return (f"the card's K1 picks teacher-forced along the CPU's {n} codes: "
            f"{diff} differ (bound 2 x floor + 2 = {bound}; floor {floor}, "
            f"the CPU chain against itself on float64 sums; the CPU's own "
            f"K1 picks differ in {own}), logits max_abs_err {err:.3e} "
            f"(bound {K1_TOL} x max(1, {lmax:.2f}))")


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

    # the rest of the serving side: a speculative request (greedy codes,
    # DDIM from x_T = 0, i.e. diffusion_temperature 0, so both devices
    # render the same thing; the stop logit's bias raised by 1, so the
    # request stops early, in the 64-code bucket, under a cap of 100 whose
    # bucket is 128), its greedy picks held by P3's rule (greedy_rule);
    # refnet_interval 1 and 2 (k 2 must differ from k 1: the perturbed
    # weights make the ReferenceNet features depend on t), unipc and
    # dpm++3m renders of the shared codes from the shared x_T, and
    # evaluate_dvae over clips whose cached mels (.mel.npy, made on the
    # CPU) both devices read
    from xtts_tpu_torch.data.audio import save_wav
    from xtts_tpu_torch.infer.api import bucket_len
    from xtts_tpu_torch.infer.eval_tools import dvae_roundtrip, evaluate_dvae
    clip_dir = ROOT / "build" / "ref_clips"
    clip_dir.mkdir(parents=True, exist_ok=True)
    for old in clip_dir.iterdir():
        old.unlink()
    clips = []
    for i in range(3):
        c = (0.3 * np.sin(2 * np.pi * (180 + 50 * i) * t)
             + 0.05 * rng.standard_normal(t.shape[0])).astype(np.float32)
        clips.append(str(clip_dir / f"clip{i}.wav"))
        save_wav(clips[-1], c)
        np.save(clips[-1] + ".mel.npy", cpu.mel(c)[0].numpy())
    greedy = dict(top_p=1e-4, repetition_penalty=1.0, sampler="ddim",
                  diffusion_steps=4, diffusion_temperature=0.0)
    spec_settings = TTSSettings(max_mel_tokens=100, speculative_render=True,
                                **greedy)
    variants = (dict(sampler="ddim", diffusion_steps=4, refnet_interval=1),
                dict(sampler="ddim", diffusion_steps=4, refnet_interval=2),
                dict(sampler="unipc", diffusion_steps=4),
                dict(sampler="dpm++3m", diffusion_steps=4))
    stop = small.gpt.stop_mel_token
    rest = {}
    for name, tts in (("cpu", cpu), ("card", card)):
        dev = tts.device
        cond = tts.cond_mel_from_wav(wav)
        bias = float(tts.gpt.mel_head.bias[stop])
        with torch.no_grad():
            tts.gpt.mel_head.bias[stop] = bias + 1.0
        tts.requantize()
        sp = tts.tts_tokens(text[0].numpy(), cond, tts._generator(0),
                            spec_settings)
        if name == "card":
            # the card's picks teacher-forced along the CPU's codes, and
            # the CPU's codes rendered on the card as the speculative
            # request renders them (the cap's bucket)
            c_codes = torch.as_tensor(rest["cpu"][0]["codes"])
            c_len = int(rest["cpu"][0]["lengths"][0])
            forced = {"card": forced_picks(torch, tts, cond, text.to(dev),
                                           c_codes[:, :c_len].to(dev))}
            n_b = bucket_len(98, tts._code_buckets())
            lens = torch.clamp(torch.tensor([c_len - 2], device=dev), 1, n_b)
            w = tts._render(cond, text.to(dev), tts._pad_codes(
                c_codes.to(dev), lens, n_b), lens, tts._generator(0),
                spec_settings)
            keep = ((c_len - 2) * small.vqvae.compression
                    * small.vocos.hop_length)
            sp["wav_of_cpu_codes"] = w[:, :keep].cpu().numpy()
        else:
            c_len = int(sp["lengths"][0])
            forced = {e: forced_picks(torch, tts, cond, text,
                                      torch.as_tensor(sp["codes"][:, :c_len]),
                                      engine=e)
                      for e in ("k1", "chain", "chain64")}
        with torch.no_grad():
            tts.gpt.mel_head.bias[stop] = bias
        tts.requantize()
        renders = [tts._render(cond, text.to(dev), codes.to(dev),
                               torch.tensor([n], device=dev), None,
                               TTSSettings(**kw), noise=xt.to(dev)).cpu()
                   for kw in variants]
        before = vq.vq_nearest.launches
        summary = evaluate_dvae(tts.dvae, clips)
        ev_codes = [dvae_roundtrip(tts.dvae, np.load(c + ".mel.npy"))["codes"]
                    for c in clips]
        rest[name] = (sp, renders, summary, ev_codes,
                      vq.vq_nearest.launches - before, forced)
    c_sp, c_r, c_sum, c_ev, c_k3, c_forced = rest["cpu"]
    k_sp, k_r, k_sum, k_ev, k_k3, k_forced = rest["card"]
    check(c_k3 == 0 and k_k3 == 6, f"K3 launches: cpu {c_k3}, card {k_k3}")
    rule = greedy_rule(torch, c_sp["codes"][0, :int(c_sp["lengths"][0])],
                       c_forced, k_forced["card"], "[ref] speculative")
    same = np.array_equal(c_sp["codes"], k_sp["codes"])
    errs = [float(np.abs(k_sp["wav_of_cpu_codes"] - c_sp["wav"]).max())]
    if same:      # the card's own request renders the same codes
        errs.append(float(np.abs(k_sp["wav"] - c_sp["wav"]).max()))
    errs += [max_err(k, c) for k, c in zip(k_r, c_r)]
    check(all(e <= SMALL_WAV_TOL for e in errs)
          and np.isfinite(k_sp["wav"]).all()
          and all(bool(torch.isfinite(k).all()) for k in k_r),
          f"speculative / refnet 1 and 2 / unipc / dpm++3m render errs "
          f"{errs}")
    d_k = max_err(k_r[1], k_r[0])
    check(d_k > 0, "[ref] refnet_interval 2 renders equal k 1's on the card: "
          "the hoist is not seen")
    check(all(np.array_equal(a, b) for a, b in zip(c_ev, k_ev))
          and c_sum["codebook_usage"] == k_sum["codebook_usage"]
          and c_sum["n"] == k_sum["n"] == 3
          and abs(c_sum["mel_l1_mean"] - k_sum["mel_l1_mean"]) <= 1e-3,
          f"evaluate_dvae: card {k_sum} vs cpu {c_sum}")
    n_sp = max(int(c_sp["lengths"][0]) - 2, 1)
    check(bucket_len(n_sp, card._code_buckets()) < bucket_len(
        98, card._code_buckets()), f"speculative request: {n_sp} codes")
    log(f"[ref] small config, the rest: speculative request (cap 100, "
        f"bucket 128, {n_sp} codes kept; {rule}; the card's own codes "
        f"{'equal' if same else 'differ from'} the CPU's) wav of the CPU's "
        f"codes max_abs_err {errs[0]:.3e}"
        f"{f', of its own codes {errs[1]:.3e}' if same else ''}; "
        f"refnet_interval 1, 2, unipc, dpm++3m renders max_abs_err "
        f"{', '.join(f'{e:.3e}' for e in errs[-4:])} (bound "
        f"{SMALL_WAV_TOL}); on the card k 2 differs from k 1 by {d_k:.3e} "
        f"(|wav| max {k_r[0].abs().max().item():.3f}); evaluate_dvae over "
        f"3 cached mels: codes identical, usage {k_sum['codebook_usage']}, "
        f"mel_l1_mean card {k_sum['mel_l1_mean']:.6f} cpu "
        f"{c_sum['mel_l1_mean']:.6f} ({k_k3} K3 launches on the card)")

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


class StandInTokenizer:
    """The card machine has no `tokenizers`: characters -> ids 3-250, with
    the interface the training CLI takes (encode, vocab_size)."""

    vocab_size = 251

    def encode(self, s):
        return [3 + ord(c) % 248 for c in s]


def adam_move_allowed(torch, g, dg, lr):
    """What a gradient within dg of g (both after the clip) can move
    AdamW's first update u(g) = g / (|g| + eps): |u'| on the interval,
    dg eps / (|g| - dg + eps)^2, at most 2 (near zero, eps turns rounding
    noise into a move of up to lr), times lr."""
    return lr * torch.clamp(dg * 1e-8 / (torch.clamp(g.abs() - dg, min=0)
                                         + 1e-8) ** 2, max=2.0)


def hold_train_step(torch, tag, c, k, lr, max_norm, norm_held=None,
                    norm_tol=TRAIN_GRAD_NORM_TOL):
    """The card's step (k) against the CPU's (c), each a dict of metrics,
    the raw gradients and the parameters after the step, and return the
    margins as one line. Metrics within TRAIN_LOSS_TOL relative; gradients
    within TRAIN_GRAD_RTOL |g| + TRAIN_GRAD_ATOL, except the parts that
    norm_held(name, tensor) returns (those within norm_tol of their
    norm); each parameter within 3 lr 1e-2 plus what the gradient gap
    (its tolerance, or the measured gap where larger), after the clip,
    moves Adam's first update. Counts the elements that need more than
    3 lr 1e-2, which pass only through that allowance."""
    err = {m: abs(k["metrics"][m] - c["metrics"][m])
           / max(abs(c["metrics"][m]), 1e-12) for m in c["metrics"]
           if m != "lr"}
    worst = max(err, key=err.get)
    check(err[worst] <= TRAIN_LOSS_TOL, f"{tag} metrics {err}")
    gn = math.sqrt(sum(float((g.double() ** 2).sum())
                       for g in c["grads"].values()))
    clip = min(1.0, max_norm / max(gn, 1e-30))
    g_over, g_norm_rel, p_err, p_margin, wide = None, 0.0, 0.0, 0.0, 0
    plain = 3 * lr * 1e-2
    for n, gc in c["grads"].items():
        gk = k["grads"][n]
        part = norm_held(n, gc) if norm_held else None
        dgap = (gk - gc).abs()
        tol = TRAIN_GRAD_RTOL * gc.abs() + TRAIN_GRAD_ATOL
        keep = torch.ones_like(gc, dtype=torch.bool)
        if part is not None:
            # a gradient that is zero in exact arithmetic (the speaker
            # encoder's attention norm bias, before a softmax over the
            # axis it is constant on) is rounding noise on both devices:
            # its scale is at least TRAIN_GRAD_FLOOR of the step's norm
            gap = (gk[part] - gc[part]).norm().item()
            scale = max(gc[part].norm().item(), TRAIN_GRAD_FLOOR * gn)
            rel = gap / scale
            check(rel <= norm_tol, f"{tag} gradient {n}: {gap:.3e} = "
                  f"{rel:.2e} of max(its norm {gc[part].norm().item():.3e}, "
                  f"{TRAIN_GRAD_FLOOR} x the step's {gn:.3e}) > {norm_tol}")
            g_norm_rel = max(g_norm_rel, rel)
            keep[part] = False
        if keep.any():
            over = (dgap - TRAIN_GRAD_RTOL * gc.abs())[keep].max().item()
            check(over <= TRAIN_GRAD_ATOL, f"{tag} gradient {n}: beyond "
                  f"rtol {TRAIN_GRAD_RTOL} by {over:.2e}")
            g_over = over if g_over is None else max(g_over, over)
        d = (k["params"][n] - c["params"][n]).abs()
        allowed = plain + adam_move_allowed(
            torch, clip * gc, clip * torch.maximum(tol, dgap), lr)
        check(bool((d <= allowed).all()), f"{tag} {n}: parameters apart by "
              f"{(d - allowed).max().item():.3e} beyond the bound")
        wide += int((d > plain).sum())
        p_err = max(p_err, d.max().item())
        p_margin = max(p_margin, (d / allowed).max().item())
    elementwise = (f"gradients past rtol {TRAIN_GRAD_RTOL} by at most "
                   f"{g_over:.2e} (bound {TRAIN_GRAD_ATOL})"
                   if g_over is not None
                   else "no gradient held element by element")
    return (f"metrics within {TRAIN_LOSS_TOL} relative, largest {worst} "
            f"{err[worst]:.2e}; {elementwise}"
            + (f", norm-held parts {g_norm_rel:.2e} of their norm (bound "
               f"{norm_tol})" if norm_held else "")
            + f"; clip x{clip:.3g}; params after the step max_abs_err "
            f"{p_err:.3e} (plain bound {plain:.0e}), largest share of its "
            f"bound {p_margin:.3f}, {wide} elements past the plain bound "
            f"(inside Adam's allowance)")


def train_reference_check(torch, np):
    """[ref], training: one optimizer step of the vqvae and the gpt trainer
    (train/trainer.py, train/steps.py) on the card and on the CPU port, f32
    (TF32 off), from the same perturbed weights and the same collated
    batch. Losses within TRAIN_LOSS_TOL relative; every parameter after the
    step within 3 lr 1e-2 (the CPU parity tests' bound against JAX); the
    DVAE codes equal up to vq_agree (the card's K3 against the CPU's twin);
    the gradients within the CPU tests' rtol 1e-4 / atol 1e-6; a parameter
    may move further apart only by what that gradient tolerance moves
    Adam's first update, lr g / (|g| + eps) (near a zero gradient, eps
    turns rounding noise into a move of up to lr);
    the codebook buffers after the EMA update within TRAIN_CB_TOL. Counted:
    K3 once a step on the card, never on the CPU."""
    import copy
    from xtts_tpu_torch.core.config import (DVAEConfig, GPTConfig,
                                            MelConfig, TrainConfig,
                                            XTTSConfig)
    from xtts_tpu_torch.models.dvae import DVAE
    from xtts_tpu_torch.models.gpt import UnifiedVoice
    from xtts_tpu_torch.nn.blocks import init_flax_like
    from xtts_tpu_torch.ops import vq
    from xtts_tpu_torch.train import cli
    from xtts_tpu_torch.train.steps import make_dvae_loss, make_gpt_loss
    from xtts_tpu_torch.train.trainer import Trainer

    mb = 8
    cfg = XTTSConfig(
        mel=MelConfig(n_mels=mb),
        vqvae=DVAEConfig(channels=mb, num_tokens=30, hidden_dim=16,
                         num_resnet_blocks=1, codebook_dim=16, num_layers=2),
        gpt=GPTConfig(layers=2, model_dim=128, heads=2, max_mel_tokens=64,
                      max_text_tokens=32, number_mel_codes=200,
                      start_mel_token=198, stop_mel_token=199, mel_bins=mb,
                      cond_attn_blocks=1),
        train=TrainConfig(lr=1e-3, lr_schedule="constant", accum_grad=1,
                          dtype="float32"))
    g = torch.Generator().manual_seed(4)
    base = {"vqvae": DVAE(cfg.vqvae), "gpt": UnifiedVoice(cfg.gpt)}
    with torch.no_grad():
        for m in base.values():
            init_flax_like(m, g)
            for p in m.parameters():    # the flax init zeroes projections
                p.add_(0.05 * torch.randn(p.shape, generator=g))
    rng = np.random.default_rng(5)
    vq_batch = {"mel": rng.standard_normal((4, mb, 64)).astype(np.float32)}
    samples = []
    for i in range(3):
        t_mel = 40 + 24 * i
        samples.append({
            "text": rng.integers(3, 250, 6 + 3 * i).astype(np.int32),
            "mel": rng.standard_normal((mb, t_mel)).astype(np.float32),
            "cond_mel": rng.standard_normal((mb, 30)).astype(np.float32),
            "wav_length": np.int32(t_mel * 256)})
    gpt_batch = cli.adapt_batch("gpt", cli.build_collate("gpt", cfg)(samples))
    lr = cfg.train.lr
    out = {}
    for dev in ("cpu", "cuda"):
        runs = {}
        for fam in ("vqvae", "gpt"):
            model = copy.deepcopy(base[fam]).to(dev)
            if fam == "vqvae":
                loss_fn, batch = make_dvae_loss(model), vq_batch
            else:
                frozen = copy.deepcopy(base["vqvae"]).to(dev).eval()
                loss_fn, batch = make_gpt_loss(model, frozen), gpt_batch
            batch = cli.to_device(batch, dev)
            dvae = model if fam == "vqvae" else frozen
            with torch.no_grad():
                x = dvae.encode(batch["mel"]).reshape(-1,
                                                      cfg.vqvae.codebook_dim)
                codes = dvae.get_codebook_indices(batch["mel"]).reshape(-1)
            tr = Trainer(model, loss_fn, cfg.train, accum_steps=1)
            st = tr.init_state()
            loss_fn(batch, None)[0].backward()     # the step's gradients
            grads = {n: p.grad.detach().cpu() for n, p in st.params.items()}
            model.zero_grad(set_to_none=True)
            k3 = vq.vq_nearest.launches
            st, metrics = tr.step(st, batch)
            runs[fam] = dict(
                grads=grads, k3=vq.vq_nearest.launches - k3, x=x,
                codes=codes,
                embed=dvae.codebook.embed.detach().clone(),
                metrics={k: float(v) for k, v in metrics.items()},
                params={k: v.detach().cpu() for k, v in st.params.items()},
                cols={k: v.cpu() for k, v in st.state_cols.items()})
        out[dev] = runs
    lines = []
    for fam in ("vqvae", "gpt"):
        c, k = out["cpu"][fam], out["cuda"][fam]
        check(c["k3"] == 0 and k["k3"] == 1,
              f"[ref] {fam} step: K3 launches cpu {c['k3']}, card {k['k3']}")
        n_diff, gap = vq_agree(torch, k["x"], k["embed"], k["codes"],
                               c["codes"].cuda(), f"[ref] {fam} step codes")
        line = hold_train_step(torch, f"[ref] {fam}", c, k, lr,
                               cfg.train.grad_clip)
        cb_err = max([max_err(k["cols"][n], c["cols"][n]) for n in c["cols"]]
                     or [0.0])
        check(cb_err <= TRAIN_CB_TOL, f"[ref] {fam} codebook err {cb_err}")
        lines.append(
            f"{fam}: {line}; codes {c['codes'].numel() - n_diff}/"
            f"{c['codes'].numel()} equal ({n_diff} within the fp32 tie "
            f"bound)" + (f"; codebook after the EMA update max_abs_err "
                         f"{cb_err:.2e} (bound {TRAIN_CB_TOL})"
                         if fam == "vqvae" else ""))
    log(f"[ref] small config, training (f32, one step from the same weights "
        f"and collated batch, card vs CPU): {'; '.join(lines)}")


def _small_train_cfg():
    """The [ref] training checks' small configuration: 8 mel bins, the
    DVAE and GPT of the vqvae / gpt step, and small diffusion, CLVP,
    classifier and HiFi-GAN sections over them."""
    from xtts_tpu_torch.core.config import (
        ClassifierConfig, CLIPRefConfig, CLVPConfig, DiffusionModelConfig,
        DiffusionProcessConfig, DVAEConfig, GPTConfig, HiFiGANConfig,
        MelConfig, TrainConfig, XTTSConfig)
    mb = 8
    return XTTSConfig(
        mel=MelConfig(n_mels=mb),
        vqvae=DVAEConfig(channels=mb, num_tokens=30, hidden_dim=16,
                         num_resnet_blocks=1, codebook_dim=16, num_layers=2),
        gpt=GPTConfig(layers=2, model_dim=128, heads=2, max_mel_tokens=64,
                      max_text_tokens=32, number_mel_codes=200,
                      start_mel_token=198, stop_mel_token=199, mel_bins=mb,
                      cond_attn_blocks=1),
        diffusion=DiffusionModelConfig(
            in_channels=mb, out_channels=2 * mb, model_channels=64,
            num_res_blocks=1, channel_mult=(1,), num_heads=2,
            context_dim=64, in_latent_channels=128,
            clip=CLIPRefConfig(width=64, layers=1, head_width=32,
                               patch_size=8, in_channels=mb,
                               max_patches=64)),
        diffusion_process=DiffusionProcessConfig(timesteps=1000),
        clvp=CLVPConfig(dim_text=64, dim_speech=64, dim_latent=32,
                        num_text_tokens=256, text_enc_depth=2,
                        text_seq_len=64, text_heads=2, num_speech_tokens=64,
                        speech_enc_depth=2, speech_heads=2),
        classifier=ClassifierConfig(spec_dim=mb, base_channels=16, depth=2,
                                    resnet_blocks=1, attn_blocks=1,
                                    num_attn_heads=2, embedding_dim=64),
        hifigan=HiFiGANConfig(decoder_input_dim=128,
                              upsample_initial_channel=64,
                              resblock_kernel_sizes=(3,),
                              resblock_dilation_sizes=((1, 3),),
                              d_vector_dim=32),
        train=TrainConfig(lr=1e-3, lr_schedule="constant", accum_grad=1,
                          dtype="float32"))


def train_reference_check_new(torch, np):
    """[ref], training, the four later families: one f32 step of each on the
    card and on the CPU port from the same perturbed weights and collated
    batch, held by hold_train_step (every margin printed). diffusion: the
    draws (t, noise, the unconditioned rows, the PatchDropout ranking) made
    once on a CPU generator and given to both; the frozen DVAE's codes by
    vq_agree, K3 once on the card; the output conv's variance rows held by
    their norm. clvp and classifier: the Trainer's step. hifigan: the
    GANTrainer's discriminator update on both from the CPU's generated
    wave (the card's within 1e-4 of it), then the generator's, both
    against the CPU's updated discriminator (Adam's first update may turn a
    near-zero gradient either way); the generator's gradients held by
    their norm (TRAIN_GRAD_KINK_TOL: LeakyReLU kinks, and the
    log-magnitude STFT loss), the discriminator's too; 4096-sample crops,
    K3 once on the card."""
    import copy
    from xtts_tpu_torch.diffusion.gaussian import (GaussianDiffusion,
                                                   get_named_beta_schedule)
    from xtts_tpu_torch.models.aa_diffusion import normalize_tacotron_mel
    from xtts_tpu_torch.nn.blocks import init_flax_like
    from xtts_tpu_torch.ops import vq
    from xtts_tpu_torch.train import cli, gan, steps
    from xtts_tpu_torch.train.trainer import Trainer
    from xtts_tpu_torch.utils.registry import MODELS

    cfg = _small_train_cfg()
    mb, lr = cfg.mel.n_mels, cfg.train.lr
    g = torch.Generator().manual_seed(6)
    base = {}
    for name in ("vqvae", "gpt", "diffusion", "clvp", "classifier",
                 "hifigan", "hifigan_discriminator"):
        m = MODELS[name]["build"](cfg, torch.float32)
        with torch.no_grad():
            init_flax_like(m, g)
            for p in m.parameters():    # the flax init zeroes projections
                p.add_(0.05 * torch.randn(p.shape, generator=g))
        base[name] = m
    rng = np.random.default_rng(7)
    diff_samples = [{
        "text": rng.integers(3, 250, 5 + 4 * i).astype(np.int32),
        "mel": rng.standard_normal((mb, 40 + 24 * i)).astype(np.float32),
        "refer_mel": rng.standard_normal((mb, 48 + 8 * i)
                                         ).astype(np.float32),
        "wav_length": np.int32((40 + 24 * i) * 256)} for i in range(3)]
    batches = {
        "diffusion": cli.adapt_batch("diffusion", cli.build_collate(
            "diffusion", cfg)(diff_samples)),
        "clvp": cli.adapt_batch("clvp", cli.build_collate("clvp", cfg)([{
            "text": rng.integers(3, 250, 7 + 5 * i).astype(np.int32),
            "codes": rng.integers(0, 64, 30 + 20 * i).astype(np.int32)}
            for i in range(4)])),
        "classifier": {"mel": rng.standard_normal((4, 64, mb)
                                                  ).astype(np.float32),
                       "label": np.array([0, 1, 1, 0], np.int32)},
        "hifigan": {"wav": (0.3 * rng.standard_normal((2, 4096))
                            ).astype(np.float32),
                    "mel": rng.standard_normal((2, mb, 16)).astype(np.float32),
                    "refer_mel16": (rng.standard_normal((2, 60, 64)) - 4.0
                                    ).astype(np.float32),
                    "wav_length": np.array([4096, 4096], np.int32)}}
    dp = cfg.diffusion_process
    gd = GaussianDiffusion(betas=get_named_beta_schedule(dp.schedule,
                                                         dp.timesteps))
    cpu_b = cli.to_device(batches["diffusion"], "cpu")
    draws = steps.diffusion_draws(
        base["diffusion"], gd, normalize_tacotron_mel(cpu_b["mel"]),
        normalize_tacotron_mel(cpu_b["refer_mel"]),
        torch.Generator().manual_seed(8), 0.1)

    def var_rows(n, t):
        return (slice(mb, None) if n.startswith("base_model.out.2.")
                else None)

    out = {}
    for dev in ("cpu", "cuda"):
        runs = {}
        mods = {k: copy.deepcopy(v).to(dev) for k, v in base.items()}
        frozen = {k: mods[k].eval().requires_grad_(False)
                  for k in ("vqvae", "gpt")}
        for fam in ("diffusion", "clvp", "classifier"):
            batch = cli.to_device(batches[fam], dev)
            model = mods[fam]
            if fam == "diffusion":
                dd = {k: v.to(dev) for k, v in draws.items()}
                inner = steps.make_diffusion_loss(
                    model, gd, frozen["gpt"], frozen["vqvae"], 0.1)
                loss_fn = lambda b, gen, f=inner, dd=dd: f(b, gen, draws=dd)
            elif fam == "clvp":
                from xtts_tpu_torch.models.clvp import make_clvp_loss
                loss_fn = make_clvp_loss(model)
            else:
                from xtts_tpu_torch.models.classifier import (
                    make_classifier_loss)
                loss_fn = make_classifier_loss(model)
            tr = Trainer(model, loss_fn, cfg.train, accum_steps=1)
            st = tr.init_state()
            loss_fn(batch, None)[0].backward()     # the step's gradients
            grads = {n: (p.grad if p.grad is not None else
                         torch.zeros_like(p)).detach().cpu()
                     for n, p in st.params.items()}
            model.zero_grad(set_to_none=True)
            k3 = vq.vq_nearest.launches
            st, metrics = tr.step(st, batch)
            runs[fam] = dict(
                grads=grads, k3=vq.vq_nearest.launches - k3,
                metrics={k: float(v) for k, v in metrics.items()},
                params={k: v.detach().cpu() for k, v in st.params.items()})
            if fam == "diffusion":
                with torch.no_grad():
                    dv = frozen["vqvae"]
                    runs[fam]["x"] = dv.encode(batch["mel"]).reshape(
                        -1, cfg.vqvae.codebook_dim)
                    runs[fam]["codes"] = dv.get_codebook_indices(
                        batch["mel"]).reshape(-1)
                    runs[fam]["embed"] = dv.codebook.embed.detach().clone()
        # the GAN: discriminator, then generator against the CPU's update
        batch = cli.to_device(batches["hifigan"], dev)
        gen_fn = gan.make_hifigan_generator_fn(mods["hifigan"],
                                               frozen["gpt"], frozen["vqvae"])
        gt = gan.GANTrainer(mods["hifigan"], mods["hifigan_discriminator"],
                            gen_fn, g_lr=lr, d_lr=lr,
                            grad_clip=cfg.train.grad_clip)
        gs = gt.init_state()
        k3 = vq.vq_nearest.launches
        latent = gen_fn.latent_of(batch)
        with torch.no_grad():
            fake = gen_fn(batch, latent)
        if dev == "cpu":
            cpu_fake = fake.clone()
        else:
            # the discriminator's gradient is piecewise linear in the wave:
            # a 1e-6 change flips LeakyReLU kinks, so both devices' updates
            # take the CPU's generated wave
            check(max_err(fake, cpu_fake.cuda()) <= 1e-4,
                  "[ref] hifigan generated wave, card vs CPU")

            def fixed(b, lat=None, w=cpu_fake.cuda()):
                return w
            fixed.latent_of = gen_fn.latent_of
            gt.gen = fixed
        d_loss, d_norm, d_raw = gt.d_step(gs, batch, latent)
        gt.gen = gen_fn
        runs["hifigan_d"] = dict(
            metrics={"d_loss": float(d_loss), "d_grad_norm": float(d_norm)},
            grads={n: v.cpu() for n, v in zip(gs.d_params, d_raw)},
            params={n: v.detach().cpu() for n, v in gs.d_params.items()})
        if dev == "cuda":
            with torch.no_grad():
                for n, p in gs.d_params.items():
                    p.copy_(out["cpu"]["hifigan_d"]["params"][n])
        g_loss, parts, g_norm, g_raw = gt.g_step(gs, batch, latent)
        runs["hifigan_g"] = dict(
            metrics={"g_loss": float(g_loss), "g_grad_norm": float(g_norm),
                     **{k: float(v) for k, v in parts.items()}},
            grads={n: v.cpu() for n, v in zip(gs.g_params, g_raw)},
            params={n: v.detach().cpu() for n, v in gs.g_params.items()},
            k3=vq.vq_nearest.launches - k3)
        out[dev] = runs
    lines = []
    for fam in ("diffusion", "clvp", "classifier", "hifigan_d", "hifigan_g"):
        c, k = out["cpu"][fam], out["cuda"][fam]
        if fam in ("diffusion", "hifigan_g"):
            check(c["k3"] == 0 and k["k3"] == 1, f"[ref] {fam} step: K3 "
                  f"launches cpu {c['k3']}, card {k['k3']}")
        extra = ""
        if fam == "diffusion":
            n_diff, _ = vq_agree(torch, k["x"], k["embed"], k["codes"],
                                 c["codes"].cuda(), "[ref] diffusion codes")
            extra = (f"; frozen codes {c['codes'].numel() - n_diff}/"
                     f"{c['codes'].numel()} equal; t "
                     f"{draws['t'].tolist()}")
        gan_step = fam.startswith("hifigan")
        held = (lambda n, t: slice(None)) if gan_step else (
            var_rows if fam == "diffusion" else None)
        line = hold_train_step(
            torch, f"[ref] {fam}", c, k, lr, cfg.train.grad_clip, held,
            TRAIN_GRAD_KINK_TOL if gan_step else TRAIN_GRAD_NORM_TOL)
        lines.append(f"{fam}: {line}{extra}")
    log(f"[ref] small config, training, the later families (f32, one step "
        f"from the same weights, batch and draws, card vs CPU): "
        f"{'; '.join(lines)}")


def flash_train_reference_check(torch, np):
    """[ref], K2's backward in a training step: one f32 diffusion Trainer
    step at a small width whose UNet heads are 64 wide (the kernels'),
    with mels of 600 frames and references of 300 (the consumer attention
    past the size gate), on the card with flash=True (K2's f32 forward and
    both backward kernels) against the same step with flash=False, from
    the same weights, batch and draws; held by hold_train_step (the output
    conv's variance rows by their norm), every margin printed."""
    from xtts_tpu_torch.models.aa_diffusion import (AADiffusion,
                                                    normalize_tacotron_mel)
    from xtts_tpu_torch.nn import flash_attn as fa
    from xtts_tpu_torch.nn.blocks import init_flax_like
    from xtts_tpu_torch.train import cli, steps
    from xtts_tpu_torch.train.trainer import Trainer
    from xtts_tpu_torch.utils.registry import MODELS

    cfg = _small_train_cfg()
    cfg = cfg.replace(gpt=cfg.gpt.replace(max_mel_tokens=160),
                      diffusion=cfg.diffusion.replace(model_channels=128))
    mb, lr = cfg.mel.n_mels, cfg.train.lr
    g = torch.Generator().manual_seed(16)
    base = {}
    for name in ("vqvae", "gpt", "diffusion"):
        m = MODELS[name]["build"](cfg, torch.float32)
        with torch.no_grad():
            init_flax_like(m, g)
            for p in m.parameters():    # the flax init zeroes projections
                p.add_(0.05 * torch.randn(p.shape, generator=g))
        base[name] = m
    frozen = {k: base[k].cuda().eval().requires_grad_(False)
              for k in ("vqvae", "gpt")}
    rng = np.random.default_rng(17)
    samples = [{
        "text": rng.integers(3, 250, 9 + 4 * i).astype(np.int32),
        "mel": rng.standard_normal((mb, 600 - 80 * i)).astype(np.float32),
        "refer_mel": rng.standard_normal((mb, 300 - 40 * i)
                                         ).astype(np.float32),
        "wav_length": np.int32((600 - 80 * i) * 256)} for i in range(2)]
    cpu_b = cli.to_device(cli.adapt_batch("diffusion", cli.build_collate(
        "diffusion", cfg)(samples)), "cpu")
    tq, tr_len = cpu_b["mel"].shape[-1], cpu_b["refer_mel"].shape[-1]
    check(fa.use_flash(tq, tq + tr_len), f"[ref] flash step {tq} | "
          f"{tq + tr_len} below the gate")
    batch = cli.to_device(cpu_b, "cuda")
    gd = training_process(cfg)
    draws = steps.diffusion_draws(
        base["diffusion"], gd, normalize_tacotron_mel(cpu_b["mel"]),
        normalize_tacotron_mel(cpu_b["refer_mel"]),
        torch.Generator().manual_seed(18), 0.1)
    dd = {k: v.cuda() for k, v in draws.items()}
    runs = {}
    for flash in (False, True):
        model = AADiffusion(cfg.diffusion, flash=flash)
        model.load_state_dict(base["diffusion"].state_dict())
        model.cuda()
        inner = steps.make_diffusion_loss(model, gd, frozen["gpt"],
                                          frozen["vqvae"], 0.1)
        loss_fn = lambda b, gen, f=inner: f(b, gen, draws=dd)
        tr = Trainer(model, loss_fn, cfg.train, accum_steps=1)
        st = tr.init_state()
        for fn in fa.KERNELS:
            fn.launches = 0
        with torch.enable_grad():
            loss_fn(batch, None)[0].backward()     # the step's gradients
        grads = {n: (p.grad if p.grad is not None else
                     torch.zeros_like(p)).detach().cpu()
                 for n, p in st.params.items()}
        model.zero_grad(set_to_none=True)
        with torch.enable_grad():
            st, metrics = tr.step(st, batch)
        runs[flash] = dict(
            grads=grads, k2=[fn.launches for fn in fa.KERNELS],
            metrics={k: float(v) for k, v in metrics.items()},
            params={k: v.detach().cpu() for k, v in st.params.items()})
    check(runs[False]["k2"] == [0, 0, 0] and min(runs[True]["k2"]) > 0,
          f"[ref] flash step K2 launches {runs[True]['k2']}, plain "
          f"{runs[False]['k2']}")
    line = hold_train_step(
        torch, "[ref] diffusion flash=True", runs[False], runs[True], lr,
        cfg.train.grad_clip,
        lambda n, t: (slice(mb, None) if n.startswith("base_model.out.2.")
                      else None))
    log(f"[ref] small config, diffusion step through K2's backward (f32, UNet "
        f"128 ch x 2 heads of 64, consumer attention {tq} | {tq + tr_len}, "
        f"t {draws['t'].tolist()}): flash=True against flash=False on the "
        f"card, K2 launches fwd / dkv / dq {runs[True]['k2']}: {line}")


def _step_times(jsonl: Path, warm: int):
    """The per-step wall times the training CLI logs, after `warm` steps."""
    recs = [json.loads(x) for x in jsonl.read_text().splitlines()]
    return [r["step_s"] for r in recs if "step_s" in r and r["step"] > warm]


def gpt_step_flops(cfg, b: int, t_text: int, t_mel: int, t_cond: int):
    """Model FLOPs of one GPT training step (forward + backward = 3 x the
    forward's 2 x multiply-adds) at padded shapes: the GPT stack's products
    2 B S 12 D^2 a layer and its attention 4 B S^2 D a layer (S = t_text +
    t_mel + 5: cond, [start; text; stop; stop], [start; codes; stop;
    stop]), the text and mel heads, and the conditioning encoder (1x1 conv
    mel -> D, then per block 2 B T 4 D^2 + 4 B T^2 D over t_cond frames).
    The frozen DVAE's codes are not counted."""
    g = cfg.gpt
    d, seq = g.model_dim, t_text + t_mel + 5
    fwd = g.layers * (2 * b * seq * 12 * d * d + 4 * b * seq * seq * d)
    fwd += 2 * b * (t_text + 2) * d * (g.number_text_tokens * g.types + 1)
    fwd += 2 * b * (t_mel + 2) * d * g.number_mel_codes
    fwd += 2 * b * t_cond * g.mel_bins * d
    fwd += g.cond_attn_blocks * (2 * b * t_cond * 4 * d * d
                                 + 4 * b * t_cond * t_cond * d)
    return 3 * fwd


def dvae_step_flops(torch, dvae, mel):
    """Model FLOPs of one DVAE training step: 3 x the forward's conv
    multiply-adds (2 Cin Cout k T_out B each, counted by forward hooks on
    one forward) plus the quantizer's two codebook products, K3's distance
    product and the one-hot statistics, 2 N D E each (no backward)."""
    total = [0]

    def hook(m, inp, out):
        total[0] += (2 * m.in_channels // m.groups * m.out_channels
                     * m.kernel_size[0] * out.shape[-1] * out.shape[0])
    hs = [m.register_forward_hook(hook) for m in dvae.modules()
          if isinstance(m, torch.nn.Conv1d)]
    try:
        with torch.no_grad():
            z = dvae.encode(mel)
            dvae.decoder(z.transpose(1, 2))
    finally:
        for h in hs:
            h.remove()
    c = dvae.cfg
    n = z.shape[0] * z.shape[1]
    return 3 * total[0] + 2 * 2 * n * c.codebook_dim * c.num_tokens


def train_phase(torch, np, launches, results, card):
    """[train], the training path at the flagship widths through the CLI
    (xtts_tpu_torch.train.cli.train): a seeded corpus of TRAIN_WAVS wavs,
    its mels cached (prepare.cache_mels); TRAIN_STEPS vqvae steps, then
    TRAIN_STEPS gpt steps on the vqvae export, each evaluating every
    TRAIN_VAL_FREQ steps on 8 held-out wavs; the gpt checkpoint restored
    bit for bit, then a --resume run to TRAIN_STEPS + 2; OVERFIT_STEPS gpt
    steps on one repeated batch; cache_vq_codes over the corpus; the exports
    through TextToSpeech.from_pretrained; K3 at the trainers' row counts
    against its plain twin. Launch counts reset before each run and read
    after. Returns the phase's seconds."""
    import itertools
    import shutil
    from xtts_tpu_torch.core.config import XTTSConfig
    from xtts_tpu_torch.data.audio import save_wav
    from xtts_tpu_torch.data.datasets import (FilelistEntry, batch_iterator,
                                              write_filelist)
    from xtts_tpu_torch.data.prepare import cache_mels, cache_vq_codes
    from xtts_tpu_torch.dsp.mel import MelFrontend
    from xtts_tpu_torch.infer.api import TextToSpeech
    from xtts_tpu_torch.ops import vq
    from xtts_tpu_torch.train import cli
    from xtts_tpu_torch.train.trainer import Trainer
    from xtts_tpu_torch.utils.registry import load_model

    t_phase = time.perf_counter()
    root = ROOT / "build" / "train_corpus"
    runs = ROOT / "build" / "train_runs"
    for d in (root, runs):
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
    rng = np.random.default_rng(12)
    syll = ("ni3", "hao3", "jin1", "tian1", "qi4", "hen3", "zhong1", "guo2",
            "ren2", "men5", "shuo1", "hua4", "xue2", "sheng1", "lao3", "shi1")
    entries = []
    for i in range(TRAIN_WAVS):
        sec = 2.0 + 10.0 * i / (TRAIN_WAVS - 1)
        t = np.arange(int(sec * SR)) / SR
        f0 = 110 + 25 * i
        w = (0.3 * np.sin(2 * np.pi * f0 * t) * (0.6 + 0.4 * np.sin(
            2 * np.pi * 3 * t)) + 0.05 * rng.standard_normal(t.size))
        path = str(root / f"utt{i:02d}.wav")
        save_wav(path, w.astype(np.float32))
        words = " ".join(rng.choice(syll, int(3 * sec)))
        entries.append(FilelistEntry(f"utt{i:02d}", path, "spk0", "zh",
                                     words, words))
    write_filelist(str(root / "train.txt"), entries)
    write_filelist(str(root / "val.txt"), entries[::2])
    cfg = XTTSConfig()
    cfg = cfg.replace(train=cfg.train.replace(
        batch_size=8, accum_grad=1, lr_schedule="constant",
        val_freq=TRAIN_VAL_FREQ, save_freq=TRAIN_STEPS, keep_ckpts=2,
        train_steps=TRAIN_STEPS))
    cfg.to_json(str(root / "cfg.json"))
    paths = [e.wav_path for e in entries]
    t0 = time.perf_counter()
    n_mels = cache_mels(paths, MelFrontend(cfg.mel, "cuda"))
    check(n_mels == TRAIN_WAVS, f"cache_mels wrote {n_mels}")
    log(f"[train] corpus: {TRAIN_WAVS} seeded wavs of 2-12 s "
        f"({sum(len(e.cleaned_text) for e in entries)} text chars), mels "
        f"cached on the card in {time.perf_counter() - t0:.2f} s; config "
        f"XTTSConfig() (DVAE 100 -> 512 hidden, 8192 x 512 codebook; GPT "
        f"{cfg.gpt.layers} x {cfg.gpt.model_dim} x {cfg.gpt.heads} heads, "
        f"vocab {cfg.gpt.number_mel_codes}), batch 8, constant lr "
        f"{cfg.train.lr}, bf16 compute, f32 parameters")

    common = ["-c", str(root / "cfg.json"), "--filelist",
              str(root / "train.txt"), "--val-filelist",
              str(root / "val.txt")]
    vq_dir, gpt_dir = runs / "vqvae", runs / "gpt"
    gpt_args = ["gpt", "-m", str(gpt_dir), "--dvae-weights",
                str(vq_dir / "vqvae.pth")] + common
    n_evals = TRAIN_STEPS // TRAIN_VAL_FREQ
    stats = {}
    for fam, argv, k3_per_eval in (
            ("vqvae", ["vqvae", "-m", str(vq_dir)] + common, 2),
            ("gpt", gpt_args, 1)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        launches.reset()
        t0 = time.perf_counter()
        st = cli.main(argv, tokenizer=StandInTokenizer())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = launches.read()
        want = TRAIN_STEPS + n_evals * k3_per_eval
        check(st.step == TRAIN_STEPS, f"[train] {fam} ended at {st.step}")
        check(got["vq_nearest"] == want, f"[train] {fam}: K3 launched "
              f"{got['vq_nearest']} times, want {want} (one a step, "
              f"{k3_per_eval} an eval pass)")
        recs = [json.loads(x) for x in (runs / fam / "logs" / "metrics.jsonl")
                .read_text().splitlines()]
        losses = [r["loss"] for r in recs if "loss" in r]
        evals = [r["eval/loss"] for r in recs if "eval/loss" in r]
        check(len(losses) == TRAIN_STEPS and all(map(math.isfinite, losses))
              and len(evals) == n_evals and all(map(math.isfinite, evals)),
              f"[train] {fam} losses {losses} evals {evals}")
        stats[fam] = dict(wall=wall, k3=got["vq_nearest"], losses=losses,
                          evals=evals, peak=torch.cuda.max_memory_allocated()
                          / 2 ** 30,
                          step_s=_step_times(runs / fam / "logs" /
                                             "metrics.jsonl", TRAIN_WARM))

    # the steps' shapes: the same seeded iterator again
    ds = cli.build_dataset("gpt", cfg, str(root / "train.txt"),
                           StandInTokenizer(), cfg.train.seed, "cuda")
    shapes = [(b["text"].shape[1], b["mel"].shape[2] // 4,
               b["cond_mel"].shape[2]) for b in itertools.islice(
        batch_iterator(ds, 8, cli.build_collate("gpt", cfg),
                       seed=cfg.train.seed), TRAIN_STEPS)][TRAIN_WARM:]
    vq_ds = cli.build_dataset("vqvae", cfg, str(root / "train.txt"), None,
                              cfg.train.seed, "cuda")
    vq_mel = next(batch_iterator(vq_ds, 8, cli.build_collate("vqvae", cfg),
                                 seed=cfg.train.seed))["mel"]
    dvae = load_model("vqvae", cfg, str(vq_dir / "vqvae.pth"),
                      dtype=torch.bfloat16)
    vq_mel = torch.from_numpy(vq_mel).cuda()
    flops = {"vqvae": [dvae_step_flops(torch, dvae, vq_mel)] * len(
        stats["vqvae"]["step_s"]),
             "gpt": [gpt_step_flops(cfg, 8, *sh) for sh in shapes]}
    tokens = [8 * (sh[1] + 2) for sh in shapes]
    for fam in ("vqvae", "gpt"):
        s = stats[fam]
        med = statistics.median(s["step_s"])   # steps after evals read more
        s["median_ms"] = 1e3 * med
        s["samples_s"] = 8 / med
        s["tflop_step"] = statistics.mean(flops[fam]) / 1e12
        s["mfu"] = s["tflop_step"] * 1e12 / med / PEAK["bf16"]
        extra = (f", mel tokens {statistics.mean(tokens) / med:.0f}/s (8 x "
                 f"(codes + 2) a step, padded)" if fam == "gpt" else "")
        log(f"[train] {fam}: {TRAIN_STEPS} steps in {s['wall']:.2f} s (with "
            f"{n_evals} evals and the save); step "
            f"{s['median_ms']:.1f} ms median over steps {TRAIN_WARM + 1}-"
            f"{TRAIN_STEPS} (the loader included), {s['samples_s']:.1f} "
            f"samples/s{extra}; model FLOPs {s['tflop_step']:.3f} TFLOP a "
            f"step (mean), {100 * s['mfu']:.2f}% of {PEAK['bf16'] / 1e12:.0f} "
            f"TFLOP/s bf16; peak memory {s['peak']:.2f} GiB; loss "
            f"{s['losses'][0]:.4f} -> {s['losses'][-1]:.4f}, eval "
            f"{', '.join(f'{e:.4f}' for e in s['evals'])}; K3 {s['k3']} "
            f"launches  [{card}]")

    # resume: the restored state equals the checkpoint's bit for bit
    args = cli.parser().parse_args(gpt_args)
    loss_fn, module, _ = cli.build_loss("gpt", cfg, args, "cuda")
    tr = Trainer(module, loss_fn, cfg.train, accum_steps=1,
                 checkpoint_dir=str(gpt_dir / "ckpt"))
    state = tr.restore(tr.init_state())
    saved = torch.load(gpt_dir / "ckpt" / f"{TRAIN_STEPS}.pt",
                       map_location="cpu", weights_only=True)
    live = Trainer.payload(state)
    n_t = 0
    for group in ("params", "state_cols"):
        for k, v in live[group].items():
            check(torch.equal(v.cpu(), saved[group][k]), f"restored {k}")
            n_t += 1
    for mom in ("mu", "nu"):
        for k, v in live["opt_state"][mom].items():
            check(torch.equal(v.cpu(), saved["opt_state"][mom][k]),
                  f"restored {mom} {k}")
            n_t += 1
    check(state.step == saved["step"] == TRAIN_STEPS
          and state.opt_state.count == saved["opt_state"]["count"],
          f"restored step {state.step}")

    # overfitting: one batch, repeated
    batch = cli.to_device(cli.adapt_batch("gpt", next(batch_iterator(
        ds, 8, cli.build_collate("gpt", cfg), seed=99))), "cuda")
    fit = []
    launches.reset()
    for _ in range(OVERFIT_STEPS):
        state, m = tr.step(state, batch)
        fit.append(float(m["loss"]))
    check(launches.read()["vq_nearest"] == OVERFIT_STEPS,
          "[train] overfit: K3 once a step")
    check(all(map(math.isfinite, fit))
          and fit[-1] <= OVERFIT_RATIO * fit[0],
          f"[train] gpt loss on one repeated batch {fit[0]:.4f} -> "
          f"{fit[-1]:.4f}: ratio {fit[-1] / fit[0]:.3f} > {OVERFIT_RATIO}")
    del tr, state, module, loss_fn, batch
    torch.cuda.empty_cache()

    launches.reset()
    st = cli.main(gpt_args + ["--resume", "--steps", str(TRAIN_STEPS + 2)],
                  tokenizer=StandInTokenizer())
    recs = [json.loads(x) for x in (gpt_dir / "logs" / "metrics.jsonl")
            .read_text().splitlines()]
    after = [r["step"] for r in recs if "loss" in r][TRAIN_STEPS:]
    check(st.step == TRAIN_STEPS + 2 and after == [TRAIN_STEPS + 1,
                                                   TRAIN_STEPS + 2]
          and launches.read()["vq_nearest"] == 2,
          f"[train] --resume ran steps {after}")
    log(f"[train] resume: the gpt checkpoint of step {TRAIN_STEPS} restored "
        f"on the card equal to the saved one bit for bit ({n_t} tensors: "
        f"parameters, Adam moments; count and step); --resume ran steps "
        f"{after}; overfitting one repeated batch of 8: loss {fit[0]:.4f} "
        f"-> {fit[-1]:.4f} over {OVERFIT_STEPS} steps (ratio "
        f"{fit[-1] / fit[0]:.3f}, bound {OVERFIT_RATIO})  [{card}]")

    # cache_vq_codes over the corpus on the vqvae export (K3 a file)
    launches.reset()
    for p in paths:
        Path(p + ".melvq.npy").unlink(missing_ok=True)
    n_vq = cache_vq_codes(paths, load_model("vqvae", cfg,
                                            str(vq_dir / "vqvae.pth")))
    check(n_vq == TRAIN_WAVS and launches.read()["vq_nearest"] == TRAIN_WAVS,
          f"cache_vq_codes wrote {n_vq}")

    # the exports load where the serving side reads them
    pre = runs / "pretrained"
    pre.mkdir()
    for src in (vq_dir / "vqvae.pth", gpt_dir / "gpt.pth"):
        (pre / src.name).symlink_to(src)
    tts = TextToSpeech.from_pretrained(str(pre), cfg, device="cuda",
                                       quantized_decode=False)
    exported = torch.load(gpt_dir / "gpt.pth", map_location="cuda",
                          weights_only=True)
    check(all(torch.equal(tts.gpt.state_dict()[k], v)
              for k, v in exported.items())
          and torch.equal(tts.dvae.codebook.embed.cpu(),
                          dvae.codebook.embed.cpu()),
          "from_pretrained did not load the exports")
    del tts, exported

    # K3 at the trainers' row counts against its plain twin
    with torch.no_grad():
        x_vq = dvae.encode(vq_mel).float().reshape(-1, 512).contiguous()
        gb = next(batch_iterator(ds, 8, cli.build_collate("gpt", cfg),
                                 seed=cfg.train.seed))
        frozen = load_model("vqvae", cfg, str(vq_dir / "vqvae.pth"))
        x_gpt = frozen.encode(torch.from_numpy(gb["mel"]).cuda()).reshape(
            -1, 512).contiguous()
    emb = dvae.codebook.embed
    rows = [k3_train_row(torch, vq, xx, emb, tag, card)
            for tag, xx in (("vqvae", x_vq), ("gpt", x_gpt))]
    del dvae, frozen, x_vq, x_gpt
    torch.cuda.empty_cache()
    ctx = dict(root=root, runs=runs, cfg=cfg, entries=entries, common=common,
               vq=vq_dir / "vqvae.pth", gpt=gpt_dir / "gpt.pth")
    rows += train_phase_new(torch, np, launches, card, ctx)
    flash_train_run(torch, np, launches, card, ctx)
    # the same at 2 heads of 256: K2's bf16 wgmma wide backward pair, then
    # in f32 its f32 wide pair
    for dt in (None, torch.float32):
        flash_train_run(torch, np, launches, card, ctx, heads=2,
                        n_steps=FLASH_WARM + 2, dtype=dt)
    results["vq_nearest"]["train"] = rows
    torch.cuda.empty_cache()
    return time.perf_counter() - t_phase


def k3_train_row(torch, vq, xx, emb, tag, card):
    """K3 at a trainer's rows xx (N, 512) against its plain twin and
    cdist + argmin: codes by vq_agree, the single-call CUDA-event ms and
    the device us a call of each, the bound."""
    got, want = vq.vq_nearest(xx, emb), vq.vq_nearest_plain(xx, emb)
    n_diff, gap = vq_agree(torch, xx, emb, got, want, f"[train] K3 {tag}")
    n, d = xx.shape
    e = emb.shape[1]
    et = emb.t().contiguous()
    dk = device_us(torch, lambda: vq.vq_nearest(xx, emb), n=20)
    dp = device_us(torch, lambda: vq.vq_nearest_plain(xx, emb), n=20)
    dl = device_us(torch, lambda: torch.cdist(xx, et).argmin(1), n=20)
    ms = [time_ms(torch, f) for f in (
        lambda: vq.vq_nearest(xx, emb), lambda: vq.vq_nearest_plain(xx, emb),
        lambda: torch.cdist(xx, et).argmin(1))]
    bnd = bound(4 * (n * d + d * e + e) + 8 * n, 3 * 2 * n * d * e, "tf32")
    log(f"[train] K3 at the {tag} trainer's rows (N {n}, D {d}, E {e}): "
        f"codes equal the twin's on {n - n_diff}/{n} rows ({n_diff} within "
        f"the fp32 tie bound, largest f64 gap {gap:.3e}); device "
        f"{fmt_us(dk)} a call, plain twin {fmt_us(dp)}, cdist+argmin "
        f"{fmt_us(dl)}; single calls {ms[0]:.4f} / {ms[1]:.4f} / "
        f"{ms[2]:.4f} ms; bound {bnd[0] * 1e3:.2f} us ({bnd[1]})  [{card}]")
    return dict(trainer=tag, n=n, ms=ms[0], plain_ms=ms[1], library_ms=ms[2],
                device_us=dk, plain_device_us=dp, library_device_us=dl,
                bound_ms=bnd[0], bound_by=bnd[1], codes_differ=n_diff)


def counted_flops(torch, fn) -> int:
    """The matmul / conv / attention FLOPs that fn() runs (torch's
    FlopCounterMode; forward and backward as they execute)."""
    from torch.utils.flop_counter import FlopCounterMode
    fc = FlopCounterMode(display=False)
    with fc:
        fn()
    return fc.get_total_flops()


def train_phase_new(torch, np, launches, card, ctx):
    """[train], the four later families through the CLI at the flagship
    widths, on [train]'s corpus and the vqvae / gpt exports, NEW_STEPS
    steps each at batch 8 with one eval (TRAIN_VAL_FREQ): diffusion with
    loss_second_moment, its eval render through a random Vocos export;
    clvp on the cached codes; classifier on the corpus (clean) and noisy
    copies of it; hifigan, its eval wav. For each: step ms (median after
    NEW_WARM), samples/s, model FLOPs a step (FlopCounterMode over one
    step's trained forward and backward, the frozen pass subtracted) and
    their share of 989 TFLOP/s bf16, peak memory, K3 launches against the
    expected count. Then the diffusion checkpoint restored bit for bit
    (the sampler's history and counts included), a --resume run, and
    DIFF_OVERFIT_STEPS steps on one repeated batch, whose loss at fixed
    draws must fall below DIFF_OVERFIT_RATIO of its start. Returns K3's
    rows at the diffusion and hifigan trainers' N."""
    from xtts_tpu_torch.data.audio import load_wav, save_wav
    from xtts_tpu_torch.data.datasets import (HifiGANDataset, batch_iterator,
                                              collate_bucketed, read_filelist)
    from xtts_tpu_torch.data.prepare import cache_mels
    from xtts_tpu_torch.dsp.mel import SPEAKER_ENCODER_MEL_CONFIG, MelFrontend
    from xtts_tpu_torch.ops import vq
    from xtts_tpu_torch.train import cli, steps
    from xtts_tpu_torch.train.trainer import Trainer
    from xtts_tpu_torch.utils.registry import load_model

    root, runs, cfg = ctx["root"], ctx["runs"], ctx["cfg"]
    entries, common = ctx["entries"], ctx["common"]
    fz = ["--dvae-weights", str(ctx["vq"]), "--gpt-weights", str(ctx["gpt"])]
    t_new = time.perf_counter()
    voc = runs / "vocos.pth"
    torch.save(load_model("vocos", cfg).state_dict(), voc)
    rng = np.random.default_rng(13)
    noisy = []
    for i, e in enumerate(entries[:8]):
        w, _ = load_wav(e.wav_path, SR)
        path = str(root / f"noisy{i:02d}.wav")
        save_wav(path, (w + 0.3 * rng.standard_normal(w.size)
                        ).astype(np.float32))
        noisy.append(path)
    cache_mels(noisy, MelFrontend(cfg.mel, "cuda"))
    clean = [e.wav_path for e in entries]
    for name, paths in (("clean.txt", clean), ("clean_val.txt", clean[1::2]),
                        ("noise.txt", noisy)):
        (root / name).write_text("\n".join(paths) + "\n")
    n_evals = NEW_STEPS // TRAIN_VAL_FREQ
    fams = {
        "diffusion": (["diffusion", "-m", str(runs / "diffusion"),
                       "--vocos-weights", str(voc), "--timestep-sampler",
                       "loss_second_moment"] + fz + common,
                      # a step, then each eval: 1 val batch + the render
                      NEW_STEPS + n_evals * 2),
        "clvp": (["clvp", "-m", str(runs / "clvp")] + common, 0),
        "classifier": (["classifier", "-m", str(runs / "classifier"), "-c",
                        str(root / "cfg.json"), "--filelist",
                        str(root / "clean.txt"), "--noise-filelist",
                        str(root / "noise.txt"), "--val-filelist",
                        str(root / "clean_val.txt")], 0),
        "hifigan": (["hifigan", "-m", str(runs / "hifigan")] + fz + common,
                     NEW_STEPS + n_evals)}
    stats = {}
    for fam, (argv, want_k3) in fams.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated() / 2 ** 30
        launches.reset()
        t0 = time.perf_counter()
        st = cli.main(argv + ["--steps", str(NEW_STEPS)],
                      tokenizer=StandInTokenizer())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = launches.read()["vq_nearest"]
        check(st.step == NEW_STEPS, f"[train] {fam} ended at {st.step}")
        check(got == want_k3, f"[train] {fam}: K3 launched {got} times, "
              f"want {want_k3}")
        recs = [json.loads(x) for x in (runs / fam / "logs" /
                                        "metrics.jsonl").read_text()
                .splitlines()]
        key = "g_loss" if fam == "hifigan" else "loss"
        losses = [r[key] for r in recs if key in r]
        evals = [r["eval/loss"] for r in recs if "eval/loss" in r]
        check(len(losses) == NEW_STEPS and all(map(math.isfinite, losses))
              and all(map(math.isfinite, evals))
              and len(evals) == (0 if fam == "hifigan" else n_evals),
              f"[train] {fam} losses {losses} evals {evals}")
        stats[fam] = dict(wall=wall, k3=got, losses=losses, evals=evals,
                          peak=torch.cuda.max_memory_allocated() / 2 ** 30,
                          resident=resident,
                          step_s=_step_times(runs / fam / "logs" /
                                             "metrics.jsonl", NEW_WARM))
        del st        # its parameters and moments, before the next family
        torch.cuda.empty_cache()

    # the hifigan step's model FLOPs and K3 at its rows, on one batch
    flops, k3_rows = {}, []
    hds = HifiGANDataset(read_filelist(str(root / "train.txt")),
                         StandInTokenizer(), MelFrontend(cfg.mel, "cuda"),
                         MelFrontend(SPEAKER_ENCODER_MEL_CONFIG, "cuda"),
                         sample_rate=cfg.mel.sample_rate, seed=cfg.train.seed)
    hb = next(batch_iterator(hds, 8, lambda ss: collate_bucketed(
        ss, {"text": 0, "refer_mel16": 0},
        {"text": (64, 128, 304), "refer_mel16": (100, 200, 300)}),
        seed=cfg.train.seed))
    hb = cli.to_device({k: v for k, v in hb.items()
                        if not k.startswith("text")}, "cuda")
    gt, gs, gen_fn = cli.build_gan_trainer(cfg, str(ctx["gpt"]),
                                           str(ctx["vq"]), "cuda")
    frozen = counted_flops(torch, lambda: gen_fn.latent_of(hb))
    flops["hifigan"] = counted_flops(torch, lambda: gt.step(gs, hb)) - frozen
    dv = load_model("vqvae", cfg, str(ctx["vq"]))
    with torch.no_grad():
        xx = dv.encode(hb["mel"]).reshape(-1, 512).contiguous()
    k3_rows.append(k3_train_row(torch, vq, xx, dv.codebook.embed, "hifigan",
                                card))
    del gt, gs, gen_fn, dv, hb
    torch.cuda.empty_cache()
    # the diffusion checkpoint: restored bit for bit, the sampler included
    d_dir = runs / "diffusion"
    argv = fams["diffusion"][0]
    args = cli.parser().parse_args(argv)
    loss_fn, module, dctx = cli.build_loss("diffusion", cfg, args, "cuda")
    tr = Trainer(module, loss_fn, cfg.train, accum_steps=1,
                 checkpoint_dir=str(d_dir / "ckpt"))
    state = tr.restore(tr.init_state())
    saved = torch.load(d_dir / "ckpt" / f"{NEW_STEPS}.pt",
                       map_location="cpu", weights_only=True)
    live = Trainer.payload(state)
    n_t = 0
    for group in ("params", "state_cols"):
        for k, v in live[group].items():
            check(torch.equal(v.cpu(), saved[group][k]), f"restored {k}")
            n_t += 1
    for mom in ("mu", "nu"):
        for k, v in live["opt_state"][mom].items():
            check(torch.equal(v.cpu(), saved["opt_state"][mom][k]),
                  f"restored {mom} {k}")
            n_t += 1
    hist = saved["state_cols"]["t_sampler.counts"]
    check(state.step == saved["step"] == NEW_STEPS
          and int(hist.sum()) == 8 * (NEW_STEPS), f"restored diffusion step "
          f"{state.step}, sampler counts {int(hist.sum())}")

    # one repeated batch: the loss at fixed draws before and after
    ds = cli.build_dataset("diffusion", cfg, str(root / "train.txt"),
                           StandInTokenizer(), cfg.train.seed, "cuda")
    batch = cli.to_device(cli.adapt_batch("diffusion", next(batch_iterator(
        ds, 8, cli.build_collate("diffusion", cfg), seed=99))), "cuda")
    from xtts_tpu_torch.models.aa_diffusion import normalize_tacotron_mel
    draws = steps.diffusion_draws(
        module, training_process(cfg), normalize_tacotron_mel(
            batch["mel"]), normalize_tacotron_mel(batch["refer_mel"]),
        torch.Generator().manual_seed(5), 0.1)
    draws = {k: v.cuda() for k, v in draws.items()}
    # the step's model FLOPs at this batch, and K3 at its rows
    latent_of = steps.diffusion_latent_fn(dctx["gpt"], dctx["dvae"])
    flops["diffusion"] = counted_flops(
        torch, lambda: loss_fn(batch, None, draws=draws)[0].backward()
    ) - counted_flops(torch, lambda: latent_of(batch))
    module.zero_grad(set_to_none=True)
    with torch.no_grad():
        xx = dctx["dvae"].encode(batch["mel"]).reshape(-1, 512).contiguous()
    k3_rows.insert(0, k3_train_row(torch, vq, xx, dctx["dvae"].codebook.embed,
                                   "diffusion", card))
    with torch.no_grad():
        before = float(loss_fn(batch, None, draws=draws)[0])
    gen = torch.Generator("cuda").manual_seed(1)
    launches.reset()
    for _ in range(DIFF_OVERFIT_STEPS):
        state, m = tr.step(state, batch, gen)
    with torch.no_grad():
        after = float(loss_fn(batch, None, draws=draws)[0])
    check(launches.read()["vq_nearest"] == DIFF_OVERFIT_STEPS + 1,
          "[train] diffusion overfit: K3 once a step")
    check(math.isfinite(after) and after <= DIFF_OVERFIT_RATIO * before,
          f"[train] diffusion loss on one repeated batch at fixed draws "
          f"{before:.4f} -> {after:.4f}: ratio {after / before:.3f} > "
          f"{DIFF_OVERFIT_RATIO}")
    del tr, state, module, loss_fn, batch, dctx, latent_of
    torch.cuda.empty_cache()

    launches.reset()
    st = cli.main(argv + ["--resume", "--steps", str(NEW_STEPS + 2)],
                  tokenizer=StandInTokenizer())
    recs = [json.loads(x) for x in (d_dir / "logs" / "metrics.jsonl")
            .read_text().splitlines()]
    after_steps = [r["step"] for r in recs if "loss" in r][NEW_STEPS:]
    counts = int(st.state_cols["t_sampler.counts"].sum())
    check(st.step == NEW_STEPS + 2
          and after_steps == [NEW_STEPS + 1, NEW_STEPS + 2]
          and launches.read()["vq_nearest"] == 2
          and counts == 8 * (NEW_STEPS + 2),
          f"[train] diffusion --resume ran steps {after_steps}, sampler "
          f"counts {counts}")
    for fam, s in stats.items():
        med = statistics.median(s["step_s"])
        fl = flops.get(fam)
        mfu = (f"model FLOPs {fl / 1e12:.3f} TFLOP a step (FlopCounterMode, "
               f"the frozen pass subtracted), "
               f"{100 * fl / med / PEAK['bf16']:.2f}% of "
               f"{PEAK['bf16'] / 1e12:.0f} TFLOP/s bf16" if fl else
               "model FLOPs not counted")
        log(f"[train] {fam}: {NEW_STEPS} steps in {s['wall']:.2f} s (with "
            f"{n_evals} eval and the save); step {1e3 * med:.1f} ms "
            f"median over steps {NEW_WARM + 1}-{NEW_STEPS} (the loader "
            f"included), {8 / med:.1f} samples/s; {mfu}; peak memory "
            f"{s['peak']:.2f} GiB ({s['resident']:.2f} resident before the "
            f"run); loss {s['losses'][0]:.4f} -> "
            f"{s['losses'][-1]:.4f}"
            + (f", eval {', '.join(f'{e:.4f}' for e in s['evals'])}"
               if s["evals"] else "")
            + f"; K3 {s['k3']} launches (want {fams[fam][1]})  [{card}]")

    log(f"[train] diffusion resume: the checkpoint of step {NEW_STEPS} "
        f"restored on the card equal to the saved one bit for bit ({n_t} "
        f"tensors: parameters, Adam moments, the loss_second_moment "
        f"history and counts); --resume ran steps {after_steps}, sampler "
        f"counts {counts}; one repeated batch of 8, {DIFF_OVERFIT_STEPS} "
        f"steps: loss at fixed draws {before:.4f} -> {after:.4f} (ratio "
        f"{after / before:.3f}, bound {DIFF_OVERFIT_RATIO}); the later "
        f"families' part of the phase {time.perf_counter() - t_new:.1f} s  "
        f"[{card}]")
    return k3_rows


def flash_train_run(torch, np, launches, card, ctx, heads=None,
                    n_steps=FLASH_STEPS, dtype=None):
    """[train], K2's backward at the lengths the decoder renders: the
    diffusion model fine-tuned through the objects the JAX API exposes
    (DiffusionDataset(max_mel=1280, max_refer=300) over [train]'s 8-12 s
    wavs, AADiffusion(bf16, flash=True), make_diffusion_loss, Trainer),
    `n_steps` steps at batch 8 on the vqvae / gpt exports; every step
    launches K2's forward and both backward kernels once for each gated
    consumer attention (counts and (Tq, Tk) printed). Then the same steps
    on the same batches with flash=False (the einsum attention) from the
    same weights. For both: step ms (median after FLASH_WARM), samples/s,
    model FLOPs a step (FlopCounterMode, the frozen pass subtracted; K2's
    launches are invisible to it, so 12 B Tq Tk H D is added for each
    gated attention: forward 4, backward 8) and MFU, peak memory, the
    losses. heads: the UNet's attention heads (its model_channels / heads
    wide), else the configuration's; dtype: the trained model's compute
    dtype, else the configuration's (cli.train_dtype)."""
    from xtts_tpu_torch.data.audio import load_wav
    from xtts_tpu_torch.data.datasets import (DiffusionDataset, MelCache,
                                              batch_iterator)
    from xtts_tpu_torch.dsp.mel import MelFrontend
    from xtts_tpu_torch.models import aa_diffusion as tad
    from xtts_tpu_torch.nn import flash_attn as fa
    from xtts_tpu_torch.nn.blocks import init_flax_like
    from xtts_tpu_torch.train import cli, steps
    from xtts_tpu_torch.train.trainer import Trainer

    t_run = time.perf_counter()
    cfg = ctx["cfg"]
    dt = cli.train_dtype(cfg) if dtype is None else dtype
    kind = {torch.bfloat16: "bf16", torch.float32: "f32"}[dt]
    dcfg = (cfg.diffusion if cfg.train.remat == "none"
            else cfg.diffusion.replace(remat=cfg.train.remat))
    if heads is not None:
        dcfg = dcfg.replace(num_heads=heads)
    width = dcfg.model_channels // dcfg.num_heads
    long = [e for e in ctx["entries"]
            if 8.0 <= load_wav(e.wav_path, SR)[0].size / SR <= 12.0]
    check(len(long) >= 4, f"[train] flash: {len(long)} wavs of 8-12 s")
    ds = DiffusionDataset(long * 2, MelCache(MelFrontend(cfg.mel, "cuda"),
                                             cfg.mel.sample_rate),
                          StandInTokenizer(), max_mel=1280, max_refer=300,
                          mel_hop=cfg.mel.hop_length, seed=21)
    it = batch_iterator(ds, 8, cli.build_collate("diffusion", cfg), seed=21)
    batches = [cli.to_device(cli.adapt_batch("diffusion", next(it)), "cuda")
               for _ in range(n_steps)]
    g = torch.Generator("cuda").manual_seed(0)
    gpt = cli._frozen("gpt", cfg, str(ctx["gpt"]), "cuda", g)
    dvae = cli._frozen("vqvae", cfg, str(ctx["vq"]), "cuda", g)
    gd = training_process(cfg)
    base = tad.AADiffusion(dcfg, dt).cuda()
    init_flax_like(base, torch.Generator("cuda").manual_seed(1))
    weights = {k: v.clone() for k, v in base.state_dict().items()}
    del base
    shapes = []
    plain_mha = tad.flash_mha

    def recorded(q, k, v, scale):
        shapes.append((q.shape[0], q.shape[1], k.shape[1]))
        return plain_mha(q, k, v, scale)

    stats = {}
    tad.flash_mha = recorded
    try:
        for flash in (True, False):
            model = tad.AADiffusion(dcfg, dt, flash=flash).cuda()
            model.load_state_dict(weights)
            loss_fn = steps.make_diffusion_loss(
                model, gd, gpt, dvae, cfg.diffusion.unconditioned_percentage)
            tr = Trainer(model, loss_fn, cfg.train, accum_steps=1)
            st = tr.init_state()
            gen = torch.Generator("cuda").manual_seed(2)
            times, counts, losses = [], [], []
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for b in batches:
                launches.reset()
                shapes.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st, m = tr.step(st, b, gen)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                d = launches.read()
                k2 = (d["flash_mha"], d["flash_mha_bwd_dkv"],
                      d["flash_mha_bwd_dq"])
                gated = [sh for sh in shapes if fa.use_flash(*sh[1:])]
                if flash:
                    # remat recomputes the forward: K2's forward once or
                    # twice a gated call, each backward kernel once
                    n = len(gated) // (1 if dcfg.remat == "none" else 2)
                    check(n > 0 and k2[1] == k2[2] == n and k2[0] >= n,
                          f"[train] flash step: K2 {k2} for {n} gated "
                          f"attentions {gated}")
                else:
                    check(k2 == (0, 0, 0), f"[train] flash=False step: K2 "
                          f"{k2}")
                counts.append((k2, sorted(set(gated))))
                losses.append(float(m["loss"]))
                check(math.isfinite(losses[-1]), f"[train] loss {losses}")
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            latent_of = steps.diffusion_latent_fn(gpt, dvae)
            shapes.clear()
            fl = counted_flops(torch, lambda: loss_fn(batches[0], gen)[0]
                               .backward()) - counted_flops(
                torch, lambda: latent_of(batches[0]))
            model.zero_grad(set_to_none=True)
            added = 0
            if flash:
                n = len(shapes) // (1 if dcfg.remat == "none" else 2)
                added = sum(12 * b * q * k * dcfg.model_channels
                            for b, q, k in shapes[:n] if fa.use_flash(q, k))
            stats[flash] = dict(times=times, counts=counts, losses=losses,
                                peak=peak, flops=fl + added, added=added)
            del model, tr, st, loss_fn
            torch.cuda.empty_cache()
    finally:
        tad.flash_mha = plain_mha
    peak_kind = "bf16" if kind == "bf16" else "tf32"
    for flash in (True, False):
        s_ = stats[flash]
        med = statistics.median(s_["times"][FLASH_WARM:])
        per = "; ".join(f"{k2[0]}/{k2[1]}/{k2[2]} at "
                        f"{', '.join(f'{q} | {k}' for _, q, k in sh)}"
                        for k2, sh in s_["counts"])
        log(f"[train] diffusion flash={flash} ({dcfg.num_heads} heads of "
            f"{width}, {kind}, batch 8, crops 1280 | 300 of {len(long)} wavs "
            f"of 8-12 s): {n_steps} steps, step "
            f"{1e3 * med:.1f} ms median over steps {FLASH_WARM + 1}-"
            f"{n_steps} ("
            + ", ".join(f"{1e3 * t:.1f}" for t in s_["times"]) +
            f" ms), {8 / med:.2f} samples/s; model FLOPs "
            f"{s_['flops'] / 1e12:.3f} TFLOP a step"
            + (f" ({s_['added'] / 1e12:.3f} of them K2's, added)"
               if flash else "")
            + f", {100 * s_['flops'] / med / PEAK[peak_kind]:.2f}% of "
            f"{PEAK[peak_kind] / 1e12:.0f} TFLOP/s {peak_kind}; peak memory "
            f"{s_['peak']:.2f} GiB; loss "
            f"{', '.join(f'{x:.4f}' for x in s_['losses'])}"
            + (f"; K2 fwd/dkv/dq a step at (Tq | Tk): {per}" if flash
               else "") + f"  [{card}]")
    gap = max(abs(a - b) / max(abs(b), 1e-6) for a, b in
              zip(stats[True]["losses"], stats[False]["losses"]))
    if kind == "f32":
        check(gap <= FLASH_F32_LOSS_TOL, f"[train] f32 flash losses "
              f"{stats[True]['losses']} against {stats[False]['losses']}")
    log(f"[train] the flash comparison at {dcfg.num_heads} heads of {width}"
        f" ({kind}): losses within {gap:.2e} of flash=False's, relative "
        f"(f32 bound {FLASH_F32_LOSS_TOL}); took "
        f"{time.perf_counter() - t_run:.1f} s  [{card}]")


def training_process(cfg):
    """The training process of cfg.diffusion_process."""
    from xtts_tpu_torch.diffusion.gaussian import (GaussianDiffusion,
                                                   get_named_beta_schedule)
    dp = cfg.diffusion_process
    return GaussianDiffusion(betas=get_named_beta_schedule(dp.schedule,
                                                           dp.timesteps))


class Launches:
    """The launch counters of every kernel wrapper, the step counters of the
    K1 and K4 chains, and, as "<kernel>+ln", the launches of a product with
    the norm prologue, as "flash_mha+f32" those of K2's f32 forward (both
    also counted in their kernel's total). Around one main
    path every count is set to 0 before it (`reset`) and read after it."""

    def __init__(self, wrappers):
        self.wrappers = wrappers
        self.total = {name: 0 for name in self.read(add=False)}

    VARIANTS = (("ln_launches", "+ln"), ("f32_launches", "+f32"))

    def reset(self):
        for fn in self.wrappers:
            fn.launches = 0
            for attr, _ in self.VARIANTS:
                if hasattr(fn, attr):
                    setattr(fn, attr, 0)

    def read(self, add: bool = True):
        got = {fn.__name__: fn.launches for fn in self.wrappers}
        for attr, tag in self.VARIANTS:
            got.update({fn.__name__ + tag: getattr(fn, attr)
                        for fn in self.wrappers if hasattr(fn, attr)})
        if add:
            for k, v in got.items():
                self.total[k] += v
        return got


def vq_agree(torch, xx, ee, got, want, tag: str):
    """K3's codes `got` against `want` for rows xx (N, D) and codebook ee
    (D, E): equal, except where the two picks' distances recomputed in f64
    lie within the fp32 error bound of one D-term dot product, 4 D 2^-24
    (2 sum|x||e| + |e|^2) (tests/test_torch_port_kernels.py:_vq_agree).
    Returns (rows that differ, the largest f64 gap among them)."""
    x64, e64 = xx.double(), ee.double()
    bad = (got != want).nonzero().flatten().tolist()
    worst = 0.0
    for r in bad:
        picks = torch.tensor([int(got[r]), int(want[r])], device=xx.device)
        ep = e64[:, picks]
        dist = (ep * ep).sum(0) - 2 * x64[r] @ ep
        lim = 4 * xx.shape[1] * 2.0 ** -24 * (
            2 * (x64[r].abs()[:, None] * ep.abs()).sum(0)
            + (ep * ep).sum(0)).max()
        gap = (dist[0] - dist[1]).abs().item()
        check(gap <= lim, f"{tag} row {r}: picks {picks.tolist()} differ "
              f"by {gap:.3e} in f64 > bound {lim.item():.3e}")
        worst = max(worst, gap)
    return len(bad), worst


def k3_checks(torch, vq, x, emb, results, card):
    """K3 on the DVAE's own logits (N 3008 x D 512) and codebook (E 8192),
    a ragged shape, and a planted tie. Codes must equal the plain twin's,
    except where the two picks' distances recomputed in f64 lie within the
    fp32 error bound of one D-term dot product, 4 D 2^-24 (2 sum|x||e| +
    |e|^2) (tests/test_torch_port_kernels.py:_vq_agree): the two sum in
    another order (the kernel's products in 3xTF32 on the tensor cores), so
    a near tie may break either way. Counted."""
    g = torch.Generator(device="cuda").manual_seed(31)
    cases = [("path", x, emb),
             ("ragged", torch.randn(1001, 512, generator=g, device="cuda"),
              torch.randn(512, 8000, generator=g, device="cuda"))]
    for name, xx, ee in cases:
        got = vq.vq_nearest(xx, ee)
        want = vq.vq_nearest_plain(xx, ee)
        n_diff, gap = vq_agree(torch, xx, ee, got, want, f"K3 {name}")
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



def chain_picks(torch, tts, qt, cond_mel, texts, codes, lens, max_gen):
    """Teacher-forced greedy picks of the B=1 int8 chain along the slot
    pool's codes: for each request, its pool codes are fed one by one and
    the chain's argmax after each is taken (the first pick is the prefill's
    argmax). Two arms: the chain as it is (products summed in f32) and the
    noise floor, the same chain with its products summed in float64 (P3's
    floors: the plain step against itself on float64 sums). One step of
    each arm is one CUDA graph on static buffers (every request pads to one
    text bucket, so one prefix length). Returns the picks of both arms."""
    from xtts_tpu_torch.infer import qdecode as qd
    from xtts_tpu_torch.models.gpt_infer import mel_pos_offset
    from xtts_tpu_torch.nn.transformer import KVCache
    gcfg = tts.cfg.gpt
    heads = gcfg.heads
    floor_qdot = qdot64(torch)
    prefix0, _ = tts.gpt.encode_prefix(cond_mel, texts[0])
    p_len = prefix0.shape[1]
    tok = torch.zeros(1, dtype=torch.long, device="cuda")
    mel_pos = torch.zeros((), dtype=torch.long, device="cuda")
    index = torch.zeros((), dtype=torch.long, device="cuda")
    arms = []
    for f64 in (False, True):
        cache = KVCache.zeros(gcfg.layers, 1, p_len + max_gen + 1, heads,
                              gcfg.model_dim // heads, device="cuda")
        pick = torch.zeros((), dtype=torch.long, device="cuda")

        def step(cache=cache, pick=pick):
            lg, _ = qd._decode_logits(qt, heads, tok, mel_pos, cache, index)
            pick.copy_(lg[0].argmax())
        orig = qd.qdot
        qd.qdot = floor_qdot if f64 else orig   # the floor arm
        try:
            step()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                step()
        finally:
            qd.qdot = orig
        arms.append((cache, pick, graph))
    out = ([], [])
    for r, text in enumerate(texts):
        prefix, n_cond = tts.gpt.encode_prefix(cond_mel, text)
        check(prefix.shape[1] == p_len, "[slots] prefix lengths differ")
        off = mel_pos_offset(gcfg, n_cond)
        for a, (cache, pick, graph) in enumerate(arms):
            cache.k.zero_()
            cache.v.zero_()
            logits0, _ = tts.gpt.prefill(prefix, cache)
            picks = torch.empty(lens[r], dtype=torch.long, device="cuda")
            picks[0] = logits0[0].float().argmax()
            for t in range(lens[r] - 1):
                tok.fill_(int(codes[r][t]))
                mel_pos.fill_(t + off)
                index.fill_(p_len + t)
                graph.replay()
                picks[t + 1].copy_(pick)
            out[a].append(picks.cpu().numpy())
    return out


def slots_phase(torch, np, tts, cond_wav, cond_mel, text, launches, cfg,
                card):
    """Continuous serving (infer/slots.py) at the flagship width on
    [main]'s model: the int8 tree's per-layer chain with one cache position
    a row, as the JAX package's slots run (not K1 or K4). 24 requests of
    distinct text (50 token ids, shifted by 7 a request) through a pool of
    16 slots, segments of 32 steps, max_gen 300, the stop logit's bias
    raised (SLOTS_STOP_BIAS) so rows stop at spread steps and installs land
    in recycled slots mid-stream.
      * greedy: the pool's codes; its first SLOTS_EAGER_SEGMENTS segments
        (the capture and the first installs into recycled slots) against
        the same segments run eagerly (device_loop.eager()), equal; then
        every request held against the B=1 chain teacher-forced along its
        first CHAIN_PICKS codes, its differing picks bounded by the float64
        floor's count (chain_picks): 2 x floor + 2;
      * seeded sampling: ContinuousBatcher.submit of the 24 requests with
        seeds, rendered through the diffusion (K2): requests a second,
        audio-s/s, AR tokens/s, occupancy, latency, host reads a segment,
        capture ms, peak memory; then the longest request again with two
        others in the same pool, now empty: its codes identical, its
        waveform within WAV_SLOTS_TOL of its peak (the render rung may
        differ between the two runs), and once more so when its render
        runs alone under torch.profiler (flash_mha's launches == the
        trace's). The check
        keeps the pool's size: cuBLAS rounds a row's logits by the row
        count, so a pool of another size samples from other logits' last
        bits. The request once more alone in a pool of 4 slots shows that
        known difference (logged, not checked);
      * the HTTP layer (backend="slots", a pool of 2) on loopback:
        /healthz, /metrics;
      * [serving]'s BatchServer (the chain engine, waves of 16) on the same
        24 texts as the comparator: unseeded, so it decodes other codes;
        both runs' renders are timed (serving.render_rows), so AR tokens/s
        and render seconds are set side by side, not audio-s/s alone."""
    import urllib.request

    from xtts_tpu_torch.infer import device_loop as dl
    from xtts_tpu_torch.infer import serving
    from xtts_tpu_torch.infer.api import TTSSettings
    from xtts_tpu_torch.infer.http import SynthesisService, serve
    from xtts_tpu_torch.infer.slots import (RENDER_FOLD, ContinuousBatcher,
                                            SlotDecoder, fold_seed)
    t_phase = time.perf_counter()

    def slog(msg):
        log(f"{msg}  (+{time.perf_counter() - t_phase:.1f} s of the phase)  "
            f"[{card}]")
    gcfg = cfg.gpt
    stop, max_gen, n_req, n_slots, seg = gcfg.stop_mel_token, 300, 24, 16, 32
    qt = tts._qtree
    tok = torch.as_tensor(text[0], dtype=torch.long)
    texts = [(3 + (tok - 3 + 7 * i) % 247).numpy() for i in range(n_req)]
    old_bias = float(qt["mel_head_b"][stop])
    settings = TTSSettings(max_mel_tokens=max_gen)

    def set_stop_bias(b):
        qt["mel_head_b"][stop] = b
        tts.gpt.mel_head.bias[stop] = b

    render_rows = serving.render_rows
    dec = SlotDecoder(tts, n_slots=n_slots, max_gen=max_gen,
                      segment_len=seg, settings=settings)
    rows = [torch.as_tensor(dec.pad_text(t), device="cuda")[None]
            for t in texts]

    def drive(dec, greedy=True, stop_at=None):
        """The 24 requests through the pool; after |stop_at| segments, a
        device copy of the pool's (codes, gen, done) as well, and with a
        negative stop_at the run ends there."""
        pending, slot_req, out = list(range(n_req)), {}, {}
        mid, segments, snap = 0, 0, None
        for s in range(n_slots):
            i = pending.pop(0)
            dec.install(s, dec.pad_text(texts[i]), cond_mel, seed=2000 + i)
            slot_req[s] = i
        while slot_req:
            done, gen = dec.run_segment(greedy=greedy)
            segments += 1
            if segments == abs(stop_at or 0):
                snap = [t.clone() for t in (dec.state.codes, dec.state.gen,
                                            dec.state.done)]
                if stop_at < 0:
                    break
            fin = [s for s in slot_req if done[s]]
            if fin:
                codes = dec.fetch_codes()
                for s in fin:
                    i = slot_req.pop(s)
                    out[i] = (codes[s].copy(), int(gen[s]))
                    if pending:
                        j = pending.pop(0)
                        mid += bool(slot_req)       # others still decode
                        dec.install(s, dec.pad_text(texts[j]), cond_mel,
                                    seed=2000 + j)
                        slot_req[s] = j
        return out, segments, mid, snap

    try:
        # ---- greedy: graphs == eager; the B=1 chain's picks ----
        set_stop_bias(SLOTS_STOP_BIAS["greedy"])
        k_e = SLOTS_EAGER_SEGMENTS
        runs = []
        for graphs in (True, False):
            dec.reset()
            dl.STATS.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.nullcontext() if graphs else dl.eager():
                got = drive(dec, stop_at=k_e if graphs else -k_e)
            torch.cuda.synchronize()
            runs.append((got, time.perf_counter() - t0, dl.STATS.captures,
                         dl.STATS.capture_ms, dl.STATS.syncs))
        (g_out, segs, mid, g_snap), t_g, caps, cap_ms, syncs = runs[0]
        _, e_segs, e_mid, e_snap = runs[1][0]
        lens = [g_out[i][1] for i in range(n_req)]
        check(e_segs == k_e and all(torch.equal(a, b)
                                    for a, b in zip(g_snap, e_snap)),
              f"[slots] graph codes != eager codes over the first {k_e} "
              f"segments")
        check(e_mid >= 1, f"[slots] greedy: no install into a recycled "
              f"slot mid-stream in the first {k_e} segments")
        check(mid >= 4, f"[slots] greedy: {mid} installs into recycled "
              f"slots mid-stream (lengths {lens})")
        steps = segs * seg
        slog(f"[slots] greedy pool, 16 slots x segments of {seg}: 24 "
            f"requests, lengths {min(lens)}-{max(lens)} ({len(set(lens))} "
            f"distinct, {sum(lens)} tokens), {mid} installs into recycled "
            f"slots mid-stream; graph run {t_g:.3f} s ({segs} segments, "
            f"{1e3 * t_g / steps:.2f} ms a pool step, {sum(lens) / t_g:.1f} "
            f"tokens/s; {caps} capture(s) in {cap_ms:.1f} ms, "
            f"{syncs / segs:.2f} host reads a segment); its first {k_e} "
            f"segments ({e_mid} installs into recycled slots) run eagerly "
            f"in {runs[1][1]:.3f} s: codes, counts and done flags equal "
            f"the graphs'")
        codes = [g_out[i][0] for i in range(n_req)]
        forced = [min(n, CHAIN_PICKS) for n in lens]
        t0 = time.perf_counter()
        p32, p64 = chain_picks(torch, tts, qt, cond_mel, rows, codes, forced,
                               max_gen)
        diff = [int((p != c[:n]).sum())
                for p, c, n in zip(p32, codes, forced)]
        floor = [int((a != b).sum()) for a, b in zip(p32, p64)]
        bound = 2 * sum(floor) + 2
        slog(f"[slots] greedy pool codes against the B=1 chain, teacher-"
            f"forced over each request's first {CHAIN_PICKS} picks "
            f"({sum(forced)} picks, {time.perf_counter() - t0:.1f} s): "
            f"{sum(diff)} differ (per request {diff}); floor, the chain "
            f"against itself on float64 sums: {sum(floor)} (per request "
            f"{floor}); bound 2 x floor + 2 = {bound}")
        check(sum(diff) <= bound, f"[slots] {sum(diff)} differing picks > "
              f"bound {bound}")

        # ---- seeded sampling through the batcher, diffusion render ----
        renders = []            # (seconds, AR tokens of its rows) a render

        def timed_render(*args, **kw):    # instrumentation: the pool's and
            t_r = time.perf_counter()       # the waves' renders alike
            out = render_rows(*args, **kw)
            renders.append((time.perf_counter() - t_r, int(args[5].sum())))
            return out

        def recording(cb, into):
            render = cb._render

            def wrapper():       # instrumentation: each request's codes
                for p, c, n in cb._finished:
                    into[p.seed] = (c.copy(), n)
                render()
            cb._render = wrapper
            return cb

        def run_batcher(cb, idx, lat):
            """Submit requests idx (seeded) and wait for their waveforms."""
            futs = []
            for i in idx:
                t_sub = time.perf_counter()
                f = cb.submit(texts[i], seed=1000 + i)
                f.add_done_callback(lambda _f, t=t_sub: lat.append(
                    time.perf_counter() - t))
                futs.append(f)
            return [f.result(timeout=900) for f in futs]

        set_stop_bias(SLOTS_STOP_BIAS["sampled"])
        serving.render_rows = timed_render
        launches.reset()
        dl.STATS.reset()
        torch.cuda.reset_peak_memory_stats()
        crowd = {}
        cb = recording(ContinuousBatcher(
            tts, cond_mel, settings, n_slots=n_slots, segment_len=seg,
            use_diffusion=True), crowd)
        try:
            lat = []
            t0 = time.perf_counter()
            wavs = run_batcher(cb, range(n_req), lat)
            wall = time.perf_counter() - t0
            st = cb.stats()
            got = launches.read()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            r_pool, n_rend = sum(r for r, _ in renders), len(renders)
            ar_s = wall - r_pool
            per = cfg.vqvae.compression * cfg.vocos.hop_length
            check(all(w.ndim == 1 and w.size > 0 and w.size % per == 0
                      and bool(np.isfinite(w).all()) for w in wavs),
                  "[slots] waveforms not finite 1-D code multiples")
            check(st["completed"] == n_req and st["failed"] == 0,
                  f"[slots] stats {st}")
            s_lens = sorted(n for _, n in crowd.values())
            check(len(set(s_lens)) >= 8 and s_lens[len(s_lens) // 2]
                  < max_gen, f"[slots] sampled stops not spread: {s_lens}")
            check(got["flash_mha"] > 0,
                  "[slots] K2 not launched by the render")
            check(got["fused_decode_logits"] == 0
                  and got["fused_serving_logits"] == 0,
                  f"[slots] the pool ran K1 / K4 steps: {got}")
            audio = sum(w.size for w in wavs) / SR
            lat = sorted(lat)
            slog(f"[slots] ContinuousBatcher, 24 seeded requests (sampled), "
                f"lengths {s_lens}, diffusion render: {wall:.3f} s, "
                f"{n_req / wall:.2f} requests/s, "
                f"{audio:.2f} s audio = {audio / wall:.2f} audio-s/s, "
                f"{st['tokens']} AR tokens = {st['tokens'] / wall:.1f} "
                f"tokens/s aggregate; {n_rend} renders {r_pool:.3f} s "
                f"({r_pool / n_rend:.3f} s a render), the rest (segments, "
                f"installs, reads, the capture) {ar_s:.3f} s = "
                f"{st['tokens'] / ar_s:.1f} AR tokens/s, without the capture "
                f"{st['tokens'] / (ar_s - dl.STATS.capture_ms / 1e3):.1f}; "
                f"occupancy "
                f"{st['slot_occupancy']:.3f}, {st['segments']} segments, "
                f"{dl.STATS.syncs / max(st['segments'], 1):.2f} host reads "
                f"a segment; latency p50 {lat[len(lat) // 2]:.3f} s, max "
                f"{lat[-1]:.3f} s; {dl.STATS.captures} capture(s) in "
                f"{dl.STATS.capture_ms:.1f} ms; peak {peak:.2f} GiB; K2 "
                f"launches {got['flash_mha']}, K1 / K4 steps 0")

            # ---- the longest request again with two others in the same
            # pool, now empty ----
            order = sorted(range(n_req), key=lambda i: -crowd[1000 + i][1])
            x, mates = order[0], order[1:3]
            c_a, n_a = crowd[1000 + x]
            w_b = run_batcher(cb, [x] + mates, [])[0]
            c_b, n_b = crowd[1000 + x]
        finally:
            cb.close()
        check(n_a == n_b and np.array_equal(c_a, c_b),
              "[slots] seeded codes differ between the two compositions")
        w_a = wavs[x]
        peak_a = float(np.abs(w_a).max())

        def moved(w):
            return (float(np.abs(w_a - w).max()) if w_a.shape == w.shape
                    else float("inf"))
        ctrl = wavs[mates[0]][:w_a.size]
        slog(f"[slots] request {x} (seed {1000 + x}), among 24 requests and "
             f"among 3: {n_a} codes identical; waveform max |diff| "
             f"{moved(w_b):.3e} against its peak {peak_a:.3f} (tolerance "
             f"{WAV_SLOTS_TOL} x peak); request {mates[0]}'s waveform "
             f"differs from it by "
             f"{float(np.abs(w_a[:ctrl.size] - ctrl).max()):.3f}")
        check(moved(w_b) <= WAV_SLOTS_TOL * peak_a, "[slots] the seeded "
              "waveform moved with the pool's composition")

        # ---- its render once more, alone (one row), traced: its frames
        # reach K2's gate (Tq Tk >= 2^19). A trace of the pool's segments
        # would hold no counted kernel (the chain) ----
        alone = {}

        def render_x():
            alone["wav"] = serving.render_rows(
                tts, torch.as_tensor(dec.pad_text(texts[x])[None],
                                     device="cuda"),
                torch.as_tensor([len(texts[x])], device="cuda"), cond_mel,
                torch.as_tensor(c_a[None], device="cuda"), np.asarray([n_a]),
                settings, True, [torch.Generator("cuda").manual_seed(
                    fold_seed(1000 + x, RENDER_FOLD))])[0]
        hold_counts_to_trace(torch, render_x, launches, f"[slots] request "
                             f"{x}'s render, one row", card)
        slog(f"[slots] request {x}'s render alone (one row): waveform max "
             f"|diff| {moved(alone['wav']):.3e} against its peak")
        check(moved(alone["wav"]) <= WAV_SLOTS_TOL * peak_a, "[slots] the "
              "seeded waveform moved with the render's batch")

        # ---- the request once more, alone in a pool of 4 slots: a known
        # difference, not checked (cuBLAS rounds a row's logits by the
        # GEMM's row count, so a pool of another size samples from logits
        # that differ in their last bits) ----
        dec4 = SlotDecoder(tts, n_slots=4, max_gen=max_gen, segment_len=seg,
                           settings=settings)
        dec4.install(0, dec4.pad_text(texts[x]), cond_mel,
                     seed=fold_seed(1000 + x, 0))
        t0 = time.perf_counter()
        done = [False]
        while not done[0]:
            done, gen = dec4.run_segment()
        c4, n4 = dec4.fetch_codes()[0], int(gen[0])
        del dec4
        part = next((i for i in range(min(n4, n_a)) if c4[i] != c_a[i]),
                    None)
        slog(f"[slots] request {x} alone in a pool of 4 slots "
            f"({time.perf_counter() - t0:.3f} s): {n4} codes, "
            + ("identical to the 16-slot pool's" if part is None
               and n4 == n_a else f"parting from the 16-slot pool's "
               f"{n_a} at code {part if part is not None else min(n4, n_a)}")
            + f" (a known difference: cuBLAS row counts)")

        # ---- the HTTP layer over loopback ----
        svc = SynthesisService(tts, cond_wav, settings, max_batch=2,
                               use_diffusion=True, backend="slots")
        httpd = serve(svc, "127.0.0.1", 0)
        try:
            host, port = httpd.server_address[:2]
            got_http = {}
            for path in ("/healthz", "/metrics"):
                with urllib.request.urlopen(f"http://{host}:{port}{path}",
                                            timeout=60) as r:
                    got_http[path] = (r.status, json.loads(r.read()))
        finally:
            httpd.shutdown()
            svc.close()
        check(got_http["/healthz"] == (200, {"ok": True, "pending": 0})
              and got_http["/metrics"][0] == 200
              and "slot_occupancy" in got_http["/metrics"][1],
              f"[slots] HTTP answers {got_http}")
        slog(f"[slots] HTTP (backend slots, a pool of 2) on 127.0.0.1:{port}: "
            f"/healthz {got_http['/healthz']}, /metrics 200 with "
            f"{sorted(got_http['/metrics'][1])}")

        # ---- [serving]'s BatchServer on the same texts ----
        os.environ.pop("XTTS_FUSED_SERVING", None)
        renders.clear()
        dl.STATS.reset()
        server = serving.BatchServer(tts, cond_mel, settings,
                                     max_batch=n_slots, window_ms=200.0,
                                     use_diffusion=True)
        try:
            lat = []
            t0 = time.perf_counter()
            futs = []
            for i in range(n_req):
                t_sub = time.perf_counter()
                f = server.submit(texts[i])
                f.add_done_callback(lambda _f, t=t_sub: lat.append(
                    time.perf_counter() - t))
                futs.append(f)
            bw = [f.result(timeout=900) for f in futs]
            wall_b = time.perf_counter() - t0
            sb = server.stats()
        finally:
            server.close()
        audio_b = sum(w.size for w in bw) / SR
        r_b, tok_b = sum(r for r, _ in renders), sum(n for _, n in renders)
        lat = sorted(lat)
        slog(f"[slots] comparator: BatchServer (chain engine, max_batch 16, "
            f"window 200 ms), the same 24 texts unseeded, so other codes "
            f"than the pool's: {wall_b:.3f} s, {n_req / wall_b:.2f} "
            f"requests/s, {audio_b:.2f} s audio = {audio_b / wall_b:.2f} "
            f"audio-s/s, {sb['waves']} waves; {tok_b} AR tokens in the "
            f"{wall_b - r_b:.3f} s besides the renders = "
            f"{tok_b / (wall_b - r_b):.1f} tokens/s ({dl.STATS.captures} "
            f"capture(s) in {dl.STATS.capture_ms:.1f} ms); {len(renders)} "
            f"renders {r_b:.3f} s ({r_b / len(renders):.3f} s a render, "
            f"{r_b / n_req:.3f} s a request; the pool's "
            f"{r_pool / n_rend:.3f} and {r_pool / n_req:.3f}); latency p50 "
            f"{lat[len(lat) // 2]:.3f} s, max {lat[-1]:.3f} s")
        slog(f"[slots] phase {time.perf_counter() - t_phase:.1f} s")
    finally:
        serving.render_rows = render_rows
        set_stop_bias(old_bias)


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
    # every forward: flash_fwd_kernel, flash_fwd_tc_kernel<T, D>,
    # flash_fwd_wide_kernel<float>, flash_fwd_wgmma_wide<CPS, MQ>
    ("flash_mha", r"flash_fwd_(?:(?:tile_|tc_|wide_)?kernel|wgmma_wide)()"),
    ("flash_mha_bwd_dkv",
     r"flash_bwd_dkv_(?:(?:tile_|tc_)?kernel|wgmma_wide|f32_wide)()"),
    ("flash_mha_bwd_dq",
     r"flash_bwd_dq_(?:(?:tile_|tc_)?kernel|wgmma_wide|f32_wide)()"),
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
    """The model's own consumer attn1 projections at bucket 320, in the
    model's dtype: the flash kernel against plain attention on the same
    q/k/v (bf16: K2_TOL; f32: K2_F32_TOL, each doubled after to_out)."""
    attn = tts.diffusion.base_model.blocks[1][1].transformer_blocks[0].attn1
    g = torch.Generator(device="cuda").manual_seed(5)
    xa = torch.randn(2, 1280 + 282, 512, generator=g,
                     device="cuda").to(tts.dtype)
    q = attn.to_q(xa[:, :1280]).unflatten(-1, (8, 64))
    k = attn.to_k(xa).unflatten(-1, (8, 64))
    v = attn.to_v(xa).unflatten(-1, (8, 64))
    check(fa.use_flash(q.shape[1], k.shape[1]), "consumer gate closed")
    check(q.dtype == tts.dtype, f"consumer q {q.dtype}")
    o_k = attn.to_out[0](fa.flash_mha(q, k, v, 0.125).flatten(-2))
    o_p = attn.to_out[0](fa.flash_mha_plain(q, k, v, 0.125).flatten(-2))
    err = max_err(o_k, o_p)
    scale = o_p.float().abs().max().item()
    tol = K2_TOL if tts.dtype == torch.bfloat16 else K2_F32_TOL
    check(err <= 2 * tol * max(1.0, scale), f"consumer attn1 err {err}")
    log(f"[k2] consumer attn1 ({str(tts.dtype)[6:]} model weights, Tq 1280, "
        f"Tk 1562): flash vs plain after to_out max_abs_err {err:.3e} "
        f"(|out| max {scale:.3f}, bound {2 * tol} x max(1, |out|))")


def p9_check(torch, np, cfg, text, cond_wav, launches, card):
    """P9: TextToSpeech(XTTSConfig(), device="cuda") at its defaults (f32,
    the full-precision AR) renders a request at code bucket 320 through
    K2's f32 forward (flash_mha raised "takes bf16" there before): the
    stop logit pinned low so the 300 codes run to the cap, the
    speculative render at the cap's bucket; K2 launches all f32; the wav
    finite; that model's consumer attention against f32 plain attention."""
    from xtts_tpu_torch.infer.api import TextToSpeech, TTSSettings
    from xtts_tpu_torch.nn import flash_attn as fa
    t0 = time.perf_counter()
    tts = TextToSpeech(cfg, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(7))
    check(tts.dtype == torch.float32, f"default dtype {tts.dtype}")
    with torch.no_grad():
        tts.gpt.mel_head.bias[cfg.gpt.stop_mel_token] = -30.0
        consumer_attention_check(torch, fa, tts)
    init_s = time.perf_counter() - t0
    cond_mel = tts.cond_mel_from_wav(cond_wav)
    launches.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = tts.tts_tokens(text, cond_mel,
                         torch.Generator(device="cuda").manual_seed(1),
                         TTSSettings(max_mel_tokens=300,
                                     speculative_render=True))
    latency = time.perf_counter() - t0
    d = launches.read()
    wav = out["wav"]
    check(d["flash_mha"] >= 200 and d["flash_mha+f32"] == d["flash_mha"],
          f"[p9] K2 launches {d['flash_mha']}, f32 {d['flash_mha+f32']}")
    check(bool(np.isfinite(wav).all()) and wav.shape[1] > 0,
          f"[p9] wav {wav.shape}")
    log(f"[p9] TextToSpeech(XTTSConfig(), device='cuda') at its default "
        f"f32: init {init_s:.1f} s; a speculative request at bucket 320 "
        f"({out['steps']} AR steps, wav {wav.shape}, finite) in "
        f"{latency:.3f} s (AR {out['ar_seconds']:.3f} s, render "
        f"{out['render_seconds']:.3f} s); K2 {d['flash_mha']} launches, "
        f"{d['flash_mha+f32']} of them f32  [{card}]")
    del tts
    torch.cuda.empty_cache()


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


class _BackboneHead:
    """A Vocos backbone variant under a head: mel -> wav (the ResBlock and
    AdaLayerNorm backbones, which the Vocos facade does not take)."""

    def __init__(self, torch, backbone, head, cond_id=None):
        self.mods = torch.nn.ModuleDict({"backbone": backbone, "head": head})
        self.cond_id = cond_id

    def __call__(self, mel):
        return self.mods["head"](self.mods["backbone"](mel, self.cond_id))


REST_SAMPLERS = ("p", "ddim", "dpm++2m", "unipc", "dpm++2m_solver",
                 "dpm++3m", "dpm++fast", "unipc_bh1", "unipc_bh2",
                 "unipc_vary")


@contextlib.contextmanager
def t_dependent_refnet(torch, diffusion, seed: int):
    """Within the block, the diffusion model's zero-initialised output
    projections (each UNet resblock's out conv, each transformer's
    proj_out, the BaseModel's out conv) hold lecun-normal draws; the zeros
    come back after. The flax init zeroes them: the time embedding then
    never reaches the ReferenceNet's features (every timestep's are equal)
    and the BaseModel's output is zero whatever the features, so a hoisted
    render (refnet_interval k > 1) equals the full one bit for bit."""
    mods = [m for m in diffusion.modules() if getattr(m, "zero_init", False)]
    saved = [(m, m.weight.detach().clone(), m.bias.detach().clone())
             for m in mods]
    g = torch.Generator(device=mods[0].weight.device).manual_seed(seed)
    with torch.no_grad():
        for m in mods:
            m.zero_init = False
            m.reset_flax(g)
            m.zero_init = True
    try:
        yield len(mods)
    finally:
        with torch.no_grad():
            for m, w, b in saved:
                m.weight.copy_(w)
                m.bias.copy_(b)


def rest_phase(torch, np, tts, text, cond_mel, launches, cfg, card):
    """The rest of the serving side on [main]'s model and inputs: the
    speculative render, refnet_interval (B=1 and render_rows at 16 rows),
    the ten samplers, the Vocos variants and evaluate_dvae. Launch counts
    are set to 0 before each item and read after it. Returns the phase's
    seconds."""
    from xtts_tpu_torch.diffusion.gaussian import model_calls
    from xtts_tpu_torch.infer import serving
    from xtts_tpu_torch.infer.api import TTSSettings, bucket_len, hoist_plan
    from xtts_tpu_torch.infer.eval_tools import (dvae_roundtrip,
                                                 evaluate_dvae, mcd, mel_l1)
    from xtts_tpu_torch.data.audio import save_wav
    from xtts_tpu_torch.data.datasets import MelCache
    from xtts_tpu_torch.models import vocos as V
    from xtts_tpu_torch.nn import flash_attn as fa
    from xtts_tpu_torch.nn.blocks import init_flax_like

    t_phase = time.perf_counter()
    stop = cfg.gpt.stop_mel_token
    refer = cond_mel.shape[-1]
    buckets = tts._code_buckets()

    def gen(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    def k2_gate(n_b, calls):
        """K2 launches of `calls` denoiser calls at code bucket n_b: 4
        consumer attentions a call where the size gate admits Tq * Tk."""
        return 4 * calls if fa.use_flash(4 * n_b, 4 * n_b + refer) else 0

    def request(settings, seed):
        launches.reset()
        torch.cuda.synchronize()
        out = tts.tts_tokens(text, cond_mel, gen(seed), settings)
        out["k2"] = launches.read()["flash_mha"]
        return out

    # ---- 1. speculative render ----
    a = request(TTSSettings(max_mel_tokens=300), 1)
    b = request(TTSSettings(max_mel_tokens=300, speculative_render=True), 1)
    n = max(int(a["lengths"][0]) - 2, 1)
    n_b, cap_b = bucket_len(n, buckets), bucket_len(298, buckets)
    same_codes = (np.array_equal(a["codes"], b["codes"])
                  and np.array_equal(a["lengths"], b["lengths"]))
    check(same_codes and a["wav"].shape == b["wav"].shape
          and np.array_equal(a["wav"], b["wav"]),
          f"speculative render != default at equal buckets: codes equal "
          f"{same_codes}, wav {b['wav'].shape} / {a['wav'].shape}, max diff "
          f"{np.abs(a['wav'] - b['wav']).max() if same_codes else 'n/a'}")
    check(n_b == cap_b == 320 and a["k2"] == b["k2"] == k2_gate(320, 50),
          f"buckets {n_b} / {cap_b}, K2 {a['k2']} / {b['k2']}")
    log(f"[rest] speculative render, max_mel_tokens 300, seed 1: codes and "
        f"wav {b['wav'].shape} equal to the default request's bit for bit "
        f"(length bucket {n_b} = cap bucket {cap_b}); render "
        f"{b['render_seconds']:.3f} s speculative, {a['render_seconds']:.3f} "
        f"s default; K2 {b['k2']} / {a['k2']}  [{card}]")

    old_bias = float(tts.gpt.mel_head.bias[stop])
    with torch.no_grad():
        tts.gpt.mel_head.bias[stop] = SLOTS_STOP_BIAS["sampled"]
    tts.requantize()
    try:
        s_out = request(TTSSettings(speculative_render=True), 2)
        d_out = request(TTSSettings(), 2)
    finally:
        with torch.no_grad():
            tts.gpt.mel_head.bias[stop] = old_bias
        tts.requantize()
    n = max(int(d_out["lengths"][0]) - 2, 1)
    own_b, cap_b = bucket_len(n, buckets), bucket_len(598, buckets)
    check(np.array_equal(s_out["codes"], d_out["codes"])
          and s_out["wav"].shape == d_out["wav"].shape == (1, n * 1024)
          and bool(np.isfinite(s_out["wav"]).all()),
          f"early-stop requests: codes or wav differ in shape "
          f"{s_out['wav'].shape} / {d_out['wav'].shape}")
    check(own_b < cap_b == 604, f"length bucket {own_b}, cap bucket {cap_b}")
    check(s_out["k2"] == k2_gate(cap_b, 50) == 200
          and d_out["k2"] == k2_gate(own_b, 50),
          f"K2 {s_out['k2']} at the cap bucket, {d_out['k2']} at {own_b}")
    log(f"[rest] early stop (stop bias {SLOTS_STOP_BIAS['sampled']}, seed "
        f"2, cap 600): {n} codes kept, length bucket {own_b}, cap bucket "
        f"{cap_b}; render {s_out['render_seconds']:.3f} s speculative "
        f"(Tq {4 * cap_b}, K2 {s_out['k2']}) against "
        f"{d_out['render_seconds']:.3f} s default (Tq {4 * own_b}, K2 "
        f"{d_out['k2']}, gate {'on' if k2_gate(own_b, 1) else 'off'}); AR "
        f"{d_out['ar_seconds']:.3f} s  [{card}]")

    # ---- 2. refnet_interval ----
    dev = torch.device("cuda")
    textt = torch.as_tensor(text, dtype=torch.long, device=dev)
    res_len = torch.as_tensor(a["lengths"], device=dev)
    lens = torch.clamp(res_len - 2, 1, 320)
    padded = tts._pad_codes(torch.as_tensor(a["codes"], device=dev), lens,
                            320)

    def timed(fn):
        launches.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, launches.read()

    with t_dependent_refnet(torch, tts.diffusion, 7) as n_drawn:
        w_def, t_def, _ = timed(lambda: tts._render(
            cond_mel, textt, padded, lens, gen(5), TTSSettings()))

        @torch.no_grad()
        def k1_staged():
            _, mel = tts._latent_and_mel(cond_mel, textt, padded, lens,
                                         gen(5),
                                         TTSSettings(refnet_interval=1))
            return tts.vocos(mel).float(), mel

        (w_k1, mel), t_k1, d = timed(k1_staged)
        check(torch.equal(w_def, w_k1), f"refnet_interval 1 != default: max "
              f"diff {max_err(w_def, w_k1)}")
        check(d["flash_mha"] == 200, f"K2 {d['flash_mha']}")
        peak = w_k1.abs().max().item()
        line = []
        for k in (2, 5):
            w, t_k, d = timed(lambda k=k: tts._render(
                cond_mel, textt, padded, lens, gen(5),
                TTSSettings(refnet_interval=k)))
            diff = max_err(w, w_k1)
            check(tuple(w.shape) == tuple(w_k1.shape)
                  and bool(torch.isfinite(w).all()) and d["flash_mha"] == 200
                  and diff > 0,
                  f"refnet_interval {k}: wav {tuple(w.shape)}, K2 "
                  f"{d['flash_mha']}, max diff from k 1 {diff}")
            line.append(f"k {k} {t_k:.3f} s, max diff / peak "
                        f"{diff / peak:.3e}")
    log(f"[rest] refnet_interval at B=1 (p x 50, bucket 320; the "
        f"diffusion model's {n_drawn} zero-initialised output projections "
        f"drawn, so the ReferenceNet's features depend on t and reach the "
        f"output): k 1 equal to the default bit "
        f"for bit ({t_def:.3f} s / {t_k1:.3f} s staged); {'; '.join(line)} "
        f"(the hoist's approximation; peak {peak:.3f})  [{card}]")

    rng = np.random.default_rng(3)
    rows = 16
    texts16 = torch.as_tensor(rng.integers(3, 250, (rows, 50)), device=dev)
    codes16 = torch.as_tensor(rng.integers(0, cfg.vqvae.num_tokens, (rows, 300)),
                              device=dev)
    lengths16 = np.array([300 - 9 * i for i in range(rows)])
    cond16 = cond_mel.repeat(rows, 1, 1)
    line = []
    for k in (1, 2):
        hoist = hoist_plan("p", rows, 50, k)[0]
        wavs, t_k, d = timed(lambda k=k: serving.render_rows(
            tts, texts16, torch.full((rows,), 50, device=dev), cond16,
            codes16, lengths16, TTSSettings(refnet_interval=k), True,
            gen(6)))
        check(len(wavs) == rows and all(
            w.shape == ((l - 2) * 1024,) and np.isfinite(w).all()
            for w, l in zip(wavs, lengths16)) and d["flash_mha"] == 200
              and hoist == (k == 2),
              f"render_rows k {k}: K2 {d['flash_mha']}, hoist {hoist}")
        line.append(f"k {k} ({'hoisted' if hoist else 'not hoisted'}, "
                    f"{rows} x {-(-50 // k)} cached) {t_k:.3f} s")
    log(f"[rest] render_rows, {rows} rows x bucket 320, p x 50: "
        f"{'; '.join(line)}; K2 200 each  [{card}]")

    # ---- 3. the ten samplers, 15 steps, one x_T ----
    xt = torch.randn((1, cfg.diffusion.in_channels, 4 * 320), generator=gen(7),
                     device=dev)
    denoise = tts.diffusion.denoise
    calls = [0]

    def counted(*args, **kw):
        calls[0] += 1
        return denoise(*args, **kw)

    tts.diffusion.denoise = counted
    line = []
    try:
        for name in REST_SAMPLERS:
            calls[0] = 0
            w, t_s, d = timed(lambda name=name: tts._render(
                cond_mel, textt, padded, lens, gen(8),
                TTSSettings(sampler=name, diffusion_steps=15), noise=xt))
            want = model_calls(name, 15)
            check(tuple(w.shape) == (1, 320 * 1024)
                  and bool(torch.isfinite(w).all()),
                  f"sampler {name}: wav {tuple(w.shape)} not finite")
            check(calls[0] == want and d["flash_mha"] == 4 * calls[0],
                  f"sampler {name}: {calls[0]} model calls (want {want}), "
                  f"K2 {d['flash_mha']}")
            line.append(f"{name} {t_s:.3f} s ({calls[0]} calls)")
    finally:
        del tts.diffusion.denoise
    log(f"[rest] samplers x 15 steps from one x_T, bucket 320, K2 = 4 x "
        f"model calls each: {'; '.join(line)}  [{card}]")

    # ---- 4. the Vocos variants at the flagship widths, on [main]'s mel ----
    vc = cfg.vocos
    builds = {
        "imdct_symexp": lambda: V.Vocos(vc.replace(head="imdct_symexp",
                                                   head_sample_rate=SR)),
        "imdct_cos": lambda: V.Vocos(vc.replace(head="imdct_cos")),
        "resnet+istft": lambda: _BackboneHead(
            torch, V.VocosResNetBackbone(vc), V.ISTFTHead(vc)),
        "adanorm+istft": lambda: _BackboneHead(
            torch, V.VocosBackbone(vc, adanorm_num_embeddings=4),
            V.ISTFTHead(vc), cond_id=1),
    }
    mel_cpu = mel.float().cpu()
    line = []
    for name, build in builds.items():
        m = build()
        mods = m.mods if isinstance(m, _BackboneHead) else m
        mods.to(dev).eval()
        g = torch.Generator(device="cuda").manual_seed(9)
        init_flax_like(mods, g)
        with torch.no_grad():
            for p in mods.parameters():   # move the AdaLN ids' embeddings
                p.add_(0.02 * torch.randn(p.shape, generator=g, device=dev))
        mc = build()
        mcm = mc.mods if isinstance(mc, _BackboneHead) else mc
        mcm.load_state_dict({k: v.cpu() for k, v in mods.state_dict().items()})
        mcm.eval()
        with torch.no_grad():
            w = m(mel.float()).float()
            wc = mc(mel_cpu).float()
            err = max_err(w.cpu(), wc) / wc.abs().max().item()
            ms = time_ms(torch, lambda: m(mel.float()), reps=5, warmup=1)
        check(bool(torch.isfinite(w).all()) and err <= SMALL_WAV_TOL,
              f"Vocos {name}: card vs CPU {err}")
        audio = w.shape[-1] / SR
        line.append(f"{name} wav {tuple(w.shape)} err/peak {err:.2e}, "
                    f"{ms:.2f} ms = {audio / (ms * 1e-3):.0f} audio-s/s")
        del m, mc
    log(f"[rest] Vocos variants (8 x 512 x 1536 / ResBlock 3 x 512, f32) on "
        f"[main]'s mel {tuple(mel.shape)}, card vs CPU within "
        f"{SMALL_WAV_TOL} of the peak: {'; '.join(line)}  [{card}]")

    # ---- 5. evaluate_dvae over 8 clips of 6 s ----
    clip_dir = ROOT / "build" / "rest_clips"
    clip_dir.mkdir(parents=True, exist_ok=True)
    for old in clip_dir.iterdir():
        old.unlink()
    paths = []
    t6 = np.arange(6 * SR) / SR
    for i in range(8):
        w = (0.3 * np.sin(2 * np.pi * (150 + 20 * i) * t6)
             + 0.05 * rng.standard_normal(t6.shape[0])).astype(np.float32)
        paths.append(str(clip_dir / f"clip{i}.wav"))
        save_wav(paths[-1], w)
    summary, t_ev, d = timed(lambda: evaluate_dvae(
        tts.dvae, paths, out_jsonl=str(clip_dir / "eval.jsonl"),
        mel_fn=tts.mel))
    check(d["vq_nearest"] == 8 and summary["n"] == 8,
          f"evaluate_dvae: K3 {d['vq_nearest']}, n {summary['n']}")
    seen = set()
    cache = MelCache(tts.mel)
    with torch.no_grad():
        for p in paths:
            m = cache(p)
            direct = tts.dvae.get_codebook_indices(
                torch.as_tensor(m, device=dev)[None])[0].cpu().numpy()
            r = dvae_roundtrip(tts.dvae, m)
            check(np.array_equal(r["codes"], direct), f"{p}: round-trip "
                  f"codes differ from get_codebook_indices")
            seen.update(direct.tolist())
    check(summary["codebook_usage"] == len(seen),
          f"codebook usage {summary['codebook_usage']} vs {len(seen)}")
    l1 = mel_l1(tts.mel, s_out["wav"][0], d_out["wav"][0])
    cd = mcd(tts.mel, s_out["wav"][0], d_out["wav"][0])
    log(f"[rest] evaluate_dvae, 8 clips x 6 s (mels on the card, DVAE bf16): "
        f"mel_l1_mean {summary['mel_l1_mean']:.4f}, codebook usage "
        f"{summary['codebook_usage']} of 8192, {t_ev:.3f} s = "
        f"{48 / t_ev:.1f} audio-s/s, K3 {d['vq_nearest']}; codes equal to "
        f"get_codebook_indices on the same mels. Early-stop renders, "
        f"speculative against default: mel_l1 {l1:.4f}, mcd {cd:.3f} dB "
        f"(not bounded)  [{card}]")
    return time.perf_counter() - t_phase


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


# ---- [parallel]: data- and tensor-parallel training (parallel/mesh.py) ----

PAR_BATCH = 8          # the global batch of every parallel step
PAR_TIMEOUT = 420      # seconds for one spawn of ranks, their start included


def parallel_batch(np, fam, bins):
    """A family's global batch, seeded, with text and mel lengths falling
    across the rows (so the data ranks' lengths differ)."""
    rng = np.random.default_rng(21)
    b = PAR_BATCH
    mel = rng.standard_normal((b, bins, 400)).astype(np.float32)
    if fam == "vqvae":
        return {"mel": mel}
    return {"cond_mel": rng.standard_normal((b, bins, 300)).astype(
                np.float32),
            "text": rng.integers(3, 250, (b, 100)),
            "text_lengths": np.array([100 - 9 * i for i in range(b)]),
            "mel": mel,
            "wav_lengths": np.array([(400 - 37 * i) * 256 for i in range(b)])}


def parallel_step(torch, np, fam, mesh, rules, cfg, dev="cuda"):
    """One f32 optimizer step of a family of `cfg` on `mesh` (None: one
    rank) from seeded weights (init_flax_like on a `dev` generator, every
    weight perturbed as [ref] does), held later by
    hold_train_step: the metrics, the step's raw gradients (this rank's
    share summed over the data group, the shards gathered), the parameters
    after the step (gathered) and the collections; K3 counted around the
    step, and the step timed (ms; the gradient pass before it warmed the
    kernels up)."""
    from xtts_tpu_torch.core.config import TrainConfig
    from xtts_tpu_torch.models.dvae import DVAE
    from xtts_tpu_torch.models.gpt import UnifiedVoice
    from xtts_tpu_torch.nn.blocks import init_flax_like
    from xtts_tpu_torch.ops import vq
    from xtts_tpu_torch.parallel import mesh as pm
    from xtts_tpu_torch.train.steps import make_dvae_loss, make_gpt_loss
    from xtts_tpu_torch.train.trainer import Trainer
    g = torch.Generator(device=dev).manual_seed(31)
    mods = {"vqvae": DVAE(cfg.vqvae).to(dev)}
    if fam == "gpt":
        mods["gpt"] = UnifiedVoice(cfg.gpt).to(dev)
    with torch.no_grad():
        for m in mods.values():
            init_flax_like(m, g)
            for p in m.parameters():
                p.add_(0.02 * torch.randn(p.shape, generator=g, device=dev))
    if fam == "gpt":
        model = mods["gpt"]
        loss_fn = make_gpt_loss(model, mods["vqvae"].eval(), mesh=mesh)
    else:
        model = mods["vqvae"]
        loss_fn = make_dvae_loss(model, mesh=mesh)
    tc = TrainConfig(lr=1e-3, lr_schedule="constant", accum_grad=1,
                     dtype="float32")
    tr = Trainer(model, loss_fn, tc, mesh=mesh, param_rules=rules)
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    st = tr.shard_state(tr.init_state())
    batch = {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in
             parallel_batch(np, fam, cfg.vqvae.channels).items()}
    local = tr.shard_batch(batch)
    loss_fn(local, None)[0].backward()
    names = list(st.params)
    grads = [st.params[n].grad.detach() for n in names]
    model.zero_grad(set_to_none=True)
    if mesh is not None:
        grads = pm.all_reduce_flat(grads, mesh.data_group)
        grads = [pm.gather_shard(gr, tr.specs[n].dim, tr.specs[n].groups,
                                 mesh) if n in tr.specs else gr
                 for n, gr in zip(names, grads)]
    host = lambda t: t.detach().to("cpu", copy=True)   # noqa: E731
    grads = {n: host(gr) for n, gr in zip(names, grads)}
    k3 = vq.vq_nearest.launches
    sync()
    t0 = time.perf_counter()
    st, metrics = tr.step(st, local)
    sync()
    ms = 1e3 * (time.perf_counter() - t0)
    k3 = vq.vq_nearest.launches - k3
    full = tr.full_payload(st)
    out = dict(metrics={k: float(v) for k, v in metrics.items()},
               grads=grads, k3=k3, ms=ms,
               params={k: host(v) for k, v in full["params"].items()},
               cols={k: host(v) for k, v in st.state_cols.items()})
    del tr, st, model, mods, loss_fn
    if dev == "cuda":
        torch.cuda.empty_cache()
    return out


def parallel_rank(rank, job):
    """One spawned rank of [parallel] (parallel.launch.run_ranks). job:
    {"root", "out", "runs": [(tag, n_data, n_model, family), ...],
    "nccl": bool, "cfg": an XTTSConfig dict, "device"}. Rank 0 writes its
    results to job["out"]; every rank returns its K3 counts and step
    times."""
    import numpy as np
    import torch
    sys.path.insert(0, job["root"])
    from xtts_tpu_torch.core.config import XTTSConfig
    cfg, dev = XTTSConfig.from_dict(job["cfg"]), job["device"]
    if dev == "cuda":
        torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist
    from xtts_tpu_torch.parallel import mesh as pm
    summary, results = {}, {}
    if job["nccl"]:
        t = torch.full((1024,), float(rank + 1), device="cuda")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        check(bool((t == sum(range(1, dist.get_world_size() + 1))).all()),
              "nccl all_reduce on the card")
        summary["nccl_all_reduce"] = float(t[0])
    meshes = {}
    for tag, n_data, n_model, fam in job["runs"]:
        key = (n_data, n_model)
        if key not in meshes:
            meshes[key] = pm.make_mesh(n_data, n_model)
        rules = pm.GPT_PARAM_RULES if n_model > 1 else ()
        out = parallel_step(torch, np, fam, meshes[key], rules, cfg, dev)
        summary[tag] = {"k3": out["k3"], "ms": out["ms"]}
        if rank == 0:
            results[tag] = out
    if rank == 0:
        torch.save(results, job["out"])
    return summary


def parallel_phase(torch, np, card, cfg, dev="cuda"):
    """[parallel], at cfg's (the flagship's) widths and depth:
    (a) dp 2, one gpt step and one vqvae step; (b) tp 2, one gpt step
    (GPT_PARAM_RULES); two gloo ranks spawned on the one card, on
    CUDA tensors, each held against the one-rank step of the same global
    batch, weights and draws on this card (hold_train_step, the EMA
    codebook within TRAIN_CB_TOL); K3 once a step on each rank. (c) one
    NCCL rank: its group, an all_reduce on the card and one dp step at
    world size 1. A rank that fails or outlasts PAR_TIMEOUT fails the
    run."""
    from xtts_tpu_torch.parallel.launch import run_ranks
    t_phase = time.perf_counter()
    runs = [("dp2 gpt", 2, 1, "gpt"), ("dp2 vqvae", 2, 1, "vqvae"),
            ("tp2 gpt", 1, 2, "gpt")]
    ref = {fam: parallel_step(torch, np, fam, None, (), cfg, dev)
           for fam in ("gpt", "vqvae")}
    out_dir = ROOT / "build" / "parallel"
    out_dir.mkdir(parents=True, exist_ok=True)
    job = {"root": str(ROOT), "out": str(out_dir / "rank0.pt"),
           "runs": runs, "nccl": False, "cfg": cfg.to_dict(), "device": dev}
    t0 = time.perf_counter()
    summary = run_ranks(parallel_rank, 2, (job,), backend="gloo",
                        timeout=PAR_TIMEOUT)
    spawn_s = time.perf_counter() - t0
    got = torch.load(job["out"], weights_only=False)
    lr = 1e-3

    def on_card(r):
        return dict(r, grads={n: v.to(dev) for n, v in r["grads"].items()},
                    params={n: v.to(dev) for n, v in r["params"].items()})
    for tag, n_data, n_model, fam in runs:
        c, k = on_card(ref[fam]), on_card(got[tag])
        line = hold_train_step(torch, f"[parallel] {tag}", c, k, lr, 1.0)
        cb = ""
        if fam == "vqvae":
            cb_err = max(max_err(k["cols"][n], c["cols"][n])
                         for n in c["cols"])
            check(cb_err <= TRAIN_CB_TOL, f"[parallel] {tag} codebook err "
                  f"{cb_err}")
            cb = (f"; EMA codebook max_abs_err {cb_err:.2e} (bound "
                  f"{TRAIN_CB_TOL})")
        k3 = [s[tag]["k3"] for s in summary]
        check(all(n == 1 for n in k3) and c["k3"] == 1,
              f"[parallel] {tag}: K3 launches a step {k3}, one rank "
              f"{c['k3']}")
        ms = ", ".join(f"rank {r} {s[tag]['ms']:.1f} ms"
                       for r, s in enumerate(summary))
        log(f"[parallel] {tag} ({n_data} data x {n_model} model ranks, "
            f"gloo, one card, global batch {PAR_BATCH}, f32, GPT "
            f"{cfg.gpt.layers} x {cfg.gpt.model_dim}) against the "
            f"one-rank step: {line}{cb}; K3 {k3} a rank a step; step {ms}; "
            f"one rank {c['ms']:.1f} ms  [{card}]")
    del ref, got
    t0 = time.perf_counter()
    job = dict(job, out=str(out_dir / "nccl0.pt"), nccl=True,
               runs=[("nccl dp1 vqvae", 1, 1, "vqvae")])
    nccl = run_ranks(parallel_rank, 1, (job,), backend="nccl",
                     timeout=PAR_TIMEOUT)[0]
    check(nccl["nccl dp1 vqvae"]["k3"] == 1, "[parallel] nccl step K3")
    log(f"[parallel] nccl: a one-rank group started, all_reduce on the card "
        f"= {nccl['nccl_all_reduce']:.0f}, one dp step at world size 1 "
        f"(vqvae) {nccl['nccl dp1 vqvae']['ms']:.1f} ms, spawn to exit "
        f"{time.perf_counter() - t0:.1f} s  [{card}]")
    log(f"[parallel] phase {time.perf_counter() - t_phase:.1f} s (the gloo "
        f"spawn {spawn_s:.1f} s)  [{card}]")


def perceiver_small_check(torch, np, TextToSpeech):
    """[perceiver], small configuration: the perceiver GPT (GPT 2 x 128,
    32 latents) with the same perturbed weights on the card and the CPU;
    greedy int8 codes of one B=1 request (K1 over the 32-position prefix
    and its 32-token tail) held by P3's rule (greedy_rule), the card's
    picks teacher-forced along the CPU's codes."""
    from xtts_tpu_torch.core.config import (DVAEConfig, GPTConfig,
                                            MelConfig, XTTSConfig)
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
                      use_perceiver=True))
    g = torch.Generator().manual_seed(12)
    cpu = TextToSpeech(small, device="cpu", quantized_decode=True,
                       generator=g)
    with torch.no_grad():
        for p in cpu.gpt.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    cpu.requantize()
    card = TextToSpeech(small, device="cuda", quantized_decode=True,
                        init=False)
    for name, m in card.modules().items():
        m.load_state_dict(cpu.modules()[name].state_dict())
    card.requantize()
    rng = np.random.default_rng(13)
    cond = torch.from_numpy(rng.standard_normal((1, mb, 60))).float()
    text = torch.from_numpy(rng.integers(3, 250, (1, 16))).long()
    runs = {}
    for name, tts in (("cpu", cpu), ("card", card)):
        dev = tts.device
        before = ds.fused_decode_logits.launches
        res = generate_speech_quantized(tts.gpt, tts._qtree, cond.to(dev),
                                        text.to(dev), None, max_gen=48,
                                        do_sample=False)
        runs[name] = (res, ds.fused_decode_logits.launches - before)
    (c_res, c_k1), (k_res, k_k1) = runs["cpu"], runs["card"]
    check(c_k1 == 0 and k_k1 == k_res.steps,
          f"[perceiver] K1 steps: cpu {c_k1}, card {k_k1} for {k_res.steps}")
    n = int(c_res.lengths[0])
    codes = c_res.codes[:, :n]
    forced_cpu = {e: forced_picks(torch, cpu, cond, text, codes, engine=e)
                  for e in ("k1", "chain", "chain64")}
    forced_card = forced_picks(torch, card, cond.cuda(), text.cuda(),
                               codes.cuda())
    rule = greedy_rule(torch, codes[0].numpy(), forced_cpu, forced_card,
                       "[perceiver] small")
    same = torch.equal(c_res.codes, k_res.codes.cpu())
    log(f"[perceiver] small config (GPT 2 x 128, 32 latents, prefix "
        f"{32 + 18 + 32} positions, f32): greedy codes card vs CPU "
        f"{'identical' if same else 'not identical'} over {n} codes "
        f"({k_k1} K1 steps on the card); {rule}")


def perceiver_phase(torch, np, cfg, cond_mel, text, main_latency, launches,
                    card):
    """[perceiver] at the flagship widths: TextToSpeech(use_perceiver=True,
    bf16, int8 decode), the stop logit pinned low as in [main], three
    tts_tokens requests (seeds 1-3) of max_mel_tokens 300, K1 every token
    over the 32-latent prefix, K2 in the render; latency beside [main]'s."""
    import dataclasses
    from xtts_tpu_torch.infer import device_loop as dl
    from xtts_tpu_torch.infer.api import TextToSpeech, TTSSettings
    pcfg = dataclasses.replace(cfg, gpt=dataclasses.replace(
        cfg.gpt, use_perceiver=True))
    t0 = time.perf_counter()
    tts = TextToSpeech(pcfg, device="cuda", dtype=torch.bfloat16,
                       quantized_decode=True,
                       generator=torch.Generator(device="cuda").manual_seed(0))
    with torch.no_grad():
        tts.gpt.mel_head.bias[pcfg.gpt.stop_mel_token] = -30.0
    tts.requantize()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    settings = TTSSettings(max_mel_tokens=300)
    nl = pcfg.gpt.layers
    lat = []
    for seed in (1, 2, 3):
        launches.reset()
        dl.STATS.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = tts.tts_tokens(text, cond_mel,
                             torch.Generator(device="cuda").manual_seed(seed),
                             settings)
        lat.append(time.perf_counter() - t0)
        d = launches.read()
        wav, steps = out["wav"], out["steps"]
        n = max(int(out["lengths"][0]) - 2, 1)
        per_code = pcfg.vqvae.compression * pcfg.vocos.hop_length
        check(wav.shape == (1, n * per_code) and bool(np.isfinite(wav).all()),
              f"[perceiver] wav {wav.shape}, n {n}")
        k1 = d["fused_decode_logits"]
        check(k1 >= steps and d["int8_gemv"] == (4 * nl + 1) * k1
              and d["decode_attention"] == nl * k1
              and d["layer_norm_rows"] == 0,
              f"[perceiver] K1 launches {d} for {steps} tokens")
        check(d["flash_mha"] >= 200, f"[perceiver] K2 launches "
              f"{d['flash_mha']} < 200")
        log(f"[perceiver] request seed {seed}: {steps} AR tokens, wav "
            f"{wav.shape}, latency {lat[-1]:.3f} s ([main] "
            f"{main_latency[seed - 1]:.3f} s), AR {out['ar_seconds']:.3f} s "
            f"= {steps / out['ar_seconds']:.1f} tokens/s, render "
            f"{out['render_seconds']:.3f} s; launches K1 step {k1}, "
            f"attention {d['decode_attention']}, K2 {d['flash_mha']}; "
            f"{loop_stats(dl, steps, rungs=1)}  [{card}]")
    log(f"[perceiver] TextToSpeech(use_perceiver=True, bf16) init "
        f"{init_s:.1f} s; prefix 32 + {text.shape[1] + 2} + 32 positions  "
        f"[{card}]")
    del tts
    torch.cuda.empty_cache()


def placed_wave_check(torch, np, tts, text, cond_mel, launches, card):
    """[serving] on two replicas: place_on_mesh([cuda:0, cuda:0]), a wave
    of 3 requests sampled at TTSSettings' defaults (temperature 0.8, top_p
    0.8; padded to 4, two rows a replica) through synthesize_batch's path
    with the shortcut render; codes equal, token for token, to the
    unplaced wave's over the same padded rows (batch_buckets=(4,)): each
    replica draws the whole wave's numbers for its rows, as JAX's one key
    for the sharded batch does. Not near-greedy: there a pick between
    near-tied logits turns on the per-row numerics, which differ on the
    card between a 2-row and a 4-row pass (cuBLAS row counts), placed or
    not (scripts/placed_wave_rows.py)."""
    from xtts_tpu_torch.infer.api import TTSSettings
    from xtts_tpu_torch.infer.serving import SynthesisRequest, _synthesize
    rng = np.random.default_rng(17)
    reqs = [SynthesisRequest(rng.integers(3, 250, 40 + 5 * i))
            for i in range(3)]
    s = TTSSettings(max_mel_tokens=64)
    runs = {}
    for placed in (False, True):
        if placed:
            tts.place_on_mesh(["cuda:0", "cuda:0"])
        launches.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wavs, codes = _synthesize(
            tts, reqs, cond_mel, s, generator=torch.Generator(
                device="cuda").manual_seed(5),
            batch_buckets=None if placed else (4,))
        codes = [c.cpu().numpy() for c in codes]
        runs[placed] = (wavs, codes, time.perf_counter() - t0,
                        launches.read())
    reps = len(tts.replicas)
    tts.place_on_mesh(None)
    (w0, c0, t_0, _), (w1, c1, t_1, d1) = runs[False], runs[True]
    same = all(np.array_equal(a, b) for a, b in zip(c0, c1))
    check(len(w1) == 3 and same, f"[serving] placed wave codes differ: "
          f"{[int((a != b).sum()) if a.shape == b.shape else -1 for a, b in zip(c0, c1)]}")
    err = max(float(np.abs(a - b).max()) for a, b in zip(w0, w1))
    check(err <= SMALL_WAV_TOL, f"[serving] placed wave wav err {err}")
    log(f"[serving] place_on_mesh([cuda:0, cuda:0]): a wave of 3 requests "
        f"padded to 4 ({reps} replicas, 2 rows each, the chain), temperature "
        f"{s.temperature}, codes identical to the unplaced wave's (padded "
        f"to 4 too) over {[len(c) for c in c1]} codes, "
        f"shortcut wav max_abs_err {err:.2e}; {t_1:.3f} s against "
        f"{t_0:.3f} s unplaced; K1 launches {d1['fused_decode_logits']}  "
        f"[{card}]")


COMPACT_ROWS = (1, 2, 4, 8, 16)
COMPACT_LADDER = (64, 128, 256)   # the waves' rungs (both waves)
# [compact]'s stop-logit biases, tried in turn on a shortcut wave: the
# first whose rows leave between 1 and half of them live at a rung (so
# the compacting wave drops rows there) is the phase's
COMPACT_STOP_BIASES = (0.0, 1.0, 2.0, 3.0, 4.0)
# DiffusionTts, card (f32, TF32 off) against the CPU port with the same
# weights, relative to the output's peak: f32 on both sides, sums in other
# orders through ~30 blocks (each ~2^-24 relative a sum)
DTTS_TOL = 1e-4


def first_diffs(got, ref) -> list:
    """The first step where each request's codes leave ref's (-1: none)."""
    out = []
    for a, b in zip(got, ref):
        n = min(len(a), len(b))
        d = [i for i in range(n) if a[i] != b[i]]
        out.append(d[0] if d else (-1 if len(a) == len(b) else n))
    return out


def compact_phase(torch, np, tts, cond_mel, launches, cfg, card):
    """[compact]: synthesize_batch of 8 requests of distinct text x 2 CLVP
    candidates (16 AR rows) with compact_rows=COMPACT_ROWS on [main]'s
    model (bf16, the int8 chain: K1 and K4 stay off), full-quality render
    (K2), beside the same wave without compaction, in turns (plain,
    compacting, compacting, plain). Greedy (top_p 1e-4) under the default
    repetition penalty, so a row's stop logit gains on the penalised
    tokens it emits; the stop logit raised by the first of
    COMPACT_STOP_BIASES that leaves between 1 and 8 of the 16 rows live at
    a rung (a plain shortcut wave each), so the rows stop at spread steps.
    Each compacting wave's rows at every take, AR and wave seconds, graph
    replays and K2 launches. The greedy codes: each wave's the same bits
    as its twin's in the turns; every request's equal to the plain wave's
    up to the first take (the same row count until then) and in full for
    the rows done by then; after it the first step where they differ is
    printed, beside a control: the plain chain at 8 rows against the
    16-row wave, no compaction (the chain's products and attention on the
    card round by the row count, PERF.md §6)."""
    from xtts_tpu_torch.infer import device_loop as dl
    from xtts_tpu_torch.infer.api import TTSSettings
    from xtts_tpu_torch.infer.serving import SynthesisRequest, _synthesize
    os.environ.pop("XTTS_FUSED_SERVING", None)
    stop = cfg.gpt.stop_mel_token
    rng = np.random.default_rng(17)
    reqs = [SynthesisRequest(rng.integers(3, 250, 50).astype(np.int32))
            for _ in range(8)]
    base = dict(max_mel_tokens=300, num_candidates=2, top_p=1e-4,
                cache_ladder=COMPACT_LADDER)
    takes, ar = [], []
    take, gen_ar = dl.LoopState.take, tts._generate

    def counted_take(self, src, idx):
        takes.append((int(src.step), src.done.shape[0], idx.numel()))
        take(self, src, idx)

    def timed_ar(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = gen_ar(*a, **k)
        torch.cuda.synchronize()
        ar.append(time.perf_counter() - t0)
        return out

    qt = tts._qtree
    old = float(tts.gpt.mel_head.bias[stop].detach())

    def set_stop_bias(b):
        with torch.no_grad():
            tts.gpt.mel_head.bias[stop] = b
            qt["mel_head_b"][stop] = b
    dl.LoopState.take = counted_take
    tts._generate = timed_ar
    codes, k2s = {}, {}
    try:
        tried = []
        for bias in COMPACT_STOP_BIASES:
            set_stop_bias(bias)
            _, got_codes = _synthesize(
                tts, reqs, cond_mel, TTSSettings(**base),
                generator=torch.Generator(device="cuda").manual_seed(5))
            lens = [len(c) for c in got_codes]
            tried.append((bias, lens))
            if any(0 < sum(n > r for n in lens) <= 4
                   for r in COMPACT_LADDER):
                break
        else:
            check(False, f"[compact] no stop bias spreads the rows: {tried}")
        log(f"[compact] stop bias {bias} (tried: "
            f"{'; '.join(f'{b}: {n}' for b, n in tried)})")
        for compact in (False, True, True, False):
            settings = TTSSettings(
                **base, compact_rows=COMPACT_ROWS if compact else None)
            launches.reset()
            dl.STATS.reset()
            takes.clear()
            ar.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wavs, got_codes = _synthesize(
                tts, reqs, cond_mel, settings, use_diffusion=True,
                generator=torch.Generator(device="cuda").manual_seed(5))
            torch.cuda.synchronize()
            wave_s = time.perf_counter() - t0
            got = launches.read()
            got_codes = [c.cpu().numpy() for c in got_codes]
            lens = [len(c) for c in got_codes]
            check(len(wavs) == 8 and all(bool(np.isfinite(w).all())
                                         for w in wavs),
                  f"[compact] wavs {[w.shape for w in wavs]}")
            # the render's bucket, so its K2 launches, are the longest
            # row's: the same in every wave
            k2 = k2s.setdefault("k2", got["flash_mha"])
            check(got["flash_mha"] == k2, f"[compact] K2 launches "
                  f"{got['flash_mha']}, {k2} in the first wave")
            check(got["fused_decode_logits"] == 0
                  and got["fused_serving_logits"] == 0,
                  f"[compact] K1 / K4 ran: {got}")
            check(dl.STATS.replays > 0, "[compact] no graph replay")
            if compact:
                check(takes and takes[-1][2] < 16, f"[compact] no row "
                      f"dropped (takes {takes}, lengths {lens})")
            name = "compacting" if compact else "plain"
            prev = codes.setdefault(name, got_codes)
            check(all(np.array_equal(a, b) for a, b in zip(got_codes, prev)),
                  f"[compact] the {name} waves' greedy codes differ")
            ref = codes.get("plain", got_codes)
            diff = first_diffs(got_codes, ref)
            msg = "equal to the plain wave's"
            if compact:
                # up to the first take every row runs at the plain wave's
                # row count: equal to the bit; after it, at a smaller one
                s1 = takes[0][0]
                check(all(d < 0 or d >= s1 for d in diff)
                      and all(d < 0 for d, n in zip(diff, ref_lens)
                              if n <= s1),
                      f"[compact] codes leave the plain wave's before the "
                      f"first take at step {s1}: first differing steps "
                      f"{diff}, plain lengths {ref_lens}")
                msg = (f"first step differing from the plain wave's a "
                       f"request {diff} (-1: none; every row equal up to "
                       f"the first take at step {s1})")
            else:
                ref_lens = lens
            rows = ", ".join(f"step {s}: {a} -> {b} rows"
                             for s, a, b in takes) or "none"
            log(f"[compact] {name} wave (8 requests x 2 candidates, 16 AR "
                f"rows, ladder {COMPACT_LADDER}"
                f"{f', compact_rows {COMPACT_ROWS}' if compact else ''}): "
                f"code lengths {lens}; takes: {rows}; AR {ar[0]:.3f} s, "
                f"wave {wave_s:.3f} s; {dl.STATS.replays} graph replays, "
                f"{dl.STATS.eager_steps} eager steps, {dl.STATS.captures} "
                f"captures; K2 launches {got['flash_mha']}; greedy codes "
                f"{msg}  [{card}]")
        # the control: the same requests without compaction, one candidate
        # each (8 rows): where the chain's picks leave the 16-row wave's at
        # another row count with no compaction at all
        _, one = _synthesize(
            tts, reqs, cond_mel,
            TTSSettings(**dict(base, num_candidates=1)),
            generator=torch.Generator(device="cuda").manual_seed(5))
        log(f"[compact] control: the plain chain at 8 rows (one candidate "
            f"a request) against the 16-row plain wave, first differing "
            f"step a request "
            f"{first_diffs([c.cpu().numpy() for c in one], codes['plain'])}"
            f"  [{card}]")
    finally:
        dl.LoopState.take = take
        tts._generate = gen_ar
        set_stop_bias(old)


def diffusion_tts_phase(torch, np, card):
    """[diffusion_tts]: load_model("diffusion_tts") on the card in f32 (the
    reference ctor's defaults; TF32 off), its zero-initialised parameters
    drawn so every block computes; a forward at B 2, 944 mel frames through
    the latent (latents (2, 512, 236)), code and conditioning-free
    branches, a conditioning mel (2, 100, 300), each against the CPU port
    with the same weights within DTTS_TOL of the output's peak (the code
    prediction too), and its card ms."""
    from xtts_tpu_torch.models.diffusion_tts import DiffusionTts
    from xtts_tpu_torch.utils.registry import load_model
    g = torch.Generator(device="cuda").manual_seed(31)
    m = load_model("diffusion_tts", device="cuda", generator=g).eval()
    check(isinstance(m, DiffusionTts), f"load_model built {type(m)}")
    with torch.no_grad():
        for p_ in m.parameters():
            if not p_.any():
                p_.normal_(0.0, 0.02, generator=g)
    cpu = DiffusionTts().eval()
    cpu.load_state_dict({k: v.cpu() for k, v in m.state_dict().items()})
    rng = np.random.default_rng(31)
    x = rng.standard_normal((2, 100, 944)).astype(np.float32)
    lat = rng.standard_normal((2, 512, 236)).astype(np.float32)
    codes = rng.integers(0, 8193, (2, 236))
    mel = rng.standard_normal((2, 100, 300)).astype(np.float32)
    ts = np.array([10, 500])
    branches = (("latent", dict(aligned_conditioning=lat)),
                ("code", dict(aligned_conditioning=codes)),
                ("conditioning-free", dict(aligned_conditioning=lat,
                                           conditioning_free=True)))
    for name, kw in branches:
        def inputs(dev):
            args = {k: (torch.from_numpy(v).to(dev)
                        if isinstance(v, np.ndarray) else v)
                    for k, v in kw.items()}
            return dict(x=torch.from_numpy(x).to(dev),
                        timesteps=torch.from_numpy(ts).to(dev),
                        conditioning_latent=torch.from_numpy(mel).to(dev),
                        return_code_pred=True, **args)
        on_card = inputs("cuda")
        with torch.no_grad():
            out, pred = m(**on_card)
            want, want_pred = cpu(**inputs("cpu"))
            ms = time_ms(torch, lambda: m(**on_card), reps=5, warmup=1)
        check(tuple(out.shape) == (2, 200, 944)
              and bool(torch.isfinite(out).all()),
              f"[diffusion_tts] {name}: out {tuple(out.shape)}")
        peak = want.abs().max().item()
        err = max_err(out.cpu(), want) / peak
        msg = ""
        if want_pred is not None:
            p_err = (max_err(pred.cpu(), want_pred)
                     / want_pred.abs().max().item())
            check(p_err <= DTTS_TOL, f"[diffusion_tts] {name}: code "
                  f"prediction err {p_err}")
            msg = f", code prediction {tuple(pred.shape)} err {p_err:.2e}"
        check(err <= DTTS_TOL, f"[diffusion_tts] {name}: err {err}")
        log(f"[diffusion_tts] {name} branch (B 2, 944 frames, f32): out "
            f"{tuple(out.shape)}, card vs CPU port err {err:.2e} of the peak "
            f"{peak:.3f} (bound {DTTS_TOL}){msg}; card {ms:.3f} ms a "
            f"call  [{card}]")
    del m, cpu
    torch.cuda.empty_cache()


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
    launches = Launches(ds.KERNELS + fa.KERNELS + vq.KERNELS
                        + ss.KERNELS + (ds.fused_decode_logits,
                                        ss.fused_serving_logits))

    # ---- 3. kernels vs their plain twins ----
    results = {}
    with torch.no_grad():
        qt, st = k1_checks(torch, ds, quantize_dense, cfg.gpt, s_max, p_len,
                           results, card)
        k1_int4_checks(torch, ds, qt, cfg.gpt, s_max, p_len, results, card)
        k2_checks(torch, fa, results, card)
        k2_f32_checks(torch, fa, results, card)
        k2_backward_checks(torch, fa, results, card)
        k2_width_checks(torch, fa, results, launches, card)
        k4_checks(torch, ds, ss, qt, st, cfg.gpt, p_len, p_len + max_gen,
                  results, card)
        del qt, st
    small_reference_check(torch, np, TextToSpeech, TTSSettings)
    train_reference_check(torch, np)
    train_reference_check_new(torch, np)
    flash_train_reference_check(torch, np)
    perceiver_small_check(torch, np, TextToSpeech)

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
    main_render, main_latency = [], []
    for seed in (1, 2, 3):
        launches.reset()
        dl.STATS.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = tts.tts_tokens(text, cond_mel,
                             torch.Generator(device="cuda").manual_seed(seed),
                             settings)
        latency = time.perf_counter() - t0
        main_latency.append(latency)
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

    # ---- 4a. P9: the default f32 TextToSpeech through K2's f32 forward ----
    p9_check(torch, np, cfg, text, cond_wav, launches, card)

    # ---- 4b. the AR loop's graphs against the same loop run eagerly ----
    with torch.no_grad():
        loop_phase(torch, dl, tts, cond_mel, text, launches, card)

    # ---- 4c. the perceiver conditioning (K1 over its 32-latent prefix,
    # K2) ----
    perceiver_phase(torch, np, cfg, cond_mel, text, main_latency, launches,
                    card)

    # ---- 5. vqvae (config #1, K3) ----
    with torch.no_grad():
        x_path, emb_path = vqvae_phase(torch, np, vq, launches, card)
        k3_checks(torch, vq, x_path, emb_path, results, card)
        del x_path, emb_path

    # ---- 6. serving (config #5, K4 + CLVP + K2) ----
    serving_phase(torch, np, tts, text, cond_mel, launches, cfg, card)
    placed_wave_check(torch, np, tts, text, cond_mel, launches, card)

    # ---- 6a. compacting waves (compact_rows: the int8 chain, K2) ----
    compact_phase(torch, np, tts, cond_mel, launches, cfg, card)

    # ---- 6b. continuous serving (slot pool, K2) + its HTTP layer ----
    with torch.no_grad():
        slots_phase(torch, np, tts, cond_wav, cond_mel, text, launches, cfg,
                    card)

    # ---- 6c. the rest of the serving side (speculative render,
    # refnet_interval, samplers, Vocos variants, evaluate_dvae) ----
    rest_s = rest_phase(torch, np, tts, text, cond_mel, launches, cfg, card)
    log(f"[rest] phase {rest_s:.1f} s  [{card}]")

    # ---- 6d. the legacy DiffusionTts, card against the CPU port ----
    diffusion_tts_phase(torch, np, card)

    # ---- 7. stream (B=1: K1-int4, HiFi-GAN, ultra_fast) ----
    stream_phase(torch, np, cfg, cond_wav, main_render, launches, card)

    # ---- 7b. train (the vqvae and gpt trainers through the CLI, K3) ----
    train_s = train_phase(torch, np, launches, results, card)
    log(f"[train] phase {train_s:.1f} s  [{card}]")

    # ---- 7c. parallel training: gloo ranks on the card, one NCCL rank ----
    parallel_phase(torch, np, card, cfg)

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
          "flash_mha+f32": "flash_attn", "flash_mha_bwd_dkv": "flash_attn",
          "flash_mha_bwd_dq": "flash_attn", "vq_nearest": "vq",
          "int8_gemm_rows": "serving_step",
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
        if name.startswith("flash_mha_bwd"):
            replaces = ("xtts_tpu/nn/flash_attn.py:99 (the library's "
                        "_flash_attention_bwd_" + name.split("_")[-1] + ")")
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
