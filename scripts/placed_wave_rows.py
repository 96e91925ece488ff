#!/usr/bin/env python3
"""Placed against unplaced serving waves of the port, on one card.

    python3 scripts/placed_wave_rows.py

builds chip_smoke's `[main]` model (XTTSConfig(), random weights from seed
0, bf16, int8 decode, the stop logit pinned low) and its placed-wave
requests (3 texts of 40-50 token ids, padded to 4 rows), then:

* the draws: one (4, V) exponential draw from a seeded CUDA generator
  against the two blocks that parallel.mesh.row_block gives two replicas
  starting from the same state (equal or not);
* for each temperature and seed, the wave's codes (64 a row) unplaced over
  the 4 padded rows, placed on two replicas on cuda:0 (two rows each),
  and unplaced again: for each real row, the number of codes that differ
  from the first unplaced wave and the first index that differs;
* the row count alone: the same near-greedy wave (temperature 1e-8) over
  the 2 rows of the second block, unplaced, against the 4-row wave's
  codes of those rows.

Prints the card's name and power limit, then one line a measurement.
"""
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from xtts_tpu_torch.core.config import XTTSConfig  # noqa: E402
from xtts_tpu_torch.infer.api import TextToSpeech, TTSSettings  # noqa: E402
from xtts_tpu_torch.infer.serving import (SynthesisRequest,  # noqa: E402
                                          _synthesize)
from xtts_tpu_torch.parallel import mesh as pm  # noqa: E402

SR = 24000
DEV = "cuda"
TEMPERATURES = (1e-8, 1e-4, 0.8, 1.0)
SEEDS = (5, 6)


def draws_check(vocab: int) -> list:
    full = torch.empty((4, vocab), device=DEV).exponential_(
        1, generator=torch.Generator(DEV).manual_seed(7))
    same = []
    for i in range(2):
        t = torch.Generator(DEV)
        t.set_state(torch.Generator(DEV).manual_seed(7).get_state())
        with pm.row_block(i, 2):
            q = pm.block_draw(lambda s: torch.empty(
                s, device=DEV).exponential_(1, generator=t), (2, vocab))
        same.append(bool(torch.equal(q, full[2 * i:2 * i + 2])))
    return same


def diff(a, b) -> list:
    """(codes that differ, first index that differs) a row."""
    out = []
    for x, y in zip(a, b):
        n = min(len(x), len(y))
        d = np.nonzero(x[:n] != y[:n])[0]
        out.append((int(len(d)) + abs(len(x) - len(y)),
                    int(d[0]) if len(d) else None))
    return out


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = XTTSConfig()
    print(f"draws: blocks equal to the whole draw's rows "
          f"{draws_check(cfg.gpt.number_mel_codes)}", flush=True)
    tts = TextToSpeech(cfg, device=DEV, dtype=torch.bfloat16,
                       quantized_decode=True, with_clvp=True,
                       generator=torch.Generator(device=DEV).manual_seed(0))
    with torch.no_grad():
        tts.gpt.mel_head.bias[cfg.gpt.stop_mel_token] = -30.0
        tts.requantize()
    rng = np.random.default_rng(0)
    t = np.arange(3 * SR) / SR
    cond_wav = (0.3 * np.sin(2 * np.pi * 220 * t)
                + 0.1 * rng.standard_normal(3 * SR)).astype(np.float32)
    cond_mel = tts.cond_mel_from_wav(cond_wav)
    rng = np.random.default_rng(17)
    reqs = [SynthesisRequest(rng.integers(3, 250, 40 + 5 * i))
            for i in range(3)]

    def wave(rq, temp, seed, placed, buckets):
        tts.place_on_mesh(["cuda:0", "cuda:0"] if placed else None)
        s = TTSSettings(max_mel_tokens=64, temperature=temp)
        _, codes = _synthesize(tts, rq, cond_mel, s, generator=torch.Generator(
            device=DEV).manual_seed(seed), batch_buckets=buckets)
        return [c.cpu().numpy() for c in codes]

    for temp in TEMPERATURES:
        for seed in SEEDS:
            t0 = time.perf_counter()
            u = wave(reqs, temp, seed, False, (4,))
            p = wave(reqs, temp, seed, True, None)
            u2 = wave(reqs, temp, seed, False, (4,))
            print(f"temperature {temp} seed {seed}: placed against unplaced "
                  f"(differing codes, first index) a row {diff(u, p)}; "
                  f"unplaced against itself {diff(u, u2)} "
                  f"({time.perf_counter() - t0:.1f} s)  [{card}]", flush=True)
    u4 = wave(reqs, 1e-8, 5, False, (4,))
    u2 = wave([reqs[2], reqs[0]], 1e-8, 5, False, None)
    print(f"row count alone, temperature 1e-8: rows (r2, r0) unplaced at 2 "
          f"rows against the 4-row wave's {diff([u4[2], u4[0]], u2)}  "
          f"[{card}]", flush=True)


if __name__ == "__main__":
    main()
