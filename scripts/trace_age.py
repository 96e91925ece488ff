#!/usr/bin/env python3
"""How many device records a torch.profiler session keeps, by the time
since the process's first session.

    python3 scripts/trace_age.py [--env none|teardown0|both]

From the root of a checkout, on a machine with a CUDA card, nvcc and
PyTorch built for CUDA. Warms K2's f32 wide forward (flash_mha at (2, 1280
| 1562, 2 x 256)), then traces it (chip_smoke.traced_run) in sessions that
begin 0, 3, 8 and 15 s after the first (one launch each), at 25 s (300
launches 10 ms apart) and after it (one launch), at 60 s (300 again),
with nothing but host sleep between them; then in a fresh process's first
session. Each session prints the launches, the kernel records the trace
holds, and the records' start less their launch call's (min, median, max
ms, matched by correlation id). --env sets torch's CUPTI switches before
torch is imported: teardown0 TEARDOWN_CUPTI=0, both also
DISABLE_CUPTI_LAZY_REINIT=1 (torch's own setting where its compiler
captures CUDA graphs). One JSON line at the end.
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

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--env", choices=("none", "teardown0", "both"),
                    default="none")
    ap.add_argument("--child", action="store_true",
                    help="one session only (the fresh process)")
    args = ap.parse_args()
    if args.env != "none":
        os.environ["TEARDOWN_CUPTI"] = "0"
    if args.env == "both":
        os.environ["DISABLE_CUPTI_LAZY_REINIT"] = "1"
    sys.path.insert(0, str(ROOT))
    import torch
    from chip_smoke import traced_run
    from xtts_tpu_torch.nn import flash_attn as fa
    if not torch.cuda.is_available():
        raise SystemExit("trace_age: no CUDA card")
    g = torch.Generator(device="cuda").manual_seed(96)
    q, k, v = (torch.randn(2, t, 2, 256, generator=g, device="cuda")
               for t in (1280, 1562, 1562))

    def launch():
        fa._flash_fwd_cuda(q, k, v, 256 ** -0.5, True)

    launch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = []

    def session(at: float, n: int = 1, gap: float = 0.0):
        time.sleep(max(0.0, at - (time.perf_counter() - t0)))

        def fn():
            for _ in range(n):
                launch()
                if gap:
                    torch.cuda.synchronize()
                    time.sleep(gap)
            torch.cuda.synchronize()

        began = time.perf_counter() - t0
        _, ev = traced_run(torch, fn, "trace_age")
        calls = {e["args"]["correlation"]: float(e["ts"]) for e in ev
                 if e.get("cat") == "cuda_runtime" and "Launch" in e["name"]}
        kern = [e for e in ev if e.get("cat") == "kernel"]
        off = sorted((float(e["ts"]) - calls[e["args"]["correlation"]])
                     / 1e3 for e in kern
                     if e.get("args", {}).get("correlation") in calls)
        row = {"at_s": round(began, 2), "launches": n,
               "records": len(kern), "launch_calls": len(calls),
               "offset_ms": [off[0], statistics.median(off), off[-1]]
               if off else None}
        out.append(row)
        print(f"[trace_age] {args.env}: session at {began:.1f} s, {n} "
              f"launches, {len(kern)} kernel records, {len(calls)} launch "
              f"calls; record start - launch call ms (min, median, max) "
              f"{row['offset_ms']}", flush=True)

    if args.child:
        session(0.0)
        return
    for at in (0, 3, 8, 15):
        session(at)
    session(25, 300, 0.01)
    session(0)
    session(60, 300, 0.01)
    child = subprocess.run([sys.executable, __file__, "--child", "--env",
                            args.env], capture_output=True, text=True,
                           timeout=300, cwd=ROOT)
    print(child.stdout.strip().replace("session at", "a fresh process's "
                                       "session at") or
          f"[trace_age] fresh process failed: {child.stderr[-500:]}",
          flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(json.dumps({"env": args.env, "card": card,
                      "torch": torch.__version__, "cuda": torch.version.cuda,
                      "sessions": out}))


if __name__ == "__main__":
    main()
