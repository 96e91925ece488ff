#!/usr/bin/env python3
"""Device time of K2's bf16 backward kernels on one card, by ring depth.

    python3 scripts/bench_flash_bwd.py [--stages 2 3] [--rounds 2]

From the root of a checkout, on a machine with an sm_90 card, nvcc and
PyTorch built for CUDA. Builds a copy of csrc/flash_attn.cu for each
depth of the backward's cp.async ring (BWD_STAGES) with -Xptxas -v and
prints the backward kernels' registers, shared memory and spills, with
any ptxas warning (such as wgmma serialized). Then, at the main bucket
(2, 1280 | 1562, 8, 64), the 604 cap bucket (2, 2416 | 2698) and a
[train] flash step's (8, 1200 | 1600), it checks each build's
gradients against the f32 plain backward (chip_smoke's K2_BWD_TOL) and
times flash_mha_bwd_dkv and flash_mha_bwd_dq as device us a call
(chip_smoke.device_us: 100 calls in one CUDA graph, median of five
replays), the builds in turns (a, b, b, a per round), beside SDPA's
backward (forward + backward less forward). Prints one JSON line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import K2_BWD_TOL, K2_TRAIN_SHAPE, device_us  # noqa: E402

SHAPES = ((2, 1280, 1562), (2, 2416, 2698), K2_TRAIN_SHAPE)


RING = "constexpr int BWD_STAGES = 2;"


def build(stages: int, out_dir: Path):
    """csrc/flash_attn.cu at this ring depth: (stages, .so, ptxas lines of
    the backward kernels)."""
    from xtts_tpu_torch.ops.build import CSRC, NVCC_FLAGS, _nvcc
    src = (CSRC / "flash_attn.cu").read_text()
    if RING not in src:
        raise SystemExit(f"bench_flash_bwd: the source no longer holds "
                         f"{RING!r}")
    cu = out_dir / f"flash_attn_s{stages}.cu"
    cu.write_text(src.replace(RING, f"constexpr int BWD_STAGES = {stages};"))
    so = cu.with_suffix(".so")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-Xptxas", "-v", "-o",
         str(so), str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed at {stages} stages:\n{proc.stderr}")
    lines, keep = [], False
    for line in proc.stderr.splitlines():     # "Compiling entry function
        if "Compiling entry function" in line:  # 'name'" then its usage
            keep = "flash_bwd" in line
        if keep or "warning" in line.lower() or "wgmma" in line:
            lines.append(line.split("ptxas info    :")[-1].strip())
    return stages, so, lines


def use(fa, so: Path) -> None:
    """Point the wrapper at this build (its argtypes set as _lib sets
    them)."""
    fa._lib.cache_clear()
    fa.load_library = lambda name: ctypes.CDLL(str(so))
    fa._lib()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--stages", type=int, nargs="+", default=[2, 3])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_flash_bwd: no CUDA card")
    F = torch.nn.functional
    from xtts_tpu_torch.nn import flash_attn as fa
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    (ROOT / "build").mkdir(exist_ok=True)
    out = {"card": card, "shapes": {}, "ptxas": {}, "attrs": {}}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        with ThreadPoolExecutor(len(args.stages)) as pool:
            built = list(pool.map(lambda s: build(s, Path(tmp)),
                                  args.stages))
        libs = {s: so for s, so, _ in built}
        for s, _, lines in built:
            out["ptxas"][s] = lines
            print(f"[ptxas] {s} stages: " + " | ".join(lines), flush=True)
        g = torch.Generator(device="cuda").manual_seed(97)
        for b, tq, tk in SHAPES:
            q, k, v, do = (torch.randn(b, t, 8, 64, generator=g,
                                       device="cuda").bfloat16()
                           for t in (tq, tk, tk, tq))
            o, lse = fa._flash_fwd_cuda(q, k, v, 0.125, True)
            delta = fa._delta(o, do)
            o32, lse32 = fa.flash_mha_plain_lse(q.float(), k.float(),
                                                v.float(), 0.125)
            want = fa.flash_mha_bwd_plain(q.float(), k.float(), v.float(),
                                          o32, lse32, do.float(), 0.125)
            del o32, lse32
            row = {"errors": {}, "dkv_us": {}, "dq_us": {}}
            for s in args.stages:
                use(fa, libs[s])
                out["attrs"][s] = {" ".join(map(str, key)): a for key, a in
                                   fa.bwd_kernel_attrs().items()}
                got = fa.flash_mha_bwd(q, k, v, o, lse, do, 0.125)
                errs = [(x.float() - w).abs().max().item()
                        / w.abs().max().item() for x, w in zip(got, want)]
                if max(errs) > K2_BWD_TOL["bf16"]:
                    raise SystemExit(f"{s} stages {(b, tq, tk)}: errors "
                                     f"{errs}")
                row["errors"][s] = errs
                row["dkv_us"][s], row["dq_us"][s] = [], []
            turns = args.stages + args.stages[::-1]
            for s in turns * args.rounds:
                use(fa, libs[s])
                row["dkv_us"][s].append(device_us(
                    torch, lambda: fa.flash_mha_bwd_dkv(q, k, v, do, lse,
                                                        delta, 0.125)))
                row["dq_us"][s].append(device_us(
                    torch, lambda: fa.flash_mha_bwd_dq(q, k, v, do, lse,
                                                       delta, 0.125)))
            qs, ks, vs = (t.transpose(1, 2).contiguous().requires_grad_()
                          for t in (q, k, v))
            dos = do.transpose(1, 2).contiguous()
            with torch.enable_grad():
                def sdpa():
                    return F.scaled_dot_product_attention(qs, ks, vs,
                                                          scale=0.125)
                row["sdpa_bwd_us"] = device_us(torch, lambda: torch.autograd
                                               .grad(sdpa(), (qs, ks, vs),
                                                     dos)) - device_us(
                                                         torch, sdpa)
            unit = 2 * b * 8 * tq * tk * 64
            for s in args.stages:
                dkv = statistics.median(row["dkv_us"][s])
                dq = statistics.median(row["dq_us"][s])
                print(f"[bwd] {s} stages (B {b}, Tq {tq}, Tk {tk}): dkv "
                      f"{dkv:.2f} us ({4 * unit / dkv / 1e6:.1f} TFLOP/s), "
                      f"dq {dq:.2f} us ({3 * unit / dq / 1e6:.1f} TFLOP/s), "
                      f"sum {dkv + dq:.2f}; sdpa backward "
                      f"{row['sdpa_bwd_us']:.2f} us; errors "
                      f"{', '.join(f'{e:.2e}' for e in row['errors'][s])} "
                      f"[{card}]", flush=True)
            out["shapes"][f"{b}x{tq}x{tk}"] = row
            del q, k, v, do, o, lse, delta, want, got, qs, ks, vs, dos
            torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
