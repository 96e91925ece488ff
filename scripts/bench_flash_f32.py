#!/usr/bin/env python3
"""Where K2's f32 tile kernels spend their time: variant builds side by side.

    python3 scripts/bench_flash_f32.py [--variants base split3 ...] [--rounds 2]

From the root of a checkout, on a machine with an sm_90 card, nvcc and
PyTorch built for CUDA. Builds a copy of csrc/flash_attn.cu for each
variant with -Xptxas -v (registers and spills of the f32 kernels at D =
32 and 64 are printed), then times the f32 forward, flash_mha_bwd_dkv and
flash_mha_bwd_dq at the main bucket (2, 1280 | 1562, 8, 64) as device us
a call (chip_smoke.device_us: 100 calls in one CUDA graph, median of five
replays), the builds in turns (a, b, ..., b, a a round). Each variant
takes one cost out of the 3xTF32 products, so only `base` computes the
right numbers (each variant's errors against the f32 plain twins are
printed):

- base: the kernels as they are (split_tf32_cut: the small part passed
  to the tensor cores as it is, its 13 low bits cut there; partials of
  four k-steps for the long sums; the f32 forward's Q in shared memory;
  mma_nt's k-steps unrolled by 2; the f32 kernels built for 2 blocks an
  SM);
- split5: the small part rounded as well (split_tf32, K3's: 5 operations
  a split instead of 3);
- nosplit: no split: the operand's bits as the big part, the small parts
  0 (the three products still issued);
- onemma: only big x big (one mma a step instead of three);
- partial1, partial2: partials of one or two k-steps;
- inplace: the long sums accumulated in place on the tensor cores (no
  partial and IEEE add);
- qregs: the f32 forward's Q in registers up to D = 64;
- ntroll, ntfull: mma_nt's k-steps (S, dP and their transposes in the
  backward) not unrolled, unrolled whole;
- minb1: the f32 kernels built with no blocks-an-SM bound;
- a name joined by `+` applies several (e.g. `ntroll+partial2`).

Prints one line a variant and one JSON line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import device_us  # noqa: E402

SPLIT = "split_tf32_cut("
SPLITS = {
    "split5": "split_tf32(",          # the small part rounded, as K3's
    "nosplit": "split_none(",
}
NOSPLIT = """__device__ __forceinline__ void split_none(float v, uint32_t& big,
                                           uint32_t& small) {
  big = __float_as_uint(v);
  small = 0u;
}
"""
MMA = """    mma_tf32(c, a.big, b.small);
    mma_tf32(c, a.small, b.big);
    mma_tf32(c, a.big, b.big);"""
PARTIAL = "static constexpr int PARTIAL = 4;"
QREG = "return sizeof(T) == 2;"
MINB = "return sizeof(T) == 4 ? 2 : 1;"
NT = """#pragma unroll 2
  for (int kk = 0; kk < D / C::KS; ++kk) {
    const typename C::A a = C::a_tile(rows, kk * C::KS);"""
TILE = "// The tile family (mma.sync)"
PATCHES = {
    "onemma": (MMA, "    mma_tf32(c, a.big, b.big);"),
    "partial1": (PARTIAL, "static constexpr int PARTIAL = 1;"),
    "partial2": (PARTIAL, "static constexpr int PARTIAL = 2;"),
    "inplace": (PARTIAL, "static constexpr int PARTIAL = 0;"),
    "qregs": (QREG, "return D * (int)sizeof(T) <= 256;"),
    "ntroll": (NT, NT.replace("#pragma unroll 2", "#pragma unroll 1")),
    "ntfull": (NT, NT.replace("#pragma unroll 2", "#pragma unroll")),
    "minb1": (MINB, "return 1;"),
}


def variant(name: str, src: str) -> str:
    """The source of one variant: `base`, or patches joined by `+`."""
    for needle in (TILE, SPLIT, MMA, PARTIAL, QREG, NT, MINB):
        if needle not in src or (needle != SPLIT and src.count(needle) > 1):
            raise SystemExit(f"bench_flash_f32: the source does not hold "
                             f"{needle!r} once")
    head, tail = src.split(TILE, 1)
    for part in name.split("+"):
        if part in SPLITS:
            tail = tail.replace(SPLIT, SPLITS[part])
            head = head + NOSPLIT
        elif part in PATCHES:
            tail = tail.replace(*PATCHES[part])
        elif part != "base":
            raise SystemExit(f"bench_flash_f32: no variant {part!r}")
    return head + TILE + tail


def build(name: str, out_dir: Path):
    """(name, .so, ptxas lines of the f32 kernels at D = 64)."""
    from xtts_tpu_torch.ops.build import CSRC, NVCC_FLAGS, _nvcc
    cu = out_dir / f"flash_attn_{name}.cu"
    cu.write_text(variant(name, (CSRC / "flash_attn.cu").read_text()))
    so = cu.with_suffix(".so")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-Xptxas", "-v", "-o",
         str(so), str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed for {name}:\n{proc.stderr}")
    lines, keep = [], False
    for line in proc.stderr.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"(flash_\w+?_tc_kernel)IfLi(32|64)E", line)
            keep = m is not None
            if keep:
                lines.append(f"{m.group(1)}<float, {m.group(2)}>")
        elif keep and ("Used" in line or "spill" in line):
            lines.append(line.split(":")[-1].strip())
    return name, so, lines


def use(fa, so: Path) -> None:
    fa._lib.cache_clear()
    fa.load_library = lambda name: ctypes.CDLL(str(so))
    fa._lib()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", nargs="+",
                    default=["base", "split5", "nosplit", "onemma",
                             "partial1", "partial2", "inplace", "qregs"])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_flash_f32: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    from xtts_tpu_torch.nn import flash_attn as fa
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    (ROOT / "build").mkdir(exist_ok=True)
    out = {"card": card, "ptxas": {}, "us": {}}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        with ThreadPoolExecutor(len(args.variants)) as pool:
            built = list(pool.map(lambda v: build(v, Path(tmp)),
                                  args.variants))
        libs = {v: so for v, so, _ in built}
        for v, _, lines in built:
            out["ptxas"][v] = lines
            print(f"[ptxas] {v}: " + " | ".join(lines), flush=True)
        g = torch.Generator(device="cuda").manual_seed(95)
        b, tq, tk = 2, 1280, 1562
        q, k, v, do = (torch.randn(b, t, 8, 64, generator=g, device="cuda")
                       for t in (tq, tk, tk, tq))
        use(fa, libs["base"] if "base" in libs else libs[args.variants[0]])
        o, lse = fa._flash_fwd_cuda(q, k, v, 0.125, True)
        delta = fa._delta(o, do)
        o32, lse32 = fa.flash_mha_plain_lse(q, k, v, 0.125)
        want = fa.flash_mha_bwd_plain(q, k, v, o32, lse32, do, 0.125)
        out["errors"] = {}
        for v_ in args.variants:
            use(fa, libs[v_])
            ob, lb = fa._flash_fwd_cuda(q, k, v, 0.125, True)
            got = fa.flash_mha_bwd(q, k, v, ob, lb, do, 0.125)
            errs = [(ob - o32).abs().max().item(),
                    *[((x - w).abs().max() / w.abs().max()).item()
                      for x, w in zip(got, want)]]
            out["errors"][v_] = errs
            print(f"[errors] {v_}: forward {errs[0]:.2e}, dq dk dv rel "
                  f"{', '.join(f'{e:.2e}' for e in errs[1:])}", flush=True)
        del o32, lse32, want, ob, lb, got
        calls = {
            "fwd": lambda: fa.flash_mha(q, k, v, 0.125),
            "dkv": lambda: fa.flash_mha_bwd_dkv(q, k, v, do, lse, delta,
                                                0.125),
            "dq": lambda: fa.flash_mha_bwd_dq(q, k, v, do, lse, delta,
                                              0.125)}
        got = {v_: {c: [] for c in calls} for v_ in args.variants}
        turns = args.variants + args.variants[::-1]
        for v_ in turns * args.rounds:
            use(fa, libs[v_])
            for c, fn in calls.items():
                got[v_][c].append(device_us(torch, fn))
        for v_ in args.variants:
            med = {c: statistics.median(x) for c, x in got[v_].items()}
            out["us"][v_] = med
            print(f"[f32] {v_}: forward {med['fwd']:.2f} us, dkv "
                  f"{med['dkv']:.2f}, dq {med['dq']:.2f} (B {b}, Tq {tq}, "
                  f"Tk {tk}, 8 x 64)  [{card}]", flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
