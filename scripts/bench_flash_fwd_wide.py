#!/usr/bin/env python3
"""K2's bf16 wide forward (flash_fwd_wgmma_wide): splits and variant builds.

    python3 scripts/bench_flash_fwd_wide.py [--variants base r1 r2 ...]
                                            [--widths 128,256,384]
                                            [--shape 2,1280,1562]
                                            [--rounds 2]

From the root of a checkout, on a machine with an sm_90a card, nvcc and
PyTorch built for CUDA. Builds a copy of csrc/flash_attn.cu for each
variant with -Xptxas -v (the forward instances' registers and spills,
and ptxas's wgmma warnings, are printed), then times flash_mha's bf16
forward at (B, Tq | Tk) = --shape over 512 channels (512 / width heads,
one head at 384) as device us a call (chip_smoke.device_us: 100 calls in
one CUDA graph, median of five replays), the builds in turns (a, b, ...,
b, a a round), and prints each build's largest error against the f32
twin, the plan fww_plan gives at each width (R, resident clusters of R)
and, beside the times, TFLOP/s and the share of the bound (4 B H Tq Tk D
operations at 989 TFLOP/s). The variants:

- base: the source as it is (R from fww_plan);
- rN: R forced to N (1-8) whatever the grid;
- nos: no S product (S's wgmma left out);
- nopv: no O += P V product;
- noload: no ring copy after the first FWW_AHEAD steps;
- nocombine: every rank stores its own O from the registers (no
  exchange, no cluster barrier);
- prof: the source as it is with clock64 marks between the phases of a
  key tile in the warpgroups that form S (s_begin: the S-steps' waits,
  barrier and next copies; s_issue: S's wgmma; s_wait: S awaited;
  softmax: the softmax, O's rescale and P; v_begin and v_issue: the
  V-steps' likewise), summed over each such warpgroup's first thread and
  divided by the ring steps, printed a width and warpgroup;
- ahead2, ahead4: FWW_AHEAD (ring steps copied ahead) 2 or 4, not 3;
- a name joined by `+` applies several (e.g. r1+nos).

Only base and rN compute the right numbers. One line a build and one
JSON line.
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

PATCHES = {
    "nos": [("        wgw_partial(s, a.qres ? myQ + i * WGW_CHUNK : st + "
             "WGW_CHUNK, st,\n                    i == 0);",
             "        (void)st;")],
    "nopv": [("          wgmma_rs128(acc[c], p[4 * kk], p[4 * kk + 1], "
              "p[4 * kk + 2],\n                      p[4 * kk + 3], "
              "desc_mn2(st + 2048 * kk));", "          ;"),
             ("        wgw_product(acc[c], sP, st + ROLE * TILE_BYTES);",
              "        (void)st;")],
    "noload": [("    if (n + FWW_AHEAD < nsteps) load(n + FWW_AHEAD);\n", "")],
    "ahead2": [("constexpr int FWW_AHEAD = 3;", "constexpr int FWW_AHEAD = 2;")],
    "ahead4": [("constexpr int FWW_AHEAD = 3;", "constexpr int FWW_AHEAD = 4;")],
    "nocombine": [("  if (a.R == 1) {  // ---- O normalised and stored from "
                   "the registers ----", "  if (true) {")],
}
PLAN = "    if (p.R == 0 || cost < best) {\n"

# prof: clock64 marks in the main loop of the warpgroups that form S (the
# cycles of each phase summed over every such warpgroup's first thread),
# read back with xt_fww_prof
PT = ("{ const long long now_ = clock64(); pr[%d] += now_ - last_; "
      "last_ = now_; }\n")
PROF_PHASES = ("s_begin", "s_issue", "s_wait", "softmax", "v_begin",
               "v_issue")
PROF = [
    ("// What a block of flash_fwd_wgmma_wide works on.",
     "__device__ unsigned long long fww_prof[16];\n"
     "// What a block of flash_fwd_wgmma_wide works on."),
    ("  int n = 0;\n  for (int tile = a.t0; tile < a.t1; ++tile) {\n",
     "  int n = 0;\n  long long pr[6] = {0, 0, 0, 0, 0, 0}, "
     "last_ = clock64();\n  for (int tile = a.t0; tile < a.t1; ++tile) {"
     "\n"),
    ("      begin(n, ROLE == 1);\n", "      begin(n, ROLE == 1);\n" + PT % 0),
    ("                    i == 0);\n", "                    i == 0);\n"
     + PT % 1),
    ("      wgmma_wait<0>();\n      fence_regs(s);\n      fence_regs(p);\n",
     "      wgmma_wait<0>();\n      fence_regs(s);\n      fence_regs(p);\n"
     + PT % 2),
    ("    // ---- O_c += P V_c", PT % 3 + "    // ---- O_c += P V_c"),
    ("      begin(n, ROLE == 1 && c == 0);\n",
     "      begin(n, ROLE == 1 && c == 0);\n" + PT % 4),
    ("      wgmma_commit();\n    }\n  }\n  wgmma_wait<0>();\n",
     "      wgmma_commit();\n" + PT % 5 + "    }\n  }\n"
     "  if (ROLE == 0 && (threadIdx.x & 127) == 0) {\n"
     "    for (int i = 0; i < 6; ++i) atomicAdd(&fww_prof[8 * wg + i], "
     "(unsigned long long)pr[i]);\n"
     "    atomicAdd(&fww_prof[8 * wg + 7], (unsigned long long)nsteps);\n"
     "  }\n  wgmma_wait<0>();\n"),
]
PROF_TAIL = """
XT_API int xt_fww_prof(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, fww_prof, sizeof(fww_prof));
  const unsigned long long zero[16] = {};
  cudaMemcpyToSymbol(fww_prof, zero, sizeof(fww_prof));
  return (int)cudaGetLastError();
}
"""


def variant(name: str, src: str) -> str:
    """The source of one variant: `base`, or patches joined by `+`."""
    for part in name.split("+"):
        if part == "base":
            continue
        if part == "prof":
            pairs = PROF
            src += PROF_TAIL
        elif part[0] == "r" and part[1:].isdigit():
            pairs = [(PLAN, f"    if (r == {int(part[1:])}) {{\n")]
        elif part in PATCHES:
            pairs = PATCHES[part]
        else:
            raise SystemExit(f"bench_flash_fwd_wide: no variant {part!r}")
        for old, new in pairs:
            if src.count(old) != 1:
                raise SystemExit(f"bench_flash_fwd_wide: the source does "
                                 f"not hold {old!r} once")
            src = src.replace(old, new)
    return src


def build(name: str, out_dir: Path):
    """(name, .so, ptxas lines of the forward's instances)."""
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
            m = re.search(r"flash_fwd_wgmma_wideILi(\d)ELi(\d)", line)
            keep = m is not None
            if keep:
                lines.append(f"<{m.group(1)}, {m.group(2)}>")
        elif keep and ("Used" in line or "spill" in line):
            lines.append(line.split(":")[-1].strip())
        elif "serialized" in line:  # ptxas's wgmma performance warning
            lines.append(line.strip())
    return name, so, lines


def use(fa, so: Path) -> None:
    fa._lib.cache_clear()
    fa.load_library = lambda name: ctypes.CDLL(str(so))
    fa._lib()


def prof(torch, fa, so, cases) -> dict:
    """A prof build's cycles of each phase a ring step, by warpgroup (those
    that form S), at each width (one call after one to warm)."""
    use(fa, so)
    lib = fa._lib()
    buf = (ctypes.c_ulonglong * 16)()
    lib.xt_fww_prof.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    res = {}
    for w, (q, k, v, sc, _, _) in cases.items():
        fa.flash_mha(q, k, v, sc)
        torch.cuda.synchronize()
        lib.xt_fww_prof(buf)
        fa.flash_mha(q, k, v, sc)
        torch.cuda.synchronize()
        lib.xt_fww_prof(buf)
        res[w] = {}
        for wg in (0, 1):
            turns = buf[8 * wg + 7]
            if not turns:
                continue
            res[w][wg] = {ph: buf[8 * wg + i] / turns
                          for i, ph in enumerate(PROF_PHASES)}
            print(f"[prof] width {w} warpgroup {wg}: cycles a ring step " +
                  ", ".join(f"{ph} {c:.0f}"
                            for ph, c in res[w][wg].items()), flush=True)
    return res


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", nargs="+",
                    default=["base", "r1", "r2", "r3", "r4", "r6", "r8"])
    ap.add_argument("--widths", default="128,256,384")
    ap.add_argument("--shape", default="2,1280,1562")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_flash_fwd_wide: no CUDA card")
    from xtts_tpu_torch.nn import flash_attn as fa
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    variants = args.variants
    widths = [int(w) for w in args.widths.split(",")]
    b, tq, tk = (int(x) for x in args.shape.split(","))
    (ROOT / "build").mkdir(exist_ok=True)
    out = {"card": card, "shape": [b, tq, tk], "ptxas": {}, "us": {},
           "errors": {}, "plan": {}}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        with ThreadPoolExecutor(len(variants)) as pool:
            built = list(pool.map(lambda s: build(s, Path(tmp)), variants))
        libs = {s: so for s, so, _ in built}
        for s, _, lines in built:
            out["ptxas"][s] = lines
            print(f"[ptxas] {s}: " + " | ".join(lines), flush=True)
        g = torch.Generator(device="cuda").manual_seed(98)
        cases = {}
        for w in widths:
            h = 512 // w if 512 % w == 0 else 1
            q, k, v = (torch.randn(b, t, h, w, generator=g,
                                   device="cuda").bfloat16()
                       for t in (tq, tk, tk))
            want = fa.flash_mha_plain(q.float(), k.float(), v.float(),
                                      w ** -0.5)
            cases[w] = (q, k, v, w ** -0.5, want, h)
        for s in variants:
            use(fa, libs[s])
            errs = {}
            for w, (q, k, v, sc, want, h) in cases.items():
                got = fa.flash_mha(q, k, v, sc)
                errs[w] = (got.float() - want).abs().max().item()
                if s == "base":
                    out["plan"][w] = fa.fwd_plan(b, tq, tk, h, w)
            out["errors"][s] = errs
            print(f"[errors] {s}: " + ", ".join(
                f"{w} {e:.2e}" for w, e in errs.items()), flush=True)
        for w, p in out["plan"].items():
            print(f"[plan] width {w}: {p}", flush=True)
        for s in variants:
            if "prof" in s.split("+"):
                out.setdefault("prof", {})[s] = prof(torch, fa, libs[s],
                                                     cases)
        got = {s: {} for s in variants}
        for s in (variants + variants[::-1]) * args.rounds:
            use(fa, libs[s])
            for w, (q, k, v, sc, _, _) in cases.items():
                got[s].setdefault(w, []).append(
                    device_us(torch, lambda: fa.flash_mha(q, k, v, sc)))
        for s in variants:
            med = {w: statistics.median(x) for w, x in got[s].items()}
            out["us"][s] = med
            ops = {w: 4 * b * cases[w][5] * tq * tk * w for w in med}
            print(f"[fwd] {s}: " + ", ".join(
                f"{w} {t:.2f} us ({ops[w] / t / 1e6:.0f} TFLOP/s, "
                f"{ops[w] / 989e12 / (t * 1e-6):.3f} of the bound)"
                for w, t in med.items()) + f"  [{card}]", flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
