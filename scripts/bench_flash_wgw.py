#!/usr/bin/env python3
"""Where K2's wide backward pairs spend their time: variant builds.

    python3 scripts/bench_flash_wgw.py [--dtype bf16|f32]
                                       [--variants base nogather ...]
                                       [--widths 128,256,384] [--rounds 2]

From the root of a checkout, on a machine with an sm_90a card, nvcc and
PyTorch built for CUDA. --dtype bf16 (the default) takes the bf16 wgmma
pair (flash_bwd_dkv_wgmma_wide, flash_bwd_dq_wgmma_wide), f32 the f32
pair (flash_bwd_dkv_f32_wide, flash_bwd_dq_f32_wide; widths above 128).
Builds a copy of csrc/flash_attn.cu for each variant with -Xptxas -v
(registers and spills of the pair are printed), then times
flash_mha_bwd_dkv and flash_mha_bwd_dq in that dtype at (2, 1280 | 1562)
over 512 channels (512 / width heads, one head at 384) as device us a
call (chip_smoke.device_us: 100 calls in one CUDA graph, median of five
replays), the builds in turns (a, b, ..., b, a a round), and prints the
clusters of each kernel that can be resident at once
(flash_attn.bwd_clusters). Each variant takes one phase out of a step,
so only `base` computes the right numbers (each variant's largest error
against the f32 plain backward, relative to the gradient's largest, is
printed). The bf16 pair's variants:

- base: the pair as it is;
- nogather: no partial read back (the DSMEM sums of S and dP left out);
- nostore: no P / dS stored into the ranks' tiles;
- nopart: no partial product (S and dP's wgmma left out);
- noprod: no output product (dV, dK, dQ's wgmma left out);
- clusterbar: the pipelined steps' waits as barrier.cluster (every
  thread of every rank) in place of the mbarriers and, at one block a
  cluster, the block barriers;
- lateload: the ring's next copy issued after the exchange, before the
  P / dS wait, in place of at the top of the step;
- prof: the pair as it is, with clock64 marks between the phases of a
  step of each kernel at one chunk a block (the cycles of each phase
  summed over every block's thread 0 and divided by the steps), read back
  after one call a width, and the clusters that can be resident at once
  (cudaOccupancyMaxActiveClusters). The phases: barrier0 (a block
  barrier, then the wait for every rank's partials), issue (the ring's
  next copy and the next partial product issued), exchange (the units'
  sums, P and dS, their stores), barrier1 (the P / dS stores' proxy
  fence, signal and wait), publish (the output products issued, the next
  partial waited for, published and signalled), drain (the products and
  the ring's copy waited for);
- a name joined by `+` applies several.

The f32 pair's: base; nogather and nostore as above (the f32 P / dS
stores); nopart (the partials' mma.sync left out, the tile family's S
products with them), noprod (the output products' mma.sync left out);
prof, clock64 marks of each kernel's step at one chunk a block: in dkv
barrier0 (the partials published, every rank's awaited), exchange,
barrier1 (every rank's P / dS awaited), products (dK or dV on both column
halves, the next tile's halves issued), partial (the next partial on the
halves as they land); in dq top (the tiles awaited, the next K issued,
the partial), barrier0, exchange (the next V issued too), barrier1,
product.

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

GATHER = """  u.s0 = ld_rank4(sS + oa, 0, c, after);
  u.s1 = ld_rank4(sS + ob, 0, c, after);
  u.d0 = ld_rank4(sdP + oa, 0, c, after);
  u.d1 = ld_rank4(sdP + ob, 0, c, after);
#pragma unroll
  for (int rk = 1; rk < WGW_MAX_CLUSTER; ++rk) {
    if (rk >= CS) break;
    add4(u.s0, ld_rank4(sS + oa, rk, c, after));
    add4(u.s1, ld_rank4(sS + ob, rk, c, after));
    add4(u.d0, ld_rank4(sdP + oa, rk, c, after));
    add4(u.d1, ld_rank4(sdP + ob, rk, c, after));
  }
"""
ZERO = """  u.s0 = u.s1 = u.d0 = u.d1 = make_float4(oa, ob, 0.f, 0.f);
"""
STORE = """  st_rank2(a, rk, c, pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
  st_rank2(a + 8 * 128, rk, c, pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
"""
PATCHES = {
    "nogather": [(GATHER, ZERO)],
    "nostore": [(STORE, "")],
    "nopart": [("    wgmma_ss(acc, desc(a + o), desc(b + o), first ? kk > 0 "
                ": 1);", "")],
    "clusterbar": [("  if (CS > 1) return mbar_wait(bars, t & 1);\n",
                    "  return cluster_sync();\n"),
                   ("  if (CS > 1) mbar_signal(bars, CS);\n", ""),
                   ("  if (CS == 1) {\n    asm volatile(\"fence.proxy.async."
                    "shared::cta;\\n\" ::: \"memory\");\n    "
                    "__syncthreads();\n    return;\n  }\n", ""),
                   ("  mbar_signal(bars + 8, CS);\n  mbar_wait(bars + 8, t & "
                    "1);\n", "  cluster_sync();\n")],
    "lateload": [("      if (t + 2 < nt) load_stage(t + 2);\n"
                  "      cp_async_commit();\n", "", 2),
                 ("      wgw_tiles_ready(bars, CS, t);\n",
                  "      if (t + 2 < nt) load_stage(t + 2);\n"
                  "      cp_async_commit();\n"
                  "      wgw_tiles_ready(bars, CS, t);\n", 2)],
    "noprod": [("    wgmma_ss_tb(acc, desc(a + 32 * kk), desc(b + 2048 * "
                "kk));", "    ;"),
               ("    wgmma_ss_tb128(acc, desc(a + 32 * kk), desc_mn2(b + "
                "2048 * kk));", "    ;")],
}


F32_STORE = """  st_rank4(a, rk, c, v[0], v[1], v[2], v[3]);
  st_rank4(a + 8 * FW_LDP * 4, rk, c, v[4], v[5], v[6], v[7]);
"""
F32_PATCHES = {
    "nogather": [(GATHER, ZERO)],
    "nostore": [(F32_STORE, "  (void)a;\n")],
    "nopart": [("      C::mma(acc[j], a, C::b_nt(b_tile, 8 * j, kk * "
                "C::KS));", "      ;", 2)],
    "noprod": [("        C::mma(t[j], a, C::b_nn(b_tile, kk * C::KS, n0 + 8 * "
                "j));", "        ;")],
}


PT = ("{ const long long now_ = clock64(); pr[%d] += now_ - last_; "
      "last_ = now_; }")
PROF_HEAD = """__device__ unsigned long long wgw_prof[16];
"""
PROF_TAIL = """
XT_API int xt_wgw_prof(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, wgw_prof, sizeof(wgw_prof));
  const unsigned long long zero[16] = {};
  cudaMemcpyToSymbol(wgw_prof, zero, sizeof(wgw_prof));
  return (int)cudaGetLastError();
}
"""
LOOP = """      const uint32_t after = wgw_wait_partials(bars, CS, t);
      if (t + 2 < nt) load_stage(t + 2);
      cp_async_commit();
      wgw_partial(part, wg ? sV : sK, wg ? sdO(n) : sQ(n), true);
      dkv_exchange(sPS, sPdP, sP + pds, sdS + pds, stats(s), t * BQ, Tq, Tk,
                   c, CS, scale_log2, scale, after);
      wgw_tiles_ready(bars, CS, t);
      products(t & 1, sQ(s), sdO(s));
      wgmma_wait<1>();  // the partial of t + 1 (the products may run)
      fence_regs(part);
      wgw_publish(mine, part);
      // the ranks may write the other parity's tiles from here on
      if (t + 1 < nt) wgw_signal_partials(bars, CS);
      wgmma_wait<0>();
      fence_regs(acc);
      cp_async_wait<0>();  // tile t + 2
      asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
"""
MARKS = (("wgw_wait_partials(bars, CS, t);\n", 0), ("true);\n", 1),
         ("scale, after);\n", 2),
         ("wgw_tiles_ready(bars, CS, t);\n", 3),
         ("wgw_signal_partials(bars, CS);\n", 4),
         ('"memory");\n', 5))
PROF_PHASES = ("barrier0", "issue", "exchange", "barrier1", "publish",
               "drain")


LOOP_DQ = """      const uint32_t after = wgw_wait_partials(bars, CS, t);
      if (t + 2 < nt) load_stage(t + 2);
      cp_async_commit();
      wgw_partial(part, wg ? sdO : sQ, wg ? sV(n) : sK(n), true);
      dq_exchange(sPS, sPdP, sdS + (t & 1) * TILE_BYTES, sL, q0, t * BK, Tq,
                  Tk, c, CS, scale_log2, scale, after);
      wgw_tiles_ready(bars, CS, t);
      products(t & 1, sK(s));
      wgmma_wait<1>();
      fence_regs(part);
      wgw_publish(mine, part);
      if (t + 1 < nt) wgw_signal_partials(bars, CS);
      wgmma_wait<0>();
      fence_regs(acc);
      cp_async_wait<0>();  // tile t + 2
      asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
"""


def prof_loop(loop: str = LOOP, marks=MARKS) -> str:
    """A kernel's step loop with a clock64 mark after each phase."""
    out, rest = "", loop
    for needle, i in marks:
        cut = rest.index(needle) + len(needle)
        out += rest[:cut] + PT % i + "\n"
        rest = rest[cut:]
    return out + rest


# The f32 pair's marks: dkv's exchange lambda and step loop, dq's
F32_DKV_EX = """    const uint32_t after = wgw_partials_ready(bars, CS, t);
    dkv_exchange<true>(sPS, sPdP, smem_u32(sP), smem_u32(sdS),
                       stats + 128 * (t & 1), t * BQ, Tq, Tk, c, CS,
                       scale_log2, scale, after);
    fw_tiles_ready(bars, CS, t);
"""
F32_DKV_LOOP = """        fw_stage<128, 16>(tile, src + col, src_t, (t + 1) * BQ, Tq, 16, tid);
      cp_async_commit();
      if (!next) break;
      cp_async_wait<1>();  // the first half of tile t + 1
      wg_sync(wg);
      zero(part);
      fw_partial<0, 8>(part, own, tile);
      cp_async_wait<0>();  // the second
      wg_sync(wg);
      fw_partial<8, 16>(part, own, tile);
"""
F32_DQ_EX = """    const uint32_t after = wgw_partials_ready(bars, CS, t);
    // every warp's reads of V_c ended: tile t + 1's may land (PER == 1)
    if (PER == 1 && t + 1 < nt)
      fw_stage<WGW_THREADS, 32>(sV, vb + c * WCH, svt, (t + 1) * BK, Tk, 0,
                                threadIdx.x);
    cp_async_commit();
    dq_exchange<true>(sPS, sPdP, smem_u32(sdS), sL, q0, t * BK, Tq, Tk, c,
                      CS, scale_log2, scale, after);
    fw_tiles_ready(bars, CS, t);
"""
F32_DQ_LOOP = """      fw_partial<0, 16>(part, own, wg ? sV : kt);
      exchange(t);
      fw_product(acc, arows, kt, 64 * wg);
"""
EX_MARKS = (("wgw_partials_ready(bars, CS, t);\n", 0),
            ("scale, after);\n", 1),
            ("fw_tiles_ready(bars, CS, t);\n", 2))
PROF_DECL = ("  long long pr[6] = {0, 0, 0, 0, 0, 0}, last_ = clock64();\n")
F32_PROF = [
    ("__global__ void __launch_bounds__(WGW_THREADS, 1)\n"
     "flash_bwd_dkv_f32_wide(",
     PROF_HEAD + "__global__ void __launch_bounds__(WGW_THREADS, 1)\n"
     "flash_bwd_dkv_f32_wide("),
    ("  float part[8][4], lo[8][4], hi[8][4];  // a partial; columns 0-63, "
     "64-127\n", "  float part[8][4], lo[8][4], hi[8][4];\n" + PROF_DECL),
    ("  float part[8][4], acc[8][4];\n",
     "  float part[8][4], acc[8][4];\n" + PROF_DECL),
    (F32_DKV_EX, ("EX", F32_DKV_EX)),
    (F32_DQ_EX, ("EX", F32_DQ_EX)),
    (F32_DKV_LOOP, ("LOOP", F32_DKV_LOOP, (
        ("16, tid);\n      cp_async_commit();\n", 3),
        ("fw_partial<8, 16>(part, own, tile);\n", 4)))),
    (F32_DQ_LOOP, ("LOOP", F32_DQ_LOOP, (
        ("fw_partial<0, 16>(part, own, wg ? sV : kt);\n", 3),
        ("fw_product(acc, arows, kt, 64 * wg);\n", 4)))),
    ("    store_tile_rows<float, 64>(out + col + 64, out_t, k0, Tk, hi);\n    return;",
     "    store_tile_rows<float, 64>(out + col + 64, out_t, k0, Tk, hi);\n"
     "    if (threadIdx.x == 0) {\n      for (int i = 0; i < 6; ++i) "
     "atomicAdd(&wgw_prof[i], (unsigned long long)pr[i]);\n      "
     "atomicAdd(&wgw_prof[7], (unsigned long long)nt);\n    }\n    return;"),
    ("    store_tile_rows<float, 64>(out + col, sqgt, q0, Tq, acc);\n    return;",
     "    store_tile_rows<float, 64>(out + col, sqgt, q0, Tq, acc);\n"
     "    if (threadIdx.x == 0) {\n      for (int i = 0; i < 6; ++i) "
     "atomicAdd(&wgw_prof[8 + i], (unsigned long long)pr[i]);\n      "
     "atomicAdd(&wgw_prof[15], (unsigned long long)nt);\n    }\n    return;"),
]
# the phases of F32_PROF's marks, dkv then dq
F32_PHASES = (("barrier0", "exchange", "barrier1", "products", "partial"),
              ("barrier0", "exchange", "barrier1", "top", "product"))


PROF = [
    ("// dK and dV of one 64-key tile's chunks (keys the accumulator rows).",
     PROF_HEAD + "// dK and dV of one 64-key tile's chunks."),
    ("  float part[32], acc[64];\n",
     "  float part[32], acc[64];\n"
     "  long long pr[6] = {0, 0, 0, 0, 0, 0}, last_ = clock64();\n"),
    (LOOP, None),
    ("  float part[32], acc[32];\n",
     "  float part[32], acc[32];\n"
     "  long long pr[6] = {0, 0, 0, 0, 0, 0}, last_ = clock64();\n"),
    (LOOP_DQ, "DQ"),
    ("    store_wg_rows(dq + b * sqgb + hd * sqgh + c * WCH + 64 * wg, sqgt, "
     "q0,\n                  Tq, acc);\n    return;",
     "    store_wg_rows(dq + b * sqgb + hd * sqgh + c * WCH + 64 * wg, sqgt, "
     "q0,\n                  Tq, acc);\n    if (threadIdx.x == 0) {\n"
     "      for (int i = 0; i < 6; ++i) atomicAdd(&wgw_prof[8 + i], "
     "(unsigned long long)pr[i]);\n      atomicAdd(&wgw_prof[15], "
     "(unsigned long long)nt);\n    }\n    return;"),
    ("    store_wg_rows(out + c * WCH, out_t, k0, Tk, acc);\n    return;",
     "    store_wg_rows(out + c * WCH, out_t, k0, Tk, acc);\n"
     "    if (threadIdx.x == 0) {\n      for (int i = 0; i < 6; "
     "++i) atomicAdd(&wgw_prof[i], (unsigned long long)pr[i]);\n      "
     "atomicAdd(&wgw_prof[7], (unsigned long long)nt);\n    }\n    return;"),
]


def prof_patches(dtype: str):
    """(old, new) pairs of the prof variant of the pair of `dtype`."""
    if dtype == "bf16":
        return [(old, {None: prof_loop(), "DQ": prof_loop(LOOP_DQ)}
                 .get(new, new)) for old, new in PROF], PROF_TAIL
    out = []
    for old, new in F32_PROF:
        if isinstance(new, tuple):
            new = prof_loop(new[1], EX_MARKS if new[0] == "EX" else new[2])
        out.append((old, new))
    return out, PROF_TAIL


def variant(name: str, src: str, dtype: str = "bf16") -> str:
    """The source of one variant of the pair of `dtype`: `base`, or
    patches joined by `+`."""
    patches = PATCHES if dtype == "bf16" else F32_PATCHES
    for part in name.split("+"):
        if part == "base":
            continue
        if part == "prof":
            pairs, tail = prof_patches(dtype)
            for old, new in pairs:
                if src.count(old) != 1:
                    raise SystemExit(f"bench_flash_wgw: the source does not "
                                     f"hold {old!r} once")
                src = src.replace(old, new)
            src += tail
            continue
        if part not in patches:
            raise SystemExit(f"bench_flash_wgw: no variant {part!r}")
        for old, new, *times in patches[part]:
            if src.count(old) != (times[0] if times else 1):
                raise SystemExit(f"bench_flash_wgw: the source does not hold "
                                 f"{old!r} as often as the patch expects")
            src = src.replace(old, new)
    return src


def build(name: str, out_dir: Path, dtype: str = "bf16"):
    """(name, .so, ptxas lines of the pair)."""
    from xtts_tpu_torch.ops.build import CSRC, NVCC_FLAGS, _nvcc
    cu = out_dir / f"flash_attn_{name}.cu"
    cu.write_text(variant(name, (CSRC / "flash_attn.cu").read_text(),
                          dtype))
    so = cu.with_suffix(".so")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-Xptxas", "-v", "-o",
         str(so), str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed for {name}:\n{proc.stderr}")
    lines, keep = [], False
    for line in proc.stderr.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"(flash_bwd_\w+_(?:wgmma|f32)_wide)", line)
            keep = m is not None
            if keep:
                lines.append(m.group(1))
        elif keep and ("Used" in line or "spill" in line):
            lines.append(line.split(":")[-1].strip())
        elif "serialized" in line:  # ptxas's wgmma performance warning
            lines.append(line.strip())
    return name, so, lines


def use(fa, so: Path) -> None:
    fa._lib.cache_clear()
    fa.load_library = lambda name: ctypes.CDLL(str(so))
    fa._lib()


def prof(torch, fa, cases, dtype: str = "bf16") -> dict:
    """The prof variant's cycles a step of each kernel, by phase, at each
    width, and the clusters that can be resident at once."""
    lib = fa._lib()
    buf = (ctypes.c_ulonglong * 16)()
    lib.xt_wgw_prof.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    phases = ((PROF_PHASES, PROF_PHASES) if dtype == "bf16"
              else F32_PHASES)
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    res = {}
    for w, (q, k, v, do, lse, delta, sc, _) in cases.items():
        fa.flash_mha_bwd_dkv(q, k, v, do, lse, delta, sc)
        fa.flash_mha_bwd_dq(q, k, v, do, lse, delta, sc)
        torch.cuda.synchronize()
        lib.xt_wgw_prof(buf)
        fa.flash_mha_bwd_dkv(q, k, v, do, lse, delta, sc)
        fa.flash_mha_bwd_dq(q, k, v, do, lse, delta, sc)
        torch.cuda.synchronize()
        lib.xt_wgw_prof(buf)
        cs = -(-(w // 128) // -(-(w // 128) // 8))
        if not buf[7] or not buf[15]:
            print(f"[prof] {dtype} width {w}: the pair does not run there",
                  flush=True)
            continue
        resident = fa.bwd_clusters(dt, w)
        for j, name in enumerate(("dkv", "dq")):
            res[f"{name} {w}"] = {p: buf[8 * j + i] / buf[8 * j + 7]
                                  for i, p in enumerate(phases[j])}
            res[f"{name} {w}"]["clusters_resident"] = resident[j]
            print(f"[prof] {name} {dtype} width {w} (clusters of {cs}, at "
                  f"most {resident[j]} resident): cycles a step " +
                  ", ".join(f"{p} {buf[8 * j + i] / buf[8 * j + 7]:.0f}"
                            for i, p in enumerate(phases[j])), flush=True)
    return res


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    ap.add_argument("--variants", nargs="+",
                    default=["base", "prof", "nogather", "nostore",
                             "nopart", "noprod"])
    ap.add_argument("--widths", default="128,256,384")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_flash_wgw: no CUDA card")
    from xtts_tpu_torch.nn import flash_attn as fa
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    (ROOT / "build").mkdir(exist_ok=True)
    out = {"card": card, "dtype": args.dtype, "ptxas": {}, "us": {},
           "errors": {}}
    dt = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    widths = [int(w) for w in args.widths.split(",")]
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        with ThreadPoolExecutor(len(args.variants)) as pool:
            built = list(pool.map(lambda v: build(v, Path(tmp), args.dtype),
                                  args.variants))
        libs = {v: so for v, so, _ in built}
        for v, _, lines in built:
            out["ptxas"][v] = lines
            print(f"[ptxas] {v}: " + " | ".join(lines), flush=True)
        g = torch.Generator(device="cuda").manual_seed(97)
        b, tq, tk = 2, 1280, 1562
        cases = {}
        for w in widths:
            h = 512 // w if 512 % w == 0 else 1
            sc = w ** -0.5
            q, k, v, do = (torch.randn(b, t, h, w, generator=g,
                                       device="cuda").to(dt)
                           for t in (tq, tk, tk, tq))
            o, lse = fa._flash_fwd_cuda(q, k, v, sc, True)
            delta = fa._delta(o, do)
            qf, kf, vf = (t.float() for t in (q, k, v))
            o32, lse32 = fa.flash_mha_plain_lse(qf, kf, vf, sc)
            want = fa.flash_mha_bwd_plain(qf, kf, vf, o32, lse32, do.float(),
                                          sc)
            cases[w] = (q, k, v, do, lse, delta, sc, want)
        for v_ in args.variants:
            use(fa, libs[v_])
            errs = {}
            for w, (q, k, v, do, lse, delta, sc, want) in cases.items():
                dk, dv = fa.flash_mha_bwd_dkv(q, k, v, do, lse, delta, sc)
                dq = fa.flash_mha_bwd_dq(q, k, v, do, lse, delta, sc)
                errs[w] = [((x.float() - y).abs().max() / y.abs().max())
                           .item() for x, y in zip((dq, dk, dv), want)]
            out["errors"][v_] = errs
            print(f"[errors] {v_}: " + "; ".join(
                f"{w}: " + ", ".join(f"{e:.2e}" for e in es)
                for w, es in errs.items()), flush=True)
            if "prof" in v_.split("+"):
                out.setdefault("prof", {})[v_] = prof(torch, fa, cases,
                                                      args.dtype)
        got = {v_: {} for v_ in args.variants}
        turns = args.variants + args.variants[::-1]
        for v_ in turns * args.rounds:
            use(fa, libs[v_])
            for w, (q, k, v, do, lse, delta, sc, _) in cases.items():
                for name, fn in (
                        ("dkv", lambda: fa.flash_mha_bwd_dkv(
                            q, k, v, do, lse, delta, sc)),
                        ("dq", lambda: fa.flash_mha_bwd_dq(
                            q, k, v, do, lse, delta, sc))):
                    got[v_].setdefault(f"{w}_{name}", []).append(
                        device_us(torch, fn))
        for v_ in args.variants:
            med = {c: statistics.median(x) for c, x in got[v_].items()}
            out["us"][v_] = med
            print(f"[wgw] {v_}: " + ", ".join(
                f"{c} {t:.2f}" for c, t in med.items()) + f" us  [{card}]",
                flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
