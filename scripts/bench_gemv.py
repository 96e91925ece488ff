#!/usr/bin/env python3
"""Device time of K1's gemv kernels (int8_gemv, int4_gemv) on one card,
and where it goes.

    python3 scripts/bench_gemv.py [--bits 8|4]

From the root of a checkout, on a machine with an sm_90 card, nvcc and
PyTorch built for CUDA. Device time a call is measured as 100 calls
captured in one CUDA graph and replayed between two CUDA events (median of
five replays), so the host launch is out of the reading. Random weights
(int8 in [-127, 127] with per-column scales, or packed int4 in [-7, 7] with
per-group scales), D = 1024.

Prints one JSON line with:
  - "shapes": the K1 step's products (qkv, proj += residual, fc + gelu,
    out += residual (int4: four groups), head), each L2-resident (one
    weight copy called 100 times) and rotating (the calls cycle through 32
    copies, 32-300 MB, more than the 50 MB L2), beside torch.matmul on the
    dequantized bf16 weights read the same two ways; qkv, fc and head also
    with the norm prologue (ln_1, ln_2, ln_f then final_norm) fused and as
    layer_norm_rows + product ("pair");
  - "breakdown": proj, fc, out and head (L2-resident; qkv, fc and head also
    with the prologue) for the kernel as it is and for copies of
    csrc/decode_step.cu built with one phase removed (outputs wrong, timing
    only): the merge's fence and counter (a split K merges through the last
    block), the products, the weight loads, and everything (an empty
    kernel); and for copies built otherwise (outputs right, each called
    with ample scratch): register caps of 4 and 5 blocks an SM, chunks
    twice as long (int8's out in two chunks, not four), and the weights'
    copies issued before the input's loads;
  - "timeline": a copy that stamps %globaltimer at the phases of every
    block (ns): the spread of block starts, the median block's time from
    start to its input staged, to its first weights, through its products
    and through its reduction, and the last store after the first start.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import device_us, rotating  # noqa: E402

KERNEL_HEAD = ("template <int BITS, int LN>\n__global__ void "
               "__launch_bounds__(GV_THREADS)\ngemv_kernel(")

# variant -> (text of csrc/decode_step.cu, its replacement)
CUTS = {
    "without the merge's fence and counter": [
        ("      __threadfence();  // the sum is visible before the count "
         "moves\n", ""),
        ("last = atomicAdd(count + tile, 1u) == (unsigned)ns - 1;",
         "last = q == 0;")],
    "without products": [
        ("row < r1; row += GV_LANES) {", "row < 0; row += GV_LANES) {")],
    "without weight loads": [
        ("row < r1; row += GV_THREADS)", "row < 0; row += GV_THREADS)")],
    "empty": [("  __shared__ bool last;\n", "  __shared__ bool last;\n"
               "  if (K > 0) return;\n")],
    "4 blocks an SM": [(KERNEL_HEAD, KERNEL_HEAD.replace(
        "(GV_THREADS)", "(GV_THREADS, 4)"))],
    "5 blocks an SM": [(KERNEL_HEAD, KERNEL_HEAD.replace(
        "(GV_THREADS)", "(GV_THREADS, 5)"))],
    "chunks twice as long": [
        ("static constexpr int MAX_CHUNK = 8192 / BITS;",
         "static constexpr int MAX_CHUNK = 16384 / BITS;")],
    "weights issued before the input's loads": [
        ("    issue_weights();\n\n", ""),
        ("  // ---- the epilogue's operands, loaded now",
         "  issue_weights();\n"
         "  // ---- the epilogue's operands, loaded now")],
}

# the kernel with %globaltimer stamps (ns) taken by thread 0 of every
# block into scratch: 0 start, 1 loads issued and the input staged, 2 the
# first commit group landed, 3 products done, 4 the chunk's sums done, 5
# the epilogue stored (blocks that store)
TIMELINE = [
    ("  __shared__ bool last;\n",
     "  __shared__ bool last;\n"
     "  unsigned long long* dbg = reinterpret_cast<unsigned long long*>(\n"
     "      part + (1 << 21));\n"
     "  auto stamp = [&](int i) {\n"
     "    if (threadIdx.x == 0) {\n"
     "      unsigned long long t;\n"
     "      asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
     "      dbg[(blockIdx.y * gridDim.x + blockIdx.x) * 8 + i] = t;\n"
     "    }\n"
     "  };\n"
     "  stamp(0);\n"),
    ("  // ---- the products: lane l, word j",
     "  stamp(1);\n  // ---- the products: lane l, word j"),
    ("    __syncthreads();  // group s of every thread, and xs, are visible\n",
     "    __syncthreads();  // group s of every thread, and xs, are visible\n"
     "    if (s == 0) stamp(2);\n"),
    ("  __syncthreads();  // every warp is done with ws, which red reuses\n",
     "  stamp(3);\n"
     "  __syncthreads();  // every warp is done with ws, which red reuses\n"),
    ("  if (ns > 1) {", "  stamp(4);\n  if (ns > 1) {"),
    ("      reinterpret_cast<float*>(out)[n] = __fadd_rn(po, y);\n    }\n",
     "      reinterpret_cast<float*>(out)[n] = __fadd_rn(po, y);\n    }\n"
     "    stamp(5);\n"),
]


def build_variant(name, cuts, out_dir, src_name="decode_step"):
    from xtts_tpu_torch.ops.build import CSRC, NVCC_FLAGS, _nvcc
    src = (CSRC / f"{src_name}.cu").read_text()
    for old, new in cuts:
        if old not in src:
            raise SystemExit(f"bench: {name}: the source no longer holds "
                             f"{old.strip()!r}")
        src = src.replace(old, new)
    cu = out_dir / f"{abs(hash(name))}.cu"
    cu.write_text(src)
    so = cu.with_suffix(".so")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o",
                           str(so), str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed for {name}:\n{proc.stderr}")
    return name, so


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bits", type=int, choices=(8, 4), default=8)
    bits = ap.parse_args().bits
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_gemv: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    from xtts_tpu_torch.ops import decode_step as ds
    from xtts_tpu_torch.ops.build import build_all

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    build_all(("decode_step",))
    g = torch.Generator(device="cuda").manual_seed(0)
    d = 1024
    gemv = ds.int8_gemv if bits == 8 else ds.int4_gemv
    cols = ds.I8_COLS if bits == 8 else ds.I4_COLS

    def plan(k, n, groups):
        return (ds.int8_gemv_plan(k, n) if bits == 8
                else ds.int4_gemv_plan(k, n, groups))

    def norm(n):
        return tuple(1 + 0.1 * torch.randn(d, generator=g, device="cuda")
                     if i % 2 == 0 else
                     0.1 * torch.randn(d, generator=g, device="cuda")
                     for i in range(2 * n))

    def weights(k, n, groups):
        if bits == 8:
            w = torch.randint(-127, 128, (k, n), generator=g,
                              device="cuda").to(torch.int8)
            return w, w.float()
        w4 = torch.randint(-7, 8, (k, n), generator=g,
                           device="cuda").to(torch.int8)
        return ds.pack_int4(w4), w4.float()

    products = {"qkv": (d, 3 * d, 1, dict(), norm(1)),
                "proj+res": (d, d, 1, dict(acc=True), None),
                "fc+gelu": (d, 4 * d, 1, dict(gelu=True,
                                              out_dtype=torch.bfloat16),
                            norm(1)),
                "out+res": (4 * d, d, 1 if bits == 8 else 4,
                            dict(acc=True), None),
                "head": (d, 9216, 1, dict(), norm(2))}
    shapes, operands = {}, {}
    for name, (k, n, groups, kw, ln) in products.items():
        kw = dict(kw)
        copies, wf = zip(*(weights(k, n, groups) for _ in range(32)))
        sc = torch.rand(groups, n, generator=g, device="cuda") * 0.02 + 1e-3
        if bits == 8:
            sc = sc[0]
        b = torch.randn(n, generator=g, device="cuda") * 0.1
        x = torch.randn(k, generator=g, device="cuda").bfloat16()
        x32 = torch.randn(k, generator=g, device="cuda") * 3 + 1
        if kw.pop("acc", False):
            kw["out"] = torch.zeros(n, device="cuda")
        operands[name] = (x, x32, copies[0], sc, b, kw, ln)
        calls = [lambda w=w: gemv(x, w, sc, b, **kw) for w in copies]
        wb = [(w.reshape(groups, -1, n) * sc.reshape(groups, 1, n))
              .reshape(k, n).bfloat16() for w in wf]
        del wf
        mms = [lambda w=w: torch.matmul(x[None], w) for w in wb]
        shapes[name] = device_us(torch, calls[0])
        shapes[name + " rotating"] = device_us(torch, rotating(calls))
        shapes[name + " matmul"] = device_us(torch, mms[0])
        shapes[name + " matmul rotating"] = device_us(torch, rotating(mms))
        del wb, mms
        if ln is not None:
            w0 = copies[0]
            lcalls = [lambda w=w: gemv(x32, w, sc, b, ln=ln, **kw)
                      for w in copies]
            shapes[name + " +ln fused"] = device_us(torch, lcalls[0])
            shapes[name + " +ln fused rotating"] = device_us(
                torch, rotating(lcalls))
            shapes[name + " +ln pair"] = device_us(
                torch, lambda: gemv(ds.layer_norm_rows(x32[None], *ln)[0],
                                    w0, sc, b, **kw))
        del copies, calls

    variants = {"kernel": []}
    variants.update(CUTS)
    variants["timeline"] = TIMELINE
    breakdown = {}
    part = torch.empty(1 << 22, device="cuda")
    count = torch.zeros(4096, dtype=torch.int32, device="cuda")
    P, I = ctypes.c_void_p, ctypes.c_int
    n_int = 4 if bits == 8 else 5
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        with ThreadPoolExecutor(len(variants)) as pool:
            libs = dict(pool.map(lambda kv: build_variant(kv[0], kv[1],
                                                          Path(tmp)),
                                 variants.items()))
        timeline = {}
        for vname, so in libs.items():
            lib = ctypes.CDLL(str(so))
            lib.xt_gemv_setup.restype = I
            if lib.xt_gemv_setup():      # the carveout, as the wrapper sets
                raise RuntimeError(f"{vname}: xt_gemv_setup failed")
            fn = getattr(lib, f"xt_int{bits}_gemv")
            fn.argtypes = [P] * 7 + [I] * n_int + [P]
            fn_ln = getattr(lib, f"xt_int{bits}_gemv_ln")
            fn_ln.argtypes = [P] * 5 + [I] + [P] * 6 + [I] * n_int + [P]
            fn.restype = fn_ln.restype = I
            for name in ("qkv", "proj+res", "fc+gelu", "out+res", "head"):
                x, x32, w, sc, b, kw, ln = operands[name]
                k, n, groups = products[name][:3]
                o = torch.zeros(n, device="cuda")
                mode = 2 if "out" in kw else 0
                tail = [k, n] + ([] if bits == 8 else [groups]) + [
                    int(kw.get("gelu", False)), mode,
                    P(torch.cuda.current_stream().cuda_stream)]
                ops = [P(t.data_ptr()) for t in (w, sc, b, o, part, count)]

                def call(fused=False):
                    tail[-1] = P(torch.cuda.current_stream().cuda_stream)
                    if fused:
                        nrm = [P(t.data_ptr()) for t in ln]
                        nrm += nrm[:2] if len(ln) == 2 else []
                        rc = fn_ln(P(x32.data_ptr()), *nrm, len(ln) // 2,
                                   *ops, *tail)
                    else:
                        rc = fn(P(x.data_ptr()), *ops, *tail)
                    if rc:
                        raise RuntimeError(f"{vname}: CUDA error {rc}")
                if vname != "timeline":
                    if name != "qkv":
                        breakdown[f"{vname}: {name}"] = device_us(torch, call)
                    if ln is not None:
                        breakdown[f"{vname}: {name} +ln"] = device_us(
                            torch, lambda: call(True))
                    continue
                if name == "qkv":
                    continue
                dbg = part[1 << 21:].view(torch.int64)
                dbg.zero_()
                for _ in range(3):       # warm, then the last call's stamps
                    call()
                torch.cuda.synchronize()
                blocks = groups * plan(k, n, groups)[0] * (n // cols)
                t = dbg[:blocks * 8].view(blocks, 8)[:, :6].double()
                t0 = t[:, 0].min()
                phase = (t[:, 1:5] - t[:, 0:4]).median(0).values
                stored = t[:, 5] > 0
                timeline[name] = dict(
                    blocks=blocks,
                    start_spread_ns=float(t[:, 0].max() - t0),
                    median_phase_ns=[float(v) for v in phase],
                    last_store_ns=float(t[stored, 5].max() - t0))
    print(json.dumps(dict(card=card, bits=bits, plan={
        name: plan(k, n, groups)[0]
        for name, (k, n, groups, _, _) in products.items()},
        shapes=shapes, breakdown=breakdown, timeline=timeline)), flush=True)


if __name__ == "__main__":
    main()
