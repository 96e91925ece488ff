#!/usr/bin/env python3
"""Device time of K1-int4's int4_gemv on one card, and where it goes.

    python3 scripts/bench_int4_gemv.py

From the root of a checkout, on a machine with an sm_90 card, nvcc and
PyTorch built for CUDA. Device time a call is measured as 100 calls
captured in one CUDA graph and replayed between two CUDA events (median of
five replays), so the host launch is out of the reading. Random packed int4
weights (values in [-7, 7]) with per-group scales, D = 1024.

Prints one JSON line with:
  - "shapes": the K1-int4 step's products (qkv, proj += residual, fc +
    gelu, out (four groups) += residual, head), each L2-resident (one
    weight copy called 100 times) and rotating (the calls cycle through 32
    copies, 64-150 MB, more than the 50 MB L2), beside torch.matmul on the
    dequantized bf16 weights read the same two ways; qkv, fc and head also
    with the norm prologue (ln_1, ln_2, ln_f then final_norm) fused and as
    layer_norm_rows + product ("pair");
  - "breakdown": proj, fc, out and head (L2-resident) for the kernel as it
    is and for copies of csrc/decode_step.cu built with one phase removed
    (outputs wrong, timing only): the merge's fence and counter (out: its
    four groups merge through the last block), the products, the weight
    loads, and everything (an empty kernel); and for copies with another
    split plan (K split until >= 128 blocks), 64 columns a block (with and
    without that split), or the weights' copies issued before the input's
    loads (outputs right, each copy called with ample scratch); and, at
    out only, a copy whose four group chunks merge through distributed
    shared memory in a cluster of their 4 blocks instead of through the
    last block and global scratch;
  - "timeline": a copy that stamps %globaltimer at the phases of every
    block (ns): the spread of block starts, the median block's time from
    start to its input staged, to its first weights, through its products
    and through its reduction, and the last store after the first start.
"""
from __future__ import annotations

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

# variant -> (text of csrc/decode_step.cu, its replacement)
CUTS = {
    "without the merge's fence and counter": [
        ("      __threadfence();  // the sum is visible before the count "
         "moves\n", ""),
        ("last = atomicAdd(count + tile, 1u) == (unsigned)ns - 1;",
         "last = q == 0;")],
    "without products": [
        ("    for (int row = s * rs + lane; row < r1; row += I4_LANES) {",
         "    for (int row = s * rs + lane; row < 0; row += I4_LANES) {")],
    "without weight loads": [
        ("c < r1 * CPR; c += I4_THREADS)", "c < 0; c += I4_THREADS)")],
    "empty": [("  __shared__ bool last;\n", "  __shared__ bool last;\n"
               "  if (K > 0) return;\n")],
    "split to 128 blocks": [("constexpr int I4_MIN_BLOCKS = 32;",
                             "constexpr int I4_MIN_BLOCKS = 128;")],
    "64 columns a block": [("constexpr int I4_COLS = 32; ",
                            "constexpr int I4_COLS = 64; ")],
    "64 columns a block, split to 128 blocks": [
        ("constexpr int I4_COLS = 32; ", "constexpr int I4_COLS = 64; "),
        ("constexpr int I4_MIN_BLOCKS = 32;",
         "constexpr int I4_MIN_BLOCKS = 128;")],
    "weights issued before the input's loads": [
        ("    issue_weights();\n\n", ""),
        ("  // ---- the epilogue's operands, loaded now ----\n",
         "  issue_weights();\n"
         "  // ---- the epilogue's operands, loaded now ----\n")],
}

# the four group chunks of out merged through distributed shared memory in
# a cluster of the 4 blocks instead of by the last block through global
# scratch (grid.x must be 4: timed at out only)
CLUSTER_MERGE = [
    ("template <bool LN>\n__global__ void __launch_bounds__(I4_THREADS)\n"
     "int4_gemv_kernel(",
     "template <bool LN>\n__global__ void __cluster_dims__(4, 1, 1) "
     "__launch_bounds__(I4_THREADS)\nint4_gemv_kernel("),
    ("""  if (ns > 1) {
    // several chunks: the last block of the tile to arrive merges them
    float* tpart = part + (size_t)tile * ns * I4_COLS;  // [chunk][32]
    if (tid < I4_COLS) {
      tpart[q * I4_COLS + tid] = sum;
      __threadfence();  // the sum is visible before the count moves
    }
    __syncthreads();
    if (tid == 0) last = atomicAdd(count + tile, 1u) == (unsigned)ns - 1;
    __syncthreads();
    if (!last) return;
    if (tid == 0) count[tile] = 0;  // every block of the tile has counted
  }
""", """  __shared__ float csum[I4_COLS];
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  if (tid < I4_COLS) csum[tid] = sum;
  cluster.sync();
  float dsum[4];
  if (q == 0 && tid < I4_COLS)
    for (int rr = 0; rr < 4; ++rr)
      dsum[rr] = cluster.map_shared_rank(csum, rr)[tid];
  cluster.sync();
  if (q != 0) return;
"""),
    ("""          sg = __fadd_rn(sg, __ldcg(tpart + (gg * splits + rr) * I4_COLS +
                                    tid));""",
     """          sg = __fadd_rn(sg, dsum[gg * splits + rr]);"""),
]

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
    ("  // ---- the products: lane l, word j;",
     "  stamp(1);\n  // ---- the products: lane l, word j;"),
    ("    __syncthreads();  // group s of every thread, and xs, are visible\n",
     "    __syncthreads();  // group s of every thread, and xs, are visible\n"
     "    if (s == 0) stamp(2);\n"),
    ("  __syncthreads();  // every warp is done with ws, which red reuses\n",
     "  stamp(3);\n"
     "  __syncthreads();  // every warp is done with ws, which red reuses\n"),
    ("  if (ns > 1) {\n", "  stamp(4);\n  if (ns > 1) {\n"),
    ("      reinterpret_cast<float*>(out)[n] = __fadd_rn(po, y);\n    }\n",
     "      reinterpret_cast<float*>(out)[n] = __fadd_rn(po, y);\n    }\n"
     "    stamp(5);\n"),
]


def build_variant(name, cuts, out_dir):
    from xtts_tpu_torch.ops.build import CSRC, NVCC_FLAGS, _nvcc
    src = (CSRC / "decode_step.cu").read_text()
    for old, new in cuts:
        if old not in src:
            raise SystemExit(f"bench_int4_gemv: {name}: the source no longer "
                             f"holds {old.strip()!r}")
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
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_int4_gemv: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    from xtts_tpu_torch.ops import decode_step as ds
    from xtts_tpu_torch.ops.build import build_all

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    build_all(("decode_step",))
    g = torch.Generator(device="cuda").manual_seed(0)
    d = 1024

    def norm(n):
        return tuple(1 + 0.1 * torch.randn(d, generator=g, device="cuda")
                     if i % 2 == 0 else
                     0.1 * torch.randn(d, generator=g, device="cuda")
                     for i in range(2 * n))

    products = {"qkv": (d, 3 * d, 1, dict(), norm(1)),
                "proj+res": (d, d, 1, dict(acc=True), None),
                "fc+gelu": (d, 4 * d, 1, dict(gelu=True,
                                              out_dtype=torch.bfloat16),
                            norm(1)),
                "out+res": (4 * d, d, 4, dict(acc=True), None),
                "head": (d, 9216, 1, dict(), norm(2))}
    shapes, operands = {}, {}
    for name, (k, n, groups, kw, ln) in products.items():
        kw = dict(kw)
        copies = [ds.pack_int4(torch.randint(-7, 8, (k, n), generator=g,
                                             device="cuda").to(torch.int8))
                  for _ in range(32)]
        sc = torch.rand(groups, n, generator=g, device="cuda") * 0.02 + 1e-3
        b = torch.randn(n, generator=g, device="cuda") * 0.1
        x = torch.randn(k, generator=g, device="cuda").bfloat16()
        if kw.pop("acc", False):
            kw["out"] = torch.zeros(n, device="cuda")
        operands[name] = (x, copies[0], sc, b, kw)
        calls = [lambda w=w: ds.int4_gemv(x, w, sc, b, **kw) for w in copies]
        wb = [(ds.unpack_int4(w).float().reshape(groups, -1, n)
               * sc[:, None]).reshape(k, n).bfloat16() for w in copies]
        mms = [lambda w=w: torch.matmul(x[None], w) for w in wb]
        shapes[name] = device_us(torch, calls[0])
        shapes[name + " rotating"] = device_us(torch, rotating(calls))
        shapes[name + " matmul"] = device_us(torch, mms[0])
        shapes[name + " matmul rotating"] = device_us(torch, rotating(mms))
        del wb, mms
        if ln is not None:
            x32 = torch.randn(k, generator=g, device="cuda") * 3 + 1
            w0 = copies[0]
            shapes[name + " +ln fused"] = device_us(
                torch, lambda: ds.int4_gemv(x32, w0, sc, b, ln=ln, **kw))
            shapes[name + " +ln pair"] = device_us(
                torch, lambda: ds.int4_gemv(
                    ds.layer_norm_rows(x32[None], *ln)[0], w0, sc, b, **kw))

    variants = {"kernel": []}
    variants.update(CUTS)
    variants["timeline"] = TIMELINE
    variants["cluster merge"] = CLUSTER_MERGE
    breakdown = {}
    part = torch.empty(1 << 22, device="cuda")
    count = torch.zeros(4096, dtype=torch.int32, device="cuda")
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        with ThreadPoolExecutor(len(variants)) as pool:
            libs = dict(pool.map(lambda kv: build_variant(kv[0], kv[1],
                                                          Path(tmp)),
                                 variants.items()))
        P, I = ctypes.c_void_p, ctypes.c_int
        timeline = {}
        for vname, so in libs.items():
            fn = ctypes.CDLL(str(so)).xt_int4_gemv
            fn.argtypes = [P] * 7 + [I] * 5 + [P]
            fn.restype = I
            for name in ("proj+res", "fc+gelu", "out+res", "head"):
                if vname == "cluster merge" and name != "out+res":
                    continue
                x, w, sc, b, kw = operands[name]
                k, n, groups = products[name][:3]
                o = torch.zeros(n, device="cuda")
                mode = 2 if "out" in kw else 0

                def call():
                    rc = fn(*(P(t.data_ptr()) for t in (x, w, sc, b, o, part,
                                                        count)),
                            k, n, groups, int(kw.get("gelu", False)), mode,
                            P(torch.cuda.current_stream().cuda_stream))
                    if rc:
                        raise RuntimeError(f"{vname}: CUDA error {rc}")
                if vname != "timeline":
                    breakdown[f"{vname}: {name}"] = device_us(torch, call)
                    continue
                dbg = part[1 << 21:].view(torch.int64)
                dbg.zero_()
                for _ in range(3):       # warm, then the last call's stamps
                    call()
                torch.cuda.synchronize()
                blocks = groups * ds.int4_gemv_plan(k, n, groups)[0] * (
                    n // ds.I4_COLS)
                t = dbg[:blocks * 8].view(blocks, 8)[:, :6].double()
                t0 = t[:, 0].min()
                phase = (t[:, 1:5] - t[:, 0:4]).median(0).values
                stored = t[:, 5] > 0
                timeline[name] = dict(
                    blocks=blocks,
                    start_spread_ns=float(t[:, 0].max() - t0),
                    median_phase_ns=[float(v) for v in phase],
                    last_store_ns=float(t[stored, 5].max() - t0))
    print(json.dumps(dict(card=card, plan={
        name: ds.int4_gemv_plan(k, n, groups)[0]
        for name, (k, n, groups, _, _) in products.items()},
        shapes=shapes, breakdown=breakdown, timeline=timeline)), flush=True)


if __name__ == "__main__":
    main()
