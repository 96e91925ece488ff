#!/usr/bin/env python3
"""Device time of K4's serving_attention on one card, and where it goes.

    python3 scripts/bench_serving_attention.py

From the root of a checkout, on a machine with an sm_90 card, nvcc and
PyTorch built for CUDA. Device time a call: 100 calls captured in one CUDA
graph and replayed between two CUDA events (median of five replays), so
the host launch is out of the reading. 16 rows x 16 heads x 64 (the
serving path's K4 at D 1024), random int8 caches with per-position scales.

Prints one JSON line with:
  - "index": device us a call at cache index 0, 1, 127, 128, 353 (the
    serving path's last, S 354), 1023 and 2047 (S 2048), L2-resident (one
    layer called 100 times) and rotating (the calls cycle through the 15
    layers of a cache: 174 MB at index 353), beside the byte bound (the
    cache rows and scales below the index, read once, over 3.35 TB/s);
  - "breakdown": index 353 and 2047 (L2-resident) for the kernel as it is
    and for copies of csrc/serving_step.cu built with one phase removed
    (outputs wrong, timing only): the scores, the v sum, the chunks'
    copies, everything (an empty kernel); and a copy that rounds the score
    products to bf16 one at a time instead of two at a time by the packed
    conversion (outputs right);
  - "timeline": a copy that stamps %globaltimer in every block (ns): the
    spread of block starts, and the median block's time from its start to
    its copies issued, to its first chunk landed, through its chunks, to
    the new row and the self score done, and to its output stored.
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
from chip_smoke import HBM_BPS, device_us, rotating  # noqa: E402
from scripts.bench_gemv import build_variant  # noqa: E402

CUTS = {
    "without scores": [
        ("if (c - c1 >= nb) break;", "break;")],
    "without the v sum": [
        ("for (int p = vg; p < SA_CHUNK; p += SA_GROUPS) {",
         "for (int p = vg; p < 0; p += SA_GROUPS) {")],
    "products rounded one at a time": [
        ("""        const float2 pr = __bfloat1622float2(__floats2bfloat162_rn(
            __fmul_rn(byte_f32(wd[j >> 2], j & 3, 8388736.f), qv[j]),
            __fmul_rn(byte_f32(wd[j >> 2], (j & 3) + 1, 8388736.f),
                      qv[j + 1])));""",
         """        const float2 pr = make_float2(
            bf16_round(__fmul_rn(byte_f32(wd[j >> 2], j & 3, 8388736.f),
                                 qv[j])),
            bf16_round(__fmul_rn(byte_f32(wd[j >> 2], (j & 3) + 1,
                                          8388736.f), qv[j + 1])));""")],
    "without the chunks' copies": [("    if (c < nchunks) {",
                                    "    if (c < 0) {")],
    "empty": [("  __shared__ __align__(16) float part[SA_STEP][SA_GROUPS][64];\n",
               "  __shared__ __align__(16) float part[SA_STEP][SA_GROUPS][64];\n"
               "  if (S > 0) return;\n")],
}

# stamps by thread 0 of every block into a device array: 0 start, 1 the
# copies issued, 2 chunk 0 landed, 3 the chunks done, 4 the new row and the
# self score done, 5 the output stored
TIMELINE = [
    ("namespace {\n",
     "namespace {\n__device__ unsigned long long sa_dbg[4096 * 8];\n"),
    ("  const int nchunks = (idx + SA_CHUNK - 1) / SA_CHUNK;\n",
     "  const int nchunks = (idx + SA_CHUNK - 1) / SA_CHUNK;\n"
     "  auto stamp = [&](int i) {\n"
     "    if (threadIdx.x == 0) {\n"
     "      unsigned long long t;\n"
     "      asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
     "      sa_dbg[(blockIdx.y * gridDim.x + blockIdx.x) * 8 + i] = t;\n"
     "    }\n"
     "  };\n"
     "  stamp(0);\n"),
    ("  for (int c = 0; c < SA_STAGES; ++c) issue(c);\n",
     "  for (int c = 0; c < SA_STAGES; ++c) issue(c);\n  stamp(1);\n"),
    ("    __syncthreads();  // the step's chunks (every thread's copies) landed\n",
     "    __syncthreads();  // the step's chunks (every thread's copies) landed\n"
     "    if (c1 == 0) stamp(2);\n"),
    ("  cp_async_wait<0>();\n\n  // ---- 3.",
     "  cp_async_wait<0>();\n  stamp(3);\n\n  // ---- 3."),
    ("    const float self_s = red[32];\n",
     "    const float self_s = red[32];\n    stamp(4);\n"),
    ("    out[(size_t)b * D + c0 + tid] = __float2bfloat16(o / l);\n"
     "  }\n",
     "    out[(size_t)b * D + c0 + tid] = __float2bfloat16(o / l);\n"
     "  }\n  stamp(5);\n"),
    ("XT_API int xt_serving_attention(",
     "XT_API void xt_sa_dbg(void* dst) {\n"
     "  cudaMemcpyFromSymbol(dst, sa_dbg, sizeof(sa_dbg));\n}\n\n"
     "XT_API int xt_serving_attention("),
]


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_serving_attention: no CUDA card")
    from xtts_tpu_torch.ops import serving_step as ss
    from xtts_tpu_torch.ops.build import build_all

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    build_all(("serving_step",))
    g = torch.Generator(device="cuda").manual_seed(0)
    rows, heads, d, layers = 16, 16, 1024, 15

    def cache(s_max):
        kc = torch.randint(-127, 128, (layers, rows, s_max, d), generator=g,
                           device="cuda").to(torch.int8)
        vc = torch.randint(-127, 128, (layers, rows, s_max, d), generator=g,
                           device="cuda").to(torch.int8)
        ks = torch.rand(layers, rows, s_max, generator=g, device="cuda") * .01
        vs = torch.rand(layers, rows, s_max, generator=g, device="cuda") * .01
        return kc, vc, ks, vs

    qkv = torch.randn(rows, 3 * d, generator=g, device="cuda")
    index, caches = {}, {}
    for s_max, idxs in ((354, (0, 1, 127, 128, 353)), (2048, (1023, 2047))):
        c = cache(s_max)
        for idx in idxs:
            calls = [lambda li=li: ss.serving_attention(
                qkv, c[0][li], c[1][li], c[2][li], c[3][li], idx, heads)
                for li in range(layers)]
            nbytes = rows * idx * 2 * (d + 4)
            index[idx] = dict(
                s_max=s_max, device_us=device_us(torch, calls[0]),
                rotating_us=device_us(torch, rotating(calls), n=4 * layers),
                bound_us=nbytes / HBM_BPS * 1e6)
        caches[s_max] = [t[0].contiguous() for t in c]
        del c

    variants = {"kernel": []}
    variants.update(CUTS)
    variants["timeline"] = TIMELINE
    breakdown, timeline = {}, {}
    P, I = ctypes.c_void_p, ctypes.c_int
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        with ThreadPoolExecutor(len(variants)) as pool:
            libs = dict(pool.map(lambda kv: build_variant(
                kv[0], kv[1], Path(tmp), "serving_step"), variants.items()))
        for vname, so in libs.items():
            lib = ctypes.CDLL(str(so))
            fn = lib.xt_serving_attention
            fn.argtypes = [P] * 6 + [I] * 5 + [ctypes.c_float, P]
            fn.restype = I
            for s_max, idx in ((354, 353), (2048, 2047)):
                kc, vc, ks, vs = caches[s_max]
                o = torch.empty(rows, d, dtype=torch.bfloat16, device="cuda")

                def call():
                    rc = fn(*(P(t.data_ptr()) for t in (qkv, kc, vc, ks, vs,
                                                        o)),
                            rows, s_max, d, heads, idx, 0.125,
                            P(torch.cuda.current_stream().cuda_stream))
                    if rc:
                        raise RuntimeError(f"{vname}: CUDA error {rc}")
                if vname != "timeline":
                    breakdown[f"{vname}: {idx}"] = device_us(torch, call)
                    continue
                for _ in range(3):       # warm, then the last call's stamps
                    call()
                torch.cuda.synchronize()
                dbg = torch.zeros(4096 * 8, dtype=torch.int64)
                lib.xt_sa_dbg.argtypes = [P]
                lib.xt_sa_dbg(P(dbg.data_ptr()))
                blocks = rows * heads
                t = dbg[:blocks * 8].view(blocks, 8)[:, :6].double()
                t0 = t[:, 0].min()
                phase = (t[:, 1:6] - t[:, 0:5]).median(0).values
                timeline[idx] = dict(
                    blocks=blocks,
                    start_spread_ns=float(t[:, 0].max() - t0),
                    median_phase_ns=[float(v) for v in phase],
                    last_store_ns=float(t[:, 5].max() - t0))
    print(json.dumps(dict(card=card, index=index, breakdown=breakdown,
                          timeline=timeline)), flush=True)


if __name__ == "__main__":
    main()
