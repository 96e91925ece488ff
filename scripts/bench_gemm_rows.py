#!/usr/bin/env python3
"""Device time of K4's int8_gemm_rows on one card, and where it goes.

    python3 scripts/bench_gemm_rows.py

From the root of a checkout, on a machine with an sm_90 card, nvcc and
PyTorch built for CUDA. Device time a call is measured as 100 calls
captured in one CUDA graph and replayed between two CUDA events (median of
five replays), so the host launch is out of the reading. Random int8
weights (quantize_dense of a scaled normal), D = 1024.

Prints one JSON line with:
  - "shapes": the K4 step's products (qkv, proj += residual, fc + gelu,
    out += residual, head) at 1, 16 and 32 rows, each beside torch.matmul
    on the dequantized bf16 weights; qkv, fc and head also with the norm
    prologue (ln_1, ln_2, ln_f then final_norm) fused and as
    layer_norm_rows + product ("pair");
  - "breakdown": fc + gelu and proj at 16 rows with the split over K
    swept, and out at its planned split, for the kernel as it is, for a
    copy of csrc/serving_step.cu whose bf16 input is always staged by the
    block's threads (stage_x) instead of by cp.async ahead of the weights
    ("without x_async", same outputs), and for copies built with one phase
    removed each (outputs wrong, timing only): the staging of x, the mma
    loop, the weight loads, the DSMEM reads of the split-K reduction, and
    all four.
"""
from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import device_us  # noqa: E402

# phase -> (text of csrc/serving_step.cu, its replacement)
CUTS = {
    "x_async": [("  const bool x_async = !LN && ",
                 "  const bool x_async = false && !LN && ")],
    "x_staging": [("  if (x_async) {\n", "  if (false) {\n"),
                  ("    if (!x_async && t % SLAB_TILES == 0) "
                   "stage_x(lo + t * GR_KT);\n", "")],
    "mma": [("    for (int ks = 0; ks < GR_KT; ks += 16) {",
             "    for (int ks = 0; ks < 0; ks += 16) {")],
    "weight_loads": [("    if (t < ntiles) load_tile(t);\n", ""),
                     ("    if (t + GR_STAGES - 1 < ntiles) "
                      "load_tile(t + GR_STAGES - 1);\n", "")],
    "reduction_reads": [
        ("        p[q] = q < S ? cluster.map_shared_rank(part, q)[off] : "
         "0.f;\n", "        p[q] = 0.f;\n")],
}


def build_variant(name, cuts, out_dir):
    from xtts_tpu_torch.ops.build import CSRC, NVCC_FLAGS, _nvcc
    src = (CSRC / "serving_step.cu").read_text()
    for old, new in cuts:
        if old not in src:
            raise SystemExit(f"bench_gemm_rows: {name}: the source no longer "
                             f"holds {old.strip()!r}")
        src = src.replace(old, new)
    cu = out_dir / f"{name}.cu"
    cu.write_text(src)
    so = out_dir / f"{name}.so"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o",
                           str(so), str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed for {name}:\n{proc.stderr}")
    return name, so


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_gemm_rows: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    from xtts_tpu_torch.infer.qdecode import quantize_dense
    from xtts_tpu_torch.ops import decode_step as ds
    from xtts_tpu_torch.ops import serving_step as ss
    from xtts_tpu_torch.ops.build import build_all

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    build_all(("decode_step", "serving_step"))
    g = torch.Generator(device="cuda").manual_seed(0)
    d = 1024
    ln1 = (1 + 0.1 * torch.randn(d, generator=g, device="cuda"),
           0.1 * torch.randn(d, generator=g, device="cuda"))
    products = {"qkv": (d, 3 * d, dict(), ln1),
                "proj+res": (d, d, dict(acc=True), None),
                "fc+gelu": (d, 4 * d, dict(gelu=True,
                                           out_dtype=torch.bfloat16), ln1),
                "out+res": (4 * d, d, dict(acc=True), None),
                "head": (d, 9216, dict(), ln1 + ln1)}
    weights = {}
    for name, (k, n, _, _) in products.items():
        q = quantize_dense(torch.randn(k, n, generator=g, device="cuda")
                           / math.sqrt(k))
        weights[name] = (q["w"], q["scale"],
                         torch.randn(n, generator=g, device="cuda") * 0.1)

    shapes = {}
    for rows in (1, 16, 32):
        for name, (k, n, kw, ln) in products.items():
            w, sc, b = weights[name]
            kw = dict(kw)
            x = torch.randn(rows, k, generator=g, device="cuda").bfloat16()
            if kw.pop("acc", False):
                res = torch.zeros(rows, n, device="cuda")
                kw["out"] = res
            key = f"{name}/{rows}"
            shapes[key] = device_us(torch, lambda: ss.int8_gemm_rows(
                x, w, sc, b, **kw))
            wb = (w.float() * sc).bfloat16()
            shapes[key + " matmul"] = device_us(torch, lambda: torch.matmul(
                x, wb))
            if ln is not None:
                x32 = torch.randn(rows, k, generator=g, device="cuda") * 3 + 1
                shapes[key + " +ln fused"] = device_us(
                    torch, lambda: ss.int8_gemm_rows(x32, w, sc, b, ln=ln,
                                                     **kw))
                shapes[key + " +ln pair"] = device_us(
                    torch, lambda: ss.int8_gemm_rows(
                        ds.layer_norm_rows(x32, *ln), w, sc, b, **kw))

    variants = {"kernel": []}
    variants.update({f"without {k}": v for k, v in CUTS.items()})
    variants["without all four"] = sum(
        (v for k, v in CUTS.items() if k != "x_async"), [])
    breakdown = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        with ThreadPoolExecutor(len(variants)) as pool:
            libs = dict(pool.map(lambda kv: build_variant(kv[0], kv[1],
                                                          Path(tmp)),
                                 variants.items()))
        P, I = ctypes.c_void_p, ctypes.c_int
        for vname, so in libs.items():
            fn = ctypes.CDLL(str(so)).xt_int8_gemm_rows
            fn.argtypes = [P] * 5 + [I] * 6 + [P]
            fn.restype = I
            for name, rows, splits in (("fc+gelu", 16, (1, 2, 4, 8)),
                                       ("proj+res", 16, (2, 4, 8)),
                                       ("out+res", 16, (8,))):
                k, n = products[name][:2]
                w, sc, b = weights[name]
                x = torch.randn(rows, k, generator=g, device="cuda").bfloat16()
                o = torch.zeros(rows, n, device="cuda")
                for s in splits:
                    def call():
                        stream = torch.cuda.current_stream().cuda_stream
                        rc = fn(*(P(t.data_ptr()) for t in (x, w, sc, b, o)),
                                rows, k, n, s, 0, 0, P(stream))
                        if rc:
                            raise RuntimeError(f"{vname}: CUDA error {rc}")
                    breakdown[f"{vname}: {name}/{rows} split {s}"] = \
                        device_us(torch, call)
    print(json.dumps(dict(card=card, plan={
        name: ss.gemm_rows_plan(k, n)[0] for name, (k, n, _, _)
        in products.items()}, shapes=shapes, breakdown=breakdown)),
        flush=True)


if __name__ == "__main__":
    main()
