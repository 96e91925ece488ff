#!/usr/bin/env python3
"""Device time of K3's vq_nearest on one card, against variants of it.

    python3 scripts/bench_vq.py

From the root of a checkout, on a machine with an sm_90 card, nvcc and
PyTorch built for CUDA. At the DVAE round trip's shape (N 3008 rows, D 512,
E 8192 codes; random normal rows and codebook) and at N 1001 x E 8000, it
times vq_nearest and torch.cdist + argmin as device time a call (20 calls
captured in one CUDA graph and replayed between CUDA events, median of
five), then copies of csrc/vq.cu built with every setting of the slab
depth (16, 32) and the ring's stages (2, 3, 4); the codes stay right (each
copy is checked against the kernel's codes). Prints one JSON line.
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
from chip_smoke import device_us  # noqa: E402

def _setting(bk, stages):
    """Text replacements that turn csrc/vq.cu's setting (32-deep slabs, 2
    stages) into this one."""
    cuts = []
    if bk != 32:
        cuts.append(("constexpr int BK = 32;", f"constexpr int BK = {bk};"))
    if stages != 2:
        cuts.append(("constexpr int STAGES = 2;",
                     f"constexpr int STAGES = {stages};"))
    return cuts


# every setting of slab depth and ring stages
VARIANTS = {f"{bk}-deep slabs, {st} stages": _setting(bk, st)
            for bk in (16, 32) for st in (2, 3, 4)}


def build_variant(name, cuts, out_dir):
    from xtts_tpu_torch.ops.build import CSRC, NVCC_FLAGS, _nvcc
    src = (CSRC / "vq.cu").read_text()
    for old, new in cuts:
        if old not in src:
            raise SystemExit(f"bench_vq: {name}: the source no longer holds "
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
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_vq: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    from xtts_tpu_torch.ops import vq
    from xtts_tpu_torch.ops.build import build_all

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    build_all(("vq",))
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        with ThreadPoolExecutor(len(VARIANTS)) as pool:
            libs = dict(pool.map(lambda kv: build_variant(kv[0], kv[1],
                                                          Path(tmp)),
                                 VARIANTS.items()))
        P, I = ctypes.c_void_p, ctypes.c_int
        for n, d, e in ((3008, 512, 8192), (1001, 512, 8000)):
            x = torch.randn(n, d, generator=g, device="cuda")
            emb = torch.randn(d, e, generator=g, device="cuda")
            et = emb.t().contiguous()
            esq = torch.empty(e, device="cuda")
            key = f"{n}x{d}x{e}"
            codes = vq.vq_nearest(x, emb)
            out[key + " kernel"] = device_us(
                torch, lambda: vq.vq_nearest(x, emb), n=20)
            out[key + " cdist+argmin"] = device_us(
                torch, lambda: torch.cdist(x, et).argmin(1), n=20)
            for vname, so in libs.items():
                lib = ctypes.CDLL(str(so))
                lib.xt_vq_ranges.argtypes = [I]
                lib.xt_vq_ranges.restype = I
                fn = lib.xt_vq_nearest
                fn.argtypes = [P] * 6 + [I] * 3 + [P]
                fn.restype = I
                ranges = lib.xt_vq_ranges(e)
                pv = torch.empty(n, ranges, device="cuda")
                pi = torch.empty(n, ranges, dtype=torch.int32, device="cuda")
                got = torch.empty(n, dtype=torch.int64, device="cuda")

                def call():
                    rc = fn(*(P(t.data_ptr()) for t in (x, emb, esq, pv, pi,
                                                        got)), n, d, e,
                            P(torch.cuda.current_stream().cuda_stream))
                    if rc:
                        raise RuntimeError(f"{vname}: CUDA error {rc}")
                call()
                torch.cuda.synchronize()
                if not torch.equal(got, codes):
                    raise SystemExit(f"bench_vq: {vname} gives other codes")
                out[f"{key} {vname}"] = device_us(torch, call, n=20)
    print(json.dumps(dict(card=card, device_us=out)), flush=True)


if __name__ == "__main__":
    main()
