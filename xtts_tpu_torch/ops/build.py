"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

Each source compiles with nvcc for sm_90a into a shared library with a
plain C interface, loaded with ctypes (no PyTorch headers, so a build takes
seconds). The library lands in build/xtts_tpu_torch/ at the checkout root,
named by a hash of its source, the shared headers (csrc/*.cuh) and the
flags, so an edited source or header rebuilds and an unchanged one is
reused. Every C entry point returns cudaGetLastError();
`check` raises on a non-zero code.
"""
from __future__ import annotations

import ctypes
import concurrent.futures
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "xtts_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of xtts_tpu_torch "
                       "build from source at first use and need the CUDA "
                       "toolkit (nvcc) on PATH or in /usr/local/cuda/bin")


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Compile csrc/<name>.cu (if its hash is not built yet) and load it."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"{name}-{digest}.so"
    if not lib_path.exists():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed for {src.name}:\n{proc.stderr}")
        os.replace(tmp, lib_path)
    return ctypes.CDLL(str(lib_path))


def build_all(names) -> None:
    """Build several kernels at once: one nvcc process for each source, all
    started together."""
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(load_library, names))


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def require_hopper(t) -> None:
    """Kernels are built for sm_90a only: refuse any other card. The answer
    is kept per device index: the capability is queried once a device, not
    at every launch."""
    _hopper(t.device.index)


@functools.cache
def _hopper(index: int) -> None:
    import torch
    cap = torch.cuda.get_device_capability(index)
    if cap != (9, 0):
        raise RuntimeError(f"xtts_tpu_torch kernels need an sm_90 (Hopper) "
                           f"card; {torch.cuda.get_device_name(index)} is "
                           f"sm_{cap[0]}{cap[1]}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
