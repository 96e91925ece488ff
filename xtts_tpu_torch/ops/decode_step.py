"""K1: the B=1 int8 GPT decode step on Hopper (port of
xtts_tpu/ops/decode_step.py).

Replaces the Pallas TPU kernel `_make_kernel` / `_fused_decode_logits`
(xtts_tpu/ops/decode_step.py:68-357), which ran the whole token step in one
pallas_call. Here the step is a chain of two hand-written CUDA kernels
(csrc/decode_step.cu), `int8_gemv` and `decode_attention`, 76 launches a
token at 15 layers; `fused_decode_logits` strings them together. Each
LayerNorm runs as the prologue of the gemv that consumes it (`ln=`), as the
TPU kernel ran `_ln` inside its one kernel; the standalone
`layer_norm_rows` computes the same norm bit for bit and no path launches
it.

Bound on the H100: weight bytes, ~190 MB of int8 per token at the flagship
width (~57 us at 3.35 TB/s). The gemv reads each weight once, 16 bytes of a
row a block with a whole chunk of rows in flight (gemv_plan), and fuses the
norm, dequant, scale, bias, gelu_new and the residual add; the chain is
still launch-bound (see PERF.md).

Numerics follow the TPU kernel, not the XLA chain of infer/qdecode.py: the
residual stays f32 across the layers, LayerNorms and softmax run in f32,
every matvec takes a bf16 input. Weights are quantize_dense's int8 (in, out)
matrices as they are; the port's layout needs no (D, D) tiling. The new
k/v row is written into the (L, S, D) bf16 cache in place at `index`.

The int4 mode (the TPU kernel's wbits == 4 branch, decode_step.py:157-167,
packed by stack_qtree_int4 :415-454) runs the same chain with `int4_gemv`
in place of `int8_gemv`: ~99 MB of packed weights a token. Its layout is
the port's own: each matrix (K, N/2) bytes, column 2j in the low nibble and
2j+1 in the high one, per-(D-row group, column) scales; the TPU kernel's
even||odd column order and its permutation matmul have no counterpart.

Each wrapper launches its kernel for a CUDA tensor (counting the launch in
its `launches` attribute) and runs its plain PyTorch twin for a CPU tensor.
The twins of layer_norm_rows, int8_gemv, int4_gemv and decode_attention
repeat their kernels' f32 operations in the kernels' order
(layer_norm_rows_ordered, ordered_sums, gelu_new_ordered,
split_attention), so on the card each kernel and its twin give the same
bits (card tests).

decode_attention takes the cache index as the TPU kernel took it by scalar
prefetch: from device memory (a 0-d integer tensor), so that one launch
captured in a CUDA graph serves every step of the AR loop
(infer/device_loop.py). An int index is range-checked and copied to the
device by the wrapper; a tensor index is the caller's to keep in range.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from xtts_tpu_torch.nn.transformer import cache_index
from xtts_tpu_torch.ops.build import (check, load_library, ptr,
                                      require_hopper, stream_of)

NEG_INF = -1e9
# layer_norm_rows stages its row in 48 KB of shared memory as f32
MAX_SMEM_FLOATS = 12288
_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("decode_step")
    lib.xt_layer_norm_rows.argtypes = [_P] * 6 + [_I, _I, _I, _P]
    lib.xt_int8_gemv.argtypes = [_P] * 7 + [_I] * 4 + [_P]
    lib.xt_int8_gemv_ln.argtypes = ([_P] * 5 + [_I] + [_P] * 6 + [_I] * 4
                                    + [_P])
    lib.xt_int4_gemv.argtypes = [_P] * 7 + [_I] * 5 + [_P]
    lib.xt_int4_gemv_ln.argtypes = ([_P] * 5 + [_I] + [_P] * 6 + [_I] * 5
                                    + [_P])
    lib.xt_int8_gemv_bounds.argtypes = [_I, _I, _P]
    lib.xt_int4_gemv_bounds.argtypes = [_I, _I, _I, _P]
    lib.xt_int8_gemv_bounds.restype = lib.xt_int4_gemv_bounds.restype = None
    lib.xt_gemv_setup.argtypes = []
    lib.xt_decode_attention.argtypes = [_P] * 5 + [_I] * 2 + [
        ctypes.c_float, _P]
    lib.xt_attention_bounds.argtypes = [_I, _P]
    lib.xt_attention_bounds.restype = None
    for fn in (lib.xt_layer_norm_rows, lib.xt_int8_gemv, lib.xt_int8_gemv_ln,
               lib.xt_int4_gemv, lib.xt_int4_gemv_ln, lib.xt_gemv_setup,
               lib.xt_decode_attention):
        fn.restype = _I
    return lib


def _check_cuda(*ts) -> None:
    for t in ts:
        if t is not None and not t.is_contiguous():
            raise ValueError("decode-step kernels take contiguous tensors")
    require_hopper(ts[0])


def norm_operands(x: torch.Tensor, ln, k: int, out=None):
    """Check a norm prologue's operands and return its C arguments.

    x: the f32 residual, K values a row; ln: (s, b) or (s1, b1, s2, b2),
    f32 (K,) each. `out` must not overlap x: other blocks still read the
    residual while one accumulates into out."""
    if len(ln) not in (2, 4):
        raise ValueError(f"ln takes (s, b) or (s1, b1, s2, b2), got "
                         f"{len(ln)} tensors")
    if x.dtype != torch.float32 or x.shape[-1] != k:
        raise ValueError(f"a norm prologue takes the f32 residual with {k} "
                         f"values a row, got {tuple(x.shape)} {x.dtype}")
    for p in ln:
        if (p.dtype != torch.float32 or p.numel() != k or p.device != x.device
                or not p.is_contiguous()):
            raise ValueError(f"norm parameters are contiguous f32 ({k},) on "
                             f"{x.device}, got {tuple(p.shape)} {p.dtype}")
    if out is not None and _overlap(x, out):
        raise ValueError("a fused norm cannot accumulate into its residual")
    two = len(ln) == 4
    s1, b1 = ln[0], ln[1]
    s2, b2 = (ln[2], ln[3]) if two else (s1, b1)
    return [s1.data_ptr(), b1.data_ptr(), s2.data_ptr(), b2.data_ptr(),
            2 if two else 1]


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    a0, b0 = a.data_ptr(), b.data_ptr()
    return (a0 < b0 + b.numel() * b.element_size()
            and b0 < a0 + a.numel() * a.element_size())


def normed_input(x, ln):
    """The bf16 input a fused product computes from the f32 residual x:
    layer_norm_rows_ordered of its rows (the plain twins' prologue, the
    kernels' statistics in their order)."""
    return layer_norm_rows_ordered(x.reshape(-1, x.shape[-1]),
                                   *ln).reshape(x.shape)


# ---------------------------------------------------------------------------
# layer_norm_rows
# ---------------------------------------------------------------------------

def layer_norm_rows_plain(x, s1, b1, s2=None, b2=None) -> torch.Tensor:
    """The LayerNorm(s) with torch's reductions: the reference that
    layer_norm_rows_ordered is held against."""
    def ln(v, s, b):
        mu = v.mean(-1, keepdim=True)
        var = ((v - mu) ** 2).mean(-1, keepdim=True)
        return (v - mu) * torch.rsqrt(var + 1e-5) * s + b
    y = ln(x.float(), s1, b1)
    if s2 is not None:
        y = ln(y, s2, b2)
    return y.to(torch.bfloat16)


def _butterfly(v: torch.Tensor) -> torch.Tensor:
    """warp_sum's fold of the last axis (32 lanes): the value every lane
    holds after the xor-16, 8, 4, 2, 1 exchanges (a + b = b + a, so lane 0's
    is every lane's)."""
    o = v.shape[-1] // 2
    while o:
        v = v[..., :o] + v[..., o:2 * o]
        o //= 2
    return v[..., 0]


def _sum256(v: torch.Tensor) -> torch.Tensor:
    """common.cuh block_sum256 of each row of v (rows, d) f32: virtual
    thread t < 256 adds elements t, t + 256, ... in turn onto 0; each
    virtual warp of 32 folds its sums by a butterfly; the 8 warp sums
    (lanes 8..31 zero) by a butterfly. Returns (rows, 1)."""
    rows, d = v.shape
    steps = -(-d // 256)
    if d != steps * 256:
        v = F.pad(v, (0, steps * 256 - d))
    v = v.reshape(rows, steps, 256)
    acc = v[:, 0] + 0.0                 # 0.f + the first term: -0 -> +0
    for j in range(1, steps):
        acc = acc + v[:, j]
    warps = _butterfly(acc.reshape(rows, 8, 32))
    # the last fold's first two levels add lanes 8..31's zeros to lanes
    # 0..7: one + 0.0, then the 8 lanes' own levels
    return _butterfly(warps + 0.0)[:, None]


def layer_norm_rows_ordered(x, s1, b1, s2=None, b2=None) -> torch.Tensor:
    """layer_norm_rows' arithmetic in its order (common.cuh
    layer_norm_inplace): each row's sum and sum of squares in
    block_sum256's order (_sum256), the divisions by d, var + eps, rsqrt,
    then (x - mu) * rstd * s + b, every f32 operation rounded on its own;
    the second norm over the first's f32 output; bf16 once at the end. On
    the card the kernel's rsqrtf and torch.rsqrt meet (PERF.md), so the two
    give the same bits."""
    x = x.float()
    # a tensor divisor: PyTorch divides a CUDA tensor by a Python number as
    # a product with its reciprocal, the kernel divides
    d = torch.full((1, 1), float(x.shape[-1]), device=x.device)

    def ln(v, s, b):
        c = v - _sum256(v) / d          # x - mu, ln_apply's first rounding
        rstd = torch.rsqrt(_sum256(c * c) / d + 1e-5)
        return c * rstd * s + b
    y = ln(x, s1, b1)
    if s2 is not None:
        y = ln(y, s2, b2)
    return y.to(torch.bfloat16)


def layer_norm_rows(x: torch.Tensor, s1: torch.Tensor, b1: torch.Tensor,
                    s2: Optional[torch.Tensor] = None,
                    b2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (rows, D) f32 -> LayerNorm(s1, b1) [then LayerNorm(s2, b2)] in f32,
    eps 1e-5, rounded to bf16 once at the end."""
    if not x.is_cuda:
        return layer_norm_rows_ordered(x, s1, b1, s2, b2)
    if (x.dtype != torch.float32 or x.dim() != 2
            or x.shape[1] > MAX_SMEM_FLOATS):
        raise ValueError("layer_norm_rows takes (rows, D <= 12288) float32")
    _check_cuda(x, s1, b1, s2, b2)
    rows, d = x.shape
    out = torch.empty((rows, d), dtype=torch.bfloat16, device=x.device)
    two = s2 is not None
    check(_lib().xt_layer_norm_rows(
        ptr(x), ptr(s1), ptr(b1), ptr(s2 if two else s1),
        ptr(b2 if two else b1), ptr(out), rows, d, 2 if two else 1,
        stream_of(x)), "layer_norm_rows")
    layer_norm_rows.launches += 1
    return out


layer_norm_rows.launches = 0


# ---------------------------------------------------------------------------
# int8_gemv and int4_gemv: one kernel template (csrc gemv_kernel)
# ---------------------------------------------------------------------------

def unpack_int4(w: torch.Tensor) -> torch.Tensor:
    """(K, N/2) packed bytes -> (K, N) int8 values in [-7, 7]."""
    b = w.to(torch.int32)                       # sign-extends the byte
    lo = ((b & 0xF) ^ 8) - 8                    # the signed low nibble
    hi = b >> 4                                 # the signed high nibble
    return torch.stack([lo, hi], dim=-1).flatten(-2).to(torch.int8)


def pack_int4(w4: torch.Tensor) -> torch.Tensor:
    """(K, N) int8 values in [-7, 7] -> (K, N/2) bytes: column 2j in the
    low nibble, column 2j+1 in the high nibble."""
    lo = w4[..., 0::2].to(torch.int32) & 0xF
    hi = w4[..., 1::2].to(torch.int32) & 0xF
    return ((hi << 4) | lo).to(torch.uint8).view(torch.int8).contiguous()


# the split plan (csrc/decode_step.cu gv_splits / gv_lo: the authority;
# this is its copy, held against xt_int8_gemv_bounds / xt_int4_gemv_bounds
# on the card). A block owns 16 bytes of each weight row: 16 int8 or 32
# int4 columns; its chunk is at most 16 KB or 32 KB.
GV_LANES = 64        # row lanes a block: lane l adds rows lo + l, + 64, ...
GV_FOLD = 8          # lanes a first-level sum
GV_MIN_BLOCKS = 32
GV_MIN_CHUNK = 64
I8_COLS, I8_MAX_CHUNK = 16, 1024
I4_COLS, I4_MAX_CHUNK = 32, 2048


def gemv_plan(k: int, n: int, groups: int, cols: int, max_chunk: int):
    """(s, bounds): each scale group of kg = k / groups rows is split into s
    chunks, chunk r taking rows [bounds[r], bounds[r + 1]) of the group,
    bounds[r] = 16 floor(r T / s) clipped to kg, T = ceil(kg / 16). s is
    1 where the ceil(n / cols) column tiles x groups make >= 32 blocks,
    else the least power of two that does, stopping at 16 or where chunks
    would be shorter than 64 rows; then doubled until no chunk exceeds
    max_chunk rows."""
    kg = k // groups
    t = -(-kg // 16)
    tiles = -(-n // cols)
    s = 1
    while (s < 16 and tiles * groups * s < GV_MIN_BLOCKS
           and kg // (2 * s) >= GV_MIN_CHUNK):
        s *= 2
    while 16 * -(-t // s) > max_chunk:
        s *= 2
    return s, [min(kg, r * t // s * 16) for r in range(s + 1)]


def int8_gemv_plan(k: int, n: int):
    """int8_gemv's plan: one chunk at every K1 product but the out matrix,
    whose 4096 rows split in four chunks of 1024."""
    return gemv_plan(k, n, 1, I8_COLS, I8_MAX_CHUNK)


def int4_gemv_plan(k: int, n: int, groups: int):
    """int4_gemv's plan: one chunk a group at every K1-int4 product."""
    return gemv_plan(k, n, groups, I4_COLS, I4_MAX_CHUNK)


def kernel_int8_gemv_plan(k: int, n: int):
    """The kernel's own plan (needs the built library, so the card)."""
    s = int8_gemv_plan(k, n)[0]
    out = (ctypes.c_int * (s + 2))()
    _lib().xt_int8_gemv_bounds(int(k), int(n), out)
    return out[0], list(out[1:out[0] + 2])


def kernel_int4_gemv_plan(k: int, n: int, groups: int):
    """The kernel's own plan (needs the built library, so the card)."""
    s = int4_gemv_plan(k, n, groups)[0]
    out = (ctypes.c_int * (s + 2))()
    _lib().xt_int4_gemv_bounds(int(k), int(n), int(groups), out)
    return out[0], list(out[1:out[0] + 2])


def ordered_sums(x, wv, groups: int, plan) -> torch.Tensor:
    """Each group's sum_k x[k] wv[k, :] in the gemv kernel's order: within
    chunk r of `plan` (s, bounds), lane l (< 64) adds rows lo + l, lo + l +
    64, ... one f32 add at a time; lanes 8h .. 8h + 7 add in order, then
    the 8 sums h in order; a group's chunks add in chunk order. x (K,)
    holds bf16 values and wv (K, N) the weights' integer values as f32, so
    every product is exact in f32 and each add is the kernel's one
    rounding. Returns (groups, N)."""
    k, n = wv.shape
    kg = k // groups
    dev = wv.device
    s, bounds = plan
    c = bounds[1]
    steps = max(1, -(-max(b - a for a, b in zip(bounds, bounds[1:]))
                     // GV_LANES))
    xf = x.float().reshape(-1)
    if bounds == [min(kg, r * c) for r in range(s + 1)] and c * s == kg:
        # equal chunks: term i of lane l of chunk r is row r c + 64 i + l
        pad = steps * GV_LANES - c
        prod = F.pad((xf[:, None] * wv).reshape(groups, s, c, n),
                     (0, 0, 0, pad)).reshape(groups, s, steps, GV_LANES, n)
    else:
        lo = torch.tensor(bounds[:-1], device=dev)
        hi = torch.tensor(bounds[1:], device=dev)
        rel = lo[:, None, None] + (
            torch.arange(steps, device=dev)[:, None] * GV_LANES
            + torch.arange(GV_LANES, device=dev)[None, :])  # (s, step, lane)
        valid = rel < hi[:, None, None]
        rows = (torch.arange(groups, device=dev)[:, None, None, None] * kg
                + torch.where(valid, rel, torch.zeros_like(rel)))
        prod = xf[rows][..., None] * wv[rows]
        prod = torch.where(valid[..., None], prod, torch.zeros_like(prod))
    acc = torch.zeros(groups, s, GV_LANES, n, device=dev)
    for i in range(steps):
        acc = acc + prod[:, :, i]
    acc = acc.reshape(groups, s, GV_LANES // GV_FOLD, GV_FOLD, n)
    fold = torch.zeros(groups, s, GV_LANES // GV_FOLD, n, device=dev)
    for lane in range(GV_FOLD):
        fold = fold + acc[:, :, :, lane]
    part = torch.zeros(groups, s, n, device=dev)
    for h in range(GV_LANES // GV_FOLD):
        part = part + fold[:, :, h]
    total = torch.zeros(groups, n, device=dev)
    for r in range(s):
        total = total + part[:, r]
    return total


def ordered_int8_sums(x, w) -> torch.Tensor:
    """sum_k x[k] w[k, :] in int8_gemv's order (ordered_sums over
    int8_gemv_plan). Returns (N,)."""
    return ordered_sums(x, w.float(), 1, int8_gemv_plan(*w.shape))[0]


def ordered_int4_sums(x, w, groups: int) -> torch.Tensor:
    """Each group's sum in int4_gemv's order (ordered_sums over
    int4_gemv_plan). Returns (groups, N)."""
    wv = unpack_int4(w).float()
    return ordered_sums(x, wv, groups, int4_gemv_plan(*wv.shape, groups))


def gelu_new_ordered(y: torch.Tensor) -> torch.Tensor:
    """csrc/common.cuh gelu_new in its order, each f32 operation rounded
    on its own: 0.5 y (1 + tanh(c (y + ((0.044715 y) y) y))), c = sqrt(2 /
    pi) as an f32 constant. On the card the kernels' epilogues and this
    give the same bits (the card's tanhf is torch.tanh's). The model's
    nn.transformer.gelu_new (a power, a double constant) stays as it is,
    for parity with the JAX package."""
    t = torch.tanh((y + y * 0.044715 * y * y) * 0.7978845608028654)
    return (y * 0.5) * (t + 1.0)


def _store(y, out, gelu, out_dtype):
    if gelu:
        y = gelu_new_ordered(y)
    if out is not None:
        out += y
        return out
    return y.to(out_dtype)


def int8_gemv_plain(x, w, scale, bias, out=None, gelu=False,
                    out_dtype=torch.float32, ln=None) -> torch.Tensor:
    """int8_gemv's arithmetic in its order (ordered_int8_sums), then the
    epilogue s * scale + bias rounded after the product and after the sum:
    on the card the two give the same bits (no gelu)."""
    if ln is not None:
        x = normed_input(x, ln)
    return _store(ordered_int8_sums(x, w) * scale + bias, out, gelu,
                  out_dtype)


def int4_gemv_plain(x, w, scale, bias, out=None, gelu=False,
                    out_dtype=torch.float32, ln=None) -> torch.Tensor:
    """int4_gemv's arithmetic in its order (ordered_int4_sums), then for
    each group in turn y_g = sum_g * scale[g] (+ bias for g = 0), rounded to
    bf16 unless gelu, added into a running f32 total: on the card the two
    give the same bits (no gelu)."""
    if ln is not None:
        x = normed_input(x, ln)
    groups = scale.shape[0]
    y = ordered_int4_sums(x, w, groups) * scale
    y[0] = y[0] + bias
    if not gelu:
        y = y.to(torch.bfloat16).float()
    total = torch.zeros_like(y[0])
    for g in range(groups):         # in group order, as the kernel sums
        total = total + y[g]
    return _store(total, out, gelu, out_dtype)


# the gemv's split-K scratch a device: the partials (grown as needed) and
# one counter a column tile, zero between launches (the kernel's last block
# of a tile resets its own). Launches run one at a time on the stream.
_GV_COUNTERS = 4096
_gv_scratch: Dict[Any, Dict[str, torch.Tensor]] = {}
# How many times any device's partials have grown. A CUDA graph holds the
# partials' address of its capture, which a growth frees: the AR loop's
# graphs are valid only while this is what it was at their capture
# (infer/device_loop.py drops them when it moves).
_gv_grown = 0


def gemv_scratch_epoch() -> int:
    """The count of partials growths (see _gv_grown)."""
    return _gv_grown
# (device, bits, w's shape, scale's shape, fused) -> what a launch of that
# product needs besides its operands: the C entry point, the arguments after
# the output pointer up to gelu (the scratch's pointers, K, N[, groups])
# and N. Made once a shape, with the checks that depend on the shapes
# alone, so that a launch checks and passes only its operands (the AR loop
# is host-bound); cleared when a device's partials grow.
_gv_launch: Dict[Any, tuple] = {}


def _gemv_scratch(device, floats: int, tiles: int):
    global _gv_grown
    if tiles > _GV_COUNTERS:
        raise ValueError(f"the gemv takes at most {_GV_COUNTERS} column "
                         f"tiles")
    sc = _gv_scratch.get(device)
    if sc is None:
        sc = _gv_scratch[device] = {
            "count": torch.zeros(_GV_COUNTERS, dtype=torch.int32,
                                 device=device),
            "part": torch.empty(0, dtype=torch.float32, device=device)}
    if sc["part"].numel() < floats:
        sc["part"] = torch.empty(floats, dtype=torch.float32, device=device)
        _gv_launch.clear()
        _gv_grown += 1
    return sc["part"], sc["count"]


def _gemv_launch(bits: int, device, wshape, sshape, fused: bool):
    """A gemv shape's entry of _gv_launch, made on its first launch (the
    checks of the shapes, the plan, the scratch, the kernels' shared-memory
    carveout on the device)."""
    if len(wshape) != 2 or len(sshape) != (1 if bits == 8 else 2):
        raise ValueError(f"int{bits}_gemv: bad shapes w {tuple(wshape)}, "
                         f"scale {tuple(sshape)}")
    k = wshape[0]
    groups, n = (1, wshape[1]) if bits == 8 else tuple(sshape)
    if wshape[1] * 8 // bits != n or n % 32 or k % groups or sshape[-1] != n:
        raise ValueError(f"int{bits}_gemv: bad shapes w {tuple(wshape)}, "
                         f"scale {tuple(sshape)}")
    if bits == 8:
        cols, splits = I8_COLS, int8_gemv_plan(k, n)[0]
    else:
        cols, splits = I4_COLS, int4_gemv_plan(k, n, groups)[0]
    tiles = -(-n // cols)
    part, count = _gemv_scratch(device, tiles * groups * splits * cols, tiles)
    lib = _lib()
    with torch.cuda.device(device):
        check(lib.xt_gemv_setup(), f"int{bits}_gemv setup")
    fn = {(8, False): lib.xt_int8_gemv, (8, True): lib.xt_int8_gemv_ln,
          (4, False): lib.xt_int4_gemv,
          (4, True): lib.xt_int4_gemv_ln}[bits, fused]
    tail = (part.data_ptr(), count.data_ptr(), k, n) + (
        () if bits == 8 else (groups,))
    got = _gv_launch[device, bits, wshape, sshape, fused] = (fn, tail, n)
    return got


def _gemv(bits: int, x, w, scale, bias, out, gelu, out_dtype, ln):
    """Check a gemv's operands, launch int8_gemv (bits 8) or int4_gemv
    (bits 4) and return its output."""
    _check_cuda(x, w, scale, bias, out)
    dev = x.device
    entry = _gv_launch.get((dev, bits, w.shape, scale.shape, ln is not None))
    fn, tail, n = entry or _gemv_launch(bits, dev, w.shape, scale.shape,
                                        ln is not None)
    want = torch.float32 if ln is not None else torch.bfloat16
    if (x.dtype != want or w.dtype != torch.int8 or x.numel() != tail[2]
            or bias.numel() != n or scale.dtype != torch.float32
            or w.data_ptr() % 16):
        raise ValueError(f"int{bits}_gemv: bad operands x {tuple(x.shape)} "
                         f"{x.dtype}, w {tuple(w.shape)} {w.dtype}, scale "
                         f"{tuple(scale.shape)} {scale.dtype}, bias "
                         f"{tuple(bias.shape)}")
    if out is not None:
        if out.dtype != torch.float32 or out.numel() != n:
            raise ValueError(f"int{bits}_gemv accumulates into an f32 (N,) "
                             f"tensor")
        mode, dst = 2, out
    else:
        if out_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"int{bits}_gemv: out_dtype {out_dtype}")
        mode = 0 if out_dtype == torch.float32 else 1
        dst = torch.empty((n,), dtype=out_dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if ln is None:
        code = fn(x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                  bias.data_ptr(), dst.data_ptr(), *tail, int(gelu), mode,
                  stream)
    else:
        code = fn(x.data_ptr(), *norm_operands(x, ln, tail[2], out),
                  w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                  dst.data_ptr(), *tail, int(gelu), mode, stream)
    check(code, f"int{bits}_gemv")
    return dst


def int8_gemv(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
              bias: torch.Tensor, out: Optional[torch.Tensor] = None,
              gelu: bool = False, out_dtype=torch.float32,
              ln=None) -> torch.Tensor:
    """y = (x_bf16 . W_int8) * scale + bias, f32 accumulation.

    x (K,) bf16; w (K, N) int8, 16-byte aligned; scale, bias (N,) f32. gelu
    applies gelu_new to y. With `out` given (f32 (N,)), y is added into it
    in place — the residual add, and the K-split accumulate of the TPU
    kernel's four out tiles, which here run as one K = 4D launch.
    Otherwise returns y in out_dtype (f32 or bf16).

    ln = (s, b) or (s1, b1, s2, b2): the norm prologue. x is then the f32
    residual (K,), and the product takes layer_norm_rows(x, *ln) — computed
    in the same launch, bit for bit the standalone kernel's output.

    The kernel runs one block for each 16 columns and chunk of
    int8_gemv_plan; where K is split (the out matrix), the chunks merge
    through this device's scratch (_gemv_scratch), so gemv launches on one
    device must not run concurrently on two streams."""
    if not x.is_cuda:
        return int8_gemv_plain(x, w, scale, bias, out, gelu, out_dtype, ln)
    dst = _gemv(8, x, w, scale, bias, out, gelu, out_dtype, ln)
    if ln is not None:
        int8_gemv.ln_launches += 1
    int8_gemv.launches += 1
    return dst


# launches: every launch; ln_launches: those with the norm prologue
int8_gemv.launches = int8_gemv.ln_launches = 0


def int4_gemv(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
              bias: torch.Tensor, out: Optional[torch.Tensor] = None,
              gelu: bool = False, out_dtype=torch.float32,
              ln=None) -> torch.Tensor:
    """y = sum_g r((x_g . W4_g) * scale[g] + (g == 0) bias), f32
    accumulation: the TPU kernel's int4 tile math.

    x (K,) bf16; w (K, N/2) packed int4 (pack_int4); scale (G, N) f32, one
    row for each group of K/G input rows; bias (N,) f32. r() rounds each
    group's output to bf16, as the TPU kernel rounds every tile it
    restores to canonical order; with gelu (its fc tiles) nothing is
    rounded before gelu_new. `out`, out_dtype and ln as int8_gemv; w must
    start 16-byte aligned.

    The kernel runs one block for each 32 columns and chunk of
    int4_gemv_plan; where a product has several chunks (K split into scale
    groups or chunks), the chunks merge through this device's scratch, as
    int8_gemv's."""
    if not x.is_cuda:
        return int4_gemv_plain(x, w, scale, bias, out, gelu, out_dtype, ln)
    dst = _gemv(4, x, w, scale, bias, out, gelu, out_dtype, ln)
    if ln is not None:
        int4_gemv.ln_launches += 1
    int4_gemv.launches += 1
    return dst


int4_gemv.launches = int4_gemv.ln_launches = 0


# ---------------------------------------------------------------------------
# decode_attention
# ---------------------------------------------------------------------------

ATT_SPLITS = 8      # blocks a head: one portable thread-block cluster
ATT_GROUPS = 16     # groups of 8 lanes a block, one cache row each
ATT_BATCH = 4       # rows a group folds in at once


def attention_bounds(index, s_max: int) -> torch.Tensor:
    """decode_attention's chunks of positions 0..index: rank r of a head's
    ATT_SPLITS blocks takes [bounds[r], bounds[r + 1]), bounds[r] = r
    (index + 1) // ATT_SPLITS. The last chunk always holds `index`; when
    index + 1 < ATT_SPLITS some chunks are empty. csrc/decode_step.cu
    att_lo is the authority; this is its copy (held against it on the card
    through kernel_attention_bounds). `index` as cache_index takes it (an
    int is checked against s_max); the bounds are an int64 tensor on its
    device (the CPU for an int)."""
    dev = index.device if torch.is_tensor(index) else torch.device("cpu")
    index = cache_index(index, dev, s_max, "decode_attention")
    r = torch.arange(ATT_SPLITS + 1, device=dev)
    return r * (index + 1) // ATT_SPLITS


def kernel_attention_bounds(index: int):
    """The kernel's own chunk bounds for `index` (needs the built library,
    so the card)."""
    out = (ctypes.c_int * (ATT_SPLITS + 1))()
    _lib().xt_attention_bounds(int(index), out)
    return list(out)


def _merge_factor(m, big_m):
    """exp(m - M), 0 for an empty partial (m = -inf) rather than NaN."""
    return torch.where(m == -math.inf, torch.zeros_like(m),
                       torch.exp(m - big_m))


def split_attention(q, k, v, bounds):
    """Softmax attention of q (H, hd) over k, v (n, H, hd), all f32, with
    decode_attention's f32 operations in the kernel's order, one rounded
    elementwise op at a time (so on the card the two give the same bits):
    chunk r of `bounds` belongs to block r; in it, group g of 16 takes rows
    lo + g + 16 j + 64 b, batch b = 0, 1, ... holding 4 of them (j); a
    score sums its 8 lanes' products (8 dims each, in order) in a
    3-level tree, then is scaled; each group runs an online softmax
    (m, l, o) over its batches; the 16 groups merge in order, then the
    blocks in rank order, each partial weighted exp(m - M) (0 when empty:
    m = -inf, l = 0, o = 0). `bounds`: a list or a tensor over k's rows;
    the batches run to the longest chunk k's n rows can hold, ceil(n / 8):
    past a chunk's end they are empty, weigh exactly 0 and leave the sums
    as they are, so one trip count serves every index. Returns (H, hd)
    f32."""
    heads, hd = q.shape
    dev = q.device
    bounds = torch.as_tensor(bounds, device=dev)
    lo, hi = bounds[:-1], bounds[1:]
    step = ATT_BATCH * ATT_GROUPS
    longest = -(-k.shape[0] // ATT_SPLITS)
    batches = max(1, -(-longest // step))
    off = (torch.arange(batches, device=dev)[:, None, None] * step
           + torch.arange(ATT_BATCH, device=dev)[None, :, None] * ATT_GROUPS
           + torch.arange(ATT_GROUPS, device=dev)[None, None, :])
    pos = lo[:, None, None, None] + off          # (P, batch, j, group)
    valid = pos < hi[:, None, None, None]
    rows = torch.where(valid, pos, torch.zeros_like(pos))
    prod = (q * k[rows]).reshape(*pos.shape, heads, 8, hd // 8)
    lane = torch.zeros(prod.shape[:-1], device=dev)
    for i in range(prod.shape[-1]):
        lane = lane + prod[..., i]
    lane = lane[..., 0::2] + lane[..., 1::2]     # the shuffle tree
    lane = lane[..., 0::2] + lane[..., 1::2]
    s = lane[..., 0] + lane[..., 1]
    s = torch.where(valid[..., None], s * (1.0 / math.sqrt(hd)),
                    torch.full_like(s, -math.inf))
    # o and l side by side: l is o's column of ones
    vx = torch.cat([v[rows], torch.ones(*pos.shape, heads, 1, device=dev)],
                   -1)
    vx = torch.where(valid[..., None, None], vx, torch.zeros_like(vx))
    m = torch.full((len(lo), ATT_GROUPS, heads), -math.inf, device=dev)
    acc = torch.zeros(*m.shape, hd + 1, device=dev)
    for b in range(batches):
        mb = torch.maximum(m, s[:, b].amax(1))
        acc = acc * _merge_factor(m, mb)[..., None]
        for j in range(ATT_BATCH):
            acc = acc + _merge_factor(s[:, b, j], mb)[..., None] * vx[:, b, j]
        m = mb
    block_m = m.amax(1)                           # (P, H)
    f = _merge_factor(m, block_m[:, None])
    block = torch.zeros(len(lo), heads, hd + 1, device=dev)
    for g in range(ATT_GROUPS):
        block = block + acc[:, g] * f[:, g, :, None]
    f = _merge_factor(block_m, block_m.amax(0))
    total = torch.zeros(heads, hd + 1, device=dev)
    for r in range(len(lo)):
        total = total + block[r] * f[r, :, None]
    return total[:, :hd] / total[:, hd:]


def decode_attention_plain(qkv, kc, vc, index, heads: int):
    """decode_attention's twin; `index` an int or a one-element integer
    tensor (no host read of it: every row of the cache enters, masked by
    the bounds)."""
    s_max, d = kc.shape
    hd = d // heads
    index = cache_index(index, kc.device, s_max, "decode_attention")
    bounds = attention_bounds(index, s_max)
    at = index.reshape(1)
    kc.index_copy_(0, at, qkv[None, d:2 * d].to(kc.dtype))
    vc.index_copy_(0, at, qkv[None, 2 * d:].to(vc.dtype))
    q = qkv[:d].to(torch.bfloat16).float().reshape(heads, hd)
    k = kc.float().reshape(s_max, heads, hd)
    v = vc.float().reshape(s_max, heads, hd)
    return split_attention(q, k, v, bounds).reshape(d).to(torch.bfloat16)


def decode_attention(qkv: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                     index, heads: int) -> torch.Tensor:
    """One query per head over cache rows 0..index.

    qkv (3D,) f32 [q | k | v]; kc, vc (S, D) bf16 — one layer of the cache,
    updated in place: the new k/v row is written at `index`, an int or a
    0-d integer tensor on the caches' device (cache_index). Returns the
    attention output (D,) bf16. head_dim must be 64; 0 <= index < S; the
    caches 16-byte aligned (rows are read 16 bytes a lane). The kernel runs
    each head as a cluster of ATT_SPLITS blocks over the chunks of
    attention_bounds, which it computes from the index it reads."""
    if not qkv.is_cuda:
        return decode_attention_plain(qkv, kc, vc, index, heads)
    s_max, d = kc.shape
    if d // heads != 64 or d % heads:
        raise ValueError("decode_attention takes head_dim 64")
    idx = cache_index(index, kc.device, s_max, "decode_attention")
    if (qkv.dtype != torch.float32 or qkv.numel() != 3 * d
            or kc.dtype != torch.bfloat16 or vc.dtype != torch.bfloat16
            or vc.shape != kc.shape):
        raise ValueError("decode_attention: qkv f32 (3D,), caches bf16 (S, D)")
    _check_cuda(qkv, kc, vc)
    if kc.data_ptr() % 16 or vc.data_ptr() % 16:
        raise ValueError("decode_attention reads the caches 16 bytes at a "
                         "time: they must start 16-byte aligned")
    out = torch.empty((d,), dtype=torch.bfloat16, device=qkv.device)
    check(_lib().xt_decode_attention(ptr(qkv), ptr(kc), ptr(vc), ptr(out),
                                     ptr(idx), d, heads,
                                     1.0 / math.sqrt(64), stream_of(qkv)),
          "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def _step(ops, st, x, kc, vc, index, layers, heads):
    """5 launches a layer (qkv with the ln_1 prologue, attention, proj, fc
    with the ln_2 prologue, out) and the head with ln_f then final_norm."""
    gemv, attention = ops
    if x.is_cuda:               # to the device once a step, not a layer
        index = cache_index(index, kc.device, kc.shape[1], "the K1 step")
    h_res = x.float().reshape(-1).clone()       # the f32 residual
    for li in range(layers):
        ln = st["ln"][li]
        qkv = gemv(h_res, st["wqkv"][li], st["sqkv"][li], st["bqkv"][li],
                   ln=(ln[0], ln[1]))
        att = attention(qkv, kc[li], vc[li], index, heads)
        gemv(att, st["wproj"][li], st["sproj"][li], st["bproj"][li],
             out=h_res)
        m = gemv(h_res, st["wfc"][li], st["sfc"][li], st["bfc"][li],
                 gelu=True, out_dtype=torch.bfloat16, ln=(ln[2], ln[3]))
        gemv(m, st["wout"][li], st["sout"][li], st["bout"][li], out=h_res)
    logits = gemv(h_res, st["whead"], st["shead"], st["bhead"],
                  ln=tuple(st["lnf"]))
    return logits[None], kc, vc


def fused_decode_logits(stacked: Dict[str, Any], x: torch.Tensor,
                        kc: torch.Tensor, vc: torch.Tensor, index: int,
                        layers: int, heads: int):
    """One decode step: token hidden -> mel-head logits.

    stacked: from stack_qtree() or stack_qtree_int4() (the step then runs
    int4_gemv); x: (1, D) token embedding (mel emb + pos
    emb); kc/vc: (L, S, D) bf16 caches, updated in place at `index` (an
    int or a 0-d integer tensor on their device).
    Returns (logits (1, head_tiles*D) f32 — slice to vocab outside, kc, vc).
    Each op launches its kernel for CUDA tensors, its plain twin for CPU
    tensors."""
    gemv = int4_gemv if stacked.get("bits") == 4 else int8_gemv
    out = _step((gemv, decode_attention), stacked, x, kc, vc, index, layers,
                heads)
    if x.is_cuda:
        fused_decode_logits.launches += 1
    return out


fused_decode_logits.launches = 0


def fused_decode_logits_plain(stacked, x, kc, vc, index, layers, heads):
    """The same step through the plain twins on any device: the reference
    the kernel chain is held against on the card."""
    gemv = int4_gemv_plain if stacked.get("bits") == 4 else int8_gemv_plain
    return _step((gemv, decode_attention_plain), stacked, x, kc, vc, index,
                 layers, heads)


# layer_norm_rows stays a kernel of the module (the prologues' comparator on
# the card); the step no longer launches it
KERNELS = (layer_norm_rows, int8_gemv, int4_gemv, decode_attention)


def reset_launch_counts() -> None:
    for fn in KERNELS + (fused_decode_logits,):
        fn.launches = 0
    int8_gemv.ln_launches = int4_gemv.ln_launches = 0


def stack_qtree(qt: Dict[str, Any], vocab: int) -> Dict[str, Any]:
    """qdecode quantized tree -> per-kind stacked arrays for the step:
    w{qkv,proj,fc,out} (L, K, N) int8 with (L, N) f32 scales and biases,
    ln (L, 4, D), lnf (4, D) and the mel head padded to head_tiles*D columns
    (scale 0, bias NEG_INF, so sampling can never pick a padded column)."""
    ls = qt["layers"]
    d = ls[0]["qkv"]["w"].shape[0]
    out: Dict[str, Any] = {}
    for kind in ("qkv", "proj", "fc", "out"):
        out["w" + kind] = torch.stack([l[kind]["w"] for l in ls]).contiguous()
        out["s" + kind] = torch.stack([l[kind]["scale"] for l in ls])
        out["b" + kind] = torch.stack([l[kind + "_b"] for l in ls]).float()
    out["ln"] = torch.stack([
        torch.stack([l["ln_1"]["scale"], l["ln_1"]["bias"],
                     l["ln_2"]["scale"], l["ln_2"]["bias"]]) for l in ls
    ]).float().contiguous()
    out["lnf"] = torch.stack([
        qt["ln_f"]["scale"], qt["ln_f"]["bias"],
        qt["final_norm"]["scale"], qt["final_norm"]["bias"]]).float()
    head_tiles = -(-vocab // d)
    pad = head_tiles * d - vocab
    out["whead"] = F.pad(qt["mel_head"]["w"], (0, pad)).contiguous()
    out["shead"] = F.pad(qt["mel_head"]["scale"], (0, pad))
    out["bhead"] = F.pad(qt["mel_head_b"].float(), (0, pad), value=NEG_INF)
    out["head_tiles"] = head_tiles
    out["vocab"] = vocab
    return out


def _int4_grid(w8: torch.Tensor, s8: torch.Tensor, groups: int):
    """int8 (K, N) with per-column scales -> (int4 values (K, N) int8,
    scales (groups, N) f32): stack_qtree_int4's math (decode_step.py
    :428-432) with one scale per column of each (K/groups)-row tile:
    W = int8 x scale, s4 = max(max|W|, 1e-8) / 7, w4 = clip(round(W / s4),
    -7, 7), rounding half to even as jnp.round."""
    k, n = w8.shape
    wg = (w8.float() * s8[None, :]).reshape(groups, k // groups, n)
    s4 = torch.clamp(wg.abs().amax(dim=1), min=1e-8) / 7.0
    w4 = torch.clamp(torch.round(wg / s4[:, None, :]), -7, 7)
    return w4.to(torch.int8).reshape(k, n), s4


def stack_qtree_int4(qt: Dict[str, Any], vocab: int) -> Dict[str, Any]:
    """qdecode quantized tree -> the packed int4 stack (XTTS_DECODE_BITS=4):
    w{qkv,proj,fc,out} (L, K, N/2) packed bytes (pack_int4), s* (L, G, N)
    f32 with G = K/D groups (four for `out`, one elsewhere), b* (L, N);
    the head (D, head_tiles*D/2), (1, head_tiles*D), padded as the int8
    stack pads it (zero weights, whose int4 scale is 1e-8/7 by the same
    formula, bias NEG_INF). The values and scales are stack_qtree_int4's,
    bit for bit, in canonical column order. Quality: lossier than int8, an
    opt-in speed mode as in the JAX package."""
    st = stack_qtree(qt, vocab)
    d = st["ln"].shape[-1]
    out = dict(st, bits=4)
    for kind in ("qkv", "proj", "fc", "out", "head"):
        w8, s8 = st["w" + kind], st["s" + kind]
        groups = w8.shape[-2] // d
        if w8.dim() == 2:                               # the head
            w4, s4 = _int4_grid(w8, s8, groups)
            out["w" + kind], out["s" + kind] = pack_int4(w4), s4
        else:
            grids = [_int4_grid(w, s, groups) for w, s in zip(w8, s8)]
            out["w" + kind] = torch.stack([pack_int4(w) for w, _ in grids])
            out["s" + kind] = torch.stack([s for _, s in grids])
    return out
