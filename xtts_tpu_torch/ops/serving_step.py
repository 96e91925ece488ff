"""K4: the B-row int8 GPT serving decode step over an int8 KV cache, on
Hopper (port of xtts_tpu/ops/serving_step.py).

Replaces the Pallas TPU kernel `_make_serving_kernel` /
`_fused_serving_logits` (xtts_tpu/ops/serving_step.py:95-372), which ran the
whole B-row token step in one pallas_call. Here the step is a chain of
hand-written CUDA kernels (csrc/serving_step.cu), 76 launches a step at 15
layers: `int8_gemm_rows` reads each int8 weight byte once for all B <= 32
rows and runs each LayerNorm as its prologue (`ln=`, bit for bit K1's
`layer_norm_rows`), and `serving_attention` quantizes the new k/v rows
into the cache and attends over it. `fused_serving_logits` strings them
together; `fused_serving_logits_plain` is the same step through the plain
twins.

The KV cache is int8 with ONE f32 scale per (layer, row, position), as the
TPU kernel's: (L, B, S, D) int8 k and v, (L, B, S) f32 scales. The CUDA
path needs no chunk padding of S (the TPU kernel padded S to its DMA chunk).
The current token attends to its own k/v unquantized, in closed form; this
differs from the kv_quant engine (infer/qdecode.py), which attends to the
quantized row. Numerics are in csrc/serving_step.cu's header.

Each wrapper launches its kernel for a CUDA tensor (counting the launch in
its `launches` attribute) and runs its plain twin for a CPU tensor.
serving_attention's twin repeats its kernel's f32 operations in order, so
on the card the two give the same bits; int8_gemm_rows' twin sums in
another order (the tensor cores'), then runs the kernel's epilogue in its
order (gelu_new_ordered): where the sums are exact the two are equal.

serving_attention reads the cache index from device memory, as the TPU
kernel took it by scalar prefetch (an int or a 0-d integer tensor: see
decode_step.cache_index).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch

from xtts_tpu_torch.ops.build import (check, load_library, ptr,
                                      require_hopper, stream_of)
from xtts_tpu_torch.ops.decode_step import (_butterfly, _merge_factor,
                                            cache_index, gelu_new_ordered,
                                            norm_operands, normed_input)

MAX_ROWS = 32
_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("serving_step")
    lib.xt_int8_gemm_rows.argtypes = [_P] * 5 + [_I] * 6 + [_P]
    lib.xt_int8_gemm_rows_ln.argtypes = ([_P] * 5 + [_I] + [_P] * 4
                                         + [_I] * 6 + [_P])
    lib.xt_serving_attention.argtypes = ([_P] * 6 + [_I] * 4
                                         + [_P, ctypes.c_float, _P])
    lib.xt_gemm_rows_bounds.argtypes = [_I, _I, _P]
    lib.xt_gemm_rows_bounds.restype = None
    for fn in (lib.xt_int8_gemm_rows, lib.xt_int8_gemm_rows_ln,
               lib.xt_serving_attention):
        fn.restype = _I
    return lib


def _check_cuda(*ts) -> None:
    for t in ts:
        if not t.is_contiguous():
            raise ValueError("serving-step kernels take contiguous tensors")
    require_hopper(ts[0])


# ---------------------------------------------------------------------------
# int8_gemm_rows
# ---------------------------------------------------------------------------

def int8_gemm_rows_plain(x, w, scale, bias, out=None, gelu=False,
                         out_dtype=torch.float32, ln=None) -> torch.Tensor:
    """int8_gemm_rows' arithmetic: (x_bf16 . W_int8) * scale + bias with
    f32 sums (the kernel's tensor-core sums have no order a twin can
    repeat), the product and the sum rounded on their own, gelu_new in the
    kernel's order, then stored or added into `out`."""
    if ln is not None:
        x = normed_input(x, ln)
    y = (x.float() @ w.float()) * scale + bias
    if gelu:
        y = gelu_new_ordered(y)
    if out is not None:
        out += y
        return out
    return y.to(out_dtype)

GEMM_COLS = 64            # output columns a cluster of the kernel
GEMM_KT = 64              # k rows a weight tile
GEMM_MAX_CHUNK = 512      # k a block stages at once
GEMM_MAX_SPLITS = 8       # a portable cluster
GEMM_MIN_BLOCKS = 128     # of the card's 132 SMs


def gemm_rows_plan(k: int, n: int):
    """int8_gemm_rows' split of K over the blocks of a cluster: (S, bounds),
    rank r taking k in [bounds[r], bounds[r + 1]), whole 16-deep mma steps
    except the last. csrc/serving_step.cu gr_lo is the authority for the
    bounds and this their copy (held against it on the card through
    kernel_gemm_rows_bounds); S is this function's. S doubles from
    1 while a half chunk still fills a weight tile and the matrix has fewer
    than 128 blocks or a chunk longer than 512: qkv 4, proj 8, fc 2, out 8,
    head 2 at the flagship width; 1 for K = 100."""
    blocks = -(-n // GEMM_COLS)
    splits = 1
    while (splits < GEMM_MAX_SPLITS and -(-k // (2 * splits)) >= GEMM_KT
           and (blocks * splits < GEMM_MIN_BLOCKS
                or -(-k // splits) > GEMM_MAX_CHUNK)):
        splits *= 2
    steps = -(-k // 16)
    return splits, tuple(min(k, r * steps // splits * 16)
                         for r in range(splits + 1))


def kernel_gemm_rows_bounds(k: int, splits: int):
    """The kernel's own chunk bounds of K over `splits` blocks (needs the
    built library, so the card)."""
    out = (ctypes.c_int * (splits + 1))()
    _lib().xt_gemm_rows_bounds(int(k), int(splits), out)
    return tuple(out)


def int8_gemm_rows(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor, out: Optional[torch.Tensor] = None,
                   gelu: bool = False, out_dtype=torch.float32,
                   ln=None) -> torch.Tensor:
    """y = (x_bf16 @ W_int8) * scale + bias for B <= 32 rows, f32
    accumulation, each weight byte read once for all rows. The kernel
    splits K over a cluster of blocks (gemm_rows_plan) and sums the
    partials in rank order.

    x (B, K) bf16; w (K, N) int8; scale, bias (N,) f32. gelu applies
    gelu_new. With `out` (f32 (B, N)), y is added into it in place (the
    residual add); otherwise y is returned in out_dtype (f32 or bf16).

    ln = (s, b) or (s1, b1, s2, b2): the norm prologue. x is then the
    (B, K) f32 residual and the product takes layer_norm_rows(x, *ln),
    computed in the same launch, bit for bit."""
    if not x.is_cuda:
        return int8_gemm_rows_plain(x, w, scale, bias, out, gelu, out_dtype,
                                    ln)
    k, n = w.shape
    want = torch.float32 if ln is not None else torch.bfloat16
    if (x.dtype != want or w.dtype != torch.int8 or x.dim() != 2
            or x.shape[1] != k or not 1 <= x.shape[0] <= MAX_ROWS or n % 32):
        raise ValueError(f"int8_gemm_rows: bad operands x {tuple(x.shape)} "
                         f"{x.dtype}, w {tuple(w.shape)} {w.dtype}")
    rows = x.shape[0]
    norm = None if ln is None else norm_operands(x, ln, k, out)
    _check_cuda(x, w, scale, bias)
    if w.data_ptr() % 16:
        raise ValueError("int8_gemm_rows streams w 16 bytes at a time: it "
                         "must start 16-byte aligned")
    if out is not None:
        if out.dtype != torch.float32 or tuple(out.shape) != (rows, n):
            raise ValueError("int8_gemm_rows accumulates into f32 (B, N)")
        _check_cuda(out)
        mode, dst = 2, out
    else:
        if out_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"int8_gemm_rows: out_dtype {out_dtype}")
        mode = 0 if out_dtype == torch.float32 else 1
        dst = torch.empty((rows, n), dtype=out_dtype, device=x.device)
    splits, _ = gemm_rows_plan(k, n)
    if norm is None:
        check(_lib().xt_int8_gemm_rows(ptr(x), ptr(w), ptr(scale), ptr(bias),
                                       ptr(dst), rows, k, n, splits,
                                       int(gelu), mode, stream_of(x)),
              "int8_gemm_rows")
    else:
        check(_lib().xt_int8_gemm_rows_ln(ptr(x), *norm, ptr(w), ptr(scale),
                                          ptr(bias), ptr(dst), rows, k, n,
                                          splits, int(gelu), mode,
                                          stream_of(x)), "int8_gemm_rows")
        int8_gemm_rows.ln_launches += 1
    int8_gemm_rows.launches += 1
    return dst


# launches: every launch; ln_launches: those with the norm prologue
int8_gemm_rows.launches = int8_gemm_rows.ln_launches = 0


# ---------------------------------------------------------------------------
# serving_attention
# ---------------------------------------------------------------------------

def quantize_rows(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., D) f32 -> (int8 rows, (...) f32 per-row scales): scale
    max(|y|, 1e-8) / 127, round half to even, clip +-127. Both divisions
    take a tensor divisor: PyTorch divides a CUDA tensor by a Python number
    as a product with its reciprocal, the kernel divides."""
    top = torch.clamp(y.abs().amax(dim=-1), min=1e-8)
    sc = top / torch.full_like(top, 127.0)
    q = torch.clamp(torch.round(y / sc[..., None]), -127, 127)
    return q.to(torch.int8), sc


SA_CHUNK = 128       # positions a chunk of serving_attention's softmax
SA_GROUPS = 16       # a chunk's v-sum groups (position 16 j + g)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def serving_attention_plain(qkv, kc, vc, ks, vs, index, heads: int):
    """serving_attention's arithmetic in its order (csrc/serving_step.cu),
    one rounded elementwise op at a time, so on the card the two give the
    same bits. The new rows are quantized over D and written at `index`.
    Positions < index run in chunks of 128 through an online softmax, as
    the TPU kernel's: a score sums its 4 quarters' bf16(k q) products (16
    dims each, in order) by a 2-level tree, times k scale x 1/sqrt(hd);
    per chunk m' = max(m, chunk max), alpha = exp(m - m') (0 while m =
    -inf), e = exp(s - m'); the chunk's E = the 4 warps' butterfly sums of
    e in order, and its P = the v sums v (bf16(e) vscale) of its 16
    groups (group g: positions g, g + 16, ... in turn), added in group
    order; then den = den alpha + E, o = o alpha + P (the TPU kernel's acc
    * alpha + contrib). The current token then enters in closed form (its
    score: pairs of bf16(k q) by a butterfly). Positions >= index weigh 0
    with zero k, v and scales, as the kernel's zero-filled copies. `index`
    is an int or a one-element integer tensor, never read back: the
    chunks run over the whole cache, and those past the index (all -inf,
    which the kernel never runs) weigh exactly 0. Returns (B, D) bf16."""
    b, s_max, d = kc.shape
    hd = d // heads
    scale = 1.0 / math.sqrt(hd)
    dev = qkv.device
    at = cache_index(index, dev, s_max, "serving_attention").reshape(1)
    q, knew, vnew = qkv.float().split(d, dim=-1)
    kq, ksc = quantize_rows(knew)
    vq, vsc = quantize_rows(vnew)
    kc.index_copy_(1, at, kq[:, None])
    vc.index_copy_(1, at, vq[:, None])
    ks.index_copy_(1, at, ksc[:, None])
    vs.index_copy_(1, at, vsc[:, None])
    t = _bf16(knew * q).reshape(b, heads, hd // 2, 2)
    self_s = _butterfly(t[..., 0] + t[..., 1]) * scale           # (B, H)

    n = -(-s_max // SA_CHUNK) * SA_CHUNK
    pos = torch.arange(n, device=dev)
    valid = pos < at
    at = torch.where(valid, pos, torch.zeros_like(pos))
    zero = torch.zeros((), device=dev)
    kk = torch.where(valid[:, None], kc[:, at].float(), zero)
    vv = torch.where(valid[:, None], vc[:, at].float(), zero)
    ksv = torch.where(valid, ks[:, at], zero)
    vsv = torch.where(valid, vs[:, at], zero)
    prod = _bf16(kk.reshape(b, n, heads, 4, hd // 4)
                 * _bf16(q).reshape(b, 1, heads, 4, hd // 4))
    lane = torch.zeros(prod.shape[:-1], device=dev)
    for i in range(hd // 4):
        lane = lane + prod[..., i]
    s = (lane[..., 0] + lane[..., 1]) + (lane[..., 2] + lane[..., 3])
    s = torch.where(valid[:, None], s * (ksv[..., None] * scale),
                    torch.full_like(s, -math.inf))               # (B, n, H)

    m = torch.full((b, heads), -math.inf, device=dev)
    den = torch.zeros(b, heads, device=dev)
    o = torch.zeros(b, heads, hd, device=dev)
    steps = SA_CHUNK // SA_GROUPS
    for c in range(n // SA_CHUNK):
        sl = slice(c * SA_CHUNK, (c + 1) * SA_CHUNK)
        sc = s[:, sl]
        m_new = torch.maximum(m, sc.amax(1))
        alpha = _merge_factor(m, m_new)
        e = torch.where(sc == -math.inf, zero,
                        torch.exp(sc - m_new[:, None]))
        w = _butterfly(e.reshape(b, 4, 32, heads).transpose(2, 3))
        wv = (_bf16(e) * vsv[:, sl, None]).reshape(b, steps, SA_GROUPS,
                                                    heads, 1)
        term = vv[:, sl].reshape(b, steps, SA_GROUPS, heads, hd) * wv
        grp = torch.zeros(b, SA_GROUPS, heads, hd, device=dev)
        for j in range(steps):
            grp = grp + term[:, j]
        pc = torch.zeros(b, heads, hd, device=dev)
        for g in range(SA_GROUPS):
            pc = pc + grp[:, g]
        den = den * alpha + (((w[:, 0] + w[:, 1]) + w[:, 2]) + w[:, 3])
        o = o * alpha[..., None] + pc
        m = m_new
    m_new = torch.maximum(m, self_s)
    alpha = _merge_factor(m, m_new)
    e_self = torch.exp(self_s - m_new)
    den = den * alpha + e_self
    o = o * alpha[..., None] + e_self[..., None] * vnew.reshape(b, heads, hd)
    return (o / den[..., None]).reshape(b, d).to(torch.bfloat16)


def serving_attention(qkv: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                      ks: torch.Tensor, vs: torch.Tensor, index,
                      heads: int) -> torch.Tensor:
    """One query per (row, head) over cache positions < index plus the
    current token.

    qkv (B, 3D) f32 [q | k | v]; kc, vc (B, S, D) int8 and ks, vs (B, S) f32
    — one layer of the cache, updated in place: the new k/v rows are
    quantized over D and written at `index`, an int or a 0-d integer
    tensor on the caches' device. Returns (B, D) bf16.
    head_dim must be 64; 0 <= index < S; the caches 16-byte aligned (their
    rows are copied 16 bytes at a time)."""
    if not qkv.is_cuda:
        return serving_attention_plain(qkv, kc, vc, ks, vs, index, heads)
    b, s_max, d = kc.shape
    if d // heads != 64 or d % heads:
        raise ValueError("serving_attention takes head_dim 64")
    idx = cache_index(index, kc.device, s_max, "serving_attention")
    if (qkv.dtype != torch.float32 or tuple(qkv.shape) != (b, 3 * d)
            or kc.dtype != torch.int8 or vc.dtype != torch.int8
            or ks.dtype != torch.float32 or vs.dtype != torch.float32
            or tuple(ks.shape) != (b, s_max) or vc.shape != kc.shape
            or vs.shape != ks.shape):
        raise ValueError("serving_attention: qkv f32 (B, 3D), caches int8 "
                         "(B, S, D), scales f32 (B, S)")
    _check_cuda(qkv, kc, vc, ks, vs)
    if kc.data_ptr() % 16 or vc.data_ptr() % 16:
        raise ValueError("serving_attention copies cache rows 16 bytes at a "
                         "time: the caches must start 16-byte aligned")
    out = torch.empty((b, d), dtype=torch.bfloat16, device=qkv.device)
    check(_lib().xt_serving_attention(
        ptr(qkv), ptr(kc), ptr(vc), ptr(ks), ptr(vs), ptr(out), b, s_max, d,
        heads, ptr(idx), 1.0 / math.sqrt(64), stream_of(qkv)),
        "serving_attention")
    serving_attention.launches += 1
    return out


serving_attention.launches = 0


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def _step(ops, st, x, kc, vc, ks, vs, index, layers, heads):
    """5 launches a layer (qkv with the ln_1 prologue, attention, proj, fc
    with the ln_2 prologue, out) and the head with ln_f then final_norm."""
    gemm, attention = ops
    if x.is_cuda:               # to the device once a step, not a layer
        index = cache_index(index, kc.device, kc.shape[2], "the K4 step")
    x32 = x.float().clone()                     # the f32 residual (B, D)
    for li in range(layers):
        ln = st["ln"][li]
        qkv = gemm(x32, st["wqkv"][li], st["sqkv"][li], st["bqkv"][li],
                   ln=(ln[0], ln[1]))
        att = attention(qkv, kc[li], vc[li], ks[li], vs[li], index, heads)
        gemm(att, st["wproj"][li], st["sproj"][li], st["bproj"][li], out=x32)
        m = gemm(x32, st["wfc"][li], st["sfc"][li], st["bfc"][li], gelu=True,
                 out_dtype=torch.bfloat16, ln=(ln[2], ln[3]))
        gemm(m, st["wout"][li], st["sout"][li], st["bout"][li], out=x32)
    logits = gemm(x32, st["whead"], st["shead"], st["bhead"],
                  ln=tuple(st["lnf"]))
    return logits, kc, vc, ks, vs


def fused_serving_logits(stacked: Dict[str, Any], x: torch.Tensor, kc, vc,
                         ks, vs, index: int, layers: int, heads: int):
    """One serving step: (B, D) bf16 token hiddens -> (B, head_tiles*D) f32
    logits (slice to vocab outside).

    stacked: ops/decode_step.stack_qtree's weight stack; kc/vc (L, B, S, D)
    int8 and ks/vs (L, B, S) f32, updated in place at `index` (an int or a
    0-d integer tensor on their device). Returns (logits, kc, vc, ks,
    vs)."""
    out = _step((int8_gemm_rows, serving_attention), stacked, x, kc, vc, ks,
                vs, index, layers, heads)
    if x.is_cuda:
        fused_serving_logits.launches += 1
    return out


fused_serving_logits.launches = 0


def fused_serving_logits_plain(stacked, x, kc, vc, ks, vs, index, layers,
                               heads):
    """The same step through the plain twins on any device: the reference
    the kernel chain is held against on the card."""
    return _step((int8_gemm_rows_plain, serving_attention_plain), stacked, x,
                 kc, vc, ks, vs, index, layers, heads)


KERNELS = (int8_gemm_rows, serving_attention)


def reset_launch_counts() -> None:
    for fn in KERNELS + (fused_serving_logits,):
        fn.launches = 0
    int8_gemm_rows.ln_launches = 0


def quantize_kv_rowwise(cache) -> Tuple[torch.Tensor, ...]:
    """(L, B, S, H, hd) KVCache -> the step's int8 layout: (L, B, S, D)
    int8 k and v with (L, B, S) f32 per-position scales. Returns
    (kc, vc, ks, vs). The JAX package pads S to its DMA chunk here; the
    CUDA kernels need no padding."""
    kq, ksc = quantize_rows(cache.k.float().flatten(3))
    vq, vsc = quantize_rows(cache.v.float().flatten(3))
    return kq, vq, ksc, vsc
