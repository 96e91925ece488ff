"""K2: flash attention for the diffusion UNet's big self-attention, forward
and backward (port of xtts_tpu/nn/flash_attn.py).

Replaces the Pallas TPU flash kernels that xtts_tpu/nn/flash_attn.py:
flash_mha calls (jax.experimental.pallas.ops.tpu.flash_attention, :99):
the forward and, under jax.grad, the library's `_flash_attention_bwd_dkv`
and `_flash_attention_bwd_dq`. The CUDA kernels (csrc/flash_attn.cu) are
written for Hopper:

- the bf16 forward at head width 64: one warpgroup per (64-query tile,
  head, batch row); K/V tiles stream through a two-stage cp.async ring in
  shared memory; S = Q K^T and O += P V run on wgmma (P as the register
  operand, V read MN-major); the f32 online softmax and O stay in
  registers;
- `flash_mha_bwd_dkv` and `flash_mha_bwd_dq`: P rebuilt from the forward's
  row log-sum-exp, P and dS rounded to the inputs' dtype before their
  products, f32 accumulation, no atomics. In bf16 at width 64 as the
  forward: one warpgroup per 64-key (dkv) or 64-query (dq) tile, the
  streamed tiles in a cp.async ring, every product on wgmma with P / dS as
  the register operand (no P or dS tile in shared memory);
- the tile family, the same three kernels for f32 inputs (as the Pallas
  kernel takes them) at widths 32 and 64, the bf16 forward and backward
  at 32: the same grids, ring and softmax on mma.sync, f32 in 3xTF32
  (each operand split in a big and a small tf32 part, three products a
  step, within ~2^-21 relative of an f32 product), P and dS kept in
  registers as the next product's A operand;
- the bf16 forward at width 128 and every multiple of 128 above on wgmma
  (`flash_fwd_wgmma_wide`): a block owns a 64-query tile across the
  whole width (up to 512; wider heads in slices of up to 512 columns), so
  each score tile is formed once; the card is filled by splitting the
  keys over a thread-block cluster of R <= 8 blocks (`fwd_plan`), whose
  ranks combine (m, l, O) once through distributed shared memory in rank
  order; up to 256 columns a block takes two query tiles, a warpgroup
  each (P in registers), above that its two warpgroups split one query
  tile's columns (P through shared memory);
- the f32 forward at width 128 and every multiple of 128 above
  (`flash_fwd_f32_wide`): the bf16 wide forward's grid, key split over a
  cluster (with its own rank cost in `fwd_plan`), steps and combine, its
  products in 3xTF32 on `mma.sync` as the tile family's, P through shared
  memory; a block holds up to 384 columns of O (wider heads in slices),
  two query tiles a block at 128 (a warpgroup each), above that one,
  whose two warpgroups split the keys of each score tile and the columns
  of O, trading their rows' maxima through shared memory;
- the bf16 backward at width 128 and every multiple of 128 above on
  wgmma (`flash_bwd_dkv_wgmma_wide`, `flash_bwd_dq_wgmma_wide`): the
  blocks of one tile's 128-column chunks form a thread-block cluster;
  each forms only its own chunks' partial S and dP, the partials are
  summed once in the cluster through distributed shared memory and P and
  dS formed once and shared, so no chunk forms a score tile again; above
  width 1024 a block owns several chunks, their accumulators between
  steps in an f32 device scratch (`_scratch`);
- the f32 backward at width 128 and every multiple of 128 above
  (`flash_bwd_dkv_f32_wide`, `flash_bwd_dq_f32_wide`): the same clusters,
  exchange and scratch, the products in 3xTF32 on `mma.sync` as the tile
  family's, two warpgroups a block, P and dS shared as f32.
  `kernel_attrs` reads every kernel's registers and spills,
  `bwd_clusters` the wide pairs' resident clusters, `fwd_plan` the wide
  forwards' split and resident clusters.

Bound on the H100: tensor-core FLOPs (8.2 GFLOP a forward and 20.5 a
backward at the main path's (2, 1280 | 1562, 8, 64); in f32 three times
as many tf32 operations); the design keeps the (B, H, Tq, Tk) score
matrix out of device memory, which the plain version writes and reads
back.

The kernels take head widths 32, 64 and 128 (`NATIVE_WIDTHS`) and every
multiple of 128 above; the wrappers zero-pad any other width up to 128 to
the next of these (zero columns of q and k leave QK^T as it is, those of
v, dO and the results are sliced off; the caller's sm_scale is the true
width's), counted in `flash_mha.pads`, and raise ValueError at a width
above 128 that is not a multiple of 128. They read the (B, T,
H, D) strides directly and mask the ragged edges themselves, so the TPU
wrapper's padding of T to 128 and its segment ids are gone. `flash_mha`
is differentiable: with gradients recorded and an input that requires
grad it runs as a torch.autograd.Function whose forward keeps the
log-sum-exp and whose backward launches the two backward kernels (D =
rowsum(dO * O) in f32 by torch ops between them, as JAX takes it in
XLA). CUDA tensors launch the kernels (counted in `.launches` of
`flash_mha` (of them `f32_launches` the f32 forward's), `flash_mha_bwd_dkv`
and `flash_mha_bwd_dq`) or raise; CPU tensors take the plain twins. A
double backward raises, as JAX's does. `XTTS_FLASH_ATTN=0` closes the
size gate (`use_flash`), as it closes the JAX package's.
"""
from __future__ import annotations

import ctypes
import functools
import os

import torch
from torch.autograd.function import once_differentiable

from xtts_tpu_torch.ops.build import (check, load_library, ptr,
                                      require_hopper, stream_of)

# Tq * Tk at or above this runs the kernel (the JAX package's gate)
FLASH_MIN_SCORES = 1 << 19
# the head widths the tile kernels take as they are
NATIVE_WIDTHS = (32, 64, 128)
# kernel_attrs' width key of the wide kernels, which take every multiple of
# 128 above 128 as it is
WIDE = 256
# O's columns a block of the wide forwards' instances, by dtype
# (kernel_attrs' width keys of the forward from 128: 128 two query tiles a
# block, WIDE in bf16 too, the others one)
FWD_BLOCK_WIDTHS = {torch.bfloat16: (128, WIDE, 384, 512),
                    torch.float32: (128, WIDE, 384)}
# key rows a kernel tile holds: with Tk <= BK the backward takes D from the
# tile (_bwd_plain's one-tile rule)
BK = 64

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def use_flash(tq: int, tk: int) -> bool:
    """The consumer attention's gate: a score matrix of at least
    FLASH_MIN_SCORES, unless XTTS_FLASH_ATTN=0 (read at every call, as the
    JAX package's _use_flash reads it at trace time)."""
    if os.environ.get("XTTS_FLASH_ATTN", "auto") == "0":
        return False
    return tq * tk >= FLASH_MIN_SCORES


def native_width(dh: int) -> int:
    """The kernels' head width a head of width dh runs at (zero-padded up
    to it): the next of NATIVE_WIDTHS up to 128, dh itself where it is a
    multiple of 128 above it (the wide kernels); any other width above 128
    raises ValueError, as JAX's kernel raises NotImplementedError."""
    for w in NATIVE_WIDTHS:
        if dh <= w:
            return w
    if dh % 128 == 0:
        return dh
    widths = ", ".join(map(str, NATIVE_WIDTHS))
    raise ValueError(f"K2 takes head widths up to 128 ({widths} as they "
                     f"are, narrower ones zero-padded) and multiples of 128 "
                     f"above: head_dim={dh} should be a multiple of 128 if "
                     f"larger")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("flash_attn")
    lib.xt_flash_attn_fwd.argtypes = (
        [_P] * 5 + [_I] * 4 + [_L] * 12 + [ctypes.c_float, _I, _I, _P])
    lib.xt_flash_attn_bwd_dkv.argtypes = (
        [_P] * 9 + [_I] * 4 + [_P, ctypes.c_float, _I, _I, _P])
    lib.xt_flash_attn_bwd_dq.argtypes = (
        [_P] * 8 + [_I] * 4 + [_P, ctypes.c_float, _I, _I, _P])
    lib.xt_flash_attn_bwd_scratch.argtypes = [_I] * 7
    lib.xt_flash_attn_bwd_scratch.restype = _L
    lib.xt_flash_attn_attrs.argtypes = [ctypes.POINTER(_I)]
    lib.xt_flash_attn_bwd_clusters.argtypes = [_I, _I, _I,
                                               ctypes.POINTER(_I)]
    lib.xt_flash_attn_fwd_plan.argtypes = [_I] * 6 + [ctypes.POINTER(_I)]
    for fn in (lib.xt_flash_attn_fwd, lib.xt_flash_attn_bwd_dkv,
               lib.xt_flash_attn_bwd_dq, lib.xt_flash_attn_attrs,
               lib.xt_flash_attn_bwd_clusters, lib.xt_flash_attn_fwd_plan):
        fn.restype = _I
    return lib


# csrc's order of xt_flash_attn_attrs: (wrapper, dtype, head width); the
# backward's 128 and WIDE keys both read the wide pairs (bf16 the wgmma
# pair, f32 the f32 pair); the forward's keys from 128 the wide forwards'
# instances (FWD_BLOCK_WIDTHS)
_KERNELS = tuple((name, kind, w)
                 for name in ("flash_mha", "flash_mha_bwd_dkv",
                              "flash_mha_bwd_dq")
                 for kind in ("bf16", "f32") for w in NATIVE_WIDTHS + (WIDE,)
                 ) + tuple(("flash_mha", kind, w) for dt, kind in (
                     (torch.bfloat16, "bf16"), (torch.float32, "f32"))
                           for w in FWD_BLOCK_WIDTHS[dt][2:])


def kernel_attrs() -> dict:
    """{(wrapper, "bf16" | "f32", head width): (registers, local-memory
    bytes)} a thread of each of the 27 keys' kernels, as built for the
    current card (width WIDE: every multiple of 128 above 128; the forward
    at 128 and above: the wide forward's instance of that many columns a
    block, `fwd_block_width`, bf16 the wgmma one, f32 the 3xTF32 one; the
    bf16 backward at 128 and WIDE: the wgmma wide pair; the f32 backward
    there: the f32 wide pair); local memory other than 0 is a register
    spill."""
    out = (_I * (2 * len(_KERNELS)))()
    check(_lib().xt_flash_attn_attrs(out), "flash_mha kernel attrs")
    return {key: (out[2 * i], out[2 * i + 1])
            for i, key in enumerate(_KERNELS)}


def bwd_kernel_attrs() -> dict:
    """kernel_attrs() of the backward kernels."""
    return {key: a for key, a in kernel_attrs().items()
            if key[0] != "flash_mha"}


def bwd_clusters(dtype, width: int) -> tuple:
    """(dkv, dq): the clusters of the wide backward pair that takes
    `dtype` (torch.bfloat16: the wgmma pair at 128 and every multiple of
    128 above; torch.float32: the f32 pair, the same widths) at head width
    `width` that can be resident on the current card at once."""
    out = []
    for dq in (0, 1):
        n = _I(0)
        check(_lib().xt_flash_attn_bwd_clusters(
            int(dtype == torch.float32), width, dq, ctypes.byref(n)),
            "flash_mha backward clusters")
        out.append(n.value)
    return tuple(out)


def fwd_block_width(width: int, dtype) -> int:
    """O's columns a block of the wide forward of `dtype` (torch.bfloat16
    or torch.float32) holds at head width `width` (a multiple of 128; csrc
    fww_plan): the whole width up to its widest instance (512 in bf16, 384
    in f32), above it the widest of equal slices of at most that (128 x
    ceil(chunks / slices)) — its kernel_attrs key."""
    nc, most = width // 128, FWD_BLOCK_WIDTHS[dtype][-1] // 128
    slices = -(-nc // most)
    return 128 * -(-nc // slices)


def fwd_plan(b: int, tq: int, tk: int, h: int, width: int, dtype) -> dict:
    """The wide forward's plan on the current card at q (b, tq, h, width),
    k / v (b, tk, h, width) of `dtype`, width a multiple of 128 (csrc
    fww_plan): "split" the ranks R of a cluster over the key tiles,
    "resident" the clusters of R that can be resident at once, "slices"
    of O's columns, "rows" the query rows a block."""
    out = (_I * 4)()
    check(_lib().xt_flash_attn_fwd_plan(b, tq, tk, h, width,
                                        int(dtype == torch.float32), out),
          "flash_mha forward plan")
    return dict(split=out[0], resident=out[1], slices=out[2], rows=out[3])


def _wide(dtype):
    """The softmax's and the backward's dtype: f32, or float64 for float64
    inputs (gradcheck)."""
    return torch.promote_types(dtype, torch.float32)


def flash_mha_plain(q, k, v, sm_scale: float) -> torch.Tensor:
    """Plain attention in the inputs' dtype with an f32 softmax — the
    einsum path of the JAX CrossAttention and flash_mha's reference core."""
    sim = torch.einsum("bihd,bjhd->bhij", q, k) * sm_scale
    attn = torch.softmax(sim.to(_wide(q.dtype)), dim=-1).to(q.dtype)
    return torch.einsum("bhij,bjhd->bihd", attn, v)


def flash_mha_plain_lse(q, k, v, sm_scale: float):
    """flash_mha_plain's output (the same operations, so the same bits) and
    the row log-sum-exp of the scaled scores, (B, H, Tq) f32, natural log:
    what the forward keeps for the backward (the Pallas forward's l, m)."""
    sim = (torch.einsum("bihd,bjhd->bhij", q, k) * sm_scale
           ).to(_wide(q.dtype))
    attn = torch.softmax(sim, dim=-1).to(q.dtype)
    return (torch.einsum("bhij,bjhd->bihd", attn, v),
            torch.logsumexp(sim, dim=-1))


def _bwd_plain(q, k, v, do, lse, delta, sm_scale: float):
    """The backward's recurrences in f32 (B, T, H, dh layout): P = exp(S
    scale - lse), dV = P^T dO, dP = dO V^T, dS = (dP - D) P scale, dK =
    dS^T Q, dQ = dS K, with P and dS rounded to q's dtype before their
    products, as the kernels and the Pallas kernels round them.

    With Tk <= BK (every key in one kernel tile) D is taken as the tile
    kernels take it (csrc ds_one_tile): dS = (dP L - E) P scale with L =
    rowsum(P) and E = rowsum(P dP), equal in exact arithmetic (L = 1, E =
    rowsum(dO O) = D) and exactly 0 at one key, where dP L and E are one
    rounded product; `delta` is not read then."""
    dt, wide = q.dtype, _wide(q.dtype)
    qf, kf, vf, dof = (t.to(wide) for t in (q, k, v, do))
    s = torch.einsum("bihd,bjhd->bhij", qf, kf) * sm_scale
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bihd,bjhd->bhij", dof, vf)
    if k.shape[1] <= BK:
        dp = dp * p.sum(-1, keepdim=True) - (p * dp).sum(-1, keepdim=True)
    else:
        dp = dp - delta[..., None]
    ds = dp * p * sm_scale
    p, ds = p.to(dt).to(wide), ds.to(dt).to(wide)
    dv = torch.einsum("bhij,bihd->bjhd", p, dof)
    dk = torch.einsum("bhij,bihd->bjhd", ds, qf)
    dq = torch.einsum("bhij,bjhd->bihd", ds, kf)
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _delta(o, do) -> torch.Tensor:
    """D = rowsum(dO * O) in f32, (B, H, Tq) contiguous."""
    wide = _wide(o.dtype)
    return (do.to(wide) * o.to(wide)).sum(-1).transpose(1, 2).contiguous()


def flash_mha_bwd_plain(q, k, v, o, lse, do, sm_scale: float):
    """(dq, dk, dv) of flash_mha from its inputs, output `o`, natural-log
    `lse` (B, H, Tq) and the output gradient `do`: the plain twin of the
    two backward kernels."""
    return _bwd_plain(q, k, v, do, lse, _delta(o, do), sm_scale)


def _readable(t) -> bool:
    """The kernels read t as it is: unit head-dim stride, the other strides
    a whole number of 16 bytes, 16-byte aligned data."""
    step = 16 // t.element_size()
    return (t.stride(3) == 1 and not any(s % step for s in t.stride()[:3])
            and t.data_ptr() % 16 == 0)


def pad_heads(*ts):
    """ts (one head width dh) zero-padded on the head axis to
    native_width(dh), contiguous copies; as they are at a native width."""
    dh = ts[0].shape[-1]
    w = native_width(dh)
    if w == dh:
        return ts
    return tuple(torch.nn.functional.pad(t, (0, w - dh)) for t in ts)


def _operands(what: str, q, k, v, *more):
    """q (B, Tq, H, dh), k / v (B, Tk, H, dh) and `more` (each q- or
    k-shaped) as the kernels read them: dh zero-padded to its native
    width (the launch counted in `flash_mha.pads`). Raise unless
    they are one dtype (bf16 or f32) on one card with unit head-dim
    stride, other strides a whole number of 16 bytes and 16-byte aligned
    data. Returns (b, tq, tk, h), the operands."""
    b, tq, h, dh = q.shape
    tk = k.shape[1]
    if (k.shape != (b, tk, h, dh) or v.shape != k.shape
            or min(b, tq, tk, h, dh) < 1
            or any(t.shape not in (q.shape, k.shape) for t in more)):
        raise ValueError(f"{what} takes q (B, Tq, H, D), k / v (B, Tk, H, "
                         f"D); got q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what} takes bf16 or f32, got {q.dtype}")
    for t in (q, k, v, *more):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{what}: operands of one dtype on one card, "
                             f"got {t.dtype} on {t.device} beside "
                             f"{q.dtype} on {q.device}")
    ops = pad_heads(q, k, v, *more)
    if ops[0].shape[-1] != dh:
        flash_mha.pads += 1
    if not all(_readable(t) for t in ops):
        raise ValueError(f"{what} needs unit head-dim stride, strides in "
                         f"multiples of 16 bytes and 16-byte aligned data")
    require_hopper(q)
    return (b, tq, tk, h), ops


def _strides(*ts):
    vals = [s for t in ts for s in t.stride()[:3]]
    return (_L * len(vals))(*vals)


def _flash_fwd_cuda(q, k, v, sm_scale: float, with_lse: bool):
    dh = q.shape[3]
    (b, tq, tk, h), (q, k, v) = _operands("flash_mha", q, k, v)
    width = q.shape[3]
    out = torch.empty((b, tq, h, width), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    check(_lib().xt_flash_attn_fwd(
        ptr(q), ptr(k), ptr(v), ptr(out), None if lse is None else ptr(lse),
        b, tq, tk, h, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], float(sm_scale), int(q.dtype == torch.float32),
        width, stream_of(q)), "flash_mha")
    flash_mha.launches += 1
    flash_mha.f32_launches += q.dtype == torch.float32
    return out[..., :dh], lse


def _check_stats(q, lse, delta):
    b, tq, h = q.shape[0], q.shape[1], q.shape[2]
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.shape != (b, h, tq) or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"K2 backward: {name} must be contiguous f32 "
                             f"(B, H, Tq) = {(b, h, tq)} on {q.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def _scratch(q, b, tq, tk, h, dq: bool):
    """The f32 device scratch a backward kernel takes at these shapes
    (csrc xt_flash_attn_bwd_scratch: the wide pairs' accumulators where a
    block owns more than one 128-column chunk, above width 1024), or
    None."""
    n = _lib().xt_flash_attn_bwd_scratch(b, tq, tk, h,
                                         int(q.dtype == torch.float32),
                                         q.shape[3], int(dq))
    return (torch.empty(n, dtype=torch.float32, device=q.device) if n
            else None)


def flash_mha_bwd_dkv(q, k, v, do, lse, delta, sm_scale: float):
    """dK and dV of flash_mha (kernels `flash_bwd_dkv_kernel`, bf16 at
    width 64; `flash_bwd_dkv_wgmma_wide`, bf16 at 128 and every multiple
    of 128 above; `flash_bwd_dkv_f32_wide`, f32 at the same widths;
    `flash_bwd_dkv_tc_kernel<T, D>` the rest): lse the forward's
    natural-log row log-sum-exp and delta = rowsum(dO * O), both (B, H,
    Tq) f32. CPU tensors take the plain twin."""
    if not q.is_cuda:
        return _bwd_plain(q, k, v, do, lse, delta, sm_scale)[1:]
    dh = q.shape[3]
    (b, tq, tk, h), (q, k, v, do) = _operands("flash_mha_bwd_dkv", q, k, v,
                                              do)
    _check_stats(q, lse, delta)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    scratch = _scratch(q, b, tq, tk, h, False)
    check(_lib().xt_flash_attn_bwd_dkv(
        ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta), ptr(dk),
        ptr(dv), None if scratch is None else ptr(scratch), b, tq, tk, h,
        _strides(q, k, v, do, dk, dv),
        float(sm_scale), int(q.dtype == torch.float32), q.shape[3],
        stream_of(q)), "flash_mha_bwd_dkv")
    flash_mha_bwd_dkv.launches += 1
    return dk[..., :dh], dv[..., :dh]


def flash_mha_bwd_dq(q, k, v, do, lse, delta, sm_scale: float,
                     stream=None):
    """dQ of flash_mha (kernels `flash_bwd_dq_kernel`, bf16 at width 64;
    `flash_bwd_dq_wgmma_wide`, bf16 at 128 and every multiple of 128
    above; `flash_bwd_dq_f32_wide`, f32 at the same widths;
    `flash_bwd_dq_tc_kernel<T, D>` the rest), on flash_mha_bwd_dkv's
    operands. CPU tensors take the plain twin. stream: a CUDA stream to
    launch on, else the current one; it waits for the current stream's
    work so far (the operands' padding included), and the tensors the
    kernel reads and writes, allocated on the current stream, are recorded
    on it, so that their memory is not reused before the kernel ends."""
    if not q.is_cuda:
        return _bwd_plain(q, k, v, do, lse, delta, sm_scale)[0]
    dh = q.shape[3]
    (b, tq, tk, h), (q, k, v, do) = _operands("flash_mha_bwd_dq", q, k, v,
                                              do)
    _check_stats(q, lse, delta)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    scratch = _scratch(q, b, tq, tk, h, True)
    if stream is not None:
        stream.wait_stream(torch.cuda.current_stream(q.device))
        for t in (q, k, v, do, lse, delta, dq, scratch):
            if t is not None:
                t.record_stream(stream)
    check(_lib().xt_flash_attn_bwd_dq(
        ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta), ptr(dq),
        None if scratch is None else ptr(scratch), b, tq, tk, h,
        _strides(q, k, v, do, dq), float(sm_scale),
        int(q.dtype == torch.float32), q.shape[3],
        stream_of(q) if stream is None else ctypes.c_void_p(
            stream.cuda_stream)),
        "flash_mha_bwd_dq")
    flash_mha_bwd_dq.launches += 1
    return dq[..., :dh]


@functools.cache
def _side_stream(index: int):
    return torch.cuda.Stream(index)


def flash_mha_bwd_pair(q, k, v, do, lse, delta, sm_scale: float):
    """(dq, dk, dv): flash_mha_bwd_dkv and flash_mha_bwd_dq on the same
    operands. The f32 wide pair (f32 at head widths of 128 and every
    multiple above) runs dq on a second stream beside dkv: each fills the
    card one block an SM in two waves (dkv 200, dq 160 blocks at the main
    bucket's 2 heads of 256 on 132 SMs), so side by side dq's blocks take
    the SMs dkv's second wave leaves idle; the current stream waits for
    both. Everything is allocated on the current stream."""
    if not (q.is_cuda and q.dtype == torch.float32
            and native_width(q.shape[3]) % 128 == 0):
        dk, dv = flash_mha_bwd_dkv(q, k, v, do, lse, delta, sm_scale)
        return flash_mha_bwd_dq(q, k, v, do, lse, delta, sm_scale), dk, dv
    main = torch.cuda.current_stream(q.device)
    side = _side_stream(q.device.index)
    dq = flash_mha_bwd_dq(q, k, v, do, lse, delta, sm_scale, stream=side)
    dk, dv = flash_mha_bwd_dkv(q, k, v, do, lse, delta, sm_scale)
    main.wait_stream(side)
    return dq, dk, dv


def flash_mha_bwd(q, k, v, o, lse, do, sm_scale: float):
    """(dq, dk, dv): the two backward kernels for CUDA tensors
    (flash_mha_bwd_pair), the plain twin for CPU tensors. An output
    gradient whose layout the kernels do not take (an expanded or
    transposed view) is copied contiguous first, counted in
    `flash_mha_bwd.copies`."""
    if not q.is_cuda:
        return flash_mha_bwd_plain(q, k, v, o, lse, do, sm_scale)
    if not _readable(do):
        do = do.contiguous()
        flash_mha_bwd.copies += 1
    return flash_mha_bwd_pair(q, k, v, do, lse, _delta(o, do), sm_scale)


class _FlashMHA(torch.autograd.Function):
    """flash_mha under autograd: the forward keeps (q, k, v, o, lse), the
    backward is flash_mha_bwd. Once differentiable: a double backward
    raises, as the Pallas kernel's "Higher-order AD not supported"."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale):
        if q.is_cuda:
            out, lse = _flash_fwd_cuda(q, k, v, sm_scale, True)
        else:
            out, lse = flash_mha_plain_lse(q, k, v, sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        return (*flash_mha_bwd(q, k, v, out, lse, do, ctx.sm_scale), None)


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              sm_scale: float) -> torch.Tensor:
    """Exact attention. q (B, Tq, H, dh), k/v (B, Tk, H, dh) -> (B, Tq, H, dh),
    differentiable.

    CUDA: bf16 or f32, dh up to 128 (32, 64 and 128 as they are, other
    widths zero-padded to the next of these and counted in `pads`) or a
    multiple of 128 above it (the wide kernels), last
    axis contiguous, other strides a whole number of 16 bytes, 16-byte
    aligned bases; anything else raises. Without an input that requires
    grad (serving) the forward keeps no lse."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashMHA.apply(q, k, v, sm_scale)
    if not q.is_cuda:
        return flash_mha_plain(q, k, v, sm_scale)
    return _flash_fwd_cuda(q, k, v, sm_scale, False)[0]


flash_mha.launches = 0
flash_mha.f32_launches = 0       # of them, the f32 forward's
flash_mha.pads = 0               # K2 launches on zero-padded head widths
flash_mha_bwd_dkv.launches = 0
flash_mha_bwd_dq.launches = 0
flash_mha_bwd.copies = 0

KERNELS = (flash_mha, flash_mha_bwd_dkv, flash_mha_bwd_dq)
