"""K2: flash attention for the diffusion UNet's big self-attention, forward
and backward (port of xtts_tpu/nn/flash_attn.py).

Replaces the Pallas TPU flash kernels that xtts_tpu/nn/flash_attn.py:
flash_mha calls (jax.experimental.pallas.ops.tpu.flash_attention, :99):
the forward and, under jax.grad, the library's `_flash_attention_bwd_dkv`
and `_flash_attention_bwd_dq`. The CUDA kernels (csrc/flash_attn.cu) are
written for Hopper:

- the bf16 forward: one warpgroup per (64-query tile, head, batch row);
  K/V tiles stream through a two-stage cp.async ring in shared memory;
  S = Q K^T and O += P V run on wgmma (P as the register operand, V read
  MN-major); the f32 online softmax and O stay in registers;
- the f32 forward (the inputs' dtype, as the Pallas kernel takes it): the
  same softmax on f32 FMA tiles, no TF32;
- `flash_mha_bwd_dkv` and `flash_mha_bwd_dq`, bf16 or f32 from one source:
  P rebuilt from the forward's row log-sum-exp, P and dS rounded to the
  inputs' dtype before their products, f32 accumulation, no atomics.

Bound on the H100: tensor-core FLOPs (8.2 GFLOP a forward and 20.5 a
backward at the main path's (2, 1280 | 1562, 8, 64)); the design keeps the
(B, H, Tq, Tk) score matrix out of device memory, which the plain version
writes and reads back.

The kernels read the (B, T, H, 64) strides directly and mask the ragged
edges themselves, so the TPU wrapper's padding to 128 and its segment ids
are gone. `flash_mha` is differentiable: with gradients recorded and an
input that requires grad it runs as a torch.autograd.Function whose
forward keeps the log-sum-exp and whose backward launches the two backward
kernels (D = rowsum(dO * O) in f32 by torch ops between them, as JAX takes
it in XLA). CUDA tensors launch the kernels (counted in `.launches` of
`flash_mha` (of them `f32_launches` the f32 forward's), `flash_mha_bwd_dkv`
and `flash_mha_bwd_dq`) or raise; CPU
tensors take the plain twins. A double backward raises, as JAX's does.
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from xtts_tpu_torch.ops.build import (check, load_library, ptr,
                                      require_hopper, stream_of)

# Tq * Tk at or above this runs the kernel (the JAX package's gate)
FLASH_MIN_SCORES = 1 << 19

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def use_flash(tq: int, tk: int) -> bool:
    return tq * tk >= FLASH_MIN_SCORES


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("flash_attn")
    lib.xt_flash_attn_fwd.argtypes = (
        [_P] * 5 + [_I] * 4 + [_L] * 12 + [ctypes.c_float, _I, _P])
    lib.xt_flash_attn_bwd_dkv.argtypes = (
        [_P] * 8 + [_I] * 4 + [_P, ctypes.c_float, _I, _P])
    lib.xt_flash_attn_bwd_dq.argtypes = (
        [_P] * 7 + [_I] * 4 + [_P, ctypes.c_float, _I, _P])
    for fn in (lib.xt_flash_attn_fwd, lib.xt_flash_attn_bwd_dkv,
               lib.xt_flash_attn_bwd_dq):
        fn.restype = _I
    return lib


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
    products, as the kernels and the Pallas kernels round them."""
    dt, wide = q.dtype, _wide(q.dtype)
    qf, kf, vf, dof = (t.to(wide) for t in (q, k, v, do))
    s = torch.einsum("bihd,bjhd->bhij", qf, kf) * sm_scale
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bihd,bjhd->bhij", dof, vf)
    ds = (dp - delta[..., None]) * p * sm_scale
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


def _check_operands(what: str, q, k, v, *more):
    """Raise unless the kernels take q (B, Tq, H, 64), k / v (B, Tk, H, 64)
    and `more` (each q- or k-shaped) as they are: one dtype (bf16 or f32),
    one card, unit head-dim stride, other strides a whole number of 16
    bytes, 16-byte aligned data."""
    b, tq, h, dh = q.shape
    tk = k.shape[1]
    if (dh != 64 or k.shape != (b, tk, h, dh) or v.shape != k.shape
            or min(b, tq, tk, h) < 1
            or any(t.shape not in (q.shape, k.shape) for t in more)):
        raise ValueError(f"{what} takes (B, T, H, 64); got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what} takes bf16 or f32, got {q.dtype}")
    for t in (q, k, v, *more):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{what}: operands of one dtype on one card, "
                             f"got {t.dtype} on {t.device} beside "
                             f"{q.dtype} on {q.device}")
        if not _readable(t):
            raise ValueError(f"{what} needs unit head-dim stride, strides "
                             f"in multiples of 16 bytes and 16-byte "
                             f"aligned data")
    require_hopper(q)
    return b, tq, tk, h


def _strides(*ts):
    vals = [s for t in ts for s in t.stride()[:3]]
    return (_L * len(vals))(*vals)


def _flash_fwd_cuda(q, k, v, sm_scale: float, with_lse: bool):
    b, tq, tk, h = _check_operands("flash_mha", q, k, v)
    out = torch.empty((b, tq, h, 64), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    check(_lib().xt_flash_attn_fwd(
        ptr(q), ptr(k), ptr(v), ptr(out), None if lse is None else ptr(lse),
        b, tq, tk, h, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], float(sm_scale), int(q.dtype == torch.float32),
        stream_of(q)), "flash_mha")
    flash_mha.launches += 1
    flash_mha.f32_launches += q.dtype == torch.float32
    return out, lse


def _check_stats(q, lse, delta):
    b, tq, h = q.shape[0], q.shape[1], q.shape[2]
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.shape != (b, h, tq) or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"K2 backward: {name} must be contiguous f32 "
                             f"(B, H, Tq) = {(b, h, tq)} on {q.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def flash_mha_bwd_dkv(q, k, v, do, lse, delta, sm_scale: float):
    """dK and dV of flash_mha (kernel `flash_bwd_dkv_kernel`): lse the
    forward's natural-log row log-sum-exp and delta = rowsum(dO * O), both
    (B, H, Tq) f32. CPU tensors take the plain twin."""
    if not q.is_cuda:
        return _bwd_plain(q, k, v, do, lse, delta, sm_scale)[1:]
    b, tq, tk, h = _check_operands("flash_mha_bwd_dkv", q, k, v, do)
    _check_stats(q, lse, delta)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    check(_lib().xt_flash_attn_bwd_dkv(
        ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta), ptr(dk),
        ptr(dv), b, tq, tk, h, _strides(q, k, v, do, dk, dv),
        float(sm_scale), int(q.dtype == torch.float32), stream_of(q)),
        "flash_mha_bwd_dkv")
    flash_mha_bwd_dkv.launches += 1
    return dk, dv


def flash_mha_bwd_dq(q, k, v, do, lse, delta, sm_scale: float):
    """dQ of flash_mha (kernel `flash_bwd_dq_kernel`), on flash_mha_bwd_dkv's
    operands. CPU tensors take the plain twin."""
    if not q.is_cuda:
        return _bwd_plain(q, k, v, do, lse, delta, sm_scale)[0]
    b, tq, tk, h = _check_operands("flash_mha_bwd_dq", q, k, v, do)
    _check_stats(q, lse, delta)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    check(_lib().xt_flash_attn_bwd_dq(
        ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta), ptr(dq),
        b, tq, tk, h, _strides(q, k, v, do, dq), float(sm_scale),
        int(q.dtype == torch.float32), stream_of(q)), "flash_mha_bwd_dq")
    flash_mha_bwd_dq.launches += 1
    return dq


def flash_mha_bwd(q, k, v, o, lse, do, sm_scale: float):
    """(dq, dk, dv): the two backward kernels for CUDA tensors, the plain
    twin for CPU tensors. An output gradient whose layout the kernels do
    not take (an expanded or transposed view) is copied contiguous first,
    counted in `flash_mha_bwd.copies`."""
    if not q.is_cuda:
        return flash_mha_bwd_plain(q, k, v, o, lse, do, sm_scale)
    if not _readable(do):
        do = do.contiguous()
        flash_mha_bwd.copies += 1
    delta = _delta(o, do)
    dk, dv = flash_mha_bwd_dkv(q, k, v, do, lse, delta, sm_scale)
    return flash_mha_bwd_dq(q, k, v, do, lse, delta, sm_scale), dk, dv


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

    CUDA: bf16 or f32, dh = 64, last axis contiguous, other strides a whole
    number of 16 bytes, 16-byte aligned bases; anything else raises. Without
    an input that requires grad (serving) the forward keeps no lse."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashMHA.apply(q, k, v, sm_scale)
    if not q.is_cuda:
        return flash_mha_plain(q, k, v, sm_scale)
    return _flash_fwd_cuda(q, k, v, sm_scale, False)[0]


flash_mha.launches = 0
flash_mha.f32_launches = 0       # of them, the f32 forward's
flash_mha_bwd_dkv.launches = 0
flash_mha_bwd_dq.launches = 0
flash_mha_bwd.copies = 0

KERNELS = (flash_mha, flash_mha_bwd_dkv, flash_mha_bwd_dq)
