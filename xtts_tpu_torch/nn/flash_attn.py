"""K2: flash attention for the diffusion UNet's big self-attention (port of
xtts_tpu/nn/flash_attn.py).

Replaces the Pallas TPU flash kernel that xtts_tpu/nn/flash_attn.py:
flash_mha calls (jax.experimental.pallas.ops.tpu.flash_attention, :99). The
CUDA kernel (csrc/flash_attn.cu) is written for Hopper: one warpgroup per
(64-query tile, head, batch row); K/V tiles stream through a two-stage
cp.async ring in shared memory; S = Q K^T and O += P V run on wgmma (P as
the register operand, V read MN-major); the f32 online softmax and O stay
in registers.

Bound on the H100: tensor-core FLOPs (8.2 GFLOP a call at the main path's
(2, 1280 | 1562, 8, 64)); the design keeps the (B, H, Tq, Tk) score matrix
out of device memory, which the plain version writes and reads back.

It reads the (B, T, H, 64) strides directly and masks the ragged Tk edge
itself, so the TPU wrapper's padding to 128 and its segment ids are gone.
`flash_mha` launches the kernel for CUDA tensors (counting launches in
`flash_mha.launches`) and runs the plain version for CPU tensors. The
kernel has no backward: on the card it refuses inputs that require grad
while gradients are recorded, rather than return an output detached from
them (the trainers build the UNet with flash=False, as JAX's do).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from xtts_tpu_torch.ops.build import (check, load_library, ptr,
                                      require_hopper, stream_of)

# Tq * Tk at or above this runs the kernel (the JAX package's gate)
FLASH_MIN_SCORES = 1 << 19


def use_flash(tq: int, tk: int) -> bool:
    return tq * tk >= FLASH_MIN_SCORES


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("flash_attn")
    lib.xt_flash_attn_fwd.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
        + [ctypes.c_longlong] * 12 + [ctypes.c_float, ctypes.c_void_p])
    lib.xt_flash_attn_fwd.restype = ctypes.c_int
    return lib


def flash_mha_plain(q, k, v, sm_scale: float) -> torch.Tensor:
    """Plain attention in the inputs' dtype with an f32 softmax — the
    einsum path of the JAX CrossAttention and flash_mha's reference core."""
    sim = torch.einsum("bihd,bjhd->bhij", q, k) * sm_scale
    attn = torch.softmax(sim.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhij,bjhd->bihd", attn, v)


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              sm_scale: float) -> torch.Tensor:
    """Exact attention. q (B, Tq, H, dh), k/v (B, Tk, H, dh) -> (B, Tq, H, dh).

    CUDA: bf16, dh = 64, last axis contiguous, other strides multiples of 8
    elements, 16-byte aligned bases; anything else raises."""
    if not q.is_cuda:
        return flash_mha_plain(q, k, v, sm_scale)
    b, tq, h, dh = q.shape
    tk = k.shape[1]
    if (dh != 64 or k.shape != (b, tk, h, dh) or v.shape != k.shape
            or min(b, tq, tk, h) < 1):
        raise ValueError(f"flash_mha takes (B, T, H, 64); got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    for t in (q, k, v):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"flash_mha takes bf16, got {t.dtype}")
        if (t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError("flash_mha needs unit head-dim stride, strides "
                             "in multiples of 8 and 16-byte aligned data")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_mha has no backward: its output would be "
                           "detached from q, k and v. Build the model with "
                           "flash=False to train, or run under no_grad")
    require_hopper(q)
    out = torch.empty((b, tq, h, dh), dtype=torch.bfloat16, device=q.device)
    check(_lib().xt_flash_attn_fwd(
        ptr(q), ptr(k), ptr(v), ptr(out), b, tq, tk, h,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        float(sm_scale), stream_of(q)), "flash_mha")
    flash_mha.launches += 1
    return out


flash_mha.launches = 0
