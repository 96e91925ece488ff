"""Bidirectional transformer encoders of the CLVP towers (port of
xtts_tpu/nn/encoder.py).

Two towers, as in the JAX module:

* `TortoiseEncoder` — the reference CLVP's live tower
  (ttts/utils/transformer.py:50-223): pre-LayerNorm (eps 1e-6, f32),
  biasless qkv, biased out projection, GEGLU feed-forward, LayerScale on
  both branches, learned positions added by the caller. Module names are the
  reference's ({tower}.layers.layers.{i}.{0|1}.scale / .fn.norm / .fn.fn.*),
  so xtts_tpu.utils.convert.clvp_from_reference reads a state_dict().
* `TransformerEncoder` — the x-transformers variant (use_xformers=True):
  RMSNorm, rotary positions on the first 32 channels of each head, GLU
  feed-forward, final RMSNorm.

Attention is plain einsum with an f32 softmax, as in the JAX module;
padding is a (B, T) keep-mask.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from xtts_tpu_torch.nn.blocks import LayerNorm, Linear

NEG_INF = -1e9


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def rotary_embed(t: int, dim: int, device, base: float = 10000.0):
    """(T, dim) cos/sin tables over the first `dim` channels."""
    inv = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                       device=device) / dim))
    freqs = torch.outer(torch.arange(t, dtype=torch.float32, device=device),
                        inv)
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """x (B, T, H, hd); rotate the leading rot_dim channels."""
    rot = cos.shape[-1]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat([x_rot * cos + rotate_half(x_rot) * sin, x_pass], dim=-1)


def _attend(q, k, v, mask: Optional[torch.Tensor], out_dtype):
    """q/k/v (B, T, H, hd) -> (B, T, H*hd): f32 softmax over keys."""
    b, t, h, hd = q.shape
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    if mask is not None:
        logits = logits.masked_fill(~mask[:, None, None, :].bool(), NEG_INF)
    w = torch.softmax(logits.float(), dim=-1).to(out_dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v.to(out_dtype)).reshape(
        b, t, h * hd)


def masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, T, D) x (B, T) -> (B, D); plain mean when mask is None
    (ttts/clvp/model.py:15-17)."""
    if mask is None:
        return x.mean(dim=1)
    m = mask.to(x.dtype)[..., None]
    return (x * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)


# ---------------------------------------------------------------------------
# x-transformers variant (use_xformers=True)
# ---------------------------------------------------------------------------

class RMSNorm(nn.Module):
    def __init__(self, dim: int, dtype=torch.float32):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.dtype = dtype

    def reset_flax(self, g):
        with torch.no_grad():
            self.scale.fill_(1.0)

    def forward(self, x):
        x32 = x.float()
        normed = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + 1e-8)
        return (normed * self.scale).to(self.dtype)


class EncoderAttention(nn.Module):
    def __init__(self, dim: int, heads: int, rotary_dim: int = 32,
                 dtype=torch.float32):
        super().__init__()
        self.heads, self.rotary_dim = heads, rotary_dim
        self.qkv = Linear(dim, 3 * dim, bias=False, dtype=dtype)
        self.out = Linear(dim, dim, bias=False, dtype=dtype)

    def forward(self, x, mask=None):
        b, t, d = x.shape
        hd = d // self.heads
        q, k, v = (z.reshape(b, t, self.heads, hd)
                   for z in self.qkv(x).chunk(3, dim=-1))
        cos, sin = rotary_embed(t, min(self.rotary_dim, hd), x.device)
        q = apply_rotary(q, cos.to(q.dtype), sin.to(q.dtype))
        k = apply_rotary(k, cos.to(k.dtype), sin.to(k.dtype))
        return self.out(_attend(q, k, v, mask, x.dtype))


class GLUFeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4, dtype=torch.float32):
        super().__init__()
        inner = dim * mult
        self.wi = Linear(dim, 2 * inner, bias=False, dtype=dtype)
        self.wo = Linear(inner, dim, bias=False, dtype=dtype)

    def forward(self, x):
        u, g = self.wi(x).chunk(2, dim=-1)
        return self.wo(u * F.gelu(g))


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dtype=torch.float32):
        super().__init__()
        self.norm1 = RMSNorm(dim, dtype)
        self.attn = EncoderAttention(dim, heads, dtype=dtype)
        self.norm2 = RMSNorm(dim, dtype)
        self.ff = GLUFeedForward(dim, dtype=dtype)

    def forward(self, x, mask=None):
        x = x + self.attn(self.norm1(x), mask)
        return x + self.ff(self.norm2(x))


class TransformerEncoder(nn.Module):
    """depth x EncoderBlock + final RMSNorm; per-token features."""

    def __init__(self, depth: int, dim: int, heads: int, dtype=torch.float32):
        super().__init__()
        self.blocks = nn.ModuleList([EncoderBlock(dim, heads, dtype)
                                     for _ in range(depth)])
        self.final_norm = RMSNorm(dim, dtype)

    def forward(self, x, mask=None):
        for blk in self.blocks:
            x = blk(x, mask)
        return self.final_norm(x)


# ---------------------------------------------------------------------------
# the live tortoise tower (use_xformers=False)
# ---------------------------------------------------------------------------

class TortoiseAttention(nn.Module):
    """Fixed dim_head (inner = heads * dim_head, independent of dim),
    biasless qkv, biased out projection (ttts/utils/transformer.py:135-179)."""

    def __init__(self, dim: int, heads: int, dim_head: int = 64,
                 dtype=torch.float32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.to_qkv = Linear(dim, 3 * inner, bias=False, dtype=dtype)
        self.to_out = nn.Sequential(Linear(inner, dim, dtype=dtype))

    def forward(self, x, mask=None):
        b, t, _ = x.shape
        q, k, v = (z.reshape(b, t, self.heads, self.dim_head)
                   for z in self.to_qkv(x).chunk(3, dim=-1))
        return self.to_out(_attend(q, k, v, mask, x.dtype))


class GEGLU(nn.Module):
    def forward(self, h):
        a, gates = h.chunk(2, dim=-1)
        return a * F.gelu(gates)


class TortoiseFeedForward(nn.Module):
    """net.0 Linear(dim, 2 inner) -> GEGLU -> (dropout) -> net.3 Linear."""

    def __init__(self, dim: int, mult: int = 4, dtype=torch.float32):
        super().__init__()
        inner = dim * mult
        self.net = nn.Sequential(Linear(dim, 2 * inner, dtype=dtype), GEGLU(),
                                 nn.Identity(), Linear(inner, dim, dtype=dtype))

    def forward(self, x, mask=None):
        return self.net(x)


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = LayerNorm(dim, eps=1e-6)
        self.fn = fn

    def forward(self, x, mask=None):
        return self.fn(self.norm(x).to(x.dtype), mask)


class LayerScale(nn.Module):
    """x -> fn(x) * scale, scale (1, 1, dim) initialised by depth
    (0.1 / 1e-5 / 1e-6, ttts/utils/transformer.py:82-88)."""

    def __init__(self, dim: int, depth_index: int, fn: nn.Module):
        super().__init__()
        self.init_eps = (0.1 if depth_index <= 18
                         else 1e-5 if depth_index <= 24 else 1e-6)
        self.scale = nn.Parameter(torch.full((1, 1, dim), self.init_eps))
        self.fn = fn

    def reset_flax(self, g):
        with torch.no_grad():
            self.scale.fill_(self.init_eps)

    def forward(self, x, mask=None):
        return self.fn(x, mask) * self.scale


class _Layers(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class TortoiseEncoder(nn.Module):
    """depth x (x += scale_a attn(ln x); x += scale_f geglu_ff(ln x)); no
    final norm."""

    def __init__(self, depth: int, dim: int, heads: int, dtype=torch.float32):
        super().__init__()
        self.layers = _Layers([
            nn.ModuleList([
                LayerScale(dim, i + 1, PreNorm(
                    dim, TortoiseAttention(dim, heads, dtype=dtype))),
                LayerScale(dim, i + 1, PreNorm(
                    dim, TortoiseFeedForward(dim, dtype=dtype)))])
            for i in range(depth)])

    def forward(self, x, mask=None):
        for attn, ff in self.layers.layers:
            x = x + attn(x, mask)
            x = x + ff(x, mask)
        return x
