"""Shared building blocks (port of xtts_tpu/nn/blocks.py).

Dtype convention, as in the flax modules: parameters are kept in f32 and
each dense/conv layer computes in its module's `dtype` (inputs, weights and
bias cast at the call, output in `dtype`); norms compute in f32. Parameter
names follow the reference's torch state dicts, so
xtts_tpu/utils/convert.py's *_from_reference functions read a port
state_dict() directly.

Random init (`init_flax_like`) draws from the flax modules' default
distributions: lecun-normal (truncated) kernels, zero biases, unit norms,
explicit zero-init where the flax module has it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

# flax truncated_normal's stddev correction for a [-2, 2] truncation
_TRUNC_STD = 0.87962566103423978


def trunc_normal_(t: torch.Tensor, std: float,
                  generator: torch.Generator) -> torch.Tensor:
    """Normal(0, std) truncated to [-2 std, 2 std], by inverse CDF."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    with torch.no_grad():
        t.uniform_(2 * lo - 1, 2 * hi - 1, generator=generator)
        t.erfinv_().mul_(std * math.sqrt(2.0))
    return t


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
    return trunc_normal_(t, math.sqrt(1.0 / fan_in) / _TRUNC_STD, generator)


def normal_(t: torch.Tensor, std: float,
            generator: torch.Generator) -> torch.Tensor:
    with torch.no_grad():
        return t.normal_(0.0, std, generator=generator)


def init_flax_like(root: nn.Module, generator: torch.Generator) -> None:
    """Re-initialize every parameter of `root` from the flax defaults."""
    for m in root.modules():
        if hasattr(m, "reset_flax"):
            m.reset_flax(generator)
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            with torch.no_grad():
                m.weight.fill_(1.0)
                m.bias.zero_()


def _cast(t: Optional[torch.Tensor], dtype) -> Optional[torch.Tensor]:
    return None if t is None else t.to(dtype)


class Linear(nn.Linear):
    """nn.Linear computing in `dtype` (flax Dense(dtype=...)). Under tensor
    parallelism (`tp`, parallel.mesh.shard_params) it holds this rank's
    output columns and returns the whole output, assembled over the model
    group."""

    tp = None

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=torch.float32, zero_init: bool = False):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype
        self.zero_init = zero_init

    def reset_flax(self, g):
        with torch.no_grad():
            if self.zero_init:
                self.weight.zero_()
            else:
                lecun_normal_(self.weight, self.in_features, g)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        dt = self.compute_dtype
        if self.tp is None:
            return F.linear(x.to(dt), self.weight.to(dt),
                            _cast(self.bias, dt))
        from xtts_tpu_torch.parallel.mesh import column_gather, copy_to_model
        y = F.linear(copy_to_model(x.to(dt), self.tp.mesh),
                     self.weight.to(dt), _cast(self.bias, dt))
        return column_gather(y, self.tp.mesh)


class Conv1d(nn.Conv1d):
    """nn.Conv1d on (B, C, T) computing in `dtype` (flax Conv)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, groups: int = 1,
                 bias: bool = True, dtype=torch.float32,
                 zero_init: bool = False, dilation: int = 1):
        super().__init__(in_channels, out_channels, kernel_size,
                         stride=stride, padding=padding, groups=groups,
                         bias=bias, dilation=dilation)
        self.compute_dtype = dtype
        self.zero_init = zero_init

    def reset_flax(self, g):
        with torch.no_grad():
            if self.zero_init:
                self.weight.zero_()
            else:
                fan_in = self.in_channels // self.groups * self.kernel_size[0]
                lecun_normal_(self.weight, fan_in, g)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        dt = self.compute_dtype
        return F.conv1d(x.to(dt), self.weight.to(dt), _cast(self.bias, dt),
                        self.stride, self.padding, self.dilation, self.groups)

    def pointwise(self, x_btc):
        """A kernel-size-1 conv applied to channels-last (B, T, C)."""
        dt = self.compute_dtype
        return F.linear(x_btc.to(dt), self.weight[:, :, 0].to(dt),
                        _cast(self.bias, dt))


class Embedding(nn.Embedding):
    """nn.Embedding with the GPT's normal(0.02) init; f32 like flax Embed.
    Under tensor parallelism (`tp`) it holds this rank's rows of the
    vocabulary (parallel.mesh.vocab_lookup)."""

    tp = None

    def reset_flax(self, g):
        normal_(self.weight, 0.02, g)

    def forward(self, idx):
        if self.tp is None:
            return super().forward(idx)
        from xtts_tpu_torch.parallel.mesh import vocab_lookup
        return vocab_lookup(idx, self.weight, self.tp.mesh)


class LayerNorm(nn.LayerNorm):
    """LayerNorm in f32 (flax LayerNorm(dtype=f32)); returns f32."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps)


def tortoise_group_count(channels: int) -> int:
    """Group-count rule of the reference's normalization()."""
    groups = 32
    if channels <= 16:
        groups = 8
    elif channels <= 64:
        groups = 16
    while channels % groups != 0:
        groups = int(groups / 2)
    assert groups > 2
    return groups


class GroupNorm32(nn.GroupNorm):
    """GroupNorm over (B, C, T) computed in f32, cast back to the input
    dtype. groups=None takes the tortoise rule; aa_diffusion passes 32 and
    falls back to the rule when channels are not divisible by 32."""

    def __init__(self, channels: int, groups: Optional[int] = None,
                 eps: float = 1e-5):
        g = groups if groups is not None else tortoise_group_count(channels)
        if channels % g != 0:
            g = tortoise_group_count(channels)
        super().__init__(g, channels, eps=eps)

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight,
                            self.bias, self.eps).to(x.dtype)

    def channels_last(self, x_btc):
        return self(x_btc.transpose(1, 2)).transpose(1, 2)


class Embed(nn.Embedding):
    """nn.Embedding with flax Embed's default init: normal with variance
    1 / features."""

    def reset_flax(self, g):
        normal_(self.weight, 1.0 / math.sqrt(self.embedding_dim), g)


class RelativePositionBias(nn.Module):
    """T5-bucketed relative attention bias (ttts/utils/xtransformers.py:
    146-186, xtts_tpu/nn/blocks.py:60-94): log-spaced distance buckets, a
    learned (bucket, head) table `relative_attention_bias`, added to the
    pre-softmax logits times `scale`."""

    def __init__(self, scale: float, heads: int, causal: bool = False,
                 num_buckets: int = 32, max_distance: int = 128):
        super().__init__()
        self.scale, self.causal = scale, causal
        self.num_buckets, self.max_distance = num_buckets, max_distance
        self.relative_attention_bias = Embed(num_buckets, heads)

    def bucket(self, rel_pos: torch.Tensor) -> torch.Tensor:
        """Relative positions (key - query, int64) -> bucket ids."""
        num_buckets = self.num_buckets
        ret = torch.zeros_like(rel_pos)
        n = -rel_pos
        if not self.causal:
            num_buckets //= 2
            ret = ret + (n < 0).long() * num_buckets
            n = n.abs()
        else:
            n = n.clamp(min=0)
        max_exact = num_buckets // 2
        large = max_exact + (
            torch.log(n.clamp(min=1).float() / max_exact)
            / math.log(self.max_distance / max_exact)
            * (num_buckets - max_exact)).long()
        large = large.clamp(max=num_buckets - 1)
        return ret + torch.where(n < max_exact, n, large)

    def forward(self, qk_dots: torch.Tensor) -> torch.Tensor:  # (B, H, T, S)
        t, s = qk_dots.shape[-2:]
        dev = qk_dots.device
        rel = (torch.arange(s, device=dev)[None, :]
               - torch.arange(t, device=dev)[:, None])
        bias = self.relative_attention_bias(self.bucket(rel))  # (T, S, H)
        return qk_dots + bias.permute(2, 0, 1)[None] * self.scale


class AttentionBlock(nn.Module):
    """Self-attention over time with residual and zero-init output proj
    (legacy QKV layout, 1/sqrt(sqrt(ch)) scaling, f32 softmax). (B, T, C).

    relative_pos_embeddings: the T5 bias with the reference's settings
    (scale sqrt(ch), 32 buckets, max distance 64; ttts/utils/utils.py:305),
    added before the softmax. forward's mask (B, S), a keep-mask on the
    keys, multiplies the probabilities after it, as the reference's."""

    def __init__(self, channels: int, num_heads: int = 1,
                 dtype=torch.float32, relative_pos_embeddings: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.norm = GroupNorm32(channels)
        self.qkv = Conv1d(channels, 3 * channels, 1, dtype=dtype)
        self.proj_out = Conv1d(channels, channels, 1, dtype=dtype,
                               zero_init=True)
        self.relative_pos_embeddings = (
            RelativePositionBias((channels // num_heads) ** 0.5, num_heads,
                                 num_buckets=32, max_distance=64)
            if relative_pos_embeddings else None)

    def forward(self, x, mask=None):
        b, t, c = x.shape
        h = self.num_heads
        ch = c // h
        y = self.norm.channels_last(x)
        qkv = self.qkv.pointwise(y).reshape(b, t, h, 3 * ch)
        q, k, v = qkv.split(ch, dim=-1)
        scale = 1.0 / math.sqrt(math.sqrt(ch))
        w = torch.einsum("bthc,bshc->bhts", q * scale, k * scale)
        if self.relative_pos_embeddings is not None:
            w = self.relative_pos_embeddings(w)
        w = torch.softmax(w.float(), dim=-1).to(q.dtype)
        if mask is not None:
            w = w * mask[:, None, None, :].to(w.dtype)
        a = torch.einsum("bhts,bshc->bthc", w, v).reshape(b, t, c)
        return x + self.proj_out.pointwise(a)


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding (guided-diffusion convention)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class RMSNorm(nn.Module):
    """F.normalize(x) * sqrt(d) * gamma (ttts/gpt/perceiver.py:168-187)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.gamma = nn.Parameter(torch.ones(dim))

    def reset_flax(self, g):
        with torch.no_grad():
            self.gamma.fill_(1.0)

    def forward(self, x):
        inv = torch.rsqrt((x * x).sum(-1, keepdim=True) + 1e-12)
        return x * inv * math.sqrt(self.dim) * self.gamma


class GEGLU(nn.Module):
    """x, gate = split(x); gelu(gate) * x, the exact erf gelu
    (perceiver.py:205-210)."""

    def forward(self, x):
        x_, gate = x.chunk(2, dim=-1)
        return F.gelu(gate) * x_


def geglu_feed_forward(dim: int, mult: int = 4,
                       dtype=torch.float32) -> nn.Sequential:
    """Linear -> GEGLU -> Linear, inner dim = dim * mult * 2 / 3
    (perceiver.py:213-222; the Linears at indices 0 and 2, as there)."""
    inner = int(dim * mult * 2 / 3)
    return nn.Sequential(Linear(dim, inner * 2, dtype=dtype), GEGLU(),
                         Linear(inner, dim, dtype=dtype))


class MHAttention(nn.Module):
    """Multi-head attention of the perceiver (perceiver.py:278-318):
    bias-free to_q / to_kv / to_out; cross_attn_include_queries prepends
    the queries to the context."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 cross_attn_include_queries: bool = False,
                 dtype=torch.float32):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.cross_attn_include_queries = cross_attn_include_queries
        self.to_q = Linear(dim, inner, bias=False, dtype=dtype)
        self.to_kv = Linear(dim, inner * 2, bias=False, dtype=dtype)
        self.to_out = Linear(inner, dim, bias=False, dtype=dtype)

    def forward(self, x, context=None, mask=None):
        h, dh = self.heads, self.dim_head
        ctx = x if context is None else context
        if context is not None and self.cross_attn_include_queries:
            ctx = torch.cat([x, ctx], dim=-2)
        q = self.to_q(x)
        k, v = self.to_kv(ctx).chunk(2, dim=-1)
        q = q.reshape(*q.shape[:-1], h, dh)
        k = k.reshape(*k.shape[:-1], h, dh)
        v = v.reshape(*v.shape[:-1], h, dh)
        sim = torch.einsum("bihd,bjhd->bhij", q, k) * (dh ** -0.5)
        if mask is not None:
            sim = sim.masked_fill(~mask[:, None, None, :].bool(),
                                  torch.finfo(sim.dtype).min)
        attn = torch.softmax(sim.float(), dim=-1).to(sim.dtype)
        out = torch.einsum("bhij,bjhd->bihd", attn, v)
        return self.to_out(out.reshape(*out.shape[:-2], h * dh))


class PerceiverResampler(nn.Module):
    """num_latents learned latents cross-attending to the conditioning mel
    (perceiver.py:225-276); (B, T, dim_context) -> (B, num_latents, dim).
    Names as the reference's: latents, proj_context, layers.{i}.0 (the
    attention), layers.{i}.1 (the feed-forward), norm."""

    def __init__(self, dim: int, depth: int = 2,
                 dim_context: Optional[int] = None, num_latents: int = 32,
                 dim_head: int = 64, heads: int = 8, ff_mult: int = 4,
                 dtype=torch.float32):
        super().__init__()
        self.proj_context = (Linear(dim_context, dim, dtype=dtype)
                             if dim_context is not None and dim_context != dim
                             else None)
        self.latents = nn.Parameter(torch.zeros(num_latents, dim))
        self.layers = nn.ModuleList([nn.ModuleList([
            MHAttention(dim, heads, dim_head,
                        cross_attn_include_queries=True, dtype=dtype),
            geglu_feed_forward(dim, ff_mult, dtype)]) for _ in range(depth)])
        self.norm = RMSNorm(dim)

    def reset_flax(self, g):
        normal_(self.latents, 0.02, g)

    def forward(self, x, mask=None):
        if self.proj_context is not None:
            x = self.proj_context(x)
        lat = self.latents[None].expand(x.shape[0], -1, -1).to(x.dtype)
        for attn, ff in self.layers:
            lat = attn(lat, x, mask=mask) + lat
            lat = ff(lat) + lat
        return self.norm(lat)
