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
    """nn.Linear computing in `dtype` (flax Dense(dtype=...))."""

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
        return F.linear(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


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
    """nn.Embedding with the GPT's normal(0.02) init; f32 like flax Embed."""

    def reset_flax(self, g):
        normal_(self.weight, 0.02, g)


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


class AttentionBlock(nn.Module):
    """Self-attention over time with residual and zero-init output proj
    (legacy QKV layout, 1/sqrt(sqrt(ch)) scaling, f32 softmax). (B, T, C)."""

    def __init__(self, channels: int, num_heads: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.norm = GroupNorm32(channels)
        self.qkv = Conv1d(channels, 3 * channels, 1, dtype=dtype)
        self.proj_out = Conv1d(channels, channels, 1, dtype=dtype,
                               zero_init=True)

    def forward(self, x):
        b, t, c = x.shape
        h = self.num_heads
        ch = c // h
        y = self.norm.channels_last(x)
        qkv = self.qkv.pointwise(y).reshape(b, t, h, 3 * ch)
        q, k, v = qkv.split(ch, dim=-1)
        scale = 1.0 / math.sqrt(math.sqrt(ch))
        w = torch.einsum("bthc,bshc->bhts", q * scale, k * scale)
        w = torch.softmax(w.float(), dim=-1).to(q.dtype)
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
