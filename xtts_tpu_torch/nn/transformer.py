"""GPT-2 style transformer core (port of xtts_tpu/nn/transformer.py).

Pre-LN (eps 1e-5, f32), gelu_new MLP, f32 softmax, 1/sqrt(head_dim)
scaling; learned positions are added by the caller. Two modes, as in JAX:
`forward` (full causal sequence; prefill collects the K/V) and
`decode_step` (one token against the preallocated cache). The port updates
the cache in place (JAX returns a new one). The decode index may be a
device tensor (the AR loop's, infer/device_loop.py): the step never reads
it back to the host.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn as nn

from xtts_tpu_torch.nn.blocks import LayerNorm, lecun_normal_
from xtts_tpu_torch.nn.remat import checkpoint_policy, remat_call
from xtts_tpu_torch.parallel.mesh import copy_to_model, reduce_from_model

NEG_INF = -1e9


def cache_index(index, device, s_max: int, who: str) -> torch.Tensor:
    """A cache or table index as every decode step takes it: a 0-d int64
    tensor on `device` (the attention kernels read it from there; its
    reshape(1) serves index_copy_ / index_select, where a 0-d subscript
    would read it back to the host). An int is checked (0 <= index <
    s_max) and copied there; a tensor (one integral element on `device`) is
    taken as it is: its range is the caller's (the AR loop's rungs are sized
    for it, infer/device_loop.cache_rows)."""
    if torch.is_tensor(index):
        if (index.device != device or index.numel() != 1
                or index.dtype.is_floating_point or index.dtype == torch.bool):
            raise ValueError(f"{who}: the index is an integer tensor of one "
                             f"element on {device}, got {index.dtype} "
                             f"{tuple(index.shape)} on {index.device}")
        return index.reshape(()).long()
    if not 0 <= index < s_max:
        raise ValueError(f"{who}: index {index} outside the cache ({s_max} "
                         f"rows)")
    return torch.tensor(index, dtype=torch.long, device=device)


def gelu_new(x: torch.Tensor) -> torch.Tensor:
    """HF "gelu_new" (tanh approximation) used by GPT2."""
    return 0.5 * x * (1.0 + torch.tanh(
        math.sqrt(2.0 / math.pi) * (x + 0.044715 * torch.pow(x, 3.0))))


@dataclass
class KVCache:
    """Preallocated decode cache: (layers, B, S_max, heads, head_dim)."""

    k: torch.Tensor
    v: torch.Tensor

    @classmethod
    def zeros(cls, layers: int, batch: int, max_len: int, heads: int,
              head_dim: int, dtype=torch.bfloat16, *,
              device) -> "KVCache":
        shape = (layers, batch, max_len, heads, head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


class Conv1D(nn.Module):
    """HF transformers Conv1D: weight stored (in, out), like a flax Dense
    kernel; computes in `dtype`. Under tensor parallelism (`tp`, set by
    parallel.mesh.shard_params) the weight holds this rank's columns (dim
    1; the bias too) or rows (dim 0: the partial products are summed over
    the model group, then the whole bias added); tp_groups: the output
    columns are that many blocks, each split alike (c_attn's q, k, v)."""

    tp = None
    tp_groups = 1

    def __init__(self, nx: int, nf: int, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(nx, nf))
        self.bias = nn.Parameter(torch.zeros(nf))
        self.compute_dtype = dtype

    def reset_flax(self, g):
        lecun_normal_(self.weight, self.weight.shape[0], g)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x):
        dt = self.compute_dtype
        x2 = x.reshape(-1, x.shape[-1]).to(dt)
        tp = self.tp
        if tp is not None and tp.dim == 0:
            y = (reduce_from_model(x2 @ self.weight.to(dt), tp.mesh)
                 + self.bias.to(dt))
        else:
            if tp is not None:
                x2 = copy_to_model(x2, tp.mesh)
            y = torch.addmm(self.bias.to(dt), x2, self.weight.to(dt))
        return y.reshape(*x.shape[:-1], -1)


class SelfAttention(nn.Module):
    def __init__(self, dim: int, heads: int, dtype=torch.float32):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.c_attn = Conv1D(dim, 3 * dim, dtype)
        self.c_attn.tp_groups = 3
        self.c_proj = Conv1D(dim, dim, dtype)

    def local_dim(self) -> int:
        """The width of this rank's heads (dim unless tensor parallel)."""
        return self.c_attn.weight.shape[1] // 3

    def qkv(self, x):
        b, t = x.shape[:2]
        d, hd = self.local_dim(), self.dim // self.heads
        shp = (b, t, d // hd, hd)
        q, k, v = self.c_attn(x).split(d, dim=-1)
        return q.reshape(shp), k.reshape(shp), v.reshape(shp)

    def forward(self, x, attn_mask=None):
        """Full-sequence causal attention; returns (y, (k, v))."""
        b, t, _ = x.shape
        q, k, v = self.qkv(x)
        scale = 1.0 / math.sqrt(self.dim // self.heads)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
        mask = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                     device=x.device))[None, None]
        if attn_mask is not None:
            mask = mask & attn_mask[:, None, None, :].bool()
        logits = torch.where(mask, logits, torch.tensor(NEG_INF,
                                                        dtype=logits.dtype,
                                                        device=x.device))
        w = torch.softmax(logits.float(), dim=-1).to(x.dtype)
        dt = torch.promote_types(w.dtype, v.dtype)
        y = torch.einsum("bhqk,bkhd->bqhd", w.to(dt), v.to(dt))
        return self.c_proj(y.reshape(b, t, self.local_dim())), (k, v)

    def step(self, x, cache: KVCache, layer: int, index):
        """Single-token decode: writes this token's k/v at `index` (an int
        or a one-element tensor; in place) and attends over positions <=
        index."""
        b = x.shape[0]
        q, k, v = self.qkv(x)                                # (B, 1, H, hd)
        k_all, v_all = cache.k[layer], cache.v[layer]        # (B, S, H, hd)
        at = cache_index(index, x.device, k_all.shape[1],
                         "the decode step").reshape(1)
        k_all.index_copy_(1, at, k.to(cache.k.dtype))
        v_all.index_copy_(1, at, v.to(cache.v.dtype))
        scale = 1.0 / math.sqrt(self.dim // self.heads)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k_all.to(q.dtype)) * scale
        valid = torch.arange(k_all.shape[1], device=x.device) <= at
        logits = logits.masked_fill(~valid, NEG_INF)
        w = torch.softmax(logits.float(), dim=-1).to(x.dtype)
        y = torch.einsum("bhqk,bkhd->bqhd", w, v_all.to(x.dtype))
        return self.c_proj(y.reshape(b, 1, self.dim))


class MLP(nn.Module):
    def __init__(self, dim: int, dtype=torch.float32):
        super().__init__()
        self.c_fc = Conv1D(dim, 4 * dim, dtype)
        self.c_proj = Conv1D(4 * dim, dim, dtype)

    def forward(self, x):
        return self.c_proj(gelu_new(self.c_fc(x)))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, dtype=torch.float32):
        super().__init__()
        self.ln_1 = LayerNorm(dim, eps=1e-5)
        self.attn = SelfAttention(dim, heads, dtype)
        self.ln_2 = LayerNorm(dim, eps=1e-5)
        self.mlp = MLP(dim, dtype)

    def forward(self, x, attn_mask=None):
        a, kv = self.attn(self.ln_1(x).to(x.dtype), attn_mask)
        x = x + a
        x = x + self.mlp(self.ln_2(x).to(x.dtype))
        return x, kv

    def step(self, x, cache: KVCache, layer: int, index):
        x = x + self.attn.step(self.ln_1(x).to(x.dtype), cache, layer, index)
        return x + self.mlp(self.ln_2(x).to(x.dtype))


class GPT2Stack(nn.Module):
    """n_layer pre-LN blocks + final LayerNorm (state-dict names h.{i}.*,
    ln_f, as HF GPT2Model). remat: the blocks' gradient checkpointing
    policy while gradients are recorded (nn/remat.py); parameters and the
    decode path are the same under every policy."""

    def __init__(self, layers: int, dim: int, heads: int,
                 dtype=torch.float32, remat: str = "none"):
        super().__init__()
        checkpoint_policy(remat)           # an unknown name raises here
        self.remat = remat
        self.h = nn.ModuleList([Block(dim, heads, dtype)
                                for _ in range(layers)])
        self.ln_f = LayerNorm(dim, eps=1e-5)

    def forward(self, x, attn_mask=None, collect_kv: bool = False):
        kvs = []
        for blk in self.h:
            x, kv = remat_call(blk, self.remat, x, attn_mask)
            if collect_kv:
                kvs.append(kv)
        normed = self.ln_f(x).to(x.dtype)
        if collect_kv:
            return x, normed, (torch.stack([kv[0] for kv in kvs]),
                               torch.stack([kv[1] for kv in kvs]))
        return x, normed

    def prefill(self, x, cache: KVCache, attn_mask=None):
        """Run the prefix and seed the cache at positions [0, T)."""
        hidden, normed, (k, v) = self(x, attn_mask, collect_kv=True)
        t = x.shape[1]
        cache.k[:, :, :t] = k.to(cache.k.dtype)
        cache.v[:, :, :t] = v.to(cache.v.dtype)
        return hidden, normed, cache

    def decode_step(self, x, cache: KVCache, index):
        """One token (B, 1, D) through all layers."""
        for i, blk in enumerate(self.h):
            x = blk.step(x, cache, i, index)
        return self.ln_f(x).to(x.dtype), cache
