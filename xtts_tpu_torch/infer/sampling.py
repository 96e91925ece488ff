"""Token sampling for the AR decode loop (port of xtts_tpu/infer/sampling.py).

HF logits-processor order: repetition penalty -> temperature -> top-p ->
categorical. Everything stays on the logits' device with no host read and
no host-to-device copy, so a CUDA graph can hold it (infer/device_loop.py).
Draws come from an explicit torch.Generator on that device, so they differ
from JAX's for the same seed; greedy decoding is identical.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e9


def apply_repetition_penalty(logits: torch.Tensor, seen: torch.Tensor,
                             penalty: float) -> torch.Tensor:
    """logits (B, V); seen (B, V) bool — ids present in the sequence."""
    if penalty == 1.0:
        return logits
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, penalized, logits)


def top_p_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Mask tokens outside the nucleus to NEG_INF, keeping the token that
    crosses the threshold and all ties of the boundary logit (always >= 1).
    Binary search for the boundary value, 40 halvings, as in JAX."""
    if top_p >= 1.0:
        return logits
    lmax = logits.max(dim=-1, keepdim=True).values
    e = torch.exp(logits - lmax)
    target = top_p * e.sum(dim=-1, keepdim=True)
    lo = torch.maximum(logits.min(dim=-1, keepdim=True).values - 1.0,
                       lmax - 88.0)
    hi = lmax
    zero = torch.zeros((), dtype=e.dtype, device=e.device)
    for _ in range(40):
        mid = 0.5 * (lo + hi)
        m = torch.where(logits > mid, e, zero).sum(dim=-1, keepdim=True)
        big = m >= target
        lo, hi = torch.where(big, mid, lo), torch.where(big, hi, mid)
    kth = logits.masked_fill(logits <= lo, float("inf")).amin(dim=-1,
                                                              keepdim=True)
    return logits.masked_fill(logits < kth, NEG_INF)


def sample_token(generator: Optional[torch.Generator], logits: torch.Tensor,
                 temperature: float = 1.0, top_p: float = 1.0,
                 seen: Optional[torch.Tensor] = None,
                 repetition_penalty: float = 1.0) -> torch.Tensor:
    """logits (B, V) -> (B,) int64. The categorical draw is
    torch.multinomial's own one-sample path, argmax(p / q) with q ~ Exp(1)
    from `generator` (the same indices for the same generator state),
    without multinomial's checks of p, which read back to the host."""
    logits = logits.float()
    if seen is not None:
        logits = apply_repetition_penalty(logits, seen, repetition_penalty)
    if temperature != 1.0:
        logits = logits / temperature
    logits = top_p_filter(logits, top_p)
    probs = torch.softmax(logits, dim=-1)
    q = torch.empty_like(probs).exponential_(1, generator=generator)
    return (probs / q).argmax(dim=-1)


def greedy_token(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1)
