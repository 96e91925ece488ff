"""Token sampling for the AR decode loop (port of xtts_tpu/infer/sampling.py).

HF logits-processor order: repetition penalty -> (typical) -> temperature ->
top-p -> categorical. Everything stays on the logits' device with no host
read and no host-to-device copy, so a CUDA graph can hold it
(infer/device_loop.py, infer/slots.py).

Two ways to draw. `sample_token` draws from an explicit torch.Generator on
that device, so its draws differ from JAX's for the same seed. Its
counterpart `sample_token_rows` gives every row a chain of its own: the
draw of a row's g-th token is a fixed function of that row's key and g
(a counter-based hash, `row_uniforms`), so it does not depend on the other
rows, on the row's slot or on how the steps are grouped between host reads
or into graphs. Greedy decoding is identical to JAX's.
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


def typical_filter(logits: torch.Tensor, mass: float = 0.9) -> torch.Tensor:
    """TypicalLogitsWarper (ttts/utils/typical_sampling.py): keep the tokens
    whose |-log p - H| is smallest until `mass` probability is covered. The
    sort is stable, as jnp.argsort is, so tied tokens keep index order."""
    norm = torch.log_softmax(logits, dim=-1)
    p = torch.exp(norm)
    ent = -(p * norm).masked_fill(p <= 0, 0.0).sum(dim=-1, keepdim=True)
    shifted = torch.abs(-norm - ent)
    order = torch.argsort(shifted, dim=-1, stable=True)
    sorted_logits = logits.gather(-1, order)
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    last_ind = (cum < mass).long().sum(dim=-1, keepdim=True)
    ranks = torch.argsort(order, dim=-1)
    return logits.masked_fill(ranks > last_ind, NEG_INF)


def _probs(logits: torch.Tensor, temperature: float, top_p: float,
           seen: Optional[torch.Tensor], repetition_penalty: float,
           typical_mass: Optional[float]) -> torch.Tensor:
    logits = logits.float()
    if seen is not None:
        logits = apply_repetition_penalty(logits, seen, repetition_penalty)
    if typical_mass is not None:
        logits = typical_filter(logits, typical_mass)
    if temperature != 1.0:
        logits = logits / temperature
    return torch.softmax(top_p_filter(logits, top_p), dim=-1)


def sample_token(generator: Optional[torch.Generator], logits: torch.Tensor,
                 temperature: float = 1.0, top_p: float = 1.0,
                 seen: Optional[torch.Tensor] = None,
                 repetition_penalty: float = 1.0,
                 typical_mass: Optional[float] = None) -> torch.Tensor:
    """logits (B, V) -> (B,) int64. The categorical draw is
    torch.multinomial's own one-sample path, argmax(p / q) with q ~ Exp(1)
    from `generator` (the same indices for the same generator state),
    without multinomial's checks of p, which read back to the host."""
    probs = _probs(logits, temperature, top_p, seen, repetition_penalty,
                   typical_mass)
    q = torch.empty_like(probs).exponential_(1, generator=generator)
    return (probs / q).argmax(dim=-1)


_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32) and c < 2**32, in
    16-bit halves so that no int64 product overflows."""
    return (((((x >> 16) * c) & 0xFFFF) << 16) + (x & 0xFFFF) * c) & _M32


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """A bijective 32-bit integer mix (Wellons' lowbias32) on int64 words in
    [0, 2**32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def row_keys(seed: int) -> tuple:
    """A row's key: the two 32-bit words of a 64-bit seed."""
    seed &= (1 << 64) - 1
    return seed & _M32, seed >> 32


def row_uniforms(keys: torch.Tensor, draws: torch.Tensor,
                 width: int) -> torch.Tensor:
    """(B, width) f32 uniforms in (0, 1): row b's numbers are a function of
    keys[b] (two 32-bit words, int64) and draws[b] (the row's draw counter)
    alone. One hash of (key, counter) a row, then one hash a column of that
    word plus the column times an odd constant: distinct columns hash
    distinct words (unit_uniform makes the numbers)."""
    row = _hash32(keys[:, 1:2] ^ _hash32(
        keys[:, 0:1] ^ _hash32(draws[:, None] & _M32)))
    col = torch.arange(width, device=keys.device) * 0x9E3779B9
    return unit_uniform(_hash32((row + col) & _M32))


def unit_uniform(h: torch.Tensor) -> torch.Tensor:
    """32-bit words (int64) -> f32 in (0, 1): the top 23 bits k give
    (2k + 1) / 2**24, odd multiples of 2**-24 that f32 holds exactly, so
    the largest is 1 - 2**-24 and -log u > 0 (a 24-bit k + 0.5 would round
    up to 1.0 at k = 2**24 - 1)."""
    return ((h >> 9).float() * 2.0 + 1.0) * (1.0 / (1 << 24))


def sample_token_rows(keys: torch.Tensor, draws: torch.Tensor,
                      logits: torch.Tensor, temperature: float = 1.0,
                      top_p: float = 1.0, seen: Optional[torch.Tensor] = None,
                      repetition_penalty: float = 1.0,
                      typical_mass: Optional[float] = None) -> torch.Tensor:
    """sample_token with a chain of its own for every row: keys (B, 2)
    int64 words (row_keys), draws (B,) int64 (the row's generated-token
    index), logits (B, V) -> (B,) int64. argmax(p / q) with q = -log u,
    u = row_uniforms(keys, draws): a row's draw depends only on its key and
    its counter, so a request's sampled codes do not change with what else
    shares the batch (JAX: one PRNG key a row, jax.vmap(categorical))."""
    probs = _probs(logits, temperature, top_p, seen, repetition_penalty,
                   typical_mass)
    q = -torch.log(row_uniforms(keys, draws, probs.shape[-1]))
    return (probs / q).argmax(dim=-1)


def greedy_token(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1)
