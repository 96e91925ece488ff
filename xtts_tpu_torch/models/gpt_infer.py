"""AR mel-code generation with the full-precision model (port of
xtts_tpu/models/gpt_infer.py): prefill + single-token decode steps against
a preallocated cache, done-masking and HF-order sampling. The loop is a
Python loop; it ends when every row has emitted the stop token.
`cache_ladder` grows the cache through segment capacities; the zero padding
is exact (positions past the index are masked), so codes do not change.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from xtts_tpu_torch.infer.sampling import greedy_token, sample_token
from xtts_tpu_torch.nn.transformer import KVCache


class GenerateResult(NamedTuple):
    codes: torch.Tensor    # (B, max_gen) int64, stop-padded
    lengths: torch.Tensor  # (B,) generated tokens incl. the stop token
    steps: int             # decode iterations executed


def ladder_caps(cache_ladder, max_gen: int):
    """Normalize a cache-capacity ladder: sorted unique breakpoints below
    max_gen, always ending at max_gen. None/() -> one monolithic cache."""
    caps = tuple(sorted({int(c) for c in (cache_ladder or ())
                         if 0 < int(c) < max_gen}))
    return caps + (max_gen,)


def grow_axis(a: torch.Tensor, axis: int, new_len: int) -> torch.Tensor:
    """Zero-extend `a` along `axis` to `new_len`."""
    shape = list(a.shape)
    shape[axis] = new_len - a.shape[axis]
    return torch.cat([a, a.new_zeros(shape)], dim=axis)


@torch.no_grad()
def generate_speech(model, cond_mel: torch.Tensor, text_tokens: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    max_gen: int = 600, do_sample: bool = True,
                    top_p: float = 0.8, temperature: float = 0.8,
                    repetition_penalty: float = 2.0,
                    cache_ladder: Optional[tuple] = None) -> GenerateResult:
    """B rows; bf16 KV cache, as the JAX engine's default."""
    cfg = model.cfg
    stop, vocab = cfg.stop_mel_token, cfg.number_mel_codes
    dev = text_tokens.device
    prefix, n_cond = model.encode_prefix(cond_mel, text_tokens)
    b, p_len, _ = prefix.shape
    caps = ladder_caps(cache_ladder, max_gen)
    cache = KVCache.zeros(cfg.layers, b, p_len + caps[0], cfg.heads,
                          cfg.model_dim // cfg.heads, dtype=torch.bfloat16,
                          device=dev)
    logits, cache = model.prefill(prefix, cache)
    # ids HF's repetition penalty has already seen: the fake input id 1 and
    # the start mel token
    seen = torch.zeros((b, vocab), dtype=torch.bool, device=dev)
    seen[:, 1] = True
    seen[:, cfg.start_mel_token] = True
    codes = torch.full((b, max_gen), stop, dtype=torch.long, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    lengths = torch.zeros((b,), dtype=torch.long, device=dev)
    rows = torch.arange(b, device=dev)
    step = 0
    for i, cap in enumerate(caps):
        if i:   # grow the cache into the next rung
            cache = KVCache(grow_axis(cache.k, 2, p_len + cap),
                            grow_axis(cache.v, 2, p_len + cap))
        while step < cap and not (step and bool(done.all())):
            if do_sample:
                tok = sample_token(generator, logits, temperature=temperature,
                                   top_p=top_p, seen=seen,
                                   repetition_penalty=repetition_penalty)
            else:
                tok = greedy_token(logits)
            tok = torch.where(done, torch.full_like(tok, stop), tok)
            codes[:, step] = tok
            seen[rows, tok] = True
            lengths = torch.where(done, lengths,
                                  torch.full_like(lengths, step + 1))
            done = done | (tok == stop)
            mel_pos = step + 1 + (n_cond if cfg.decode_position_quirk else 0)
            logits, cache = model.decode_one(tok, mel_pos, cache, p_len + step)
            step += 1
        if bool(done.all()):
            break
    return GenerateResult(codes, lengths, step)
