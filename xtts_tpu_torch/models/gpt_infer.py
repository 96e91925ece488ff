"""AR mel-code generation with the full-precision model (port of
xtts_tpu/models/gpt_infer.py): prefill, then single-token decode steps
against a preallocated cache, done-masking and HF-order sampling, run by the
device loop (infer/device_loop.py: CUDA graphs on the card, the same steps
eagerly on the CPU), as the JAX package runs them in one lax.while_loop.
`cache_ladder` grows the cache through segment capacities; the zero padding
is exact (positions past the index are masked), so codes do not change.
"""
from __future__ import annotations

from typing import Optional

import torch

from xtts_tpu_torch.infer import device_loop
from xtts_tpu_torch.infer.device_loop import (Engine, GenerateResult,
                                              Sampling)
from xtts_tpu_torch.nn.transformer import KVCache


def ladder_caps(cache_ladder, max_gen: int):
    """Normalize a cache-capacity ladder: sorted unique breakpoints below
    max_gen, always ending at max_gen. None/() -> one monolithic cache."""
    caps = tuple(sorted({int(c) for c in (cache_ladder or ())
                         if 0 < int(c) < max_gen}))
    return caps + (max_gen,)


def mel_pos_offset(cfg, n_cond: int) -> int:
    """Mel position of generated code 0: code t sits at n_cond + 1 + t
    under the reference quirk (ttts/gpt/model.py:147-149), else at t + 1."""
    return 1 + (n_cond if cfg.decode_position_quirk else 0)


@torch.no_grad()
def generate_speech(model, cond_mel: torch.Tensor, text_tokens: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    max_gen: int = 600, do_sample: bool = True,
                    top_p: float = 0.8, temperature: float = 0.8,
                    repetition_penalty: float = 2.0,
                    cache_ladder: Optional[tuple] = None,
                    **loop) -> GenerateResult:
    """B rows; bf16 KV cache, as the JAX engine's default; the loop is
    device_loop.generate's (CUDA graphs on a CUDA model), which takes
    `loop` (keys, rows_after: infer/compact.py)."""
    cfg = model.cfg
    prefix, n_cond = model.encode_prefix(cond_mel, text_tokens)
    b, p_len, _ = prefix.shape
    cache = KVCache.zeros(cfg.layers, b, p_len, cfg.heads,
                          cfg.model_dim // cfg.heads, dtype=torch.bfloat16,
                          device=text_tokens.device)
    logits, cache = model.prefill(prefix, cache)

    def make(c):
        kv = KVCache(*c)
        return lambda tok, mel_pos, index: model.decode_one(
            tok, mel_pos, kv, index)[0]
    return device_loop.generate(
        Engine("full", model, 2, make), (cache.k, cache.v), logits,
        p_len=p_len, pos_off=mel_pos_offset(cfg, n_cond),
        pos_rows=model.mel_pos_embedding.emb.weight.shape[0],
        caps=ladder_caps(cache_ladder, max_gen), stop=cfg.stop_mel_token,
        start_token=cfg.start_mel_token,
        sampling=Sampling(do_sample, temperature, top_p, repetition_penalty),
        generator=generator, **loop)
