"""Compacting decode waves (port of xtts_tpu/infer/compact.py): a batched
AR wave that drops its finished rows at the cache-ladder rungs.

A wave's loop runs until its last row stops, so every finished row keeps
paying its cache reads until then. Here the decode runs in segments (the
rungs of the cache ladder, by default power-of-two rungs from 64): at the
end of each one the (B,) done mask comes back to the host, the finished
rows retire, and the live rows go on at the smallest row bucket that holds
them, padded with finished rows (which stay done and emit stop).

Each segment runs in the device loop (infer/device_loop.py: CUDA graphs of
CHUNK steps on the card): device_loop.generate stops at each rung's end
for `rows_after`, which decides the rows, and continues with those rows of
its loop state and cache (JAX's _init_state is the engines' prefill,
_run_segment the loop's rung, _take_rows LoopState.take and the cache's
row copy). Every (rows, rung) pair is a graph key of its own under the
store's LRU caps.

Exactness, as JAX's: row math is independent, so greedy codes equal the
monolithic wave's through drops (token for token against JAX's on the
CPU). On the card the chain's cuBLAS products round by the row count, so
after a drop a near-tied greedy pick can turn, as it can between two
plain waves of other row counts; up to the first drop the codes are the
monolithic wave's bit for bit. With no drop a sampled wave is the
monolithic wave bit for bit (the same loop, the same generator rewinds).
After a drop the shared generator's draw is shaped by the smaller row
count, so sampled tokens can differ from the monolithic wave's.
per_row_keys gives every row a chain of its own (sampling.sample_token_rows
keyed by fold_seed(seed, row), the counter the step, as slot serving's
rows): sampled codes are then invariant to drops.

Engines: the bf16 chain (qtree None: the model's own decode step) and the
int8 chain over a bf16 or int8 (quantize_kv_cache) cache; K1 and K4 keep
their fixed row counts and stay off under compaction, as JAX's fused Pallas
engines are gated off.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from xtts_tpu_torch.infer.device_loop import GenerateResult
from xtts_tpu_torch.infer.qdecode import generate_speech_quantized
from xtts_tpu_torch.infer.sampling import row_keys
from xtts_tpu_torch.infer.slots import fold_seed
from xtts_tpu_torch.models.gpt import UnifiedVoice
from xtts_tpu_torch.models.gpt_infer import generate_speech, ladder_caps


def default_rungs(max_gen: int) -> Tuple[int, ...]:
    """The segment boundaries without a cache_ladder: power-of-two rungs
    from 64 below max_gen, so the drops are checked on a doubling
    schedule."""
    rungs, c = [], 64
    while c < max_gen:
        rungs.append(c)
        c *= 2
    return tuple(rungs)


def _row_keys(generator: Optional[torch.Generator], b: int,
              device) -> torch.Tensor:
    """(b, 2) int64 row keys: row i's of fold_seed(seed, i), the seed one
    draw of the generator (seed 0 without one; JAX: fold_in(key, i))."""
    seed = 0 if generator is None else int(torch.randint(
        0, 2 ** 62, (), generator=generator, device=generator.device))
    return torch.tensor([row_keys(fold_seed(seed, i)) for i in range(b)],
                        dtype=torch.long, device=device)


@torch.no_grad()
def generate_speech_compacting(
        model: UnifiedVoice, qtree: Optional[Dict[str, Any]],
        cond_mel: torch.Tensor, text_tokens: torch.Tensor,
        generator: Optional[torch.Generator] = None, max_gen: int = 600,
        do_sample: bool = True, top_p: float = 0.8,
        temperature: float = 0.8, repetition_penalty: float = 2.0,
        quantize_kv_cache: bool = False,
        cache_ladder: Optional[tuple] = None,
        row_buckets: Tuple[int, ...] = (1, 2, 4, 8, 16, 32),
        per_row_keys: bool = False) -> GenerateResult:
    """generate_speech with row compaction at the rungs.

    qtree None runs the bf16 chain (gpt_infer.generate_speech); a quantized
    tree the int8 chain (qdecode, quantize_kv_cache for the int8 cache).
    cache_ladder gives the rungs (default_rungs without one); row_buckets
    the row counts the wave may shrink through. Codes and lengths come back
    in the rows' original order; `steps` is the longest-lived row's."""
    if quantize_kv_cache and qtree is None:
        raise ValueError("quantize_kv_cache needs the quantized engine "
                         "(pass the qtree)")
    dev = text_tokens.device
    stop = model.cfg.stop_mel_token
    b0 = text_tokens.shape[0]
    caps = ladder_caps(cache_ladder or default_rungs(max_gen), max_gen)
    buckets = tuple(sorted({int(r) for r in row_buckets if int(r) > 0}))
    orig = np.arange(b0)                 # the original row of each live row
    out_codes = torch.full((b0, max_gen), stop, dtype=torch.long, device=dev)
    out_lengths = torch.zeros((b0,), dtype=torch.long, device=dev)

    def rows_after(st):
        nonlocal orig
        done = st.done.cpu().numpy()
        live = np.flatnonzero(~done)
        b_cur = done.shape[0]
        b_new = next((r for r in buckets if r >= live.size), b_cur)
        if b_new >= b_cur:
            return None
        # the finished rows retire: their codes are final (a done row only
        # rewrites stop over its stop-filled tail)
        drop = np.flatnonzero(done)
        at = torch.as_tensor(drop, device=dev)
        to = torch.as_tensor(orig[drop], device=dev)
        out_codes[to] = st.codes[at]
        out_lengths[to] = st.lengths[at]
        # finished rows pad the bucket; they stay done and emit stop
        keep = np.concatenate([live, drop[:b_new - live.size]])
        orig = orig[keep]
        return keep.tolist()

    loop = dict(rows_after=rows_after,
                keys=_row_keys(generator, b0, dev) if per_row_keys else None)
    kw = dict(max_gen=max_gen, do_sample=do_sample, top_p=top_p,
              temperature=temperature,
              repetition_penalty=repetition_penalty, cache_ladder=caps)
    if qtree is None:
        res = generate_speech(model, cond_mel, text_tokens, generator, **kw,
                              **loop)
    else:
        res = generate_speech_quantized(
            model, qtree, cond_mel, text_tokens, generator,
            quantize_kv_cache=quantize_kv_cache, use_fused=False,
            use_fused_serving=False, **kw, **loop)
    at = torch.as_tensor(orig, device=dev)
    out_codes[at] = res.codes
    out_lengths[at] = res.lengths
    return GenerateResult(out_codes, out_lengths, res.steps)
