"""int8 weight-only AR decode engine (port of xtts_tpu/infer/qdecode.py).

Per-output-channel symmetric int8 weights for the transformer matmuls and
the mel head; LayerNorms, embeddings and biases stay exact. The int8 values
and scales are bit-identical to JAX's quantize_dense for the same f32
weights (tests/test_torch_port_gpt.py).

Engines, chosen per call as the JAX package chooses them:

* B=1: every token runs as one K1 step (ops/decode_step.py) over an
  (L, S, D) bf16 cache: the CUDA kernel chain for a CUDA model, its plain
  twin on the CPU;
* use_fused_serving at B in {8, 16}: every token runs as one K4 step
  (ops/serving_step.py) over an (L, B, S, D) int8 cache with per-position
  scales;
* otherwise the per-layer chain `_decode_step` (bf16 residual, bf16 cache)
  or, with quantize_kv_cache, `_decode_step_qkv` over a per-(position,
  head) int8 cache (`QuantKVCache`).

cache_ladder grows the cache through segment capacities (zero padding is
exact: positions past the index are masked) for every engine.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from xtts_tpu_torch.infer.sampling import greedy_token, sample_token
from xtts_tpu_torch.models.gpt import UnifiedVoice
from xtts_tpu_torch.models.gpt_infer import (GenerateResult, grow_axis,
                                             ladder_caps)
from xtts_tpu_torch.nn.transformer import NEG_INF, KVCache, gelu_new
from xtts_tpu_torch.ops import decode_step as _ds
from xtts_tpu_torch.ops import serving_step as _ss


def quantize_dense(kernel: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(in, out) kernel -> {w: int8 (in, out), scale: f32 (out,)} symmetric
    per output channel."""
    k32 = kernel.detach().float()
    scale = torch.clamp(k32.abs().amax(dim=0) / 127.0, min=1e-8)
    w = torch.clamp(torch.round(k32 / scale[None, :]), -127, 127).to(torch.int8)
    return {"w": w, "scale": scale}


def qdot(x: torch.Tensor, q: Dict[str, torch.Tensor],
         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B, in) @ int8 kernel -> f32 (B, out): bf16 operands, f32 result
    (the products of bf16 and int8 values are exact in f32)."""
    y = torch.matmul(x.to(torch.bfloat16).float(),
                     q["w"].float()) * q["scale"]
    if bias is not None:
        y = y + bias
    return y


@torch.no_grad()
def quantize_gpt_decode(model: UnifiedVoice,
                        include_fused: bool = True) -> Dict[str, Any]:
    """UnifiedVoice -> quantized decode tree (+ the K1 weight stack)."""
    f32 = lambda t: t.detach().float()
    ln = lambda m: {"scale": f32(m.weight), "bias": f32(m.bias)}
    out: Dict[str, Any] = {"layers": []}
    for blk in model.gpt.h:
        out["layers"].append({
            "ln_1": ln(blk.ln_1), "ln_2": ln(blk.ln_2),
            "qkv": quantize_dense(blk.attn.c_attn.weight),
            "qkv_b": f32(blk.attn.c_attn.bias),
            "proj": quantize_dense(blk.attn.c_proj.weight),
            "proj_b": f32(blk.attn.c_proj.bias),
            "fc": quantize_dense(blk.mlp.c_fc.weight),
            "fc_b": f32(blk.mlp.c_fc.bias),
            "out": quantize_dense(blk.mlp.c_proj.weight),
            "out_b": f32(blk.mlp.c_proj.bias),
        })
    out["ln_f"] = ln(model.gpt.ln_f)
    out["final_norm"] = ln(model.final_norm)
    out["mel_head"] = quantize_dense(model.mel_head.weight.t())
    out["mel_head_b"] = f32(model.mel_head.bias)
    out["mel_embedding"] = model.mel_embedding.weight.detach().to(torch.bfloat16)
    out["mel_pos_embedding"] = (model.mel_pos_embedding.emb.weight.detach()
                                .to(torch.bfloat16))
    if include_fused:
        attach_fused_stack(out, model.cfg)
    return out


def attach_fused_stack(qtree: Dict[str, Any], cfg) -> Dict[str, Any]:
    """Add the K1 weight stack (ops/decode_step.stack_qtree) in place."""
    qtree["fused"] = _ds.stack_qtree(qtree, cfg.number_mel_codes)
    return qtree


# ---------------------------------------------------------------------------
# per-layer chain (B rows; mirrors the flax Block.step numerics)
# ---------------------------------------------------------------------------

def _layer_norm(x: torch.Tensor, ln: Dict[str, torch.Tensor]) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    return (x32 - mu) * torch.rsqrt(var + 1e-5) * ln["scale"] + ln["bias"]


def _cached_attention(q, k_all, v_all, index: int) -> torch.Tensor:
    """q (B, H, hd), k_all/v_all (B, S, H, hd) -> (B, H, hd)."""
    hd = k_all.shape[-1]
    logits = torch.einsum("bhd,bshd->bhs", q.to(torch.bfloat16),
                          k_all.to(torch.bfloat16)) / math.sqrt(hd)
    valid = torch.arange(k_all.shape[1], device=q.device) <= index
    logits = logits.masked_fill(~valid, NEG_INF)
    w = torch.softmax(logits.float(), dim=-1).to(torch.bfloat16)
    return torch.einsum("bhs,bshd->bhd", w, v_all.to(torch.bfloat16))


def _decode_step(qt: Dict[str, Any], heads: int, x: torch.Tensor,
                 cache: KVCache, index: int):
    """x (B, D) bf16 -> (ln_f-normed (B, D) f32, cache); cache in place."""
    b, d = x.shape
    hd = d // heads
    for li, lp in enumerate(qt["layers"]):
        h = _layer_norm(x, lp["ln_1"]).to(torch.bfloat16)
        q, k, v = qdot(h, lp["qkv"], lp["qkv_b"]).split(d, dim=-1)
        cache.k[li, :, index] = k.reshape(b, heads, hd).to(cache.k.dtype)
        cache.v[li, :, index] = v.reshape(b, heads, hd).to(cache.v.dtype)
        a = _cached_attention(q.reshape(b, heads, hd), cache.k[li],
                              cache.v[li], index).reshape(b, d)
        x = x + qdot(a, lp["proj"], lp["proj_b"]).to(x.dtype)
        h2 = _layer_norm(x, lp["ln_2"]).to(torch.bfloat16)
        m = gelu_new(qdot(h2, lp["fc"], lp["fc_b"])).to(torch.bfloat16)
        x = x + qdot(m, lp["out"], lp["out_b"]).to(x.dtype)
    return _layer_norm(x, qt["ln_f"]), cache


class QuantKVCache(NamedTuple):
    k: torch.Tensor         # (L, B, S, H, hd) int8
    v: torch.Tensor
    k_scale: torch.Tensor   # (L, B, S, H) f32
    v_scale: torch.Tensor


def _quant_heads(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., hd) f32 -> (int8 values, f32 scale over the hd axis)."""
    scale = torch.clamp(x.abs().amax(dim=-1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(x / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def quantize_kv(cache: KVCache) -> QuantKVCache:
    """Quantize a (prefilled) bf16/f32 cache wholesale."""
    kq, ks = _quant_heads(cache.k.float())
    vq, vs = _quant_heads(cache.v.float())
    return QuantKVCache(kq, vq, ks, vs)


def _decode_step_qkv(qt: Dict[str, Any], heads: int, x: torch.Tensor,
                     cache: QuantKVCache, index: int):
    """_decode_step against an int8 KV cache: the new k/v quantized per
    (position, head) at write and attended as quantized; the scales fold
    into the scores and the probabilities. Cache updated in place."""
    b, d = x.shape
    hd = d // heads
    scale = 1.0 / math.sqrt(hd)
    valid = torch.arange(cache.k.shape[2], device=x.device) <= index
    for li, lp in enumerate(qt["layers"]):
        h = _layer_norm(x, lp["ln_1"]).to(torch.bfloat16)
        q, k, v = qdot(h, lp["qkv"], lp["qkv_b"]).split(d, dim=-1)
        kq, ks = _quant_heads(k.reshape(b, heads, hd))
        vq, vs = _quant_heads(v.reshape(b, heads, hd))
        cache.k[li, :, index], cache.k_scale[li, :, index] = kq, ks
        cache.v[li, :, index], cache.v_scale[li, :, index] = vq, vs
        logits = torch.einsum("bhd,bshd->bhs",
                              q.reshape(b, heads, hd).to(torch.bfloat16),
                              cache.k[li].to(torch.bfloat16))
        logits = logits.float() * cache.k_scale[li].transpose(1, 2) * scale
        logits = logits.masked_fill(~valid, NEG_INF)
        w = torch.softmax(logits, dim=-1)
        w = (w * cache.v_scale[li].transpose(1, 2)).to(torch.bfloat16)
        a = torch.einsum("bhs,bshd->bhd", w,
                         cache.v[li].to(torch.bfloat16)).reshape(b, d)
        x = x + qdot(a, lp["proj"], lp["proj_b"]).to(x.dtype)
        h2 = _layer_norm(x, lp["ln_2"]).to(torch.bfloat16)
        m = gelu_new(qdot(h2, lp["fc"], lp["fc_b"])).to(torch.bfloat16)
        x = x + qdot(m, lp["out"], lp["out_b"]).to(x.dtype)
    return _layer_norm(x, qt["ln_f"]), cache


def _decode_logits(qt: Dict[str, Any], heads: int, token: torch.Tensor,
                   mel_pos: int, cache: KVCache, index: int):
    """token (B,) -> (logits (B, V) f32, cache)."""
    emb = qt["mel_embedding"][token] + qt["mel_pos_embedding"][mel_pos][None]
    step = (_decode_step_qkv if isinstance(cache, QuantKVCache)
            else _decode_step)
    normed, cache = step(qt, heads, emb.to(torch.bfloat16), cache, index)
    final = _layer_norm(normed.to(torch.bfloat16), qt["final_norm"])
    return qdot(final.to(torch.bfloat16), qt["mel_head"],
                qt["mel_head_b"]), cache


# ---------------------------------------------------------------------------
# generation loop
# ---------------------------------------------------------------------------

@torch.no_grad()
def generate_speech_quantized(model: UnifiedVoice, qtree: Dict[str, Any],
                              cond_mel: torch.Tensor,
                              text_tokens: torch.Tensor,
                              generator: Optional[torch.Generator] = None,
                              max_gen: int = 600, do_sample: bool = True,
                              top_p: float = 0.8, temperature: float = 0.8,
                              repetition_penalty: float = 2.0,
                              quantize_kv_cache: bool = False,
                              use_fused_serving: bool = False,
                              cache_ladder: Optional[tuple] = None
                              ) -> GenerateResult:
    """generate_speech with the int8 per-token engines: the prefix prefill
    runs the flax-equivalent model; every token then runs the engine the
    flags select (module docstring): K1 at B=1 (S rounded up to 8 like the
    JAX fused path), K4 with use_fused_serving at B in {8, 16},
    else the per-layer chain over a bf16 or (quantize_kv_cache) int8
    cache."""
    cfg = model.cfg
    stop, vocab, d = cfg.stop_mel_token, cfg.number_mel_codes, cfg.model_dim
    layers, heads = cfg.layers, cfg.heads
    dev = text_tokens.device
    prefix, n_cond = model.encode_prefix(cond_mel, text_tokens)
    b, p_len, _ = prefix.shape
    fused = b == 1 and not quantize_kv_cache
    fserv = use_fused_serving and not fused and b in (8, 16)
    if (fused or fserv) and "fused" not in qtree:
        attach_fused_stack(qtree, cfg)
    caps = ladder_caps(cache_ladder, max_gen)

    def seg_len(cap: int) -> int:
        s = p_len + cap
        return -(-s // 8) * 8 if fused else s

    s_max = seg_len(caps[0])
    cache = KVCache.zeros(layers, b, s_max, heads, d // heads,
                          dtype=torch.bfloat16, device=dev)
    logits, cache = model.prefill(prefix, cache)
    logits = logits.float()
    if fserv:
        cache = _ss.quantize_kv_rowwise(cache)           # (kc, vc, ks, vs)
    elif quantize_kv_cache:
        cache = quantize_kv(cache)
    elif fused:
        cache = (cache.k.view(layers, s_max, d),         # same memory
                 cache.v.view(layers, s_max, d))

    seen = torch.zeros((b, vocab), dtype=torch.bool, device=dev)
    seen[:, 1] = True
    seen[:, cfg.start_mel_token] = True
    codes = torch.full((b, max_gen), stop, dtype=torch.long, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    lengths = torch.zeros((b,), dtype=torch.long, device=dev)
    rows = torch.arange(b, device=dev)
    step = 0
    for i, cap in enumerate(caps):
        if i:   # grow the cache into the next rung (zero padding is exact)
            new_s = seg_len(cap)
            if isinstance(cache, KVCache):
                cache = KVCache(grow_axis(cache.k, 2, new_s),
                                grow_axis(cache.v, 2, new_s))
            elif isinstance(cache, QuantKVCache):
                cache = QuantKVCache(*(grow_axis(t, 2, new_s) for t in cache))
            else:   # K1's (L, S, D) pair or K4's (L, B, S[, D]) quartet
                cache = tuple(grow_axis(t, 1 if fused else 2, new_s)
                              for t in cache)
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
            # code t sits at mel position n_cond + 1 + t (reference quirk)
            mel_pos = step + 1 + (n_cond if cfg.decode_position_quirk else 0)
            if fused or fserv:
                x = (qtree["mel_embedding"][tok]
                     + qtree["mel_pos_embedding"][mel_pos][None])
                if fused:
                    logits, *_ = _ds.fused_decode_logits(
                        qtree["fused"], x, *cache, p_len + step, layers, heads)
                else:
                    logits, *_ = _ss.fused_serving_logits(
                        qtree["fused"], x, *cache, p_len + step, layers,
                        heads)
                logits = logits[:, :vocab]
            else:
                logits, cache = _decode_logits(qtree, heads, tok, mel_pos,
                                               cache, p_len + step)
            step += 1
        if bool(done.all()):
            break
    return GenerateResult(codes, lengths, step)
