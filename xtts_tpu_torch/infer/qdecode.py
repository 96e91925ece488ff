"""int8 weight-only AR decode engine (port of xtts_tpu/infer/qdecode.py).

Per-output-channel symmetric int8 weights for the transformer matmuls and
the mel head; LayerNorms, embeddings and biases stay exact. The int8 values
and scales are bit-identical to JAX's quantize_dense for the same f32
weights (tests/test_torch_port_gpt.py).

Engines, chosen per call as the JAX package chooses them:

* B=1: every token runs as one K1 step (ops/decode_step.py) over an
  (L, S, D) bf16 cache: the CUDA kernel chain for a CUDA model, its plain
  twin on the CPU; on the int4 stack where XTTS_DECODE_BITS=4 was set when
  the tree was built (attach_fused_stack);
* use_fused_serving at B in {8, 16}: every token runs as one K4 step
  (ops/serving_step.py) over an (L, B, S, D) int8 cache with per-position
  scales;
* otherwise the per-layer chain `_decode_step` (bf16 residual, bf16 cache)
  or, with quantize_kv_cache, `_decode_step_qkv` over a per-(position,
  head) int8 cache (`QuantKVCache`).

Every engine runs in the device loop (infer/device_loop.py): the loop's
state, the cache index and the mel position stay on the device, CUDA
graphs of CHUNK steps replay on the card and the same steps run eagerly on
the CPU, as the JAX package runs each engine in one lax.while_loop.
cache_ladder grows the cache through segment capacities (zero padding is
exact: positions past the index are masked) for every engine.

quantization_quality_gate measures an engine's teacher-forced greedy
agreement with the full-precision chain, as the JAX package's does.
"""
from __future__ import annotations

import math
import os
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from xtts_tpu_torch.infer import device_loop
from xtts_tpu_torch.infer.device_loop import Engine, GenerateResult, Sampling
from xtts_tpu_torch.models.gpt import UnifiedVoice
from xtts_tpu_torch.models.gpt_infer import ladder_caps, mel_pos_offset
from xtts_tpu_torch.nn.transformer import (NEG_INF, KVCache, cache_index,
                                           gelu_new)
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
    """Add the K1 weight stack in place: ops/decode_step.stack_qtree, or,
    with XTTS_DECODE_BITS=4 set when this runs, the packed int4 stack
    (stack_qtree_int4; lossier, an opt-in speed mode), as the JAX package's
    attach_fused_stack reads the variable (qdecode.py:103-115). The JAX
    package attaches lazily at the first B=1 fused generate; the port
    attaches when the tree is built (TextToSpeech.requantize()), so the
    variable counts as it stands then."""
    build = (_ds.stack_qtree_int4
             if os.environ.get("XTTS_DECODE_BITS") == "4" else _ds.stack_qtree)
    qtree["fused"] = build(qtree, cfg.number_mel_codes)
    return qtree


def _k4_stack(qtree: Dict[str, Any]) -> Dict[str, Any]:
    """The weight stack K4 reads: the int8 one. An int4 stack is refused
    (in the JAX package K4 would DMA its packed tiles as int8 ones)."""
    st = qtree["fused"]
    if st.get("bits") == 4:
        raise ValueError(
            "the fused serving step (K4, XTTS_FUSED_SERVING=1) reads int8 "
            "weights and cannot run on the int4 stack that "
            "XTTS_DECODE_BITS=4 attached; unset one of the two")
    return st


# ---------------------------------------------------------------------------
# per-layer chain (B rows; mirrors the flax Block.step numerics)
# ---------------------------------------------------------------------------

def _layer_norm(x: torch.Tensor, ln: Dict[str, torch.Tensor]) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    return (x32 - mu) * torch.rsqrt(var + 1e-5) * ln["scale"] + ln["bias"]


def _cached_attention(q, k_all, v_all, index) -> torch.Tensor:
    """q (B, H, hd), k_all/v_all (B, S, H, hd) -> (B, H, hd) over positions
    <= index: an int, a one-element tensor, or one index a row shaped
    (B, 1, 1)."""
    hd = k_all.shape[-1]
    logits = torch.einsum("bhd,bshd->bhs", q.to(torch.bfloat16),
                          k_all.to(torch.bfloat16)) / math.sqrt(hd)
    valid = torch.arange(k_all.shape[1], device=q.device) <= index
    logits = logits.masked_fill(~valid, NEG_INF)
    w = torch.softmax(logits.float(), dim=-1).to(torch.bfloat16)
    return torch.einsum("bhs,bshd->bhd", w, v_all.to(torch.bfloat16))


def _quant_attention(q, kc, vc, ks, vs, valid) -> torch.Tensor:
    """q (B, H, hd) against an int8 cache kc/vc (B, S, H, hd) with f32
    scales ks/vs (B, S, H): the values attended as quantized, the scales
    folded into the scores and the probabilities; valid broadcasts against
    (B, H, S)."""
    hd = q.shape[-1]
    logits = torch.einsum("bhd,bshd->bhs", q.to(torch.bfloat16),
                          kc.to(torch.bfloat16))
    logits = logits.float() * ks.transpose(1, 2) * (1.0 / math.sqrt(hd))
    logits = logits.masked_fill(~valid, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    w = (w * vs.transpose(1, 2)).to(torch.bfloat16)
    return torch.einsum("bhs,bshd->bhd", w, vc.to(torch.bfloat16))


def _layers(qt: Dict[str, Any], heads: int, x: torch.Tensor,
            attend) -> torch.Tensor:
    """The per-layer chain (mirrors the flax Block.step numerics): x (B, D)
    bf16 -> ln_f-normed (B, D) f32. attend(li, q, k, v) takes layer li's
    q, k, v (B, H, hd) f32, writes k and v into its cache and returns the
    attention (B, H, hd)."""
    b, d = x.shape
    for li, lp in enumerate(qt["layers"]):
        h = _layer_norm(x, lp["ln_1"]).to(torch.bfloat16)
        q, k, v = (t.reshape(b, heads, d // heads) for t in
                   qdot(h, lp["qkv"], lp["qkv_b"]).split(d, dim=-1))
        a = attend(li, q, k, v).reshape(b, d)
        x = x + qdot(a, lp["proj"], lp["proj_b"]).to(x.dtype)
        h2 = _layer_norm(x, lp["ln_2"]).to(torch.bfloat16)
        m = gelu_new(qdot(h2, lp["fc"], lp["fc_b"])).to(torch.bfloat16)
        x = x + qdot(m, lp["out"], lp["out_b"]).to(x.dtype)
    return _layer_norm(x, qt["ln_f"])


def _decode_step(qt: Dict[str, Any], heads: int, x: torch.Tensor,
                 cache: KVCache, index):
    """x (B, D) bf16 -> (ln_f-normed (B, D) f32, cache); cache in place at
    `index` (an int or a one-element tensor)."""
    at = cache_index(index, x.device, cache.k.shape[2],
                     "the decode step").reshape(1)

    def attend(li, q, k, v):
        cache.k[li].index_copy_(1, at, k[:, None].to(cache.k.dtype))
        cache.v[li].index_copy_(1, at, v[:, None].to(cache.v.dtype))
        return _cached_attention(q, cache.k[li], cache.v[li], at)
    return _layers(qt, heads, x, attend), cache


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
                     cache: QuantKVCache, index):
    """_decode_step against an int8 KV cache: the new k/v quantized per
    (position, head) at write and attended as quantized; the scales fold
    into the scores and the probabilities. Cache updated in place."""
    at = cache_index(index, x.device, cache.k.shape[2],
                     "the decode step").reshape(1)
    valid = torch.arange(cache.k.shape[2], device=x.device) <= at

    def attend(li, q, k, v):
        kq, ks = _quant_heads(k[:, None])
        vq, vs = _quant_heads(v[:, None])
        cache.k[li].index_copy_(1, at, kq)
        cache.k_scale[li].index_copy_(1, at, ks)
        cache.v[li].index_copy_(1, at, vq)
        cache.v_scale[li].index_copy_(1, at, vs)
        return _quant_attention(q, cache.k[li], cache.v[li],
                                cache.k_scale[li], cache.v_scale[li], valid)
    return _layers(qt, heads, x, attend), cache


def _decode_step_rows(qt: Dict[str, Any], heads: int, x: torch.Tensor,
                      cache: tuple, pos: torch.Tensor):
    """_decode_step with one cache position a row (the slot pool's step,
    xtts_tpu/infer/slots.py:81-133): x (B, D) bf16, pos (B,) int64 tensor;
    row b's k/v land at cache[.., b, pos[b]] and it attends to positions
    <= pos[b]. cache (k, v) bf16 (L, B, S, H, hd), or the kv_quant 4-tuple
    (k, v, k_scale, v_scale) as _decode_step_qkv keeps it. In place; no
    host read."""
    rows = torch.arange(x.shape[0], device=x.device)
    at = (rows, pos)
    if len(cache) == 4:
        kc, vc, ks, vs = cache
        valid = (torch.arange(kc.shape[2], device=x.device)[None, None, :]
                 <= pos[:, None, None])

        def attend(li, q, k, v):
            kq, ksc = _quant_heads(k)
            vq, vsc = _quant_heads(v)
            kc[li].index_put_(at, kq)
            ks[li].index_put_(at, ksc)
            vc[li].index_put_(at, vq)
            vs[li].index_put_(at, vsc)
            return _quant_attention(q, kc[li], vc[li], ks[li], vs[li], valid)
    else:
        kc, vc = cache

        def attend(li, q, k, v):
            kc[li].index_put_(at, k.to(kc.dtype))
            vc[li].index_put_(at, v.to(vc.dtype))
            return _cached_attention(q, kc[li], vc[li], pos[:, None, None])
    return _layers(qt, heads, x, attend), cache


def _embed(qt: Dict[str, Any], token: torch.Tensor, mel_pos) -> torch.Tensor:
    """token (B,) at mel position `mel_pos` (an int or a one-element
    tensor) -> (B, D) bf16."""
    table = qt["mel_pos_embedding"]
    return qt["mel_embedding"][token] + table.index_select(0, cache_index(
        mel_pos, token.device, table.shape[0], "the mel position").reshape(1))


def _head(qt: Dict[str, Any], normed: torch.Tensor) -> torch.Tensor:
    """ln_f-normed (B, D) -> final norm -> int8 mel head: logits (B, V)."""
    final = _layer_norm(normed.to(torch.bfloat16), qt["final_norm"])
    return qdot(final.to(torch.bfloat16), qt["mel_head"], qt["mel_head_b"])


def _decode_logits(qt: Dict[str, Any], heads: int, token: torch.Tensor,
                   mel_pos, cache: KVCache, index):
    """token (B,) -> (logits (B, V) f32, cache)."""
    emb = _embed(qt, token, mel_pos)
    step = (_decode_step_qkv if isinstance(cache, QuantKVCache)
            else _decode_step)
    normed, cache = step(qt, heads, emb.to(torch.bfloat16), cache, index)
    return _head(qt, normed), cache


def _decode_logits_rows(qt: Dict[str, Any], heads: int, token: torch.Tensor,
                        mel_pos: torch.Tensor, cache: tuple,
                        pos: torch.Tensor):
    """token (B,) at per-row mel positions (B,) and cache positions (B,)
    -> (logits (B, V) f32, cache) (xtts_tpu/infer/slots.py:136-145)."""
    emb = qt["mel_embedding"][token] + qt["mel_pos_embedding"][mel_pos]
    normed, cache = _decode_step_rows(qt, heads, emb.to(torch.bfloat16),
                                      cache, pos)
    return _head(qt, normed), cache


# ---------------------------------------------------------------------------
# quantization quality gate (xtts_tpu/infer/qdecode.py:274-408)
# ---------------------------------------------------------------------------

def requantize_int4_tree(qtree: Dict[str, Any]) -> Dict[str, Any]:
    """The JAX package's int4 grid for the per-layer chain, as it is:
    dequantize each int8 matrix and re-quantize it per output column over
    the WHOLE K axis, s4 = max(max|W| / 7, 1e-8). Its docstring there calls
    this stack_qtree_int4's exact math, but K1-int4 takes one scale per
    (D-row group, column): for the MLP out matrix (K = 4D) the two grids
    differ, so the gate measures other weights than K1-int4 streams
    (ROADMAP R4). Kept as the JAX package has it."""
    def requant(q):
        w = q["w"].float() * q["scale"][None, :]
        s4 = torch.clamp(w.abs().amax(dim=0) / 7.0, min=1e-8)
        w4 = torch.clamp(torch.round(w / s4[None, :]), -7, 7)
        return {"w": w4.to(torch.int8), "scale": s4}

    out = dict(qtree)
    out["layers"] = [
        {k: (requant(v) if k in ("qkv", "proj", "fc", "out") else v)
         for k, v in layer.items()}
        for layer in qtree["layers"]]
    out["mel_head"] = requant(qtree["mel_head"])
    return out


@torch.no_grad()
def _teacher_forced_agreement(model: UnifiedVoice, qtree: Dict[str, Any],
                              cond_mel, text_tokens, codes,
                              kv_quant: bool = False,
                              fused_serving: bool = False):
    """Teacher-forced greedy picks of the quantized engine and of the
    full-precision decode chain over the same ground-truth codes (B, N).
    Returns (picks of the chain (N, B), picks of the quantized engine
    (N, B), margin (N, B)): margin is the smaller of the two arms' top-2
    logit gaps at each position. kv_quant: the quantized arm keeps a
    per-(position, head) int8 cache; fused_serving: it runs K4 over its
    per-(layer, row, position) int8 cache."""
    cfg = model.cfg
    prefix, n_cond = model.encode_prefix(cond_mel, text_tokens)
    b, p_len, _ = prefix.shape
    n = codes.shape[1]
    s_max = p_len + n + 1
    hd = cfg.model_dim // cfg.heads

    def prefilled():
        cache = KVCache.zeros(cfg.layers, b, s_max, cfg.heads, hd,
                              dtype=torch.bfloat16, device=prefix.device)
        return model.prefill(prefix, cache)[1]

    cache_f, cache_q = prefilled(), prefilled()
    if fused_serving:
        k4 = _k4_stack(qtree)
        cache_q = _ss.quantize_kv_rowwise(cache_q)
    elif kv_quant:
        cache_q = quantize_kv(cache_q)
    picks_f, picks_q, margins = [], [], []

    def top2_gap(lg):
        top = lg.float().topk(2, dim=-1).values
        return top[..., 0] - top[..., 1]

    for t in range(n):
        tok = codes[:, t]
        mel_pos = t + mel_pos_offset(cfg, n_cond)
        lf, cache_f = model.decode_one(tok, mel_pos, cache_f, p_len + t)
        if fused_serving:
            x = _embed(qtree, tok, mel_pos)
            lq = _ss.fused_serving_logits(k4, x, *cache_q, p_len + t,
                                          cfg.layers, cfg.heads)[0]
            lq = lq[:, :cfg.number_mel_codes]
        else:
            lq, cache_q = _decode_logits(qtree, cfg.heads, tok, mel_pos,
                                         cache_q, p_len + t)
        picks_f.append(lf.argmax(-1))
        picks_q.append(lq.argmax(-1))
        margins.append(torch.minimum(top2_gap(lf), top2_gap(lq)))
    return (torch.stack(picks_f), torch.stack(picks_q),
            torch.stack(margins))


def quantization_quality_gate(model: UnifiedVoice, cond_mel, text_tokens,
                              codes, bits: int = 8, kv_quant: bool = False,
                              fused_serving: bool = False,
                              min_agreement: float = 0.98) -> Dict[str, Any]:
    """Teacher-forced greedy top-1 agreement of a quantized decode engine
    with the full-precision decode chain over the given mel-code sequences
    (B, N): the acceptance check before a quantized engine becomes a
    default on a set of weights. Engines: bits 8 or 4 (the int4 grid of
    requantize_int4_tree) over a bf16 cache; kv_quant adds the
    per-(position, head) int8 cache; fused_serving runs K4 (rows 8 or 16).
    Returns {bits, kv_quant, fused_serving, agreement, n_positions,
    min_agreement, passed}."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    if kv_quant and fused_serving:
        raise ValueError("kv_quant and fused_serving are separate engines; "
                         "gate them one at a time")
    qtree = quantize_gpt_decode(model, include_fused=fused_serving)
    if bits == 4:
        qtree = requantize_int4_tree(qtree)
    dev = next(model.parameters()).device
    pf, pq, _ = _teacher_forced_agreement(
        model, qtree, torch.as_tensor(cond_mel, device=dev),
        torch.as_tensor(text_tokens, dtype=torch.long, device=dev),
        torch.as_tensor(codes, dtype=torch.long, device=dev),
        kv_quant=kv_quant, fused_serving=fused_serving)
    agreement = float((pf == pq).float().mean())
    return {"bits": bits, "kv_quant": kv_quant,
            "fused_serving": fused_serving, "agreement": agreement,
            "n_positions": int(codes.shape[0]) * int(codes.shape[1]),
            "min_agreement": min_agreement,
            "passed": agreement >= min_agreement}


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
                              cache_ladder: Optional[tuple] = None,
                              use_fused: bool = True) -> GenerateResult:
    """generate_speech with the int8 per-token engines: the prefix prefill
    runs the flax-equivalent model; every token then runs the engine the
    flags select (module docstring): K1 at B=1 (use_fused=False: the chain,
    as the JAX package's default), K4 with use_fused_serving at B in
    {8, 16}, else the per-layer chain over a bf16 or (quantize_kv_cache)
    int8 cache, each in the device loop."""
    cfg = model.cfg
    vocab, d = cfg.number_mel_codes, cfg.model_dim
    layers, heads = cfg.layers, cfg.heads
    prefix, n_cond = model.encode_prefix(cond_mel, text_tokens)
    b, p_len, _ = prefix.shape
    fused = use_fused and b == 1 and not quantize_kv_cache
    fserv = use_fused_serving and not fused and b in (8, 16)
    if (fused or fserv) and "fused" not in qtree:
        attach_fused_stack(qtree, cfg)
    cache = KVCache.zeros(layers, b, p_len, heads, d // heads,
                          dtype=torch.bfloat16, device=text_tokens.device)
    logits, cache = model.prefill(prefix, cache)
    if fused or fserv:
        stack = _k4_stack(qtree) if fserv else qtree["fused"]
        fn = _ss.fused_serving_logits if fserv else _ds.fused_decode_logits

        def make(c):
            def step(tok, mel_pos, index):
                return fn(stack, _embed(qtree, tok, mel_pos), *c, index,
                          layers, heads)[0][:, :vocab]
            return step
        if fserv:
            engine = Engine("k4", stack["wqkv"], 2, make)
            cache = _ss.quantize_kv_rowwise(cache)      # (kc, vc, ks, vs)
        else:   # K1's (L, S, D) pair: the same memory
            engine = Engine("k1", stack["wqkv"], 1, make)
            cache = (cache.k.view(layers, p_len, d),
                     cache.v.view(layers, p_len, d))
    else:
        kind = QuantKVCache if quantize_kv_cache else KVCache

        def make(c):
            kv = kind(*c)
            return lambda tok, mel_pos, index: _decode_logits(
                qtree, heads, tok, mel_pos, kv, index)[0]
        engine = Engine("kv_quant" if quantize_kv_cache else "chain",
                        qtree["layers"][0]["qkv"]["w"], 2, make)
        cache = (tuple(quantize_kv(cache)) if quantize_kv_cache
                 else (cache.k, cache.v))
    return device_loop.generate(
        engine, cache, logits.float(), p_len=p_len,
        pos_off=mel_pos_offset(cfg, n_cond),
        pos_rows=qtree["mel_pos_embedding"].shape[0],
        caps=ladder_caps(cache_ladder, max_gen), stop=cfg.stop_mel_token,
        start_token=cfg.start_mel_token,
        sampling=Sampling(do_sample, temperature, top_p, repetition_penalty),
        generator=generator)
