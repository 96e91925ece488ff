"""Continuous batching (slot serving): per-row decode with mid-stream refill
(port of xtts_tpu/infer/slots.py).

Wave serving (serving.synthesize_batch / BatchServer) holds a batch until
its slowest row finishes. Here a fixed pool of B decode SLOTS shares one
preallocated KV cache (L, B, S_max, H, hd); each slot carries its own
prefix length and position counters, and the pool decodes in segments of
`segment_len` steps. Between segments the host reads the small (B,) done
mask, harvests finished rows and prefills new requests into the freed slots
while the other rows keep decoding.

Engine: the int8 per-layer chain of infer/qdecode.py with one cache
position and one attention mask a row (`qdecode._decode_step_rows`), over a
bf16 cache or, with settings.kv_quant, the per-(position, head) int8 one.
As in the JAX package it is not K1 (one row) or K4 (one cache index for all
rows). A segment runs on the device as the device loop runs an engine
(infer/device_loop.py): on a CUDA model its steps replay as CUDA graphs of
gcd(segment_len, CHUNK) steps, captured once a pool and sampling setting,
and nothing in a segment reads back to the host. Idle rows (done or empty)
take the stop token, keep their counters and write only in bounds, so idle
steps are exact and a segment always runs all its steps: there is no early
exit, and a segment ends in one copy of (done | gen) to pinned host memory
behind an event (`dispatch_segment`), which the host waits for only when
it reads it (`read_packed`).

Exactness: greedy decode of every request equals the B=1 chain on the same
padded text, token for token (row math is independent; masked positions
contribute exact zeros). Sampled rows draw from per-row chains
(sampling.sample_token_rows: a row's g-th draw is a function of its key and
g), so a request's sampled codes are a function of its own (text, voice,
seed), whatever else shares the pool. The diffusion render draws each row's
noise from a generator seeded from the request seed's render derivation
(fold_seed(seed, RENDER_FOLD), as JAX's fold_in(key, _RENDER_FOLD)), and
rows group by their own code bucket, so a seeded request's waveform does
not depend on the traffic either, up to the render batch's arithmetic.
"""
from __future__ import annotations

import functools
import math
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from xtts_tpu_torch.infer import device_loop
from xtts_tpu_torch.infer.device_loop import Sampling
from xtts_tpu_torch.infer.qdecode import _decode_logits_rows, quantize_kv
from xtts_tpu_torch.infer.sampling import (NEG_INF, greedy_token, row_keys,
                                           sample_token_rows)
from xtts_tpu_torch.models.gpt_infer import mel_pos_offset
from xtts_tpu_torch.nn.transformer import KVCache

# derivation namespace of a request's RENDER noise; candidate i of K draws
# its AR codes from fold_seed(seed, i), i < K
RENDER_FOLD = 0x52454E44  # "REND"
_M64 = (1 << 64) - 1


def _mix64(z: int) -> int:
    """splitmix64's finalizer on a 64-bit integer."""
    z = (z + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def fold_seed(seed: int, data: int) -> int:
    """A 64-bit seed derived from (seed, data), as jax.random.fold_in
    derives a key: distinct data give unrelated seeds."""
    return _mix64(_mix64(seed & _M64) ^ (data & _M64))


class SlotState:
    """The device-side slot pool; every field is updated in place, so a
    captured segment reads and writes the same buffers."""

    def __init__(self, cache: tuple, n_slots: int, vocab: int, max_gen: int,
                 device):
        def vec():
            return torch.zeros((n_slots,), dtype=torch.long, device=device)
        # cache: (k, v) bf16, or (k, v, k_scale, v_scale) int8 + f32 scales
        self.cache = cache
        self.pos = vec()      # next cache write index (plen + gen)
        self.gen = vec()      # tokens generated (stop included)
        self.plen = vec()     # the slot's prefix length
        self.logits = torch.zeros((n_slots, vocab), dtype=torch.float32,
                                  device=device)
        self.done = torch.zeros((n_slots,), dtype=torch.bool, device=device)
        self.seen = torch.zeros((n_slots, vocab), dtype=torch.bool,
                                device=device)
        self.codes = torch.zeros((n_slots, max_gen), dtype=torch.long,
                                 device=device)
        # the rows' RNG keys: two 32-bit words each (sampling.row_keys)
        self.keys = torch.zeros((n_slots, 2), dtype=torch.long,
                                device=device)

    def clear(self, stop: int) -> None:
        """Every slot empty: idle as done, stop-padded, cache zeroed."""
        for t in self.cache:
            t.zero_()
        for t in (self.pos, self.gen, self.plen, self.keys):
            t.zero_()
        self.logits.fill_(NEG_INF)
        self.done.fill_(True)
        self.seen.zero_()
        self.codes.fill_(stop)


def _slot_step(st: SlotState, qt: Dict[str, Any], heads: int, pos_off: int,
               pos_rows: int, max_gen: int, stop: int,
               sampling: Sampling) -> None:
    """One step of every slot (xtts_tpu/infer/slots.py:163-193), in place:
    sample (per-row chains, the draw counter is the row's gen), force idle
    rows to stop, write the code at gen, advance the live rows' counters,
    then the chain step at each row's mel position and cache position. An
    idle row keeps its codes, gen and pos; its write is clamped into the
    cache and lands past what it attends."""
    if sampling.do_sample:
        tok = sample_token_rows(st.keys, st.gen, st.logits,
                                temperature=sampling.temperature,
                                top_p=sampling.top_p, seen=st.seen,
                                repetition_penalty=sampling.repetition_penalty)
    else:
        tok = greedy_token(st.logits)
    idle = st.done.clone()
    tok = tok.masked_fill(idle, stop)
    col = st.gen.clamp(max=max_gen - 1)[:, None]
    # an idle row must not overwrite its last column: a row that hit the
    # cap holds a real token at max_gen - 1
    st.codes.scatter_(1, col, torch.where(idle[:, None], st.codes.gather(
        1, col), tok[:, None]))
    st.seen.scatter_(1, tok[:, None], True)
    gen = torch.where(idle, st.gen, st.gen + 1)
    # code g embeds at mel position g + pos_off and its K/V land at cache
    # index plen + g
    mel_pos = (st.gen + pos_off).clamp(max=pos_rows - 1)
    wpos = st.pos.clamp(max=st.cache[0].shape[2] - 1)
    logits, _ = _decode_logits_rows(qt, heads, tok, mel_pos, st.cache, wpos)
    st.pos.copy_(torch.where(idle, st.pos, st.pos + 1))
    st.done.copy_(idle | (tok == stop) | (gen >= max_gen))
    st.gen.copy_(gen)
    st.logits.copy_(logits)


def prefix_len(cfg, text_len: int) -> int:
    """Prefix length of a text of text_len tokens: the conditioning, [start;
    text; stop; stop] and the start-mel tail (models/gpt.encode_prefix)."""
    n_cond = cfg.perceiver_latents if cfg.use_perceiver else 1
    return n_cond + text_len + 4


class SlotDecoder:
    """Device-facing half of continuous batching: owns the SlotState and
    its three programs (install / segment / fetch).

    Requires TextToSpeech(quantized_decode=True): the per-row engine runs
    on the int8 decode tree."""

    def __init__(self, tts, n_slots: int = 16, max_gen: int = 600,
                 segment_len: int = 32,
                 text_buckets: Optional[Sequence[int]] = None,
                 settings=None):
        from xtts_tpu_torch.infer.api import TTSSettings
        if getattr(tts, "_qtree", None) is None:
            raise ValueError("SlotDecoder needs TextToSpeech("
                             "quantized_decode=True)")
        self.tts = tts
        cfg = tts.cfg.gpt
        self.cfg = cfg
        self.device = tts.device
        self.settings = settings or TTSSettings(max_mel_tokens=max_gen)
        self.max_gen = max_gen
        self.segment_len = segment_len
        self.n_slots = n_slots
        self.text_buckets = tuple(
            b for b in (text_buckets or (16, 32, 64, 128, 256,
                                         cfg.max_text_tokens))
            if b <= cfg.max_text_tokens) or (cfg.max_text_tokens,)
        self.n_cond = cfg.perceiver_latents if cfg.use_perceiver else 1
        self.pos_off = mel_pos_offset(cfg, self.n_cond)
        # S_max: the prefix at the largest text bucket + the generation cap
        self.p_len_max = prefix_len(cfg, self.text_buckets[-1])
        self.s_max = self.p_len_max + max_gen
        hd = cfg.model_dim // cfg.heads
        shape = (cfg.layers, n_slots, self.s_max, cfg.heads, hd)
        dev = self.device
        if self.settings.kv_quant:
            # int8 pool: every slot step reads the whole S_max cache
            cache = (torch.zeros(shape, dtype=torch.int8, device=dev),
                     torch.zeros(shape, dtype=torch.int8, device=dev),
                     torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
                     torch.zeros(shape[:-1], dtype=torch.float32, device=dev))
        else:
            cache = (torch.zeros(shape, dtype=torch.bfloat16, device=dev),
                     torch.zeros(shape, dtype=torch.bfloat16, device=dev))
        self.state = SlotState(cache, n_slots, cfg.number_mel_codes, max_gen,
                               dev)
        self.state.clear(cfg.stop_mel_token)
        self._install_seq = 0
        # this pool's graphs, in a memory pool of their own (they write
        # only this pool's buffers)
        self._store = device_loop.Store()

    def reset(self) -> None:
        """Drop all slot state (e.g. after a poisoned-pool error). In
        place: the captured segments stay valid."""
        self.state.clear(self.cfg.stop_mel_token)

    def pad_text(self, text_tokens: np.ndarray) -> np.ndarray:
        """Pad a (T,) request to its text bucket with stop_text_token (the
        framing wave serving uses, serving._pad_texts)."""
        from xtts_tpu_torch.infer.api import bucket_len
        t = np.asarray(text_tokens, np.int64)
        tb = bucket_len(len(t), self.text_buckets)
        out = np.full((tb,), self.cfg.stop_text_token, np.int64)
        out[:min(len(t), tb)] = t[:tb]
        return out

    @torch.no_grad()
    def install(self, slot: int, text_tokens: np.ndarray,
                cond_mel: torch.Tensor, seed: Optional[int] = None) -> None:
        """Prefill `text_tokens` (pre-padded via pad_text) with `cond_mel`
        (1, mel, T) into `slot` (a B=1 pass of the model): the prefix K/V
        into the row's cache positions [0, p_len) (quantized under
        kv_quant), its counters, logits, seen set and codes reset, and its
        RNG chain keyed by `seed` (default: a fresh seed an install). No
        host read."""
        if seed is None:
            self._install_seq += 1
            seed = self._install_seq
        gpt, cfg, st = self.tts.gpt, self.cfg, self.state
        text = torch.as_tensor(np.asarray(text_tokens), dtype=torch.long,
                               device=self.device)[None]
        prefix, _ = gpt.encode_prefix(cond_mel.to(self.device), text)
        p_len = prefix.shape[1]
        if p_len > self.p_len_max:
            raise ValueError(f"a prefix of {p_len} positions does not fit "
                             f"the pool's {self.p_len_max} (pad_text first)")
        tmp = KVCache.zeros(cfg.layers, 1, p_len, cfg.heads,
                            cfg.model_dim // cfg.heads, dtype=torch.bfloat16,
                            device=self.device)
        logits0, tmp = gpt.prefill(prefix, tmp)
        new = tuple(quantize_kv(tmp)) if len(st.cache) == 4 else (tmp.k,
                                                                  tmp.v)
        for dst, src in zip(st.cache, new):
            dst[:, slot, :p_len].copy_(src[:, 0])
        st.pos[slot] = p_len
        st.gen[slot] = 0
        st.plen[slot] = p_len
        st.logits[slot].copy_(logits0[0])
        st.done[slot] = False
        st.seen[slot] = False
        st.seen[slot, 1] = True
        st.seen[slot, cfg.start_mel_token] = True
        st.codes[slot] = cfg.stop_mel_token
        k0, k1 = row_keys(seed)
        st.keys[slot, 0] = k0
        st.keys[slot, 1] = k1

    def _sampling(self, greedy: bool) -> Sampling:
        s = self.settings
        if greedy:
            return Sampling(False, 1.0, 1.0, 1.0)
        return Sampling(True, s.temperature, s.top_p, s.repetition_penalty)

    @torch.no_grad()
    def dispatch_segment(self, greedy: bool = False):
        """Run one segment of segment_len steps and return the packed
        (done | gen) as a handle for read_packed, without waiting for the
        device: on the card the copy to pinned host memory is queued behind
        the segment with an event, so the host can dispatch the next
        segment before it reads this one (the pipelined scheduler)."""
        sampling = self._sampling(greedy)
        qt = self.tts._qtree
        run = functools.partial(
            _slot_step, self.state, qt, self.cfg.heads, self.pos_off,
            qt["mel_pos_embedding"].shape[0], self.max_gen,
            self.cfg.stop_mel_token, sampling)
        chunk = math.gcd(self.segment_len, device_loop.CHUNK)
        store = self._store if device_loop.graphed(self.device) else None
        with self._store.lock:
            for _ in range(self.segment_len // chunk):
                device_loop.run_chunk(store, sampling, lambda _gen: run(),
                                      chunk, chunk, False, self.device)
            packed = torch.cat([self.state.done.long(), self.state.gen])
            if packed.device.type != "cuda":
                return packed, None
            host = torch.empty(packed.shape, dtype=packed.dtype,
                               pin_memory=True)
            host.copy_(packed, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            return host, event

    def read_packed(self, packed) -> Tuple[np.ndarray, np.ndarray]:
        """(done (B,) bool, gen (B,) int64) of a dispatched segment: the
        loop's one host read a segment."""
        host, event = packed
        if event is not None:
            event.synchronize()
        device_loop.STATS.syncs += 1
        p = host.numpy()
        return p[:self.n_slots].astype(bool), p[self.n_slots:]

    def run_segment(self, greedy: bool = False
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Decode segment_len tokens for all slots; returns (done, gen).
        greedy=True is token-exact with the B=1 chain."""
        return self.read_packed(self.dispatch_segment(greedy))

    def run_segment_greedy(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.run_segment(greedy=True)

    def fetch_codes(self) -> np.ndarray:
        """(B, max_gen) codes snapshot (a host read; a copy on the CPU
        too, where .cpu() would share the pool's buffer)."""
        device_loop.STATS.syncs += 1
        return self.state.codes.to("cpu", copy=True).numpy()


@dataclass
class _Group:
    """One request: K candidate decodes sharing a text/voice/future."""
    text: np.ndarray                 # bucket-padded tokens
    raw_len: int
    cond_mel: Optional[torch.Tensor]
    seed: Optional[int]              # request seed (candidate i draws from
                                     # fold_seed(seed, i)); None = fresh
    future: "Future"
    need: int                        # K candidates outstanding
    cands: list                      # harvested (codes_row, gen) pairs
    launched: int = 0                # candidates installed so far
    t_submit: float = 0.0            # perf_counter at submit (latency stat)


class ContinuousBatcher:
    """Host half: a scheduler thread that keeps the slot pool full and owns
    the device work of the pool.

    submit() returns a Future resolving to the rendered waveform. Finished
    rows are harvested between segments, grouped, and rendered through the
    batched render wave serving uses (serving.render_rows).

    settings.num_candidates K > 1 decodes K candidate rows a request (they
    share the pool with everything else), reranks the harvested candidates
    with CLVP (rerank_batch, the ttts/api.py:397-412 semantics) and renders
    only each winner."""

    def __init__(self, tts, cond_mel: torch.Tensor, settings=None,
                 n_slots: int = 16, max_gen: Optional[int] = None,
                 segment_len: int = 32, use_diffusion: bool = False,
                 render_min: int = 4,
                 render_buckets: Sequence[int] = (1, 2, 4, 8, 16),
                 pipeline: bool = True,
                 max_pending: Optional[int] = None,
                 request_timeout_s: Optional[float] = None):
        """pipeline: dispatch segment N+1 before reading segment N's done
        mask, so the device does not idle while the host reads. Refills
        then lag one segment; per-request results are unchanged.

        max_pending: candidate-queue depth bound: submit() raises
        serving.ServerBusy when the K candidates would not fit (503 at the
        HTTP layer). request_timeout_s: a request still fully queued (no
        candidate installed) after this long fails with TimeoutError
        instead of taking slots."""
        from xtts_tpu_torch.infer.api import TTSSettings
        self.settings = settings or TTSSettings()
        if self.settings.num_candidates > 1 and tts.clvp is None:
            raise ValueError("settings.num_candidates > 1 needs "
                             "TextToSpeech(with_clvp=True) for the rerank")
        self.tts = tts
        self.cond_mel = cond_mel
        self.use_diffusion = use_diffusion
        self.render_min = render_min
        self.render_buckets = tuple(sorted(render_buckets))
        self.dec = SlotDecoder(
            tts, n_slots=n_slots,
            max_gen=max_gen or self.settings.max_mel_tokens,
            segment_len=segment_len, settings=self.settings)
        self.max_pending = max_pending
        self.request_timeout_s = request_timeout_s
        self._q: "queue.Queue[_Group]" = queue.Queue()
        self._slot_req: List[Optional[_Group]] = [None] * n_slots
        self._finished: List[Tuple[_Group, np.ndarray, int]] = []
        self._stop = threading.Event()
        self._seq = 0
        self.pipeline = pipeline
        self._inflight = None      # dispatched-but-unread packed (done|gen)
        # serving metrics (stats()): completed requests, latency sum/max,
        # segments run, live-row-step counts for slot occupancy
        self._m = {"completed": 0, "failed": 0, "timed_out": 0,
                   "latency_sum": 0.0, "latency_max": 0.0, "segments": 0,
                   "live_row_steps": 0, "row_steps": 0, "tokens": 0}
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def warmup(self, text_lens: Optional[Sequence[int]] = None,
               render_sizes: Optional[Sequence[int]] = None) -> int:
        """Drive dummy requests through submit() before traffic: one install
        per text bucket, the segment graphs, and one render per (render
        bucket x text bucket) burst (the analogue of BatchServer.warmup; the
        pool drains between grid points). Returns the requests driven."""
        text_lens = tuple(text_lens or self.dec.text_buckets)
        render_sizes = tuple(render_sizes or self.render_buckets)
        n = 0
        for t in text_lens:
            for rb in render_sizes:
                if rb > self.dec.n_slots * 2:
                    continue   # a burst this size cannot accumulate anyway
                toks = np.ones((min(t, self.tts.cfg.gpt.max_text_tokens),),
                               np.int64)
                futs = [self.submit(toks) for _ in range(rb)]
                for f in futs:
                    f.result()
                n += rb
        return n

    def submit(self, text_tokens: np.ndarray,
               cond_mel: Optional[torch.Tensor] = None,
               seed: Optional[int] = None) -> "Future[np.ndarray]":
        """seed: optional request seed. With it the request's waveform does
        not depend on concurrent traffic: candidate i of K draws its codes
        from fold_seed(seed, i) on a per-row chain, deterministic renders
        (the DVAE shortcut) follow from the codes, and the diffusion render
        draws from fold_seed(seed, RENDER_FOLD) a row, grouped by the row's
        own code bucket (_render). Without one, fresh seeds are used."""
        if self._stop.is_set():
            raise RuntimeError("ContinuousBatcher is closed")
        toks = np.asarray(text_tokens, np.int64)
        cap = min(self.tts.cfg.gpt.max_text_tokens,
                  self.dec.text_buckets[-1])
        if toks.shape[-1] > cap:
            raise ValueError(
                f"text of {toks.shape[-1]} tokens exceeds this pool's "
                f"limit {cap} (max_text_tokens / largest text bucket): "
                f"pad_text would silently truncate it")
        k = self.settings.num_candidates
        if (self.max_pending is not None
                and self._q.qsize() + k > self.max_pending):
            from xtts_tpu_torch.infer.serving import ServerBusy
            raise ServerBusy(
                f"pending candidate queue full ({self.max_pending})")
        fut: "Future[np.ndarray]" = Future()
        g = _Group(self.dec.pad_text(toks), len(toks), cond_mel, seed, fut,
                   k, [], t_submit=time.perf_counter())
        for _ in range(k):           # K candidate rows, independently slotted
            self._q.put(g)
        return fut

    def pending(self) -> int:
        """Candidate decodes not yet installed into a slot (a request with
        num_candidates=K contributes up to K entries)."""
        return self._q.qsize()

    def stats(self) -> Dict[str, Any]:
        """Serving metrics: completed / failed / timed-out requests, mean
        and max submit->result latency, decoded tokens, segments run, slot
        occupancy (occupied row-steps / all row-steps), pending candidates
        and the process's hanzi the G2P could not voice."""
        m = dict(self._m)
        m.pop("latency_sum")
        m["latency_mean_s"] = round(
            self._m["latency_sum"] / max(m["completed"], 1), 4)
        m["latency_max_s"] = round(m.pop("latency_max"), 4)
        m["slot_occupancy"] = round(
            self._m["live_row_steps"] / max(self._m["row_steps"], 1), 4)
        m.pop("live_row_steps"), m.pop("row_steps")
        m["pending"] = self._q.qsize()
        from xtts_tpu_torch.text.chinese import oov_stats
        m["oov_dropped"] = sum(oov_stats().values())
        return m

    def close(self):
        self._stop.set()
        self._thread.join(timeout=10)
        try:
            while True:
                self._q.get_nowait().future.cancel()
        except queue.Empty:
            pass
        for p in self._slot_req:
            if p is not None and not p.future.done():
                p.future.cancel()

    # ------------------------------------------------------------------

    def _refill(self, free: List[int]) -> Tuple[List[int], List[int]]:
        still_free, installed = [], []
        for slot in free:
            p = None
            while p is None:
                try:
                    p = self._q.get_nowait()
                except queue.Empty:
                    break
                if p.future.done():    # a sibling candidate already failed
                    p = None
                    continue
                if (self.request_timeout_s is not None and p.launched == 0
                        and time.perf_counter() - p.t_submit
                        > self.request_timeout_s):
                    # a fully queued request expired: fail it rather than
                    # spend slots on work its client has abandoned (its
                    # other queued candidates skip via future.done())
                    p.future.set_exception(TimeoutError(
                        f"request waited > {self.request_timeout_s}s "
                        f"queued"))
                    self._m["timed_out"] += 1
                    p = None
            if p is None:
                still_free.append(slot)
                continue
            self._seq += 1
            idx, p.launched = p.launched, p.launched + 1
            self._slot_req[slot] = p
            installed.append(slot)
            self.dec.install(slot, p.text,
                             p.cond_mel if p.cond_mel is not None
                             else self.cond_mel,
                             seed=(None if p.seed is None
                                   else fold_seed(p.seed, idx)))
        return still_free, installed

    def _rerank(self, ready: List[_Group]):
        """CLVP-score each completed group's K candidates (one batched pass
        a text length) and stage the winners for render."""
        from xtts_tpu_torch.infer.api import bucket_len
        tts = self.tts
        dev = tts.device
        by_len: Dict[int, List[_Group]] = {}
        for g in ready:
            by_len.setdefault(len(g.text), []).append(g)
        for groups in by_len.values():
            s = self.dec.max_gen
            # the group count pads to a render_buckets rung (group 0
            # repeated, its extra scores dropped), as the JAX package pads
            # to bound its compiled programs
            gb = bucket_len(len(groups), self.render_buckets)
            padded = groups + [groups[0]] * (gb - len(groups))
            texts = torch.as_tensor(np.stack([g.text for g in padded]),
                                    device=dev)
            codes = np.stack([np.stack([c for c, _ in g.cands])
                              for g in padded])          # (G, K, S)
            gens = np.stack([[n for _, n in g.cands] for g in padded])
            mask = (np.arange(s)[None, None, :] < gens[:, :, None])
            scores = tts.clvp.rerank_batch(
                texts, torch.as_tensor(np.clip(
                    codes, 0, tts.cfg.clvp.num_speech_tokens - 1),
                    device=dev),
                code_mask=torch.as_tensor(mask, device=dev).long())
            best = scores.argmax(dim=1).cpu().numpy()
            for g, b in zip(groups, best[:len(groups)]):
                self._finished.append((g, g.cands[b][0], int(g.cands[b][1])))

    def _render(self):
        """Render the harvested rows through the batched render, grouped by
        (text bucket, cond shape, own code bucket); the row count pads up to
        a render_buckets rung (row 0 repeated, its outputs dropped), as
        synthesize_batch's batch_buckets.

        Determinism: rows group by their own code bucket (not the harvest
        max) and each renders with its own noise generator seeded from the
        request seed (fold_seed(seed, RENDER_FOLD)), so a seeded request's
        diffusion waveform is a function of (text, voice, seed) and the
        render batch's rung (the rung sets the matmul shapes)."""
        from xtts_tpu_torch.infer.api import bucket_len
        from xtts_tpu_torch.infer.serving import render_rows
        tts = self.tts
        dev = tts.device
        batch, self._finished = self._finished, []
        cbuckets = tts._code_buckets()
        groups: Dict[Any, list] = {}
        for p, codes, gen in batch:
            ck = (len(p.text),
                  None if p.cond_mel is None else tuple(p.cond_mel.shape),
                  bucket_len(max(int(gen) - 2, 1), cbuckets))
            groups.setdefault(ck, []).append((p, codes, gen))
        for items in groups.values():
            n_real = len(items)
            nb = bucket_len(n_real, self.render_buckets)
            padded = items + [items[0]] * (nb - n_real)
            texts = torch.as_tensor(np.stack([p.text for p, _, _ in padded]),
                                    device=dev)
            lens = torch.as_tensor([p.raw_len for p, _, _ in padded],
                                   device=dev)
            codes = torch.as_tensor(np.stack([c for _, c, _ in padded]),
                                    device=dev)
            gens = np.asarray([g for _, _, g in padded], np.int64)
            cond = items[0][0].cond_mel
            conds = (torch.cat([p.cond_mel.to(dev) for p, _, _ in padded])
                     if cond is not None else self.cond_mel.to(dev).repeat(
                         (nb,) + (1,) * (self.cond_mel.dim() - 1)))
            self._seq += 1
            gens_rng = [torch.Generator(dev).manual_seed(fold_seed(
                p.seed if p.seed is not None else self._seq * 1024 + i,
                RENDER_FOLD)) for i, (p, _, _) in enumerate(padded)]
            try:
                wavs = render_rows(tts, texts, lens, conds, codes, gens,
                                   self.settings, self.use_diffusion,
                                   gens_rng)
                now = time.perf_counter()
                for (p, _, _), w in zip(items, wavs[:n_real]):
                    if not p.future.cancelled():   # client gave up
                        p.future.set_result(w)
                        lat = now - p.t_submit
                        self._m["completed"] += 1
                        self._m["latency_sum"] += lat
                        self._m["latency_max"] = max(self._m["latency_max"],
                                                     lat)
            except Exception as e:   # the group's requests fail, the pool
                for p, _, _ in items:                            # lives
                    if not p.future.done():
                        p.future.set_exception(e)
                        self._m["failed"] += 1

    def _fail_inflight(self, exc: Exception):
        """A device or scheduler error poisons the whole pool state: fail
        every in-flight future (slots, harvested, queued), reset the pool,
        and keep the scheduler alive for new traffic (BatchServer fails
        only the offending wave; here the shared SlotState is the wave).
        The futures fail last, once the queue is drained and the pool
        reset: a request submitted after a caller saw the error is served,
        not drained with the failed ones."""
        in_slots = [g for g in self._slot_req if g is not None]
        for s in range(len(self._slot_req)):
            self._slot_req[s] = None
        doomed = [g for g, _, _ in self._finished]
        self._finished = []
        try:
            while True:
                doomed.append(self._q.get_nowait())
        except queue.Empty:
            pass
        try:
            self._inflight = None
            self.dec.reset()
        finally:
            for g in in_slots:
                if not g.future.done():
                    g.future.set_exception(exc)
                    self._m["failed"] += 1
            for g in doomed:
                if not g.future.done():
                    g.future.set_exception(exc)

    @torch.no_grad()
    def _loop(self):
        free = list(range(self.dec.n_slots))
        while not self._stop.is_set():
            try:
                free = self._step(free)
            except Exception as e:
                self._fail_inflight(e)
                free = list(range(self.dec.n_slots))

    def _step(self, free: List[int]) -> List[int]:
        free, installed = self._refill(free)
        if len(free) == self.dec.n_slots and self._inflight is None:
            # pool empty: render stragglers, then park on the queue
            if self._finished:
                self._render()
            try:
                p = self._q.get(timeout=0.1)
                self._q.put(p)        # re-queued; _refill takes it
            except queue.Empty:
                pass
            return free
        packed = (self.dec.dispatch_segment()
                  if len(free) < self.dec.n_slots else None)
        stale_ok = ()
        if self.pipeline:
            # read LAST round's mask while this round's segment runs. That
            # mask was dispatched before this round's installs, so a slot
            # refilled this round still carries its old occupant's done
            # flag there: never harvest it from this (stale) mask.
            stale_ok = installed
            packed, self._inflight = self._inflight, packed
            if packed is None:
                return free
        done, gen = self.dec.read_packed(packed)
        self._m["segments"] += 1
        occupied = sum(1 for g in self._slot_req if g is not None)
        self._m["live_row_steps"] += occupied * self.dec.segment_len
        self._m["row_steps"] += self.dec.n_slots * self.dec.segment_len
        harvest = [s for s in range(self.dec.n_slots)
                   if done[s] and self._slot_req[s] is not None
                   and s not in stale_ok]
        if harvest:
            codes = self.dec.fetch_codes()
            ready = []
            for s in harvest:
                g = self._slot_req[s]
                self._slot_req[s] = None
                g.cands.append((codes[s], int(gen[s])))
                self._m["tokens"] += int(gen[s])
                free.append(s)
                if len(g.cands) == g.need:
                    if g.need == 1:
                        self._finished.append(
                            (g, g.cands[0][0], g.cands[0][1]))
                    else:
                        ready.append(g)
            if ready:
                self._rerank(ready)
        # render when a batch has accumulated, or promptly when no queued
        # traffic waits for the freed slots (low load: latency first; high
        # load: batched renders)
        if self._finished and (len(self._finished) >= self.render_min
                               or self._q.empty()):
            self._render()
        return free
