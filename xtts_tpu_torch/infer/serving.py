"""Batched synthesis serving, BASELINE config #5 (port of
xtts_tpu/infer/serving.py).

* `synthesize_batch` — B utterances through ONE AR pass (per-row
  done-masking), one latent extract, one diffusion, one vocode. With
  settings.num_candidates K > 1 the AR pass runs B*K rows and one batched
  CLVP pass picks each utterance's winner on the device before the render
  (ttts/api.py:397-460 semantics, batched).
* `BatchServer` — a microbatching front: submit() returns a Future; a worker
  thread packs requests arriving within `window_ms` (up to `max_batch`) into
  one synthesize_batch call, with backpressure (max_pending) and a queue
  timeout.

Every wave renders through the diffusion, the DVAE shortcut or, with
use_hifigan, the HifiDecoder (per-request speaker mels in
SynthesisRequest.spk_mel16). Randomness: each wave draws from one
torch.Generator on the model's device (the JAX package's batch-level key).
The multi-device (place_on_mesh) branch is not ported.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from xtts_tpu_torch.infer.api import TextToSpeech, TTSSettings, bucket_len
from xtts_tpu_torch.models.hifigan import hifigan_samples


@dataclass
class SynthesisRequest:
    text_tokens: np.ndarray          # (T,) int, framed [start..stop]
    # kept for the JAX package's `key` field, and never read, as there
    # (xtts_tpu/infer/serving.py:43): a wave draws from the generator given
    # to synthesize_batch. Per-request seeds are the slot pool's
    # (infer/slots.py ContinuousBatcher.submit(seed=...)).
    generator: Optional[torch.Generator] = None
    # per-request voice: (1, mel, T) conditioning mel; all requests of a
    # batch share T (TextToSpeech.cond_mel_bucketed). None -> the
    # batch-level cond_mel.
    cond_mel: Optional[torch.Tensor] = None
    # per-request speaker mel for the HiFi-GAN render: (1, T16, 64) from
    # TextToSpeech.speaker_mel_from_wav, one shape across a batch. None ->
    # the batch-level spk_mel16.
    spk_mel16: Optional[torch.Tensor] = None


def _pad_texts(texts: Sequence[np.ndarray], stop_token: int,
               buckets) -> np.ndarray:
    max_len = max(len(t) for t in texts)
    tb = bucket_len(max_len, buckets)
    out = np.full((len(texts), tb), stop_token, np.int64)
    for i, t in enumerate(texts):
        out[i, :min(len(t), tb)] = t[:tb]
    return out


@torch.no_grad()
def synthesize_batch(tts: TextToSpeech, requests: Sequence[SynthesisRequest],
                     cond_mel: torch.Tensor,
                     settings: TTSSettings = TTSSettings(),
                     use_diffusion: bool = False,
                     generator: Optional[torch.Generator] = None,
                     use_hifigan: bool = False,
                     spk_mel16: Optional[torch.Tensor] = None,
                     batch_buckets: Optional[Sequence[int]] = None
                     ) -> List[np.ndarray]:
    """Synthesize B utterances in one pass; returns per-request waveforms
    trimmed to their true lengths. Runs on the model's device.

    use_hifigan: render the rows' GPT latents through the HifiDecoder (one
    batched call; with_hifigan=True and spk_mel16 from
    tts.speaker_mel_from_wav, or per-request SynthesisRequest.spk_mel16).
    Overrides use_diffusion.

    batch_buckets: pad the row count up to a bucket (e.g. (1, 2, 4, 8))
    with dummy rows reusing request 0 (outputs dropped), as the JAX package
    does to bound its compiled programs; counts above the largest bucket
    run unbucketed."""
    cfg = tts.cfg
    dev = tts.device
    g = generator if generator is not None else tts._generator(0)
    n_real = len(requests)
    if n_real == 0:
        return []
    if batch_buckets:
        bb = bucket_len(n_real, tuple(batch_buckets))
        if bb > n_real:
            requests = list(requests) + [requests[0]] * (bb - n_real)
    text_buckets = (16, 32, 64, 128, 256, cfg.gpt.max_text_tokens)
    texts = torch.as_tensor(_pad_texts([r.text_tokens for r in requests],
                                       cfg.gpt.stop_text_token, text_buckets),
                            device=dev)
    b = texts.shape[0]
    if any(r.cond_mel is not None for r in requests):
        # multi-tenant batch: each row speaks with its request's voice
        per = [r.cond_mel if r.cond_mel is not None else cond_mel
               for r in requests]
        shapes = {tuple(c.shape) for c in per}
        if len(shapes) != 1 or per[0].dim() != 3:
            raise ValueError(
                "per-request cond_mels must all be (1, mel, T) with one "
                f"shared T (use cond_mel_bucketed); got {sorted(shapes)}")
        cond = torch.cat([c.to(dev) for c in per], dim=0)
    else:
        cond = cond_mel.to(dev)
        if cond.shape[0] == 1:      # (1, mel, T) or stacked clips
            cond = cond.repeat((b,) + (1,) * (cond.dim() - 1))

    k = settings.num_candidates
    if k > 1:
        if tts.clvp is None:
            raise ValueError("settings.num_candidates > 1 needs "
                             "TextToSpeech(with_clvp=True)")
        res = tts._generate(cond.repeat_interleave(k, 0),
                            texts.repeat_interleave(k, 0), g, settings)
        s_gen = res.codes.shape[1]
        code_mask = (torch.arange(s_gen, device=dev)[None, :]
                     < res.lengths[:, None]).long()
        scores = tts.clvp.rerank_batch(
            texts, torch.clamp(res.codes, 0, cfg.clvp.num_speech_tokens - 1)
            .reshape(b, k, s_gen), code_mask=code_mask.reshape(b, k, s_gen))
        # the winners are chosen on the device; only the lengths reach the
        # host before the render
        best = torch.argmax(scores, dim=1)
        rows = torch.arange(b, device=dev)
        codes = res.codes.reshape(b, k, s_gen)[rows, best]
        lengths = res.lengths.reshape(b, k)[rows, best]
    else:
        res = tts._generate(cond, texts, g, settings)
        codes, lengths = res.codes, res.lengths
    if use_hifigan and any(r.spk_mel16 is not None for r in requests):
        per = [r.spk_mel16 if r.spk_mel16 is not None else spk_mel16
               for r in requests]
        if (any(s is None for s in per)
                or len({tuple(s.shape) for s in per}) != 1):
            raise ValueError(
                "per-request spk_mel16s must share one shape (use "
                "speaker_mel_from_wav, bucketed), or a batch-level "
                "spk_mel16 must fill the requests without one")
        spk_mel16 = torch.cat([s.to(dev) for s in per], dim=0)
    text_lens = torch.as_tensor([len(r.text_tokens) for r in requests],
                                device=dev)
    wavs = render_rows(tts, texts, text_lens, cond, codes,
                       lengths.cpu().numpy(), settings, use_diffusion, g,
                       use_hifigan=use_hifigan, spk_mel16=spk_mel16)
    return wavs[:n_real]


@torch.no_grad()
def render_rows(tts: TextToSpeech, texts, text_lens, cond, codes,
                lengths: np.ndarray, settings: TTSSettings,
                use_diffusion: bool, generator,
                use_hifigan: bool = False,
                spk_mel16: Optional[torch.Tensor] = None
                ) -> List[np.ndarray]:
    """Render B generated rows to per-row trimmed waveforms in one batched
    render.

    texts (B, Tt) framed tokens; text_lens (B,) true lengths; cond
    (B, mel, T) conditioning mels; codes (B, S) generated codes; lengths
    (B,) generated lengths including the stop token. Strips the trailing 2
    codes (test.py:150) and pads to a code bucket. use_hifigan renders
    through the HifiDecoder with spk_mel16 ((1 or B, T16, 64)). generator:
    one torch.Generator for the diffusion noise, or one a row (the slot
    pool's per-request render seeds, as JAX's per-row keys,
    xtts_tpu/infer/serving.py:232-236)."""
    cfg = tts.cfg
    ns = np.maximum(lengths - 2, 1)
    n_b = bucket_len(int(ns.max()), tts._code_buckets())
    lens = torch.as_tensor(np.minimum(ns, n_b), device=tts.device)
    padded = tts._pad_codes(codes, lens, n_b)
    if use_hifigan:
        wav = tts._render_hifigan(
            cond, texts, padded, torch.as_tensor(ns, device=tts.device),
            spk_mel16, text_lens=text_lens).cpu().numpy()
        return [wav[i, :hifigan_samples(cfg.hifigan, int(ns[i]))]
                for i in range(wav.shape[0])]
    if use_diffusion:
        wav = tts._render(cond, texts, padded,
                          torch.as_tensor(ns, device=tts.device), generator,
                          settings, text_lens=text_lens)
    else:
        wav, _ = tts._render_shortcut(padded)
    wav = wav.cpu().numpy()
    per_code = cfg.vqvae.compression * cfg.vocos.hop_length
    return [wav[i, :int(ns[i]) * per_code] for i in range(wav.shape[0])]


class ServerBusy(RuntimeError):
    """submit() rejected: the pending queue is full (backpressure; HTTP
    fronts map this to 503)."""


class BatchServer:
    """Microbatching synthesis front-end.

    submit() is thread-safe and returns a concurrent.futures.Future that
    resolves to the waveform. Requests arriving within `window_ms` of each
    other are packed into one synthesize_batch call (up to `max_batch`), on
    the model's device."""

    def __init__(self, tts: TextToSpeech, cond_mel: torch.Tensor,
                 settings: TTSSettings = TTSSettings(),
                 max_batch: int = 8, window_ms: float = 20.0,
                 use_diffusion: bool = False,
                 batch_buckets: Optional[Sequence[int]] = None,
                 max_pending: Optional[int] = None,
                 request_timeout_s: Optional[float] = None,
                 use_hifigan: bool = False,
                 spk_mel16: Optional[torch.Tensor] = None):
        """use_hifigan / spk_mel16: render every wave through the
        HifiDecoder with this speaker mel (see synthesize_batch).
        batch_buckets: row-count buckets (see synthesize_batch).
        max_pending: submit() raises ServerBusy once this many requests wait
        unpacked (None = unbounded). request_timeout_s: a request that waits
        in the queue longer fails with TimeoutError instead of occupying a
        wave."""
        self.tts = tts
        self.cond_mel = cond_mel
        self.settings = settings
        self.max_batch = max_batch
        self.window = window_ms / 1000.0
        self.use_diffusion = use_diffusion
        self.use_hifigan = use_hifigan
        self.spk_mel16 = spk_mel16
        self.batch_buckets = (tuple(b for b in batch_buckets
                                    if b <= max_batch)
                              if batch_buckets else None)
        self.max_pending = max_pending
        self.request_timeout_s = request_timeout_s
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._seq = 0
        self._m = {"completed": 0, "failed": 0, "waves": 0, "timed_out": 0,
                   "rows_sum": 0, "latency_sum": 0.0, "latency_max": 0.0}
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, text_tokens: np.ndarray,
               cond_mel: Optional[torch.Tensor] = None,
               spk_mel16: Optional[torch.Tensor] = None
               ) -> "Future[np.ndarray]":
        """cond_mel: optional per-request voice ((1, mel, T), one T across a
        batch); None uses the server's voice. spk_mel16: the request's
        speaker mel for the HiFi-GAN render. Requests with different cond
        or speaker-mel shapes run as separate waves, so a mismatched tenant
        never fails its neighbours."""
        if self._stop.is_set():
            raise RuntimeError("BatchServer is closed")
        toks = np.asarray(text_tokens, np.int64)
        cap = self.tts.cfg.gpt.max_text_tokens
        if toks.shape[-1] > cap:
            # reject in the caller's thread: past the queue it would fail
            # every co-batched request
            raise ValueError(
                f"text of {toks.shape[-1]} tokens exceeds "
                f"max_text_tokens={cap}; split the text "
                f"(TextToSpeech.tts() sentence-splits and truncates)")
        if (self.max_pending is not None
                and self._q.qsize() >= self.max_pending):
            raise ServerBusy(
                f"pending queue full ({self.max_pending} requests)")
        fut: "Future[np.ndarray]" = Future()
        self._q.put((toks, cond_mel, spk_mel16, fut, time.perf_counter()))
        return fut

    def pending(self) -> int:
        """Requests submitted but not yet packed into a wave."""
        return self._q.qsize()

    def stats(self) -> dict:
        """Serving metrics: completed/failed counts, mean/max submit->result
        latency, waves run, mean rows per wave, pending requests, and the
        process's hanzi the G2P could not voice."""
        m = dict(self._m)
        m.pop("latency_sum")
        m["latency_mean_s"] = round(
            self._m["latency_sum"] / max(m["completed"], 1), 4)
        m["latency_max_s"] = round(m.pop("latency_max"), 4)
        m["rows_per_wave"] = round(m.pop("rows_sum") / max(m["waves"], 1), 2)
        m["pending"] = self._q.qsize()
        from xtts_tpu_torch.text.chinese import oov_stats
        m["oov_dropped"] = sum(oov_stats().values())
        return m

    def warmup(self, text_lens: Optional[Sequence[int]] = None,
               batch_sizes: Optional[Sequence[int]] = None) -> int:
        """Drive synthesize_batch synchronously over a (batch, text length)
        grid, so that the first real requests find the kernels built and
        the allocator warm. Defaults: this server's batch buckets (or
        max_batch) x all text buckets. Returns the number of waves run."""
        cfg = self.tts.cfg
        if text_lens is None:
            text_lens = (16, 32, 64, 128, 256, cfg.gpt.max_text_tokens)
        bs = tuple(batch_sizes or self.batch_buckets or (self.max_batch,))
        n = 0
        for b in bs:
            for t in text_lens:
                toks = np.ones((min(t, cfg.gpt.max_text_tokens),), np.int64)
                synthesize_batch(self.tts, [SynthesisRequest(toks)] * b,
                                 self.cond_mel, self.settings,
                                 use_diffusion=self.use_diffusion,
                                 generator=self.tts._generator(0),
                                 use_hifigan=self.use_hifigan,
                                 spk_mel16=self.spk_mel16)
                n += 1
        return n

    def close(self):
        """Stop the worker; requests still queued get their futures
        cancelled."""
        self._stop.set()
        self._thread.join(timeout=5)
        try:
            while True:
                self._q.get_nowait()[3].cancel()
        except queue.Empty:
            pass

    # ------------------------------------------------------------------

    def _collect(self):
        try:
            first = self._q.get(timeout=0.1)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.perf_counter() + self.window
        while len(batch) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                batch.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _loop(self):
        while not self._stop.is_set():
            batch = self._collect()
            if self.request_timeout_s is not None:
                now = time.perf_counter()
                live = []
                for item in batch:
                    if now - item[4] > self.request_timeout_s:
                        if not item[3].done():
                            item[3].set_exception(TimeoutError(
                                f"request waited {now - item[4]:.1f}s in "
                                f"queue (> {self.request_timeout_s}s)"))
                        self._m["timed_out"] += 1
                    else:
                        live.append(item)
                batch = live
            # per-request conds and speaker mels share shapes within a wave
            groups: dict = {}
            for item in batch:
                key = tuple(None if t is None else tuple(t.shape)
                            for t in item[1:3])
                groups.setdefault(key, []).append(item)
            for items in groups.values():
                self._run_wave(items)

    def _run_wave(self, items) -> None:
        reqs = [SynthesisRequest(t, cond_mel=c, spk_mel16=s)
                for t, c, s, _, _ in items]
        self._seq += 1
        self._m["waves"] += 1
        self._m["rows_sum"] += len(items)
        try:
            wavs = synthesize_batch(
                self.tts, reqs, self.cond_mel, self.settings,
                use_diffusion=self.use_diffusion,
                batch_buckets=self.batch_buckets,
                generator=self.tts._generator(self._seq),
                use_hifigan=self.use_hifigan, spk_mel16=self.spk_mel16)
        except Exception as e:  # the wave's requests fail, the server lives
            for _, _, _, f, _ in items:
                if not f.done():
                    f.set_exception(e)
                    self._m["failed"] += 1
            return
        now = time.perf_counter()
        for (_, _, _, f, t0), w in zip(items, wavs):
            if not f.cancelled():
                f.set_result(w)
                lat = now - t0
                self._m["completed"] += 1
                self._m["latency_sum"] += lat
                self._m["latency_max"] = max(self._m["latency_max"], lat)
