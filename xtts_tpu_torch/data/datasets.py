"""Datasets and fixed-shape bucketed collation (the port's own copy of
xtts_tpu/data/datasets.py, numpy on the host).

Per-model datasets read a 6-field filelist `key|wav|spk|lang|raw_text|
cleaned_text` (ttts/gpt/dataset.py:33-38) or clean/noise path lists. Every
collater pads to a fixed bucket shape (the next bucket >= the batch's
longest), so a trainer sees a bounded set of shapes. A bad sample gives
None and the collater drops it (ttts/gpt/dataset.py:69-74). Every numpy
draw happens in the JAX package's order, so the same seed gives the same
batches bit for bit. Mels from a MelFrontend (a torch tensor on the card
or the CPU) come back to the host as numpy.
"""
from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from xtts_tpu_torch.data.audio import get_prompt_slice, load_wav, resample

log = logging.getLogger(__name__)


def host_array(x) -> np.ndarray:
    """A mel from a MelFrontend (a tensor on any device) or numpy -> numpy."""
    return x.float().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


# ---------------------------------------------------------------------------
# filelists
# ---------------------------------------------------------------------------


@dataclass
class FilelistEntry:
    key: str
    wav_path: str
    speaker: str
    lang: str
    raw_text: str
    cleaned_text: str


def read_filelist(path: str) -> List[FilelistEntry]:
    """6-field `|`-separated filelist (ttts/prepare/preprocess_text.py:34-41)."""
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            parts = line.split("|")
            if len(parts) != 6:
                log.warning("skip malformed filelist line: %r", line[:80])
                continue
            out.append(FilelistEntry(*parts))
    return out


def write_filelist(path: str, entries: Sequence[FilelistEntry]):
    with open(path, "w", encoding="utf-8") as f:
        for e in entries:
            f.write("|".join([e.key, e.wav_path, e.speaker, e.lang,
                              e.raw_text, e.cleaned_text]) + "\n")


def read_jsonl(path: str) -> List[dict]:
    with open(path, encoding="utf-8") as f:
        return [json.loads(l) for l in f if l.strip()]


# ---------------------------------------------------------------------------
# bucketing
# ---------------------------------------------------------------------------

def next_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def pad_to(x: np.ndarray, length: int, axis: int = -1,
           value: float = 0.0) -> np.ndarray:
    """Pad (or truncate) `axis` to exactly `length`."""
    axis = axis % x.ndim
    cur = x.shape[axis]
    if cur == length:
        return x
    if cur > length:
        sl = [slice(None)] * x.ndim
        sl[axis] = slice(0, length)
        return x[tuple(sl)]
    pads = [(0, 0)] * x.ndim
    pads[axis] = (0, length - cur)
    return np.pad(x, pads, constant_values=value)


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------


class MelCache:
    """A wav path -> its mel (bins, T) as numpy: the `.mel.npy` beside the
    wav when present (or the path itself when it is one), else the wav run
    through `mel_fn` (a MelFrontend, on the card or the CPU); None when
    neither gives a mel (no cache and no mel_fn, or an unreadable wav)."""

    def __init__(self, mel_fn: Optional[Callable] = None,
                 sample_rate: int = 24000):
        self._mel_fn = mel_fn
        self.sample_rate = sample_rate

    def __call__(self, wav_path: str) -> Optional[np.ndarray]:
        if wav_path.endswith(".mel.npy"):   # direct cached-mel path lists
            return np.load(wav_path) if os.path.exists(wav_path) else None
        cache = wav_path + ".mel.npy"
        if os.path.exists(cache):
            return np.load(cache)
        if self._mel_fn is None:
            return None
        try:
            wav, _ = load_wav(wav_path, self.sample_rate)
        except Exception as e:
            log.warning("bad wav %s: %s", wav_path, e)
            return None
        mel = host_array(self._mel_fn(wav))
        return mel[0] if mel.ndim == 3 else mel


class VQVAEMelDataset:
    """Random fixed-length mel crops (ttts/vqvae/dataset.py:15-67:
    pad_to_samples=200 random crop)."""

    def __init__(self, entries: Sequence[FilelistEntry], mel_cache: MelCache,
                 crop_frames: int = 200, seed: int = 0):
        self.entries = list(entries)
        self.mel = mel_cache
        self.crop = crop_frames
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i: int) -> Optional[Dict[str, np.ndarray]]:
        mel = self.mel(self.entries[i].wav_path)
        if mel is None:
            return None
        t = mel.shape[-1]
        if t < self.crop:
            mel = pad_to(mel, self.crop)
        else:
            s = int(self.rng.integers(0, t - self.crop + 1))
            mel = mel[:, s:s + self.crop]
        return {"mel": mel.astype(np.float32)}


class GptTTSDataset:
    """Text tokens + target mel + conditioning slice
    (ttts/gpt/dataset.py:17-130): BPE of '[lang] cleaned_text', reject
    text>300 tokens / mel>2000 frames, random 1/3-2/3 split for cond mel."""

    def __init__(self, entries: Sequence[FilelistEntry], mel_cache: MelCache,
                 tokenizer, max_text: int = 300, max_mel: int = 2000,
                 mel_hop: int = 256, seed: int = 0):
        self.entries = list(entries)
        self.mel = mel_cache
        self.tok = tokenizer
        self.max_text = max_text
        self.max_mel = max_mel
        self.mel_hop = mel_hop
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i: int) -> Optional[Dict[str, np.ndarray]]:
        e = self.entries[i]
        ids = self.tok.encode(f"[{e.lang.upper()}] {e.cleaned_text}")
        if len(ids) > self.max_text:
            return None
        mel = self.mel(e.wav_path)
        if mel is None or mel.shape[-1] > self.max_mel:
            return None
        t = mel.shape[-1]
        # cond = random 1/3..2/3 prefix/suffix slice (gpt/dataset.py:96-104)
        lo, hi = t // 3, (2 * t) // 3
        cut = int(self.rng.integers(lo, max(hi, lo + 1)))
        cond = mel[:, :cut] if self.rng.random() < 0.5 else mel[:, cut:]
        return {
            "text": np.asarray(ids, np.int32),
            "mel": mel.astype(np.float32),
            "cond_mel": cond.astype(np.float32),
            "wav_length": np.int32(t * self.mel_hop),
        }


class DiffusionDataset:
    """Target mel (<=400 frames) + reference slice (<=300 frames) + text
    (ttts/diffusion/dataset.py:18-120)."""

    def __init__(self, entries: Sequence[FilelistEntry], mel_cache: MelCache,
                 tokenizer, max_mel: int = 400, max_refer: int = 300,
                 mel_hop: int = 256, seed: int = 0):
        self.entries = list(entries)
        self.mel = mel_cache
        self.tok = tokenizer
        self.max_mel = max_mel
        self.max_refer = max_refer
        self.mel_hop = mel_hop
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i: int) -> Optional[Dict[str, np.ndarray]]:
        e = self.entries[i]
        mel = self.mel(e.wav_path)
        if mel is None:
            return None
        mel = mel[:, :self.max_mel]
        t = mel.shape[-1]
        r_len = int(self.rng.integers(min(100, t), min(self.max_refer, t) + 1))
        r_start = int(self.rng.integers(0, t - r_len + 1))
        refer = mel[:, r_start:r_start + r_len]
        ids = self.tok.encode(f"[{e.lang.upper()}] {e.cleaned_text}")
        return {
            "text": np.asarray(ids, np.int32),
            "mel": mel.astype(np.float32),
            "refer_mel": refer.astype(np.float32),
            "wav_length": np.int32(t * self.mel_hop),
        }


class ClassifierDataset:
    """Clean/noise mel lists -> (mel crop, label)
    (ttts/classifier/dataset.py:13-70)."""

    def __init__(self, clean_paths: Sequence[str], noise_paths: Sequence[str],
                 mel_cache: MelCache, crop_frames: int = 200, seed: int = 0):
        self.items = [(p, 0) for p in clean_paths] + [(p, 1) for p in noise_paths]
        self.mel = mel_cache
        self.crop = crop_frames
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i: int) -> Optional[Dict[str, np.ndarray]]:
        path, label = self.items[i]
        mel = self.mel(path)
        if mel is None:
            return None
        mel = pad_to(mel, self.crop) if mel.shape[-1] < self.crop else \
            mel[:, :self.crop]
        return {"mel": mel.astype(np.float32), "label": np.int32(label)}


class HifiGANDataset:
    """Waveform crops + target mel + 16 kHz speaker-reference mel
    (ttts/hifigan/dataset.py:16-148: returns wav, wav_refer, text).

    Crops are fixed-length and code-aligned (multiples of 1024 samples =
    one VQ code) so the GAN batch is one static shape.
    """

    def __init__(self, entries: Sequence[FilelistEntry], tokenizer,
                 mel_fn: Callable[[np.ndarray], np.ndarray],
                 mel16_fn: Callable[[np.ndarray], np.ndarray],
                 crop_samples: int = 24 * 1024, sample_rate: int = 24000,
                 refer_sec: float = 2.0, seed: int = 0):
        assert crop_samples % 1024 == 0
        self.entries = list(entries)
        self.tok = tokenizer
        self.mel_fn = mel_fn
        self.mel16_fn = mel16_fn
        self.crop = crop_samples
        self.sr = sample_rate
        self.refer_sec = refer_sec
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i: int) -> Optional[Dict[str, np.ndarray]]:
        e = self.entries[i]
        try:
            wav, _ = load_wav(e.wav_path, self.sr)
        except Exception:
            return None
        if len(wav) < self.crop:
            wav = np.pad(wav, (0, self.crop - len(wav)))
            crop = wav
        else:
            s = int(self.rng.integers(0, (len(wav) - self.crop) // 1024 + 1))
            crop = wav[s * 1024:s * 1024 + self.crop]
        mel = host_array(self.mel_fn(crop))
        mel = mel[0] if mel.ndim == 3 else mel
        ref = get_prompt_slice(wav, self.sr, max_sec=self.refer_sec + 1,
                               min_sec=min(self.refer_sec,
                                           len(wav) / self.sr), rng=self.rng)
        ref16 = resample(ref, self.sr, 16000)
        mel16 = host_array(self.mel16_fn(ref16))
        mel16 = mel16[0] if mel16.ndim == 3 else mel16
        ids = self.tok.encode(f"[{e.lang.upper()}] {e.cleaned_text}")
        return {"wav": crop.astype(np.float32),
                "mel": np.asarray(mel, np.float32),
                "refer_mel16": np.asarray(mel16, np.float32).T,  # (T, 64)
                "text": np.asarray(ids, np.int32),
                "wav_length": np.int32(self.crop)}


class CLVPDataset:
    """Text BPE ids + cached mel-VQ codes (ttts/clvp/dataset.py:29-102,
    reads `.melvq.pth`; here `.melvq.npy`)."""

    def __init__(self, entries: Sequence[FilelistEntry], tokenizer,
                 max_text: int = 350, max_codes: int = 430):
        self.entries = list(entries)
        self.tok = tokenizer
        self.max_text = max_text
        self.max_codes = max_codes

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i: int) -> Optional[Dict[str, np.ndarray]]:
        e = self.entries[i]
        vq_path = e.wav_path + ".melvq.npy"
        if not os.path.exists(vq_path):
            return None
        codes = np.load(vq_path).reshape(-1)[:self.max_codes]
        ids = self.tok.encode(f"[{e.lang.upper()}] {e.cleaned_text}")[:self.max_text]
        return {"text": np.asarray(ids, np.int32),
                "codes": codes.astype(np.int32)}


# ---------------------------------------------------------------------------
# bucketed collation + batching
# ---------------------------------------------------------------------------

TEXT_BUCKETS = (32, 64, 128, 256, 304)
MEL_BUCKETS = (100, 200, 400, 800, 1200, 2000)


def collate_bucketed(samples: List[Optional[Dict[str, np.ndarray]]],
                     pad_axes: Dict[str, int],
                     buckets: Dict[str, Sequence[int]],
                     pad_values: Optional[Dict[str, float]] = None,
                     ) -> Optional[Dict[str, np.ndarray]]:
    """Drop Nones; stack each field, padding `pad_axes[field]` up to the next
    bucket size. Emits `<field>_length` arrays for padded fields."""
    samples = [s for s in samples if s is not None]
    if not samples:
        return None
    pad_values = pad_values or {}
    out: Dict[str, np.ndarray] = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        if k in pad_axes:
            axis = pad_axes[k]
            lens = np.asarray([v.shape[axis] for v in vals], np.int32)
            target = next_bucket(int(lens.max()), buckets[k])
            vals = [pad_to(v, target, axis, pad_values.get(k, 0.0))
                    for v in vals]
            out[k + "_length"] = lens
        out[k] = np.stack(vals)
    return out


def prefetch_iterator(it: Iterator, depth: int = 2) -> Iterator:
    """Background-thread prefetch over any batch iterator: the host
    assembles the next `depth` batches (wav IO + STFT/mel, numpy/BLAS —
    GIL-releasing) while the device executes the current step. The TPU
    counterpart of the reference's DataLoader worker processes
    (ttts/gpt/train_ms.py:104-110 num_workers); depth<=0 is a no-op."""
    if depth <= 0:
        yield from it
        return
    import queue
    import threading
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    sentinel = object()
    err: List[BaseException] = []

    def fill():
        try:
            for item in it:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # re-raised on the consumer side
            err.append(e)
        finally:
            # the sentinel MUST reach the consumer on normal completion (a
            # dropped sentinel deadlocks its q.get()); stop-aware loop so
            # an abandoned consumer still lets the thread exit
            while not stop.is_set():
                try:
                    q.put(sentinel, timeout=0.1)
                    break
                except queue.Full:
                    continue

    threading.Thread(target=fill, daemon=True,
                     name="prefetch-fill").start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        # consumer abandoned the generator (training loops exit via
        # `break`): unblock the fill thread so it and its queued batches
        # are released instead of leaking for the process lifetime
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass


def batch_iterator(dataset, batch_size: int, collate_fn: Callable,
                   shuffle: bool = True, seed: int = 0, drop_last: bool = True,
                   epochs: Optional[int] = None,
                   prefetch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Epoch-shuffled host loader; prefetch>0 wraps it in a background-
    thread prefetcher (the reference uses torch DataLoader worker
    processes; XLA dispatch overlap plus thread prefetch covers the same
    latency-hiding on TPU)."""
    if prefetch > 0:
        yield from prefetch_iterator(
            batch_iterator(dataset, batch_size, collate_fn, shuffle=shuffle,
                           seed=seed, drop_last=drop_last, epochs=epochs),
            depth=prefetch)
        return
    rng = np.random.default_rng(seed)
    epoch = 0
    while epochs is None or epoch < epochs:
        order = np.arange(len(dataset))
        if shuffle:
            rng.shuffle(order)
        yielded = 0
        for i in range(0, len(order) - (batch_size - 1 if drop_last else 0),
                       batch_size):
            batch = collate_fn([dataset[int(j)]
                                for j in order[i:i + batch_size]])
            if batch is not None:
                yielded += 1
                yield batch
        if yielded == 0 and epochs is None:
            # every sample was rejected (length caps, bad files) — the
            # endless epochs=None loop would otherwise spin silently
            # forever; bounded-epoch callers (eval sweeps) may legitimately
            # get an empty pass instead
            raise RuntimeError(
                "batch_iterator: a full epoch produced no usable batches — "
                "all samples were rejected (check dataset length caps vs "
                "the model config, and the input files)")
        epoch += 1
