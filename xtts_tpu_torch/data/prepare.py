"""Data preparation pipeline (the port's own copy of
xtts_tpu/data/prepare.py).

Reference stages (ttts/prepare/, SURVEY.md §2.11):
  crawl -> VAD segment -> ASR -> jsonl -> noise filter -> text clean ->
  filelist -> mel cache -> VQ cache -> BPE corpus

Host-side orchestration with the card doing the tensor work: `cache_mels`
runs a MelFrontend, `cache_vq_codes` a DVAE's get_codebook_indices (K3 on
the card), one file at a time as the reference does
(ttts/prepare/mel_extract.py:8-25 / extract_vq.py:9-25). There is no
offline ASR model; `transcribe` defines the interface and raises with
guidance unless a callable is injected.
"""
from __future__ import annotations

import json
import logging
import os
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from xtts_tpu_torch.data.audio import (energy_vad_segments, load_wav,
                                       save_wav, silence_split_segments)
from xtts_tpu_torch.data.datasets import (FilelistEntry, host_array,
                                          write_filelist)

log = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# stage: VAD segmentation (ttts/prepare/vad_process.py)
# ---------------------------------------------------------------------------

def vad_split_file(wav_path: str, out_dir: str, sample_rate: int = 24000,
                   method: str = "silence", **vad_kw) -> List[str]:
    """Split one long recording into keep-range clips; returns clip paths.

    method="silence" (default) reproduces the reference's pydub
    split_on_silence(600 ms, -40 dBFS, seek 100 ms, keep 50 ms) + 4-20 s
    keep-window (ttts/prepare/vad_process.py:6-29); method="energy" is the
    cheaper framewise energy splitter."""
    os.makedirs(out_dir, exist_ok=True)
    wav, sr = load_wav(wav_path, sample_rate)
    stem = os.path.splitext(os.path.basename(wav_path))[0]
    splitter = (silence_split_segments if method == "silence"
                else energy_vad_segments)
    out = []
    for n, (s, e) in enumerate(splitter(wav, sr, **vad_kw)):
        path = os.path.join(out_dir, f"{stem}_{n:04d}.wav")
        save_wav(path, wav[s:e], sr)
        out.append(path)
    return out


# ---------------------------------------------------------------------------
# stage: ASR (ttts/prepare/asr_process.py — modelscope FunASR in the
# reference; interface-only here)
# ---------------------------------------------------------------------------

TranscribeFn = Callable[[str], str]


def transcribe(wav_path: str, asr_fn: Optional[TranscribeFn] = None) -> str:
    if asr_fn is None:
        raise RuntimeError(
            "No ASR backend in this environment. Inject one, e.g.\n"
            "  transcribe(path, asr_fn=my_funasr_wrapper)\n"
            "(reference uses modelscope paraformer-large-vad-punc,"
            " ttts/prepare/asr_process.py:14-30)")
    return asr_fn(wav_path)


def vad_asr_to_jsonl(wav_paths: Sequence[str], out_jsonl: str,
                     asr_fn: TranscribeFn, accept=None):
    """Clips -> `{path, text}` jsonl (ttts/prepare/vad_asr_save_to_jsonl.py).

    accept: transcript keep-rule; defaults to the reference's
    asr_process.py:31-38 filter (>= 5 chars, no Latin letters) via
    data/asr.py. Pass `lambda t: True` to keep everything."""
    if accept is None:
        from xtts_tpu_torch.data.asr import accept_transcript
        accept = accept_transcript
    with open(out_jsonl, "w", encoding="utf-8") as f:
        for p in wav_paths:
            try:
                text = transcribe(p, asr_fn)
            except RuntimeError:
                raise
            except Exception as e:
                log.warning("ASR failed for %s: %s", p, e)
                continue
            if not accept(text):
                log.info("transcript rejected for %s: %r", p, text)
                continue
            f.write(json.dumps({"path": p, "text": text},
                               ensure_ascii=False) + "\n")


# ---------------------------------------------------------------------------
# stage: noise filter (ttts/prepare/filter_noise.py + classifier)
# ---------------------------------------------------------------------------

def filter_noise(mel_paths: Sequence[str], score_fn: Callable[[np.ndarray], float],
                 threshold: float = 0.5) -> Tuple[List[str], List[str]]:
    """Split paths into (clean, noisy) by classifier noise probability."""
    clean, noisy = [], []
    for p in mel_paths:
        mel = np.load(p)
        (noisy if score_fn(mel) > threshold else clean).append(p)
    return clean, noisy


def high_freq_energy_ratio(wav: np.ndarray, sr: int, n_fft: int = 1024,
                           cutoff_hz: float = 6000.0) -> float:
    """Mean high-band/full-band magnitude ratio — low values indicate
    band-limited (e.g. 8 kHz-upsampled) audio
    (ttts/script/filter_nohifreq_data.py:8-21)."""
    n = len(wav) // n_fft
    if n == 0:
        return 0.0
    frames = wav[:n * n_fft].reshape(n, n_fft)
    mag = np.abs(np.fft.rfft(frames * np.hanning(n_fft), axis=-1))
    cut_bin = int(cutoff_hz / (sr / 2) * (n_fft // 2))
    hi = mag[:, cut_bin:].mean()
    total = mag.mean() + 1e-9
    return float(hi / total)


# ---------------------------------------------------------------------------
# stage: text cleaning -> filelist (ttts/prepare/preprocess_text.py)
# ---------------------------------------------------------------------------

def preprocess_text(jsonl_records: Iterable[dict], out_filelist: str,
                    lang: str = "ZH", speaker: str = "spk0"):
    """jsonl {path, text} -> 6-field filelist with frontend-cleaned text."""
    from xtts_tpu_torch.text.cleaner import clean_text
    entries = []
    for rec in jsonl_records:
        try:
            norm, words = clean_text(rec["text"], lang)
        except Exception as e:
            log.warning("text clean failed for %r: %s", rec.get("text"), e)
            continue
        if not words:
            continue
        key = os.path.splitext(os.path.basename(rec["path"]))[0]
        entries.append(FilelistEntry(
            key=key, wav_path=rec["path"], speaker=rec.get("speaker", speaker),
            lang=lang, raw_text=rec["text"], cleaned_text=" ".join(words)))
    write_filelist(out_filelist, entries)
    return entries


# ---------------------------------------------------------------------------
# stage: mel + VQ caches (ttts/prepare/save_mel_to_disk.py,
# save_mel_vq_to_disk.py)
# ---------------------------------------------------------------------------

def cache_mels(wav_paths: Sequence[str], mel_fn, sample_rate: int = 24000,
               overwrite: bool = False) -> int:
    """Write `{wav}.mel.npy` per file. mel_fn: (1, T) wav -> (1, bins, F),
    e.g. a MelFrontend (its tensor comes back to the host)."""
    n = 0
    for p in wav_paths:
        out = p + ".mel.npy"
        if os.path.exists(out) and not overwrite:
            continue
        try:
            wav, _ = load_wav(p, sample_rate)
        except Exception as e:
            log.warning("bad wav %s: %s", p, e)
            continue
        mel = host_array(mel_fn(wav))
        np.save(out, mel[0] if mel.ndim == 3 else mel)
        n += 1
    return n


def cache_vq_codes(wav_paths: Sequence[str], codes_fn,
                   overwrite: bool = False) -> int:
    """Write `{wav}.melvq.npy` from cached mels. codes_fn: (1, bins, F) ->
    (1, F//4) int codes, or a DVAE, whose get_codebook_indices (K3 on the
    card) runs on the mel moved to the DVAE's device."""
    if hasattr(codes_fn, "get_codebook_indices"):
        dvae = codes_fn
        dev = dvae.codebook.embed.device
        codes_fn = lambda mel: dvae.get_codebook_indices(
            torch.as_tensor(mel, dtype=torch.float32, device=dev))
    n = 0
    for p in wav_paths:
        mel_path = p + ".mel.npy"
        out = p + ".melvq.npy"
        if not os.path.exists(mel_path):
            log.warning("no cached mel for %s", p)
            continue
        if os.path.exists(out) and not overwrite:
            continue
        mel = np.load(mel_path)
        codes = host_array(codes_fn(mel[None]))
        np.save(out, codes[0].astype(np.int32))
        n += 1
    return n


# ---------------------------------------------------------------------------
# stage: BPE training corpus (ttts/prepare/bpe_all_text_to_one_file.py)
# ---------------------------------------------------------------------------

def build_bpe_corpus(entries: Sequence[FilelistEntry], out_path: str) -> int:
    """Collect cleaned (pinyin-token) transcripts into one training file."""
    n = 0
    with open(out_path, "w", encoding="utf-8") as f:
        for e in entries:
            if e.cleaned_text.strip():
                f.write(e.cleaned_text.strip() + "\n")
                n += 1
    return n


def train_bpe_from_corpus(corpus_path: str, out_tokenizer: str,
                          vocab_size: int = 255):
    """Train the voice BPE on the prepared corpus (voice_tokenizer.py:83-105)."""
    from xtts_tpu_torch.text.tokenizer import train_tokenizer
    with open(corpus_path, encoding="utf-8") as f:
        lines = [l.strip() for l in f if l.strip()]
    tok = train_tokenizer(lines, vocab_size=vocab_size)
    tok.save(out_tokenizer)
    return tok
