"""Host-side audio IO and utilities (the port's own copy of
xtts_tpu/data/audio.py, numpy only): WAV IO rides scipy.io.wavfile,
resampling scipy.signal.resample_poly; `get_prompt_slice` and
`make_pad_mask` (ttts/utils/utils.py:60-103); the silence and energy VAD
splitters of the prepare pipeline (ttts/prepare/vad_process.py)."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly


def load_wav(path: str, target_sr: Optional[int] = None,
             mono: bool = True) -> Tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 [-1, 1] samples, sample rate). int16,
    int32 and uint8 PCM scale to [-1, 1); several channels average to one
    (mono); the result is resampled to target_sr and clipped to [-1, 1]."""
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if mono and data.ndim > 1:
        data = data.mean(axis=1)
    if target_sr is not None and sr != target_sr:
        data = resample(data, sr, target_sr)
        sr = target_sr
    return np.clip(data, -1.0, 1.0), sr


def save_wav(path: str, wav: np.ndarray, sr: int = 24000) -> None:
    """float [-1, 1] samples -> 16-bit PCM WAV file."""
    wav = np.clip(np.asarray(wav, np.float32), -1.0, 1.0)
    wavfile.write(path, sr, (wav * 32767.0).astype(np.int16))


def resample(wav: np.ndarray, orig_sr: int, new_sr: int) -> np.ndarray:
    """Polyphase resampling by the reduced ratio new_sr / orig_sr."""
    if orig_sr == new_sr:
        return wav
    g = math.gcd(orig_sr, new_sr)
    return resample_poly(wav, new_sr // g, orig_sr // g).astype(np.float32)


def get_prompt_slice(wav: np.ndarray, sr: int, max_sec: float = 20.0,
                     min_sec: float = 3.0, deterministic: bool = False,
                     rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Random (or deterministic for eval) reference slice of 3-20 s
    (utils.py:60-78 get_prompt_slice)."""
    rng = rng or np.random.default_rng(0 if deterministic else None)
    max_len = int(max_sec * sr)
    min_len = int(min_sec * sr)
    if len(wav) <= min_len:
        return wav
    length = min_len if deterministic else int(rng.integers(
        min_len, min(max_len, len(wav)) + 1))
    start = 0 if deterministic else int(rng.integers(0, len(wav) - length + 1))
    return wav[start:start + length]


def make_pad_mask(lengths: np.ndarray, max_len: Optional[int] = None
                  ) -> np.ndarray:
    """(B,) lengths -> (B, T) bool mask, True at PAD positions
    (utils.py:81-103 semantics)."""
    lengths = np.asarray(lengths)
    t = int(max_len if max_len is not None else lengths.max())
    return np.arange(t)[None, :] >= lengths[:, None]


def _ms_to_samples(ms: float, sr: int) -> int:
    return int(round(ms * sr / 1000.0))


def detect_silence_ms(wav: np.ndarray, sr: int, min_silence_ms: int = 600,
                      silence_db: float = -40.0, seek_step_ms: int = 100):
    """pydub.silence.detect_silence semantics on a float waveform.

    A window of `min_silence_ms` starting at every `seek_step_ms` (plus one
    final window flush with the end) is silent when its RMS <=
    10^(silence_db/20) of full scale (pydub dBFS vs max_possible_amplitude;
    full scale = 1.0 for float wavs). Overlapping/continuous silent windows
    merge into [start_ms, end_ms] ranges. This is the reference VAD's exact
    windowing (ttts/prepare/vad_process.py:19 calls split_on_silence with
    min_silence_len=600, silence_thresh=-40, seek_step=100).
    """
    seg_len = int(len(wav) * 1000.0 / sr)          # pydub length in ms
    if seg_len < min_silence_ms:
        return []
    thresh = 10.0 ** (silence_db / 20.0)
    last_start = seg_len - min_silence_ms
    starts = list(range(0, last_start + 1, seek_step_ms))
    if last_start % seek_step_ms:
        starts.append(last_start)
    silence_starts = []
    for i in starts:
        s = _ms_to_samples(i, sr)
        e = _ms_to_samples(i + min_silence_ms, sr)
        sl = wav[s:e]
        rms = float(np.sqrt(np.mean(sl.astype(np.float64) ** 2))) if sl.size else 0.0
        if rms <= thresh:
            silence_starts.append(i)
    if not silence_starts:
        return []
    ranges = []
    prev = silence_starts[0]
    cur_start = prev
    for i in silence_starts[1:]:
        continuous = i == prev + seek_step_ms
        has_gap = i > prev + min_silence_ms
        if not continuous and has_gap:
            ranges.append([cur_start, prev + min_silence_ms])
            cur_start = i
        prev = i
    ranges.append([cur_start, prev + min_silence_ms])
    return ranges


def split_on_silence_ranges(wav: np.ndarray, sr: int,
                            min_silence_ms: int = 600,
                            silence_db: float = -40.0,
                            seek_step_ms: int = 100,
                            keep_silence_ms: int = 50):
    """pydub.silence.split_on_silence boundary semantics: nonsilent ranges
    from detect_silence complements, +/- keep_silence margins, overlapping
    neighbour margins split at the midpoint. Returns [start_ms, end_ms]
    pairs (clamped to the clip). Matches the reference's segmentation call
    (ttts/prepare/vad_process.py:19, keep_silence=50)."""
    seg_len = int(len(wav) * 1000.0 / sr)
    silent = detect_silence_ms(wav, sr, min_silence_ms, silence_db,
                               seek_step_ms)
    if not silent:
        nonsilent = [[0, seg_len]]
    elif silent[0][0] == 0 and silent[0][1] == seg_len:
        nonsilent = []
    else:
        nonsilent = []
        prev_end = 0
        for s, e in silent:
            nonsilent.append([prev_end, s])
            prev_end = e
        if silent[-1][1] != seg_len:
            nonsilent.append([prev_end, seg_len])
        if nonsilent and nonsilent[0] == [0, 0]:
            nonsilent.pop(0)
    out = [[s - keep_silence_ms, e + keep_silence_ms] for s, e in nonsilent]
    for a, b in zip(out, out[1:]):
        if b[0] < a[1]:
            mid = (a[1] + b[0]) // 2
            a[1] = mid
            b[0] = mid
    return [[max(s, 0), min(e, seg_len)] for s, e in out]


def silence_split_segments(wav: np.ndarray, sr: int,
                           min_silence_ms: int = 600,
                           silence_db: float = -40.0,
                           seek_step_ms: int = 100,
                           keep_silence_ms: int = 50,
                           keep_min_sec: float = 4.0,
                           keep_max_sec: float = 20.0):
    """The reference VAD stage (ttts/prepare/vad_process.py:6-29): pydub
    split_on_silence(600 ms, -40 dBFS, seek 100 ms, keep 50 ms) then keep
    only 4-20 s clips. Returns (start_sample, end_sample) pairs."""
    out = []
    for s_ms, e_ms in split_on_silence_ranges(
            wav, sr, min_silence_ms, silence_db, seek_step_ms,
            keep_silence_ms):
        dur = (e_ms - s_ms) / 1000.0
        if keep_min_sec <= dur <= keep_max_sec:
            out.append((_ms_to_samples(s_ms, sr),
                        min(_ms_to_samples(e_ms, sr), len(wav))))
    return out


def energy_vad_segments(wav: np.ndarray, sr: int,
                        min_silence_ms: float = 600.0,
                        silence_db: float = -40.0,
                        keep_min_sec: float = 4.0,
                        keep_max_sec: float = 20.0,
                        frame_ms: float = 30.0):
    """Energy-based split-on-silence (stand-in for pydub split_on_silence in
    ttts/prepare/vad_process.py:6-29: 600 ms / -40 dBFS / keep 4-20 s clips).

    Returns list of (start_sample, end_sample) segments.
    """
    frame = max(1, int(sr * frame_ms / 1000.0))
    n = len(wav) // frame
    if n == 0:
        return []
    frames = wav[:n * frame].reshape(n, frame)
    rms = np.sqrt((frames ** 2).mean(axis=1) + 1e-12)
    db = 20.0 * np.log10(rms + 1e-12)
    voiced = db > silence_db
    min_sil_frames = max(1, int(min_silence_ms / frame_ms))

    segments = []
    start = None
    silence_run = 0
    for i, v in enumerate(voiced):
        if v:
            if start is None:
                start = i
            silence_run = 0
        else:
            if start is not None:
                silence_run += 1
                if silence_run >= min_sil_frames:
                    segments.append((start, i - silence_run + 1))
                    start = None
                    silence_run = 0
    if start is not None:
        segments.append((start, n))

    out = []
    for s, e in segments:
        dur = (e - s) * frame / sr
        if keep_min_sec <= dur <= keep_max_sec:
            out.append((s * frame, e * frame))
    return out
