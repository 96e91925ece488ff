"""Host-side audio IO (the port's own copy of `load_wav`, `save_wav` and
`resample` from xtts_tpu/data/audio.py; the training-data slices are not
ported). WAV IO rides scipy.io.wavfile, resampling scipy.signal.resample_poly.
"""
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
