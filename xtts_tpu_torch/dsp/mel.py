"""Log-mel front-end (port of xtts_tpu/dsp/mel.py).

The filterbank is host numpy, built by the same formulas as the JAX module
(which cannot be imported here: it loads jax at import time).
"""
from __future__ import annotations

import numpy as np
import torch

from xtts_tpu_torch.core.config import MelConfig
from xtts_tpu_torch.dsp.spectral import _reflect_pad_1d, hann_window, stft


def hz_to_mel(f: np.ndarray, scale: str = "htk") -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    if scale == "htk":
        return 2595.0 * np.log10(1.0 + f / 700.0)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    f_safe = np.maximum(f, min_log_hz)
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(f_safe / min_log_hz) / logstep, mels)


def mel_to_hz(m: np.ndarray, scale: str = "htk") -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    if scale == "htk":
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int,
                   fmin: float = 0.0, fmax: float | None = None,
                   scale: str = "htk", norm: str | None = None) -> np.ndarray:
    """Triangular mel filterbank, shape (n_fft//2 + 1, n_mels)."""
    fmax = fmax if fmax is not None else sample_rate / 2.0
    all_freqs = np.linspace(0, sample_rate // 2, n_fft // 2 + 1)
    m_pts = np.linspace(hz_to_mel(fmin, scale), hz_to_mel(fmax, scale),
                        n_mels + 2)
    f_pts = mel_to_hz(m_pts, scale)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    if norm == "slaney":
        enorm = 2.0 / (f_pts[2:n_mels + 2] - f_pts[:n_mels])
        fb = fb * enorm[None, :]
    return fb.astype(np.float32)


def safe_log(x: torch.Tensor, clip_val: float = 1e-5) -> torch.Tensor:
    """log(clamp(x, clip))."""
    return torch.log(torch.clamp(x, min=clip_val))


class MelFrontend:
    """wav (B, T) float in [-1, 1] -> log-mel (B, n_mels, frames), f32, on
    `device`: the card unless the caller asks for the CPU."""

    def __init__(self, cfg: MelConfig = MelConfig(), device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.filterbank = torch.as_tensor(
            mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels,
                           cfg.mel_fmin, cfg.mel_fmax, scale=cfg.mel_scale,
                           norm=cfg.mel_norm), device=self.device)
        self.window = hann_window(cfg.win_length, device=self.device)

    def __call__(self, wav) -> torch.Tensor:
        cfg = self.cfg
        wav = torch.as_tensor(np.asarray(wav, np.float32)
                              if not torch.is_tensor(wav) else wav,
                              dtype=torch.float32, device=self.device)
        if wav.ndim == 1:
            wav = wav[None]
        if cfg.padding == "center":
            mag = stft(wav, cfg.n_fft, cfg.hop_length, cfg.win_length,
                       self.window, center=True, magnitude=True)
        else:
            pad = int((cfg.n_fft - cfg.hop_length) / 2)
            mag = stft(_reflect_pad_1d(wav, pad), cfg.n_fft, cfg.hop_length,
                       cfg.win_length, self.window, center=False,
                       magnitude=True, mag_eps=1e-9)
        if cfg.power != 1.0:
            mag = mag ** cfg.power
        mel = torch.einsum("bft,fm->bmt", mag, self.filterbank)
        return safe_log(mel, cfg.log_clip)


# 16 kHz 64-bin mel for the HiFi-GAN speaker encoder
# (ttts/hifigan/hifigan_vocoder.py:671-678 audio_config)
SPEAKER_ENCODER_MEL_CONFIG = MelConfig(
    sample_rate=16000, n_mels=64, n_fft=512, win_length=400, hop_length=160,
)
