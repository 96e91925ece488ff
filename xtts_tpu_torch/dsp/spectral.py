"""STFT / iSTFT and MDCT / IMDCT in PyTorch (port of
xtts_tpu/dsp/spectral.py).

Framing is a static index gather, the overlap-add an index_add, exactly as
in the JAX module, so both frame and fold with the same index grids. The
FFTs are torch.fft (cuFFT on the card); the MDCT pair is a product with
the cosine basis, built in f32 by the JAX module's expression.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_length: int, dtype=torch.float32, *,
                device) -> torch.Tensor:
    """Periodic Hann window (torch.hann_window(periodic=True))."""
    n = np.arange(win_length)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
    return torch.as_tensor(w, dtype=dtype, device=device)


def _reflect_pad_1d(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad the last axis of (B, T) (no edge duplication)."""
    if pad == 0:
        return x
    return F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]


def _frame_index(n_frames: int, frame_length: int, hop: int,
                 device) -> torch.Tensor:
    idx = (np.arange(n_frames)[:, None] * hop
           + np.arange(frame_length)[None, :])
    return torch.as_tensor(idx, device=device)


def frame_signal(x: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """(B, T) -> (B, n_frames, frame_length) via a static gather."""
    n_frames = 1 + (x.shape[1] - frame_length) // hop
    return x[:, _frame_index(n_frames, frame_length, hop, x.device)]


def stft(x: torch.Tensor, n_fft: int, hop_length: int,
         win_length: int | None = None, window: torch.Tensor | None = None,
         center: bool = True, magnitude: bool = False,
         mag_eps: float = 0.0) -> torch.Tensor:
    """(B, T) -> complex (B, n_fft//2+1, frames), or its magnitude
    sqrt(re^2 + im^2 + mag_eps)."""
    win_length = win_length or n_fft
    if window is None:
        window = hann_window(win_length, x.dtype, device=x.device)
    if win_length < n_fft:  # torch centers the window inside n_fft
        lpad = (n_fft - win_length) // 2
        window = F.pad(window, (lpad, n_fft - win_length - lpad))
    if center:
        x = _reflect_pad_1d(x, n_fft // 2)
    frames = frame_signal(x, n_fft, hop_length) * window[None, None, :]
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1).transpose(1, 2)
    if magnitude:
        return torch.sqrt(spec.real ** 2 + spec.imag ** 2 + mag_eps)
    return spec


def overlap_add(frames: torch.Tensor, hop: int,
                output_size: int) -> torch.Tensor:
    """(B, n_frames, win) -> (B, output_size) overlap-add.

    Where the hop divides the window (every caller's case: r = win / hop
    frames cover a sample), the frames are summed as r shifted slabs of
    hop samples, added into zeros in frame order: the sum, and its
    rounding, of a sequential scatter-add (index_add_ on the CPU) to the
    bit, and on the card deterministic, where index_add_ adds with atomics
    in whatever order the threads arrive. Otherwise a scatter-add."""
    b, n_frames, win = frames.shape
    r = win // hop if win % hop == 0 else 0
    chunks = n_frames + r - 1
    if r == 0 or output_size < chunks * hop:
        idx = _frame_index(n_frames, win, hop, frames.device).reshape(-1)
        out = torch.zeros((b, output_size), dtype=frames.dtype,
                          device=frames.device)
        return out.index_add_(1, idx, frames.reshape(b, -1))
    parts = frames.reshape(b, n_frames, r, hop)
    acc = frames.new_zeros((b, chunks, hop))
    for q in range(r - 1, -1, -1):      # frame j = chunk - q: j ascending
        acc[:, q:q + n_frames] += parts[:, :, q]
    return F.pad(acc.reshape(b, chunks * hop),
                 (0, output_size - chunks * hop))


def _mdct_basis(n: int, device) -> torch.Tensor:
    """(n, n/2) cosine basis cos(pi/M (k + 0.5 + M/2)(m + 0.5)), M = n/2,
    in f32 as the JAX module computes it."""
    half = n // 2
    k = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    m = torch.arange(half, dtype=torch.float32, device=device)[None, :]
    return torch.cos(math.pi / half * (k + 0.5 + half / 2) * (m + 0.5))


def _mdct_window(n: int, device) -> torch.Tensor:
    """The sine window sin(pi/n (i + 0.5)) (scipy's cosine window)."""
    i = torch.arange(n, dtype=torch.float32, device=device)
    return torch.sin(math.pi / n * (i + 0.5))


def _mdct_pad(frame_len: int, padding: str) -> int:
    """Edge zero-pad a side: "same" frame_len // 4, "center" // 2."""
    if padding == "same":
        return frame_len // 4
    if padding == "center":
        return frame_len // 2
    raise ValueError("Padding must be 'center' or 'same'.")


def mdct(x: torch.Tensor, frame_len: int,
         padding: str = "same") -> torch.Tensor:
    """Modified DCT of (B, T) -> (B, frames, frame_len // 2): zero edge pad,
    sine-windowed frames at 50% overlap, times the cosine basis and
    sqrt(2 / N), N = frame_len / 2 (the reference's FFT-twiddle MDCT)."""
    n = frame_len
    half = n // 2
    pad = _mdct_pad(n, padding)
    x = F.pad(x, (pad, pad))
    frames = frame_signal(x, n, half) * _mdct_window(n, x.device)[None, None]
    return (frames @ _mdct_basis(n, x.device)) * math.sqrt(2.0 / half)


def imdct(coeffs: torch.Tensor, frame_len: int,
          padding: str = "same") -> torch.Tensor:
    """Inverse MDCT of (B, frames, frame_len // 2) -> (B, T): synthesis
    product, sine window, TDAC overlap-add, edge trim. T = frames * N for
    "same", (frames - 1) * N for "center"; perfect reconstruction away
    from the padded edges."""
    n = frame_len
    half = n // 2
    t = coeffs.shape[1]
    frames = math.sqrt(2.0 / half) * (coeffs @ _mdct_basis(n, coeffs.device).T)
    frames = frames * _mdct_window(n, coeffs.device)[None, None]
    out_len = (t + 1) * half
    y = overlap_add(frames, half, out_len)
    pad = _mdct_pad(n, padding)
    return y[:, pad:out_len - pad]


def istft(spec_real: torch.Tensor, spec_imag: torch.Tensor, n_fft: int,
          hop_length: int, win_length: int | None = None,
          padding: str = "same") -> torch.Tensor:
    """Inverse STFT of (B, bins, T) given as (real, imag): irfft per frame,
    window, overlap-add, divide by the window envelope, trim `pad` samples
    each side ("same": (win-hop)//2, "center": n_fft//2)."""
    if padding == "same":
        pad = ((win_length or n_fft) - hop_length) // 2
    elif padding == "center":
        pad = n_fft // 2
    else:
        raise ValueError("padding must be 'same' or 'center'")
    win_length = win_length or n_fft
    window = hann_window(win_length, spec_real.dtype,
                         device=spec_real.device)
    spec = torch.complex(spec_real, spec_imag).transpose(1, 2)
    t = spec.shape[1]
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1)
    frames = frames[..., :win_length] * window[None, None, :]
    output_size = (t - 1) * hop_length + win_length
    y = overlap_add(frames, hop_length, output_size)
    win_sq = (window * window)[None, None, :].expand(1, t, win_length)
    env = overlap_add(win_sq.contiguous(), hop_length, output_size)[0]
    y = y[:, pad:output_size - pad]
    env = env[pad:output_size - pad].clamp(min=1e-11)
    return y / env[None, :]
