"""Metrics / logging / observability (port of xtts_tpu/core/logging.py).

Reference inventory (SURVEY.md §5): TensorBoard scalars/images/audio via
`summarize` (ttts/utils/utils.py:129-139), file+console logger (:17-30),
mel-spectrogram plots (:141), grad-norm tracking (ttts/gpt/train_ms.py:28-37).

Here: one MetricLogger that fans out to console/file and JSONL (always) and
TensorBoard (only where torch.utils.tensorboard imports), plus
`torch.profiler` span and capture helpers the reference never had.
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch


def get_logger(name: str = "xtts_tpu_torch",
               log_file: Optional[str] = None) -> logging.Logger:
    """Console + optional file logger (ttts/utils/utils.py:17-30)."""
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter(
        "%(asctime)s %(levelname)s [%(name)s] %(message)s")
    sh = logging.StreamHandler(sys.stderr)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file:
        os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.propagate = False
    return logger


def plot_spectrogram_to_numpy(mel: np.ndarray) -> np.ndarray:
    """(bins, T) mel -> (H, W, 3) uint8 image without matplotlib
    (viridis-ish colormap; the reference uses matplotlib at utils.py:141)."""
    mel = np.asarray(mel, np.float32)
    lo, hi = float(mel.min()), float(mel.max())
    norm = (mel - lo) / (hi - lo + 1e-8)
    # 5-stop viridis approximation
    stops = np.array([[68, 1, 84], [59, 82, 139], [33, 145, 140],
                      [94, 201, 98], [253, 231, 37]], np.float32)
    idx = norm * (len(stops) - 1)
    i0 = np.clip(idx.astype(np.int32), 0, len(stops) - 2)
    frac = (idx - i0)[..., None]
    rgb = stops[i0] * (1 - frac) + stops[i0 + 1] * frac
    return np.flipud(rgb.astype(np.uint8))  # low freqs at the bottom


class MetricLogger:
    """Scalar/image/audio sink: JSONL + console + optional TensorBoard
    (`summarize`, ttts/utils/utils.py:129-139)."""

    def __init__(self, log_dir: str, use_tensorboard: bool = True,
                 console_every: int = 1):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self.console_every = console_every
        self.logger = get_logger("xtts_tpu_torch.train",
                                 os.path.join(log_dir, "train.log"))
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(log_dir)
            except Exception:
                self.logger.info("TensorBoard unavailable; JSONL only")

    def scalars(self, step: int, metrics: Dict[str, float], prefix: str = ""):
        vals = {k: float(v) for k, v in metrics.items()}
        rec = {"step": int(step),
               **{f"{prefix}{k}": v for k, v in vals.items()}}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in vals.items():
                self._tb.add_scalar(prefix + k, v, int(step))
        if step % self.console_every == 0:
            body = " ".join(f"{k}={v:.5g}" for k, v in vals.items())
            self.logger.info("step %d %s", step, body)

    def image_mel(self, step: int, tag: str, mel: np.ndarray):
        if self._tb is not None:
            img = plot_spectrogram_to_numpy(mel)
            self._tb.add_image(tag, img, int(step), dataformats="HWC")

    def audio(self, step: int, tag: str, wav: np.ndarray, sample_rate: int = 24000):
        if self._tb is not None:
            self._tb.add_audio(tag, np.asarray(wav)[None], int(step),
                               sample_rate=sample_rate)

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


@contextlib.contextmanager
def trace_span(name: str):
    """A named range in torch.profiler traces (record_function)."""
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def profile_to(log_dir: str):
    """Capture a host and device trace of this block (torch.profiler, the
    card's activity where CUDA is present) into <log_dir>/trace.json."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Rolling step-time / throughput tracker."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times = []
        self._last = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self.times.append(dt)
            if len(self.times) > self.window:
                self.times.pop(0)
        self._last = now
        return dt

    @property
    def mean(self) -> float:
        return float(np.mean(self.times)) if self.times else 0.0
