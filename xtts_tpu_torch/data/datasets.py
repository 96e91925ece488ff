"""Dataset helpers (port of the parts of xtts_tpu/data/datasets.py that
inference uses: `MelCache`, which the offline DVAE evaluation reads
through). The training datasets and collaters are not ported yet."""
from __future__ import annotations

import logging
import os
from typing import Callable, Optional

import numpy as np
import torch

from xtts_tpu_torch.data.audio import load_wav

log = logging.getLogger(__name__)


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
        mel = self._mel_fn(wav)
        mel = (mel.float().cpu().numpy() if torch.is_tensor(mel)
               else np.asarray(mel))
        return mel[0] if mel.ndim == 3 else mel
