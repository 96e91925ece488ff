"""Audio helpers the inference path needs (the port's own copy of
`resample` from xtts_tpu/data/audio.py; the rest of that module, loading
and saving files and the training-data slices, is not ported)."""
from __future__ import annotations

import math

import numpy as np
from scipy.signal import resample_poly


def resample(wav: np.ndarray, orig_sr: int, new_sr: int) -> np.ndarray:
    """Polyphase resampling by the reduced ratio new_sr / orig_sr."""
    if orig_sr == new_sr:
        return wav
    g = math.gcd(orig_sr, new_sr)
    return resample_poly(wav, new_sr // g, orig_sr // g).astype(np.float32)
