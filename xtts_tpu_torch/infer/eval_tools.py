"""Offline evaluation tools (port of xtts_tpu/infer/eval_tools.py).

The DVAE round trip over a file list (reference ttts/vqvae/inference.py:
per-clip mel L1 and codebook usage, optional wav renders through Vocos),
and two objective distances between renders: `mel_l1` and `mcd`. The round
trip runs `get_codebook_indices` (K3 on the card, one launch a clip) and
`decode` on the DVAE's device.
"""
from __future__ import annotations

import json
import logging
import os
from typing import Optional, Sequence

import numpy as np
import torch

log = logging.getLogger(__name__)


@torch.no_grad()
def dvae_roundtrip(dvae, mel):
    """One mel (bins, T), numpy or a tensor -> dict(codes, recon, mel_l1,
    unique_codes): the codes (T // 4,) and the decoded mel as numpy, the
    mean |recon - mel| over the frames both cover."""
    dev = next(dvae.parameters()).device
    mel_t = torch.as_tensor(mel if torch.is_tensor(mel)
                            else np.asarray(mel, np.float32),
                            dtype=torch.float32, device=dev)[None]
    codes = dvae.get_codebook_indices(mel_t)
    recon, _ = dvae.decode(codes)
    t = min(mel_t.shape[-1] // 4 * 4, recon.shape[-1])
    l1 = float((recon[0, :, :t].float() - mel_t[0, :, :t]).abs().mean())
    c = codes[0].cpu().numpy()
    return {"codes": c, "recon": recon[0].float().cpu().numpy(),
            "mel_l1": l1, "unique_codes": int(len(np.unique(c)))}


def evaluate_dvae(dvae, mel_paths: Sequence[str],
                  out_jsonl: Optional[str] = None, vocos=None,
                  wav_dir: Optional[str] = None, sample_rate: int = 24000,
                  mel_fn=None):
    """File-list DVAE evaluation: per clip the mel L1 of the round trip and
    its distinct codes (one JSON line each to out_jsonl); with vocos and
    wav_dir, each reconstruction rendered to <name>_recon.wav. mel_fn: a
    front end for wav paths; without it only cached `.mel.npy` entries are
    scored. Returns {mel_l1_mean, codebook_usage (distinct codes over all
    clips), n}."""
    from xtts_tpu_torch.data.audio import save_wav
    from xtts_tpu_torch.data.datasets import MelCache
    cache = MelCache(mel_fn, sample_rate=sample_rate)
    results = []
    seen_codes: set = set()
    writer = open(out_jsonl, "w") if out_jsonl else None
    try:
        for p in mel_paths:
            mel = cache(p)
            if mel is None:
                log.warning("no mel for %s", p)
                continue
            r = dvae_roundtrip(dvae, mel)
            seen_codes.update(np.unique(r["codes"]).tolist())
            rec = {"path": p, "mel_l1": r["mel_l1"],
                   "unique_codes": r["unique_codes"]}
            results.append(rec)
            if writer:
                writer.write(json.dumps(rec) + "\n")
            if vocos is not None and wav_dir is not None:
                os.makedirs(wav_dir, exist_ok=True)
                dev = next(vocos.parameters()).device
                with torch.no_grad():
                    wav = vocos(torch.as_tensor(r["recon"], device=dev)[None])
                name = os.path.splitext(os.path.basename(p))[0] + "_recon.wav"
                save_wav(os.path.join(wav_dir, name),
                         wav[0].float().cpu().numpy(), sample_rate)
    finally:
        if writer:
            writer.close()
    if not results:
        return {"mel_l1_mean": float("nan"), "codebook_usage": 0, "n": 0}
    return {"mel_l1_mean": float(np.mean([r["mel_l1"] for r in results])),
            "codebook_usage": len(seen_codes), "n": len(results)}


# --------------------------------------------------------------------------
# objective distances between two renders (the reference has none; its
# evaluations are listening checks)


def _bucketed_mel_pair(mel_fn, wav_a, wav_b):
    """Mels of two renders over their shared length: both cut to it,
    zero-padded to a multiple of 8192 samples (one STFT shape a bucket),
    then trimmed to the frames the shared length covers."""
    n = min(len(np.ravel(wav_a)), len(np.ravel(wav_b)))
    nb = max(-(-n // 8192) * 8192, 8192)

    def pad(w):
        return np.pad(np.asarray(w, np.float32).reshape(-1)[:n], (0, nb - n))

    a, b = mel_fn(pad(wav_a)), mel_fn(pad(wav_b))
    frames = max(n // mel_fn.cfg.hop_length, 1)
    return a[..., :frames], b[..., :frames]


def mel_l1(mel_fn, wav_a, wav_b) -> float:
    """Mean |mel_a - mel_b| between two waveforms of one sample rate, over
    their shared length."""
    a, b = _bucketed_mel_pair(mel_fn, wav_a, wav_b)
    return float((a - b).abs().mean())


def mcd(mel_fn, wav_a, wav_b, n_coeff: int = 13) -> float:
    """Mel-cepstral-distortion-style distance (dB) between two renders: the
    DCT-II of the log-mel (coefficients 1..n_coeff, c0 left out), the
    frame mean of 10 / ln 10 * sqrt(2 sum dc^2). From the pipeline's own
    log-mel front end, so comparable between renders of one text, not with
    published MCD tables."""
    a, b = _bucketed_mel_pair(mel_fn, wav_a, wav_b)
    a = a.float().cpu().numpy()[0].T.astype(np.float64)    # (T, bins)
    b = b.float().cpu().numpy()[0].T.astype(np.float64)
    bins = a.shape[1]
    k = np.arange(1, n_coeff + 1)[None, :]
    basis = np.cos(np.pi * k * (2 * np.arange(bins)[:, None] + 1)
                   / (2 * bins))                # (bins, n_coeff) DCT-II
    ca, cb = a @ basis, b @ basis
    d = np.sqrt(2.0 * np.sum((ca - cb) ** 2, axis=1))
    return float((10.0 / np.log(10.0)) * d.mean())
