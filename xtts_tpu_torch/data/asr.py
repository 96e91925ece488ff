"""ASR backends + transcript acceptance for the prepare pipeline (the
port's own copy of xtts_tpu/data/asr.py).

The reference transcribes VAD clips with a modelscope FunASR paraformer
pipeline (ttts/prepare/asr_process.py:14-30) and keeps a transcript only
if it has >= 5 characters and contains no Latin letters (:31-38 — Latin
in the ASR output marks code-switched/garbage clips for this Mandarin
corpus). modelscope/FunASR is not in this image; the pipeline instead
takes any `asr_fn: wav_path -> text`, and this module provides

* `accept_transcript` — the reference keep-rule, used by
  `prepare.vad_asr_to_jsonl`;
* `WhisperASR` — a concrete adapter over HF transformers Whisper
  (imported only when no model is injected) loading weights from a LOCAL
  directory, for environments with a downloaded checkpoint.
"""
from __future__ import annotations

import re
from typing import Optional

import numpy as np

_LATIN = re.compile(r"[A-Za-z]")


def accept_transcript(text: str, min_len: int = 5) -> bool:
    """Keep-rule of ttts/prepare/asr_process.py:31-38: at least `min_len`
    characters and no Latin letters."""
    return len(text) >= min_len and not _LATIN.search(text)


class WhisperASR:
    """`asr_fn` adapter over a local HF Whisper checkpoint.

    >>> asr = WhisperASR("/models/whisper-large-v3", language="zh")
    >>> prepare.vad_asr_to_jsonl(paths, "out.jsonl", asr_fn=asr)

    model/processor may be injected directly (tests use a stand-in model
    and processor; no files or network needed). The model runs on `device`:
    the card unless the caller asks for the CPU.
    """

    def __init__(self, model_dir: Optional[str] = None, language: str = "zh",
                 task: str = "transcribe", device: str = "cuda",
                 model=None, processor=None):
        if model is None or processor is None:
            from transformers import (WhisperForConditionalGeneration,
                                      WhisperProcessor)
            processor = processor or WhisperProcessor.from_pretrained(
                model_dir)
            model = model or WhisperForConditionalGeneration.from_pretrained(
                model_dir)
        self.model = model.to(device).eval()
        self.processor = processor
        self.device = device
        self.language = language
        self.task = task
        self.sample_rate = 16000          # Whisper's fixed input rate

    def transcribe_array(self, wav: np.ndarray, sr: int) -> str:
        import torch
        from xtts_tpu_torch.data.audio import resample
        wav = np.asarray(wav, np.float32).reshape(-1)
        if sr != self.sample_rate:
            wav = resample(wav, sr, self.sample_rate)
        feats = self.processor.feature_extractor(
            wav, sampling_rate=self.sample_rate, return_tensors="pt"
        ).input_features.to(self.device)
        kw = {}
        try:          # random-init test models lack language token ids
            kw["forced_decoder_ids"] = (
                self.processor.tokenizer.get_decoder_prompt_ids(
                    language=self.language, task=self.task))
        except Exception:
            pass
        # cap by the model's decoder context (prompt tokens included)
        max_new = min(128, getattr(self.model.config,
                                   "max_target_positions", 448) - 8)
        with torch.no_grad():
            ids = self.model.generate(feats, max_new_tokens=max_new, **kw)
        return self.processor.tokenizer.batch_decode(
            ids, skip_special_tokens=True)[0].strip()

    def __call__(self, wav_path: str) -> str:
        from xtts_tpu_torch.data.audio import load_wav
        wav, sr = load_wav(wav_path)
        return self.transcribe_array(wav, sr)
