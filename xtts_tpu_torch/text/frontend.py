"""Host-side frontend glue: raw text -> per-sentence GPT token arrays.

Mirrors the reference's inference preamble (test.py:108-135): split long text
into sentences on terminal punctuation, run the language frontend + BPE per
sentence, then frame each id list as [start_text_token, ids..., stop_text_token]
(test.py:133-135 pads with 0 then 255 at the front).
"""
from __future__ import annotations

import re
from typing import Iterator, List, Optional

import numpy as np

from xtts_tpu_torch.text.cleaner import text_to_bpe_string
from xtts_tpu_torch.text.symbols import SENTENCE_SPLIT
from xtts_tpu_torch.text.tokenizer import VoiceBpeTokenizer

_default_tokenizer: Optional[VoiceBpeTokenizer] = None


def get_default_tokenizer() -> VoiceBpeTokenizer:
    global _default_tokenizer
    if _default_tokenizer is None:
        _default_tokenizer = VoiceBpeTokenizer()
    return _default_tokenizer


def split_sentences(text: str, max_chars: int = 120) -> List[str]:
    """Split on sentence-final punctuation (test.py:108-110); long runs
    without terminal punctuation are further split on commas."""
    pattern = "([" + re.escape(SENTENCE_SPLIT) + "])"
    parts = re.split(pattern, text)
    sents: List[str] = []
    cur = ""
    for p in parts:
        cur += p
        if p and p in SENTENCE_SPLIT:
            if cur.strip():
                sents.append(cur.strip())
            cur = ""
    if cur.strip():
        sents.append(cur.strip())
    out: List[str] = []
    for s in sents:
        while len(s) > max_chars:
            cut = max((s.rfind(c, 0, max_chars) for c in "，,、"), default=-1)
            if cut <= 0:
                cut = max_chars
            out.append(s[:cut + 1])
            s = s[cut + 1:]
        if s:
            out.append(s)
    return out


def sentence_to_tokens(sentence: str, lang: str = "ZH",
                       tokenizer: Optional[VoiceBpeTokenizer] = None,
                       start_token: int = 255, stop_token: int = 0,
                       ) -> np.ndarray:
    """One sentence -> framed int32 id array [start, ids..., stop]."""
    tok = tokenizer or get_default_tokenizer()
    ids = tok.encode(text_to_bpe_string(sentence, lang))
    return np.asarray([start_token] + list(ids) + [stop_token], np.int32)


def sentences_to_token_batches(text: str, lang: str = "ZH",
                               tokenizer: Optional[VoiceBpeTokenizer] = None,
                               ) -> Iterator[np.ndarray]:
    """Yield per-sentence token arrays for the synthesis loop."""
    for sent in split_sentences(text):
        yield sentence_to_tokens(sent, lang, tokenizer)
