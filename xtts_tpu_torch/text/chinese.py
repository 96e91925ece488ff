"""Mandarin text -> pinyin-token pipeline (reference: ttts/gpt/text/chinese.py).

Stages (same contract as the reference's text_normalize + g2w):
1. `text_normalize`: NSW normalization (xtts_tpu_torch.text.normalize), punctuation
   folding onto the retained set, CJK/ASCII filtering, space cleanup
2. `g2w`: split on retained punctuation; per sentence: extract latin words,
   jieba posseg segmentation, sandhi pre-merge, per-word G2P + tone rules,
   emit syllable+tone tokens ("ni3"), punctuation marks, and lowercased
   English words in reading order

Output feeds VoiceBpeTokenizer as "[ZH] " + " ".join(tokens).
"""
from __future__ import annotations

import logging
import re
from typing import List, Tuple

from xtts_tpu_torch.text.normalize import TextNormalizer
from xtts_tpu_torch.text.pinyin import G2P, VALID_SYLLABLES, parse_toned
from xtts_tpu_torch.text.sandhi import ToneSandhi
from xtts_tpu_torch.text.symbols import PUNCTUATION

log = logging.getLogger(__name__)

# Running OOV accounting: characters no G2P backend could voice. The
# reference (pypinyin-backed) never drops; our lexicon path can, so the drops
# are logged AND countable (oov_stats()/reset_oov_stats()) instead of silent.
_OOV_COUNTS: dict = {}


def oov_stats() -> dict:
    """{char: drop_count} for every hanzi dropped since the last reset."""
    return dict(_OOV_COUNTS)


def reset_oov_stats() -> None:
    _OOV_COUNTS.clear()

# Marker standing in for an extracted latin-script word during segmentation
# (the reference uses the same sentinel trick, chinese.py:19,115-148).
_EN_MARK = "▁"  # ▁

# All punctuation variants fold onto the retained set (chinese.py rep_map).
_PUNCT_FOLD = {
    "：": ",", "；": ",", "，": ",", "。": ".", "！": "!", "？": "?",
    "\n": ".", "·": ",", "、": ",", "...": "…", "$": ".",
    "“": "'", "”": "'", '"': "'", "‘": "'", "’": "'",
    "（": "'", "）": "'", "(": "'", ")": "'", "《": "'", "》": "'",
    "【": "'", "】": "'", "[": "'", "]": "'",
    "—": "-", "～": "-", "~": "-", "「": "'", "」": "'",
}

# Interjection homophone swaps the reference applies before folding
# (chinese.py:80: 嗯/呣 have no standard pinyin syllable).
_HOMOPHONE = {"嗯": "恩", "呣": "母"}

_normalizer = TextNormalizer()
_g2p = G2P()
_sandhi = ToneSandhi(g2p=_g2p)

_LATIN = set("abcdefghijklmnopqrstuvwxyz0123456789")


def _collapse_spaces(text: str) -> str:
    """Drop spaces except between two latin words (chinese.py:64-76)."""
    out = ""
    prev_latin = False
    for chunk in text.split():
        cur_latin = chunk[0].lower() in _LATIN
        out += " " + chunk if (prev_latin and cur_latin) else chunk
        prev_latin = chunk[-1].lower() in _LATIN
    return out


def replace_punctuation(text: str) -> str:
    for k, v in _HOMOPHONE.items():
        text = text.replace(k, v)
    pattern = re.compile("|".join(re.escape(p) for p in _PUNCT_FOLD))
    text = pattern.sub(lambda m: _PUNCT_FOLD[m.group(0)], text)
    keep = "".join(re.escape(p) for p in PUNCTUATION)
    text = re.sub(r"[^一-龥a-zA-Z " + keep + r"]+", "", text)
    return _collapse_spaces(text)


def text_normalize(text: str) -> str:
    return replace_punctuation(_normalizer.normalize_sentence(text))


def _extract_latin(text: str) -> Tuple[str, List[str]]:
    """'好heko世界' -> ('好▁世界', ['heko']): latin runs become markers."""
    words: List[str] = []
    out = ""
    cur = ""
    for ch in text:
        if ch.lower() in _LATIN and ch != " ":
            cur += ch
        else:
            if cur:
                words.append(cur)
                out += _EN_MARK
                cur = ""
            out += ch
    if cur:
        words.append(cur)
        out += _EN_MARK
    return out, words


def _resplit_markers(segs):
    """jieba may glue markers into a segment; split them back out."""
    out = []
    for word, pos in segs:
        if _EN_MARK not in word:
            out.append((word, pos))
            continue
        for part in re.split(f"({_EN_MARK})", word):
            if part:
                out.append((part, pos))
    return out


def g2w(text: str) -> List[str]:
    pattern = r"(?<=[{0}])\s*".format("".join(re.escape(p) for p in PUNCTUATION))
    sentences = [s for s in re.split(pattern, text) if s.strip()]
    return _g2w(sentences)


def _g2w(sentences: List[str]) -> List[str]:
    tokens: List[str] = []
    for sent in sentences:
        sent, latin_words = _extract_latin(sent)
        import jieba.posseg as psg   # lazily: only text input needs it
        segs = [(w, p) for w, p in psg.lcut(sent)]
        segs = _sandhi.pre_merge(segs)
        segs = _resplit_markers(segs)
        k = 0
        for word, pos in segs:
            if word == " ":
                continue
            if word == _EN_MARK:
                tokens.append(latin_words[k].lower())
                k += 1
                continue
            syls = []
            per_char = _g2p(word)
            kept_chars = []
            for ch, s in zip(word, per_char):
                if s is None:
                    if ch in PUNCTUATION:
                        kept_chars.append(ch)
                        syls.append(ch)
                    else:
                        _OOV_COUNTS[ch] = _OOV_COUNTS.get(ch, 0) + 1
                        log.warning("g2p: no reading for %r (dropped)", ch)
                    continue
                kept_chars.append(ch)
                syls.append(s)
            if all(s in PUNCTUATION for s in syls):
                tokens.extend(syls)
                continue
            word_kept = "".join(kept_chars)
            syls = _sandhi.apply(word_kept, pos, syls)
            for s in syls:
                if s in PUNCTUATION:
                    tokens.append(s)
                    continue
                syl, tone = parse_toned(s)
                if syl not in VALID_SYLLABLES:
                    log.warning("g2w: illegal syllable %r from %r", s, word)
                    continue
                tokens.append(syl + tone)
    return tokens
