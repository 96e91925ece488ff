"""Japanese text frontend — kana -> Hepburn romaji tokens.

Reference: ttts/gpt/text/japanese.py (pyopenjtalk-based romaji pipeline with
a post-processing symbol map). pyopenjtalk is not in this image, so this
module romanizes kana directly (hiragana/katakana incl. digraphs, sokuon
gemination, chouon long vowels). Kanji have no reading backend and are
dropped with a warning — inject a kakasi/openjtalk-style `kanji_to_kana`
callable for full coverage.

Output format matches the other language modules: list of lowercase romaji
syllable tokens + retained punctuation, ready for "[JA] " + " ".join(...).
"""
from __future__ import annotations

import logging
import re
from typing import Callable, List, Optional

from xtts_tpu_torch.text.symbols import PUNCTUATION

log = logging.getLogger(__name__)

_BASE = {
    "あ": "a", "い": "i", "う": "u", "え": "e", "お": "o",
    "か": "ka", "き": "ki", "く": "ku", "け": "ke", "こ": "ko",
    "さ": "sa", "し": "shi", "す": "su", "せ": "se", "そ": "so",
    "た": "ta", "ち": "chi", "つ": "tsu", "て": "te", "と": "to",
    "な": "na", "に": "ni", "ぬ": "nu", "ね": "ne", "の": "no",
    "は": "ha", "ひ": "hi", "ふ": "fu", "へ": "he", "ほ": "ho",
    "ま": "ma", "み": "mi", "む": "mu", "め": "me", "も": "mo",
    "や": "ya", "ゆ": "yu", "よ": "yo",
    "ら": "ra", "り": "ri", "る": "ru", "れ": "re", "ろ": "ro",
    "わ": "wa", "ゐ": "i", "ゑ": "e", "を": "o", "ん": "n",
    "が": "ga", "ぎ": "gi", "ぐ": "gu", "げ": "ge", "ご": "go",
    "ざ": "za", "じ": "ji", "ず": "zu", "ぜ": "ze", "ぞ": "zo",
    "だ": "da", "ぢ": "ji", "づ": "zu", "で": "de", "ど": "do",
    "ば": "ba", "び": "bi", "ぶ": "bu", "べ": "be", "ぼ": "bo",
    "ぱ": "pa", "ぴ": "pi", "ぷ": "pu", "ぺ": "pe", "ぽ": "po",
    "ぁ": "a", "ぃ": "i", "ぅ": "u", "ぇ": "e", "ぉ": "o",
    "ゔ": "vu",
}

_DIGRAPH_SECOND = {"ゃ": "ya", "ゅ": "yu", "ょ": "yo"}

# chi/shi/ji digraphs contract: ち+ゃ -> cha (not chya)
_CONTRACT = {
    ("chi", "ya"): "cha", ("chi", "yu"): "chu", ("chi", "yo"): "cho",
    ("shi", "ya"): "sha", ("shi", "yu"): "shu", ("shi", "yo"): "sho",
    ("ji", "ya"): "ja", ("ji", "yu"): "ju", ("ji", "yo"): "jo",
}

_PUNCT_FOLD = {
    "。": ".", "、": ",", "！": "!", "？": "?", "・": ",", "「": "'",
    "」": "'", "『": "'", "』": "'", "…": "…", "ー": "ー", "．": ".",
    "，": ",",
}


def _kata_to_hira(ch: str) -> str:
    o = ord(ch)
    if 0x30A1 <= o <= 0x30F6:  # katakana -> hiragana block shift
        return chr(o - 0x60)
    return ch


def kana_to_romaji(text: str) -> List[str]:
    """Kana string -> romaji syllable list; non-kana chars pass through the
    punctuation fold or are dropped."""
    out: List[str] = []
    geminate = False
    i = 0
    chars = [_kata_to_hira(c) for c in text]
    while i < len(chars):
        ch = chars[i]
        if ch == "っ":
            geminate = True
            i += 1
            continue
        if ch == "ー":  # long vowel: extend previous syllable's vowel
            if out and out[-1][-1] in "aiueo":
                out[-1] += out[-1][-1]
            i += 1
            continue
        if ch == "ん":
            # moraic n attaches to the previous syllable (ko+n -> kon)
            if out and out[-1] not in PUNCTUATION and out[-1] != " ":
                out[-1] += "n"
            else:
                out.append("n")
            i += 1
            continue
        if ch in _BASE:
            syl = _BASE[ch]
            if i + 1 < len(chars) and chars[i + 1] in _DIGRAPH_SECOND:
                second = _DIGRAPH_SECOND[chars[i + 1]]
                syl = _CONTRACT.get((syl, second), syl[:-1] + second)
                i += 1
            if geminate:
                syl = syl[0] + syl
                geminate = False
            out.append(syl)
        elif ch in _PUNCT_FOLD and _PUNCT_FOLD[ch] in PUNCTUATION:
            out.append(_PUNCT_FOLD[ch])
        elif ch in PUNCTUATION:
            out.append(ch)
        elif ch.isascii() and ch.isalnum():
            # latin/digit run: accumulate into one word token
            j = i
            word = ""
            while j < len(chars) and chars[j].isascii() and chars[j].isalnum():
                word += chars[j].lower()
                j += 1
            out.append(word)
            i = j
            continue
        elif "一" <= ch <= "鿿":
            log.warning("japanese: no kanji reading backend; dropped %r", ch)
        i += 1
    return out


_kanji_backend: Optional[Callable[[str], str]] = None


def set_kanji_backend(fn: Callable[[str], str]):
    """Install a kanji->kana converter (e.g. pykakasi/openjtalk wrapper)."""
    global _kanji_backend
    _kanji_backend = fn


def text_normalize(text: str) -> str:
    text = re.sub(r"\s+", " ", text).strip()
    if _kanji_backend is not None:
        text = _kanji_backend(text)
    return text


def g2w(text: str) -> List[str]:
    return kana_to_romaji(text)
