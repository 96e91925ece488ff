"""Hanyu-pinyin syllable machinery for the Mandarin G2P front-end.

Replaces the reference's pypinyin dependency (ttts/gpt/text/chinese.py:102-112
uses lazy_pinyin INITIALS / FINALS_TONE3 and then re-assembles written
syllables). Here the canonical unit IS the written syllable (e.g. "zhong",
"lv", "yuan"); tone is a trailing digit 1-5 (5 = neutral), matching the token
format the reference feeds its BPE ("ni3 hao3 ...", chinese.py:228).

Spelling conventions:
* j/q/x + u-umlaut written as ju/qu/xu (standard orthography)
* l/n + u-umlaut written with "v": lv, nv, lve, nve
* zero-initial forms written fully: yi/wu/yu/ya/wo/yuan/...

G2P resolution order per word:
1. pypinyin if importable (full coverage, tone3 style -> converted here)
2. built-in word lexicon (polyphone disambiguation)
3. built-in char lexicon (~2.6k most frequent characters, hand-curated)
4. trad->simp + NFKC compatibility folds onto (3)
5. 17k-char table derived from Unicode pinyin collation data
   (scripts/build_lexicon_ext.py; ~99% syllable-exact on holdout)
Unknown hanzi fall back to None and are dropped by the caller with a warning
plus per-call accounting (chinese.oov_stats, TextToSpeech.last_oov).
Measured coverage over jieba's 349k-entry frequency dictionary (the largest
in-image Chinese corpus): >99.9% frequency-weighted (tests/test_text.py).
"""
from __future__ import annotations

import re
from typing import List, Optional, Tuple

# ---------------------------------------------------------------------------
# Syllable inventory
# ---------------------------------------------------------------------------

# Initials, longest first so greedy prefix matching peels zh/ch/sh before z/c/s.
INITIALS = [
    "zh", "ch", "sh",
    "b", "p", "m", "f", "d", "t", "n", "l", "g", "k", "h",
    "j", "q", "x", "r", "z", "c", "s",
]

# initial -> finals it legally combines with (written forms). This is the
# standard Mandarin syllabary; assembled table rather than a flat list so the
# inventory stays reviewable.
_FINALS_BY_INITIAL = {
    "b": "a o ai ei ao an en ang eng i ie iao ian in ing u",
    "p": "a o ai ei ao ou an en ang eng i ie iao ian in ing u",
    "m": "a o e ai ei ao ou an en ang eng i ie iao iu ian in ing u",
    "f": "a o ei ou an en ang eng u",
    "d": "a e ai ei ao ou an en ang eng i ia ie iao iu ian ing u uo ui uan un ong",
    "t": "a e ai ei ao ou an ang eng i ie iao ian ing u uo ui uan un ong",
    "n": "a e ai ei ao ou an en ang eng i ie iao iu ian in iang ing u uo uan ong v ve",
    "l": "a o e ai ei ao ou an ang eng i ia ie iao iu ian in iang ing u uo uan un ong v ve",
    "g": "a e ai ei ao ou an en ang eng u ua uo uai ui uan un uang ong",
    "k": "a e ai ei ao ou an en ang eng u ua uo uai ui uan un uang ong",
    "h": "a e ai ei ao ou an en ang eng u ua uo uai ui uan un uang ong",
    "j": "i ia ie iao iu ian in iang ing iong u ue uan un",
    "q": "i ia ie iao iu ian in iang ing iong u ue uan un",
    "x": "i ia ie iao iu ian in iang ing iong u ue uan un",
    "zh": "a e i ai ei ao ou an en ang eng u ua uo uai ui uan un uang ong",
    "ch": "a e i ai ao ou an en ang eng u ua uo uai ui uan un uang ong",
    "sh": "a e i ai ei ao ou an en ang eng u ua uo uai ui uan un uang",
    "r": "e i ao ou an en ang eng u ua uo ui uan un ong",
    "z": "a e i ai ei ao ou an en ang eng u uo ui uan un ong",
    "c": "a e i ai ao ou an en ang eng u uo ui uan un ong",
    "s": "a e i ai ao ou an en ang eng u uo ui uan un ong",
}

# Zero-initial syllables (written forms).
_ZERO_INITIAL = (
    "a o e ai ei ao ou an en ang eng er "
    "yi ya yo ye yai yao you yan yin yang ying yong "
    "wu wa wo wai wei wan wen wang weng "
    "yu yue yuan yun"
).split()


def _build_inventory() -> set:
    syls = set(_ZERO_INITIAL)
    for ini, finals in _FINALS_BY_INITIAL.items():
        for fin in finals.split():
            syls.add(ini + fin)
    # l/n with bare u-umlaut
    syls.update({"lv", "nv"})
    # syllabic nasals & interjections seen in running text
    syls.update({"n", "ng", "m", "hm", "hng", "ei", "o"})
    return syls


VALID_SYLLABLES = _build_inventory()


def all_syllables() -> List[str]:
    """Sorted legal-syllable inventory (used to seed the default BPE)."""
    return sorted(VALID_SYLLABLES)


def split_initial_final(syllable: str) -> Tuple[str, str]:
    """'zhong' -> ('zh','ong'); 'an' -> ('','an'); 'lv' -> ('l','v')."""
    for ini in INITIALS:
        if syllable.startswith(ini) and len(syllable) > len(ini):
            return ini, syllable[len(ini):]
    return "", syllable


_TONE_RE = re.compile(r"^([a-z]+)([1-5])$")


def parse_toned(tok: str) -> Tuple[str, str]:
    """'hao3' -> ('hao','3'); raises on malformed input."""
    m = _TONE_RE.match(tok)
    if not m:
        raise ValueError(f"not a toned pinyin token: {tok!r}")
    return m.group(1), m.group(2)


def is_valid_toned(tok: str) -> bool:
    m = _TONE_RE.match(tok)
    return bool(m) and m.group(1) in VALID_SYLLABLES


# ---------------------------------------------------------------------------
# pypinyin tone3 -> written-syllable conversion
# ---------------------------------------------------------------------------

# pypinyin's FINALS/TONE3 styles expose underlying finals; written orthography
# contracts uei->ui, iou->iu, uen->un after an initial (chinese.py:199-205
# performs the same contraction on reference output).
_CONTRACTIONS = {"uei": "ui", "iou": "iu", "uen": "un"}

# Zero-initial underlying finals -> full written syllables (chinese.py:208-224
# rebuilds these; table here covers the complete set directly).
_ZERO_REWRITE = {
    "i": "yi", "ia": "ya", "ie": "ye", "iao": "yao", "iou": "you", "iu": "you",
    "ian": "yan", "in": "yin", "iang": "yang", "ing": "ying", "iong": "yong",
    "u": "wu", "ua": "wa", "uo": "wo", "uai": "wai", "uei": "wei", "ui": "wei",
    "uan": "wan", "uen": "wen", "un": "wen", "uang": "wang", "ueng": "weng",
    "v": "yu", "ve": "yue", "van": "yuan", "vn": "yun", "io": "yo",
}


def normalize_syllable(initial: str, final: str) -> str:
    """Map a pypinyin-style (initial, final) pair to the written syllable."""
    if not initial:
        return _ZERO_REWRITE.get(final, final)
    final = _CONTRACTIONS.get(final, final)
    if initial in ("j", "q", "x") and final and final[0] == "v":
        final = "u" + final[1:]  # jv->ju, jve->jue, jvan->juan, jvn->jun
    if initial in ("j", "q", "x") and final == "ue":
        pass  # already written form
    return initial + final


# ---------------------------------------------------------------------------
# G2P
# ---------------------------------------------------------------------------

try:  # optional full-coverage backend
    from pypinyin import Style, lazy_pinyin  # type: ignore

    _HAVE_PYPINYIN = True
except Exception:  # pragma: no cover - environment dependent
    _HAVE_PYPINYIN = False


def _pypinyin_word(word: str) -> List[Optional[str]]:
    inis = lazy_pinyin(word, neutral_tone_with_five=True, style=Style.INITIALS,
                       strict=True)
    fins = lazy_pinyin(word, neutral_tone_with_five=True,
                       style=Style.FINALS_TONE3, strict=True)
    out: List[Optional[str]] = []
    for ini, fin in zip(inis, fins):
        if not fin or not fin[-1].isdigit():
            out.append(None)
            continue
        syl = normalize_syllable(ini, fin[:-1])
        out.append(syl + fin[-1])
    return out


class G2P:
    """word -> [syllable+tone] with polyphone-aware lexicon fallback."""

    def __init__(self, prefer_pypinyin: bool = True):
        from xtts_tpu_torch.text.lexicon import CHAR_LEXICON, WORD_LEXICON
        self._chars = CHAR_LEXICON
        self._words = WORD_LEXICON
        self._ext = None  # lazy 17k-char derived table (lexicon_ext)
        self._use_pypinyin = prefer_pypinyin and _HAVE_PYPINYIN

    def __call__(self, word: str) -> List[Optional[str]]:
        if self._use_pypinyin:
            return _pypinyin_word(word)
        if word in self._words:
            return list(self._words[word])
        out: List[Optional[str]] = []
        i = 0
        while i < len(word):
            # longest-match word-lexicon lookup inside the segment handles
            # polyphones when jieba merges (e.g. sandhi pre-merge) words
            matched = False
            for j in range(min(len(word), i + 4), i + 1, -1):
                sub = word[i:j]
                if sub in self._words:
                    out.extend(self._words[sub])
                    i = j
                    matched = True
                    break
            if matched:
                continue
            ch = word[i]
            syl = self._chars.get(ch)
            if syl is None:
                # OOV fallback 1: traditional form of a known simplified
                # char (the reference normalizes via pypinyin's full table,
                # ttts/gpt/text/chinese.py:105-108; we map trad->simp)
                from xtts_tpu_torch.text.trad_simp_data import TRAD_TO_SIMP
                simp = TRAD_TO_SIMP.get(ch)
                if simp is not None:
                    syl = self._chars.get(simp)
            if syl is None:
                # OOV fallback 2: Unicode compatibility ideographs (U+F900+)
                # NFKC-fold onto their canonical CJK codepoint
                import unicodedata
                folded = unicodedata.normalize("NFKC", ch)
                if folded != ch:
                    syl = self._chars.get(folded)
                    if syl is None:
                        ch = folded  # let fallback 3 see the canonical char
            if syl is None:
                # OOV fallback 3: the 17k-char table derived from Unicode
                # pinyin collation data (scripts/build_lexicon_ext.py) —
                # ~99% syllable-exact on holdout; better than dropping.
                # Lazy import keeps the common path free of the 17k parse.
                if self._ext is None:
                    from xtts_tpu_torch.text.lexicon_ext import EXT_CHAR_LEXICON
                    self._ext = EXT_CHAR_LEXICON
                syl = self._ext.get(ch)
            out.append(syl)
            i += 1
        return out

    def coverage(self, text: str) -> float:
        """Fraction of hanzi in `text` the backend can voice (diagnostics)."""
        hanzi = [c for c in text if "一" <= c <= "龥"]
        if not hanzi:
            return 1.0
        got = [s for s in self("".join(hanzi)) if s is not None]
        return len(got) / len(hanzi)
