"""Language-dispatching text cleaner (reference: ttts/gpt/text/cleaner.py:7-11).

`clean_text(text, lang)` -> (normalized_text, tokens); tokens are the
whitespace-joinable units fed to the BPE as "[LANG] tok tok ...".
"""
from __future__ import annotations

from typing import List, Tuple

from xtts_tpu_torch.text import chinese, english, japanese

_MODULES = {"ZH": chinese, "EN": english, "JA": japanese, "JP": japanese}


def clean_text(text: str, language: str = "ZH") -> Tuple[str, List[str]]:
    try:
        mod = _MODULES[language.upper()]
    except KeyError:
        raise ValueError(
            f"unsupported language {language!r}; have {sorted(_MODULES)}")
    norm = mod.text_normalize(text)
    return norm, mod.g2w(norm)


# reference-compatible alias (cleaner.py:7 names it clean_text1)
clean_text1 = clean_text


def text_to_bpe_string(text: str, language: str = "ZH") -> str:
    """Full frontend: normalized token string ready for VoiceBpeTokenizer."""
    _, words = clean_text(text, language)
    return f"[{language.upper()}] " + " ".join(words)
