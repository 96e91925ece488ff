"""English text frontend (reference: ttts/gpt/text/english.py:379-408).

The live reference path treats English minimally: normalize numbers/
abbreviations, then g2w = whitespace split + lowercase (full ARPAbet G2P in
the reference is dead code behind the unused `g2p` entry point).
"""
from __future__ import annotations

import re
from typing import List

_ABBREVIATIONS = [
    (re.compile(rf"\b{abbr}\.", re.IGNORECASE), full) for abbr, full in [
        ("mrs", "misess"), ("mr", "mister"), ("dr", "doctor"), ("st", "saint"),
        ("co", "company"), ("jr", "junior"), ("maj", "major"), ("gen", "general"),
        ("drs", "doctors"), ("rev", "reverend"), ("lt", "lieutenant"),
        ("hon", "honorable"), ("sgt", "sergeant"), ("capt", "captain"),
        ("esq", "esquire"), ("ltd", "limited"), ("col", "colonel"), ("ft", "fort"),
    ]
]

_UNITS = ["", "thousand", "million", "billion", "trillion"]
_ONES = ["", "one", "two", "three", "four", "five", "six", "seven", "eight",
         "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
         "sixteen", "seventeen", "eighteen", "nineteen"]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]


def _three(n: int) -> str:
    out = []
    if n >= 100:
        out.append(_ONES[n // 100] + " hundred")
        n %= 100
    if n >= 20:
        t = _TENS[n // 10]
        if n % 10:
            t += " " + _ONES[n % 10]
        out.append(t)
    elif n > 0:
        out.append(_ONES[n])
    return " ".join(out)


def number_to_words(n: int) -> str:
    if n == 0:
        return "zero"
    if n < 0:
        return "minus " + number_to_words(-n)
    parts = []
    group = 0
    while n > 0:
        g = n % 1000
        if g:
            unit = _UNITS[group]
            parts.append(_three(g) + (" " + unit if unit else ""))
        n //= 1000
        group += 1
    return " ".join(reversed(parts))


def _expand_number(m: re.Match) -> str:
    tok = m.group(0)
    if "." in tok:
        ip, fp = tok.split(".", 1)
        return (number_to_words(int(ip)) + " point "
                + " ".join(number_to_words(int(d)) for d in fp))
    return number_to_words(int(tok))


def text_normalize(text: str) -> str:
    for pat, repl in _ABBREVIATIONS:
        text = pat.sub(repl, text)
    text = re.sub(r"(\d+)%", lambda m: m.group(1) + " percent", text)
    text = re.sub(r"\$(\d+)", lambda m: m.group(1) + " dollars", text)
    text = re.sub(r"\d+(\.\d+)?", _expand_number, text)
    return text


def g2w(text: str) -> List[str]:
    """Whitespace-split lowercase words, punctuation stripped to retained set."""
    words = []
    for w in text.split():
        w = w.strip().lower()
        w = re.sub(r"[^a-z'!?,.…-]", "", w)
        if w:
            words.append(w)
    return words
