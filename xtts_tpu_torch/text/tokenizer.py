"""Voice BPE tokenizer (re-design of ttts/gpt/voice_tokenizer.py).

Wraps HuggingFace `tokenizers` BPE with the reference's conventions:
* spaces become the [SPACE] special before encoding (voice_tokenizer.py:46-48)
* decode strips [SPACE]/[START]/[STOP]/[UNK] framing (:50-57)
* trainer targets specials [START][STOP][UNK][SPACE][ZH][EN][JA]
  (voice_tokenizer.py:97-100); the shipped checkpoint uses the compact
  255-entry vocab matching GPT number_text_tokens=256.

A reference-format tokenizer JSON loads directly. When none is supplied,
`build_default_tokenizer()` trains an equivalent 255-token BPE over the full
legal pinyin-syllable inventory (xtts_tpu_torch/text/pinyin.py) so the stack is
usable out of the box.
"""
from __future__ import annotations

import os
import re
from typing import List, Optional


SPECIALS = ["[STOP]", "[UNK]", "[SPACE]", "[ZH]", "[EN]", "[JA]", "[START]"]

_REPLACEMENTS = {
    "{": "(", "}": ")", "[": "(", "]": ")", "`": "'", "—": "-", "ʼ": "'",
}


def remove_extraneous_punctuation(word: str) -> str:
    """voice_tokenizer.py:17-30."""
    pattern = re.compile("|".join(
        re.escape(k) for k in sorted(_REPLACEMENTS, key=len, reverse=True)))
    word = pattern.sub(lambda m: _REPLACEMENTS[m.group(0)], word)
    return re.sub(r"^[@#%_=\$\^&\*\+\\]$", "", word)


class VoiceBpeTokenizer:
    def __init__(self, vocab_file: Optional[str] = None,
                 tokenizer: Optional[Tokenizer] = None):
        if tokenizer is not None:
            self.tokenizer = tokenizer
        elif vocab_file is not None:
            from tokenizers import Tokenizer
            self.tokenizer = Tokenizer.from_file(vocab_file)
        else:
            self.tokenizer = build_default_tokenizer()

    def encode(self, txt: str) -> List[int]:
        txt = txt.replace(" ", "[SPACE]")
        return self.tokenizer.encode(txt).ids

    def decode(self, seq) -> str:
        seq = [int(s) for s in seq]
        txt = self.tokenizer.decode(seq, skip_special_tokens=False).replace(" ", "")
        txt = txt.replace("[SPACE]", " ")
        for sp in ("[START]", "[STOP]", "[UNK]"):
            txt = txt.replace(sp, "")
        return txt

    @property
    def vocab_size(self) -> int:
        return self.tokenizer.get_vocab_size()

    def save(self, path: str):
        self.tokenizer.save(path)


def train_tokenizer(lines, vocab_size: int = 255,
                    specials=tuple(SPECIALS)) -> Tokenizer:
    """BPE trainer with the reference's setup (voice_tokenizer.py:97-100)."""
    from tokenizers import Tokenizer
    from tokenizers.models import BPE
    from tokenizers.pre_tokenizers import Whitespace
    from tokenizers.trainers import BpeTrainer
    trainer = BpeTrainer(special_tokens=list(specials), vocab_size=vocab_size)
    tok = Tokenizer(BPE(unk_token="[UNK]"))
    tok.pre_tokenizer = Whitespace()
    tok.train_from_iterator(lines, trainer, length=None)
    return tok


_DEFAULT_CACHE = os.path.join(os.path.dirname(__file__), "default_tokenizer.json")


def build_default_tokenizer(force: bool = False) -> Tokenizer:
    """Train (once, cached to package data) a 255-token pinyin BPE over the
    legal syllable inventory with all five tones."""
    if not force and os.path.exists(_DEFAULT_CACHE):
        from tokenizers import Tokenizer
        return Tokenizer.from_file(_DEFAULT_CACHE)
    from xtts_tpu_torch.text.pinyin import all_syllables
    corpus = []
    syls = all_syllables()
    for s in syls:
        for tone in "12345":
            corpus.append(s + tone)
    # weight common syllable bigram context lightly so merges favour whole
    # syllables (matches the shipped vocab's merge pattern: an/ng/sh/ji...)
    lines = [" ".join(corpus)] * 4 + [" ".join(sorted(corpus))]
    tok = train_tokenizer(lines, vocab_size=255)
    try:
        tok.save(_DEFAULT_CACHE)
    except OSError:
        pass
    return tok
