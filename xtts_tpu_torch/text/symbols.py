"""Symbol inventory for the text frontend.

The reference keeps the retained punctuation set plus phone symbols in
ttts/gpt/text/symbols.py:1-60. The live pipeline (ttts/gpt/text/chinese.py:228)
emits whole pinyin-syllable+tone tokens rather than phones, so only the
punctuation inventory matters downstream; the phone split (initial/final) is
still exposed from xtts_tpu_torch.text.pinyin for completeness.
"""

# Punctuation retained after normalization (everything else is mapped onto
# these or dropped; ttts/gpt/text/symbols.py:1 and chinese.py rep_map).
PUNCTUATION = ["!", "?", "…", ",", ".", "'", "-"]

PAD = "_"

# Sentence-final marks used for splitting long text into per-sentence AR calls
# (test.py:108-110 splits on Chinese punctuation above the model).
SENTENCE_SPLIT = "。！？!?.;；\n"
