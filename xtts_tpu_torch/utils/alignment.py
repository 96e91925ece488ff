"""CTC forced alignment for bracket redaction, the tortoise path (port of
xtts_tpu/utils/alignment.py; numpy, no framework).

Reference: ttts/utils/wav2vec_alignment.py:7-146 aligns generated audio
against its text with a wav2vec2-CTC model, so that bracketed spans
("[I am really sad,] Please feed me.") can be cut from the waveform
(api.py:180-181,536-540). Semantics as there:

* `max_alignment`: DP character alignment of the expected text onto the
  CTC-decoded prediction, '~' for characters the model never emitted
  (:7-42; on equal scores the expected character is skipped), bottom-up
  instead of the memoized recursion;
* `Wav2VecAlignment.align`: per-character sample offsets: walk the greedy
  CTC path, record the first frame emitting each expected token, mark '~'
  positions -1 and interpolate them linearly afterwards (:56-125);
* `Wav2VecAlignment.redact`: split on brackets, align the bare text and
  concatenate the audio of the kept [start, stop) character intervals
  (:127-146).

No wav2vec2 weights ship with the port: the CTC model and its tokenizer
are injected as callables (model_fn, encode, decode).
"""
from __future__ import annotations

import re
from typing import Callable, List, Sequence, Tuple

import numpy as np


def max_alignment(s1: str, s2: str, skip_character: str = "~") -> str:
    """Align s1 onto s2 keeping order; unmatched s1 chars become '~'.

    Bottom-up DP equivalent of ttts/utils/wav2vec_alignment.py:7-42:
    score[i][j] = max chars of s1[i:] matchable inside s2[j:]; equal first
    chars always match; on score ties the s1 char is skipped (the reference
    recursion prefers `take_s2` on ties).
    """
    assert skip_character not in s1, (
        f"Found the skip character {skip_character} in the provided string, "
        f"{s1}")
    n, m = len(s1), len(s2)
    # score[i][j] for i in 0..n, j in 0..m
    score = np.zeros((n + 1, m + 1), np.int32)
    for i in range(n - 1, -1, -1):
        for j in range(m - 1, -1, -1):
            if s1[i] == s2[j]:
                score[i][j] = 1 + score[i + 1][j + 1]
            else:
                score[i][j] = max(score[i][j + 1], score[i + 1][j])
    out = []
    i = j = 0
    while i < n:
        if j >= m:
            out.append(skip_character)
            i += 1
        elif s1[i] == s2[j]:
            out.append(s1[i])
            i += 1
            j += 1
        elif score[i][j + 1] > score[i + 1][j]:   # ties -> skip s1[i]
            j += 1
        else:
            out.append(skip_character)
            i += 1
    return "".join(out)


def find_redactions(text: str) -> Tuple[str, List[Tuple[int, int]]]:
    """Strip [bracketed] spans; return (clean_text, spans as char ranges in
    the CLEAN text marking where redacted material bordered)."""
    spans = []
    out = ""
    for m in re.finditer(r"\[([^\]]*)\]|([^\[\]]+)", text):
        if m.group(1) is not None:
            spans.append((len(out), len(out)))
        else:
            out += m.group(2)
    return out, spans


def align_from_logits(logits: np.ndarray, token_ids: List[int],
                      blank_id: int = 0) -> List[int]:
    """Monotonic greedy CTC alignment: for each target token, the frame index
    where it is first emitted (argmax path restricted to the target order).

    logits: (T_frames, vocab). A simplified single-pass mapper kept for the
    lightweight API; the reference-exact per-character path is
    `Wav2VecAlignment.align`.
    """
    path = logits.argmax(-1)
    frames: List[int] = []
    ti = 0
    for f, p in enumerate(path):
        if ti >= len(token_ids):
            break
        if p == token_ids[ti]:
            frames.append(f)
            ti += 1
    # unmatched tail tokens: clamp to last frame
    while len(frames) < len(token_ids):
        frames.append(len(path) - 1)
    return frames


class Wav2VecAlignment:
    """Audio/text alignment via a CTC model (wav2vec_alignment.py:45-146).

    model_fn: wav (T,) float32 (at the model's rate) -> (frames, vocab) CTC
    logits. encode / decode: the CTC tokenizer pair; encode returns one id
    per character (the reference's tacotron-symbols character tokenizer),
    decode collapses a greedy id path to text.
    """

    def __init__(self, model_fn: Callable[[np.ndarray], np.ndarray],
                 encode: Callable[[str], List[int]],
                 decode: Callable[[Sequence[int]], str],
                 sample_rate: int = 16000):
        """model_fn: a CTC model, e.g. a local Wav2Vec2ForCTC wrapped as
        wav -> logits[0] after the reference's per-clip normalisation
        ((w - mean) / sqrt(var + 1e-7), wav2vec_alignment.py:64-66);
        encode / decode: its character tokenizer."""
        if model_fn is None or encode is None or decode is None:
            raise RuntimeError(
                "Wav2VecAlignment needs (model_fn, encode, decode): no "
                "wav2vec2 weights ship with the port (the reference loads "
                "jbetker/wav2vec2-large-robust-ft-libritts-voxpopuli, "
                "ttts/utils/wav2vec_alignment.py:48-56)")
        self.sample_rate = sample_rate
        self._fn = model_fn
        self._encode = encode
        self._decode = decode

    # ------------------------------------------------------------------

    def align(self, wav: np.ndarray, expected_text: str) -> List[int]:
        """Per-character sample offsets into `wav` (reference :56-125).

        Returns a list of len(expected_text) sample positions; characters
        the CTC model never emitted are linearly interpolated.
        """
        wav = np.asarray(wav, np.float32)
        orig_len = len(wav)
        logits = np.asarray(self._fn(wav))
        path = logits.argmax(-1)
        pred_string = self._decode(path.tolist())

        fixed = max_alignment(expected_text.lower(), pred_string)
        w2v_compression = orig_len // len(logits)
        expected_tokens = list(self._encode(fixed))
        expected_chars = list(fixed)
        if len(expected_tokens) == 1:
            return [0]
        # first char is anchored at sample 0
        expected_tokens.pop(0)
        expected_chars.pop(0)

        alignments = [0]

        def pop_next():
            """Advance past '~' chars (appending -1 markers) to the next
            real expected token (reference pop_till_you_win :82-94)."""
            while expected_tokens:
                tok = expected_tokens.pop(0)
                ch = expected_chars.pop(0)
                if ch != "~":
                    return tok
                alignments.append(-1)
            return None

        nxt = pop_next()
        for i, top in enumerate(path):
            if nxt is None:
                break
            if top == nxt:
                alignments.append(i * w2v_compression)
                if expected_tokens:
                    nxt = pop_next()
                else:
                    break
        pop_next()   # drain trailing '~' markers (reference :103)
        if not (len(expected_tokens) == 0
                and len(alignments) == len(expected_text)):
            raise RuntimeError(
                f"alignment failed: {len(alignments)} offsets for "
                f"{len(expected_text)} characters, {len(expected_tokens)} "
                f"tokens unmatched (text={expected_text!r})")

        # interpolate -1 runs between anchored neighbours (reference :108-123)
        alignments.append(orig_len)
        for i in range(len(alignments)):
            if alignments[i] == -1:
                for j in range(i + 1, len(alignments)):
                    if alignments[j] != -1:
                        nf = j
                        break
                for j in range(i, nf):
                    gap = alignments[nf] - alignments[i - 1]
                    alignments[j] = ((j - i + 1) * gap // (nf - i + 1)
                                     + alignments[i - 1])
        return alignments[:-1]

    def redact(self, wav: np.ndarray, expected_text: str) -> np.ndarray:
        """Excise the audio of [bracketed] spans (reference :127-146): keep
        and concatenate the aligned non-redacted character intervals."""
        if "[" not in expected_text:
            return wav
        splitted = expected_text.split("[")
        fully_split = [splitted[0]]
        for spl in splitted[1:]:
            assert "]" in spl, (
                'Every "[" character must be paired with a "]" with no '
                "nesting.")
            fully_split.extend(spl.split("]"))

        # even indices = keep, odd = redact
        non_redacted = []
        last = 0
        for i, piece in enumerate(fully_split):
            if i % 2 == 0 and piece != "":
                non_redacted.append((last, max(0, last + len(piece) - 1)))
            last += len(piece)

        bare = "".join(fully_split)
        offsets = self.align(wav, bare)
        wav = np.asarray(wav)
        out = [wav[offsets[s]:offsets[e]] for s, e in non_redacted]
        return np.concatenate(out) if out else wav[:0]
