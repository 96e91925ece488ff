"""Bulk file-operation harness.

Reference: ttts/script/do_to_files.py (thread-pool map of a shell/python op
over a file list, with progress + error collection). Used by the prepare
pipeline for embarrassingly parallel host work (mel caching, VAD, filters).
"""
from __future__ import annotations

import concurrent.futures as cf
import logging
from typing import Callable, List, Sequence, Tuple, TypeVar

log = logging.getLogger(__name__)

T = TypeVar("T")
R = TypeVar("R")


def do_to_files(items: Sequence[T], fn: Callable[[T], R],
                max_workers: int = 8,
                on_error: str = "collect") -> Tuple[List[R], List[Tuple[T, Exception]]]:
    """Apply `fn` to every item on a thread pool.

    on_error: 'collect' (default) returns failures alongside results;
    'raise' re-raises the first failure.
    Returns (results in input order (None for failed), failures).
    """
    results: List = [None] * len(items)
    failures: List[Tuple[T, Exception]] = []
    with cf.ThreadPoolExecutor(max_workers=max_workers) as ex:
        futs = {ex.submit(fn, it): i for i, it in enumerate(items)}
        for fut in cf.as_completed(futs):
            i = futs[fut]
            try:
                results[i] = fut.result()
            except Exception as e:
                if on_error == "raise":
                    raise
                failures.append((items[i], e))
                log.warning("do_to_files: %r failed: %s", items[i], e)
    return results, failures


def corpus_duration(paths: Sequence[str], max_workers: int = 8):
    """Total duration of a WAV corpus in seconds + a HH:MM:SS.cc string
    (ttts/spider/duration_calc.sh semantics: sum per-file durations and
    pretty-print; that script shells out to ffprobe over mp3s — here we
    read WAV headers directly, the only audio container in this image).

    Returns (total_seconds, "HH:MM:SS.cc", failures) where failures is the
    do_to_files (path, exc) list for unreadable files.
    """
    import contextlib
    import wave

    def one(path: str) -> float:
        with contextlib.closing(wave.open(path, "rb")) as w:
            return w.getnframes() / float(w.getframerate())

    durs, failures = do_to_files(list(paths), one, max_workers=max_workers)
    total = float(sum(d for d in durs if d is not None))
    t = int(total)
    frac = int(round((total - t) * 100))
    pretty = f"{t // 3600:02d}:{t % 3600 // 60:02d}:{t % 60:02d}.{frac:02d}"
    return total, pretty, failures
