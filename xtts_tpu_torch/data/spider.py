"""Podcast / corpus crawler interface (port of xtts_tpu/data/spider.py).

Reference: ttts/spider/ (selenium crawlers for player.fm and ximalaya,
and a plain downloader). The port makes no network call of its own: the
caller injects the site's listing function and the fetch function. The
URL bookkeeping, the resume after a crash and the download loop are
real.
"""
from __future__ import annotations

import json
import logging
import os
from typing import Callable, Iterable, List, Optional

log = logging.getLogger(__name__)

FetchFn = Callable[[str], bytes]
ListingFn = Callable[[str], List[str]]


def crawl_episode_urls(channel_urls: Iterable[str], out_jsonl: str,
                       listing_fn: Optional[ListingFn] = None) -> int:
    """Channel pages -> episode audio URLs, appended to a jsonl of
    {"channel", "url"} (ttts/spider/spider.py:1-30 walks player.fm pages
    with selenium; inject `listing_fn` per site). A channel whose listing
    fails is logged and skipped. Returns the URLs written."""
    if listing_fn is None:
        raise RuntimeError(
            "no listing backend: inject listing_fn(channel_url) -> "
            "[audio_urls] (the reference drives player.fm / ximalaya with "
            "selenium, ttts/spider/)")
    n = 0
    with open(out_jsonl, "a", encoding="utf-8") as f:
        for ch in channel_urls:
            try:
                urls = listing_fn(ch)
            except Exception as e:                 # noqa: BLE001 - logged
                log.warning("listing failed for %s: %s", ch, e)
                continue
            for u in urls:
                f.write(json.dumps({"channel": ch, "url": u}) + "\n")
                n += 1
    return n


def download_audio(url_jsonl: str, out_dir: str,
                   fetch_fn: Optional[FetchFn] = None,
                   skip_existing: bool = True) -> List[str]:
    """Download every URL of the jsonl through `fetch_fn(url) -> bytes`
    (ttts/spider/download.py: the file named after the URL's tail, resume
    by skipping files that exist). A failed fetch is logged and skipped.
    Returns the paths, in the jsonl's order."""
    if fetch_fn is None:
        raise RuntimeError("no fetch backend: inject fetch_fn(url) -> bytes")
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    with open(url_jsonl, encoding="utf-8") as f:
        records = [json.loads(line) for line in f if line.strip()]
    for rec in records:
        url = rec["url"]
        name = url.rstrip("/").split("/")[-1].split("?")[0] or "audio"
        path = os.path.join(out_dir, name)
        if skip_existing and os.path.exists(path):
            paths.append(path)
            continue
        try:
            data = fetch_fn(url)
        except Exception as e:                     # noqa: BLE001 - logged
            log.warning("download failed %s: %s", url, e)
            continue
        with open(path, "wb") as out:
            out.write(data)
        paths.append(path)
    return paths
