"""Checkpoints with optimizer state, rotation and filtered restore (port of
xtts_tpu/core/checkpoint.py; torch.save in place of orbax).

The reference saves weights and step only (ttts/gpt/train_ms.py:131-140),
rotates keep-N (ttts/utils/utils.py:166-185) and restores module-filtered
(ttts/utils/checkpoint.py:64-103). Here the whole training state is saved
(parameters, optimizer moments and count, the state collections such as
the DVAE codebook buffers, the step), so resume is exact. Each checkpoint
is one `<directory>/<step>.pt`, written to a temporary file and moved into
place with os.replace, so a reader never sees half a file. A save copies
the tensors to the host at once and writes them on a background thread;
`wait` joins it.
"""
from __future__ import annotations

import os
import re
import threading
from typing import Any, Iterable, List, Optional

import torch

_NAME = re.compile(r"^(\d+)\.pt$")


def _to_host(tree):
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _place(loaded, target):
    """`loaded` (host tensors) in `target`'s structure, each tensor moved
    to its target's device and dtype after a shape check."""
    if target is None:
        return loaded
    if torch.is_tensor(target):
        if tuple(loaded.shape) != tuple(target.shape):
            raise ValueError(f"checkpoint shape {tuple(loaded.shape)} != "
                             f"{tuple(target.shape)}")
        return loaded.to(target.device, target.dtype)
    if isinstance(target, dict):
        missing = set(target) - set(loaded)
        if missing:
            raise KeyError(f"checkpoint lacks {sorted(missing)[:5]}")
        return {k: _place(loaded[k], v) for k, v in target.items()}
    return loaded


class CheckpointManager:
    """keep-N rotation of whole-state checkpoints in one directory."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: List[BaseException] = []

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{int(step)}.pt")

    def save(self, step: int, state: Any, wait: bool = False) -> bool:
        """Save `state` (nested dicts of tensors and numbers) as `step`;
        False when that step is already saved."""
        step = int(step)
        if step in self.all_steps():
            return False
        self.wait()
        host = _to_host(state)

        def write():
            try:
                tmp = self._path(step) + ".tmp"
                torch.save(host, tmp)
                os.replace(tmp, self._path(step))
                for old in self.all_steps()[:-self.keep or None]:
                    os.remove(self._path(old))
            except BaseException as e:   # re-raised by wait()
                self._error.append(e)

        self._thread = threading.Thread(target=write, daemon=True,
                                        name="checkpoint-write")
        self._thread.start()
        if wait:
            self.wait()
        return True

    def restore(self, step: Optional[int] = None, target: Any = None) -> Any:
        """Load `step` (default: the latest). With `target` (the same
        structure), each tensor lands on its target's device and dtype."""
        self.wait()
        step = int(step) if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        loaded = torch.load(self._path(step), map_location="cpu",
                            weights_only=True)
        return _place(loaded, target)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(
            _NAME.match, os.listdir(self.directory)) if m)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error:
            raise self._error.pop()

    def close(self) -> None:
        self.wait()


def flatten(tree, prefix: str = "", sep: str = ".") -> dict:
    """Nested dicts -> one dict of `sep`-joined names (a flat dict, such as
    a state dict, comes back as it is)."""
    flat = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat.update(flatten(v, f"{prefix}{k}{sep}", sep))
    else:
        flat[prefix[:-len(sep)]] = tree
    return flat


def filter_restore(restored_params: Any, init_params: Any,
                   include: Iterable[str] = (), exclude: Iterable[str] = ()
                   ) -> dict:
    """Module-filtered partial restore (ttts/utils/checkpoint.py:26-103),
    over the port's flat dotted names (nested dicts are flattened with
    "."). Returns init_params overlaid with the restored entries whose name
    matches any `include` regex (all, when empty) and no `exclude` regex;
    an entry whose shape differs stays from init, as the reference skips
    mismatches."""
    inc = [re.compile(p) for p in include]
    exc = [re.compile(p) for p in exclude]
    flat_init, flat_rest = flatten(init_params), flatten(restored_params)
    out = {}
    for path, leaf in flat_init.items():
        cand = flat_rest.get(path)
        use = cand is not None
        if use and inc:
            use = any(p.search(path) for p in inc)
        if use and any(p.search(path) for p in exc):
            use = False
        if use and hasattr(cand, "shape") and hasattr(leaf, "shape") \
                and tuple(cand.shape) != tuple(leaf.shape):
            use = False
        out[path] = cand if use else leaf
    return out
