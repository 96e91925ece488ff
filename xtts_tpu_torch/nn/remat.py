"""Gradient checkpointing (rematerialization) policies (port of
xtts_tpu/nn/remat.py onto torch.utils.checkpoint).

The reference's HF GPT2 `gradient_checkpointing` flag
(ttts/gpt/model.py:257) as graded policies:

* "none"          — save all activations (no remat)
* "dots"          — save the matmul outputs (aten mm / addmm / bmm),
                    recompute the elementwise and norm chains
* "dots_no_batch" — save the batch-free matmul outputs only (mm / addmm,
                    not the attention's bmm)
* "full"          — save nothing inside the block; recompute it on the
                    backward pass

A policy applies only while gradients are recorded: inference runs the
block as it is.
"""
from __future__ import annotations

import functools

import torch

POLICIES = ("none", "dots", "dots_no_batch", "full")

_aten = torch.ops.aten
_SAVED = {"dots": (_aten.mm.default, _aten.addmm.default, _aten.bmm.default),
          "dots_no_batch": (_aten.mm.default, _aten.addmm.default)}


def checkpoint_policy(name: str):
    """A policy name -> the selective-checkpoint context factory
    (None: "none" and "full", which save all or nothing)."""
    if name in ("none", "full"):
        return None
    if name not in _SAVED:
        raise ValueError(f"unknown remat policy {name!r}; have {POLICIES}")
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)
    saved = _SAVED[name]

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return functools.partial(create_selective_checkpoint_contexts, policy)


def remat_call(module, policy: str, *args):
    """module(*args) under `policy` when gradients are recorded."""
    if policy in (None, "none") or not torch.is_grad_enabled():
        return module(*args)
    from torch.utils.checkpoint import checkpoint
    ctx = checkpoint_policy(policy)
    if ctx is None:
        return checkpoint(module, *args, use_reentrant=False)
    return checkpoint(module, *args, use_reentrant=False, context_fn=ctx)
