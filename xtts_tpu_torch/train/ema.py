"""Exponential moving average of model weights (port of
xtts_tpu/train/ema.py; ttts/utils/utils.py:187-201)."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def ema_init(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """f32 copies of the parameters."""
    return {k: p.detach().float().clone() for k, p in params.items()}


@torch.no_grad()
def ema_update(ema_params: Dict[str, torch.Tensor],
               new_params: Dict[str, torch.Tensor],
               decay: float = 0.999) -> Dict[str, torch.Tensor]:
    """ema = decay * ema + (1 - decay) * new, in place (utils.py:199-201);
    decay and 1 - decay rounded to float32, as JAX takes them."""
    d = np.float32(decay)
    keep, take = float(d), float(np.float32(1.0) - d)
    for k, e in ema_params.items():
        e.copy_(e * keep + new_params[k].to(e.dtype) * take)
    return ema_params


def ema_warmup_decay(step: int, decay: float = 0.999) -> float:
    """A decay ramped from ~0, (1 + s) / (10 + s) capped at `decay`, in
    float32 as the JAX function computes it."""
    s = np.float32(step)
    return float(min(np.float32(decay),
                     (np.float32(1.0) + s) / (np.float32(10.0) + s)))
