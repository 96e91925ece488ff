"""Learning-rate schedules of the reference trainers (port of
xtts_tpu/train/schedules.py): plain functions of the step (counted from
0) that return a Python float, computed in float32 in the order of the JAX
expressions, so the rate of each update equals optax's.

* cosine with warmup and a min-lr floor: ttts/gpt/train_ms.py:45-59
* linear warmup: ttts/gpt/train.py:36-40
* exponential decay: ttts/vqvae/train_ms.py:80 (gamma 0.999875)
"""
from __future__ import annotations

import math

import numpy as np

_f = np.float32


def cosine_with_warmup(lr: float, warmup_steps: int, total_steps: int,
                       min_lr_ratio: float = 0.1):
    def fn(step):
        s = _f(step)
        warm = _f(lr) * min(s / _f(max(warmup_steps, 1)), _f(1.0))
        prog = np.clip((s - _f(warmup_steps))
                       / _f(max(total_steps - warmup_steps, 1)),
                       _f(0.0), _f(1.0))
        cos = _f(min_lr_ratio * lr) + _f((1 - min_lr_ratio) * lr * 0.5) * (
            _f(1.0) + np.cos(_f(math.pi) * prog))
        return float(warm if step < warmup_steps else cos)
    return fn


def linear_warmup(lr: float, warmup_steps: int):
    def fn(step):
        return float(_f(lr) * min((_f(step) + _f(1.0)) / _f(warmup_steps),
                                  _f(1.0)))
    return fn


def exponential(lr: float, gamma: float = 0.999875):
    def fn(step):
        return float(_f(lr) * _f(gamma) ** _f(step))
    return fn


def make_schedule(kind: str, lr: float, warmup_steps: int, total_steps: int,
                  min_lr_ratio: float = 0.1):
    if kind == "cosine":
        return cosine_with_warmup(lr, warmup_steps, total_steps, min_lr_ratio)
    if kind == "linear":
        return linear_warmup(lr, warmup_steps)
    if kind == "exponential":
        return exponential(lr)
    if kind == "constant":
        return lambda step: float(_f(lr))
    raise ValueError(kind)
