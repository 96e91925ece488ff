"""Timestep samplers for diffusion training (port of
xtts_tpu/diffusion/resample.py; reference ttts/utils/resample.py:9-188).

`UniformSampler` draws t uniformly. `LossSecondMomentResampler` draws t
with probability proportional to the RMS of the recent losses at each t
(uniform until every t holds a full history), and returns the weights
1 / (T p(t)) that de-bias the loss. Draws come from a torch.Generator, on
its device. The state is two tensors, a per-t ring buffer of losses and
its fill counts, which the Trainer keeps in its state columns
("t_sampler.history", "t_sampler.counts"), so checkpoints carry them.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


def _device(generator: Optional[torch.Generator], fallback) -> torch.device:
    return generator.device if generator is not None else torch.device(
        fallback)


class UniformSampler:
    def __init__(self, num_timesteps: int):
        self.num_timesteps = num_timesteps

    def sample(self, generator: Optional[torch.Generator], batch: int,
               device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
        """(t, weights of 1), drawn on the generator's device."""
        dev = _device(generator, device)
        t = torch.randint(0, self.num_timesteps, (batch,),
                          generator=generator, device=dev)
        return t, torch.ones((batch,), dtype=torch.float32, device=dev)


class LossAwareState(NamedTuple):
    """Per-timestep ring buffer of recent losses."""

    history: torch.Tensor    # (T, H) f32
    counts: torch.Tensor     # (T,) int32, entries written per t


class LossSecondMomentResampler:
    """p(t) proportional to sqrt(E[loss(t)^2]) with a uniform floor
    (resample.py:120-188: history 10 per t, uniform_prob 0.001)."""

    def __init__(self, num_timesteps: int, history_per_term: int = 10,
                 uniform_prob: float = 0.001):
        self.num_timesteps = num_timesteps
        self.history = history_per_term
        self.uniform_prob = uniform_prob

    def init_state(self, device="cpu") -> LossAwareState:
        return LossAwareState(
            torch.zeros((self.num_timesteps, self.history),
                        dtype=torch.float32, device=device),
            torch.zeros((self.num_timesteps,), dtype=torch.int32,
                        device=device))

    def weights(self, state: LossAwareState) -> torch.Tensor:
        """(T,) sampling distribution (resample.py:160-173)."""
        t_n = self.num_timesteps
        uniform = torch.full((t_n,), 1.0 / t_n, dtype=torch.float32,
                             device=state.history.device)
        sq = torch.sqrt(torch.mean(state.history ** 2, dim=-1))
        p = sq / torch.clamp(sq.sum(), min=1e-12)
        p = p * (1 - self.uniform_prob) + self.uniform_prob / t_n
        return torch.where((state.counts >= self.history).all(), p, uniform)

    def sample(self, generator: Optional[torch.Generator], batch: int,
               state: LossAwareState) -> Tuple[torch.Tensor, torch.Tensor]:
        """(t, importance weights 1 / (T p(t))), on the state's device; t
        is drawn on the generator's device."""
        p = self.weights(state)
        dev = _device(generator, p.device)
        t = torch.multinomial(p.to(dev), batch, replacement=True,
                              generator=generator).to(p.device)
        return t, 1.0 / (self.num_timesteps * p[t])

    @torch.no_grad()
    def update(self, state: LossAwareState, t: torch.Tensor,
               losses: torch.Tensor) -> LossAwareState:
        """Push per-example losses into the ring buffers. A t drawn twice
        in a batch keeps the last loss and counts twice (JAX's scatter, the
        reference's sequential loop)."""
        slot = (state.counts[t] % self.history).long()
        n = t.shape[0]
        later = ((t[None, :] == t[:, None])
                 & (torch.arange(n, device=t.device)[None, :]
                    > torch.arange(n, device=t.device)[:, None])).any(1)
        keep = ~later
        history = state.history.clone()
        history[t[keep], slot[keep]] = losses[keep].float()
        counts = state.counts.index_add(
            0, t, torch.ones_like(t, dtype=state.counts.dtype))
        return LossAwareState(history, counts)
