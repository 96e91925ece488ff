"""Random conditioning-latent generator, the tortoise path (port of
xtts_tpu/utils/latents.py).

Reference: ttts/utils/random_latent_generator.py:40 RandomLatentConverter,
which maps N(0, 1) noise through a small MLP to a stand-in conditioning
latent, used by the reference's api.py when no voice is given
(`get_random_conditioning_latents`). The noise comes from an explicit
torch.Generator.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from xtts_tpu_torch.nn.blocks import Linear


class RandomLatentConverter(nn.Module):
    """`layers` Linear(channels, channels), ReLU between them (fc.{i})."""

    def __init__(self, channels: int, layers: int = 5, dtype=torch.float32):
        super().__init__()
        self.channels = channels
        self.fc = nn.ModuleList([Linear(channels, channels, dtype=dtype)
                                 for _ in range(layers)])

    def forward(self, noise: torch.Tensor) -> torch.Tensor:
        x = noise
        for i, fc in enumerate(self.fc):
            x = fc(x)
            if i < len(self.fc) - 1:
                x = torch.relu(x)
        return x


@torch.no_grad()
def random_conditioning_latent(model: RandomLatentConverter,
                               generator: Optional[torch.Generator] = None,
                               batch: int = 1) -> torch.Tensor:
    """(batch, channels) latents from N(0, 1) noise drawn from `generator`
    (on its device; the model's device when None)."""
    dev = (generator.device if generator is not None
           else next(model.parameters()).device)
    noise = torch.randn((batch, model.channels), generator=generator,
                        device=dev)
    return model(noise.to(next(model.parameters()).device))
