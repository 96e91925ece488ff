"""The port's configuration dataclasses.

They are the JAX package's framework-free configs (xtts_tpu/core/config.py,
which imports neither jax nor flax), re-exported so that the port and its
callers name only xtts_tpu_torch. No config is copied.
"""
from xtts_tpu.core.config import (CLIPRefConfig, DVAEConfig,
                                  DiffusionModelConfig, GPTConfig, MelConfig,
                                  VocosConfig, XTTSConfig)

__all__ = ["CLIPRefConfig", "DVAEConfig", "DiffusionModelConfig",
           "GPTConfig", "MelConfig", "VocosConfig", "XTTSConfig"]
