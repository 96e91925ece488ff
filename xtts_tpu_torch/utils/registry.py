"""Model loader registry: a family name -> its module built from the config
and loaded with weights (port of xtts_tpu/utils/registry.py; the
reference's load_model, ttts/utils/infer_utils.py:12-45).

The port's modules carry the reference's torch names, so a `.pth` / `.pt`
/ `.bin` state dict loads as it is; a `.npz` holds the JAX package's flat
"a/b/c" tree (its registry.save_npz), carried by utils/convert.py's
*_from_jax converters. No weights: the flax-like random init from a
torch.Generator.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from xtts_tpu_torch.core.config import XTTSConfig
from xtts_tpu_torch.nn.blocks import init_flax_like
from xtts_tpu_torch.utils import convert

MODELS: Dict[str, Dict[str, Callable]] = {}


def register(name: str, build: Callable, from_jax: Callable) -> None:
    """build(cfg, dtype) -> module; from_jax(tree, cfg) -> state dict."""
    MODELS[name] = {"build": build, "from_jax": from_jax}


def _register_defaults() -> None:
    from xtts_tpu_torch.models.aa_diffusion import AADiffusion
    from xtts_tpu_torch.models.classifier import AudioClassifier
    from xtts_tpu_torch.models.clvp import CLVP
    from xtts_tpu_torch.models.diffusion_tts import DiffusionTts
    from xtts_tpu_torch.models.dvae import DVAE
    from xtts_tpu_torch.models.gpt import UnifiedVoice
    from xtts_tpu_torch.models.hifigan import HifiDecoder
    from xtts_tpu_torch.models.hifigan_discriminator import (
        HifiganDiscriminator)
    from xtts_tpu_torch.models.vocos import Vocos

    register("gpt", lambda cfg, dt: UnifiedVoice(cfg.gpt, dt),
             lambda t, cfg: convert.unified_voice_from_jax(
                 t, cfg.gpt.layers, cfg.gpt.cond_attn_blocks))
    register("vqvae", lambda cfg, dt: DVAE(cfg.vqvae, dt),
             lambda t, cfg: convert.dvae_from_jax(
                 t, cfg.vqvae.num_layers, cfg.vqvae.num_resnet_blocks))
    register("diffusion", lambda cfg, dt: AADiffusion(cfg.diffusion, dt),
             lambda t, cfg: convert.aa_diffusion_from_jax(t, cfg.diffusion))
    register("vocos", lambda cfg, dt: Vocos(cfg.vocos, dt),
             lambda t, cfg: convert.vocos_from_jax(t, cfg.vocos.num_layers))
    register("clvp", lambda cfg, dt: CLVP(cfg.clvp, dt),
             lambda t, cfg: convert.clvp_from_jax(t, cfg.clvp))
    register("hifigan", lambda cfg, dt: HifiDecoder(cfg.hifigan, dt),
             lambda t, cfg: convert.hifigan_from_jax(t, cfg.hifigan))
    register("classifier",
             lambda cfg, dt: AudioClassifier(cfg.classifier, dt),
             lambda t, cfg: convert.classifier_from_jax(t, cfg.classifier))
    # the legacy tortoise denoiser (ttts/diffusion/model.py:134-341, built by
    # the reference api.py:200) with the reference ctor's defaults, as JAX's
    # registry builds it
    register("diffusion_tts", lambda cfg, dt: DiffusionTts(dtype=dt),
             lambda t, cfg: convert.diffusion_tts_from_jax(t))
    # the GAN trainer's discriminator (JAX builds it outside its registry)
    register("hifigan_discriminator",
             lambda cfg, dt: HifiganDiscriminator(dtype=dt),
             lambda t, cfg: convert.hifigan_discriminator_from_jax(t))


_register_defaults()


def require_device(device, who: str) -> torch.device:
    """`device` as a torch.device; a CUDA device without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who} runs on the card by default and no CUDA "
                           f"card is available; pass device='cpu' to run on "
                           f"the CPU")
    return device


def load_state(path: str, device) -> Dict[str, torch.Tensor]:
    """A torch state dict (or one wrapped as {"model": ...}), without the
    fixed buffers the port computes itself."""
    sd = torch.load(path, map_location=device, weights_only=True)
    if isinstance(sd.get("model"), dict):
        sd = sd["model"]
    return convert.drop_fixed_buffers(sd)


@torch.no_grad()
def load_model(name: str, cfg: XTTSConfig = XTTSConfig(),
               weights_path: Optional[str] = None, dtype=torch.float32,
               device="cuda",
               generator: Optional[torch.Generator] = None
               ) -> torch.nn.Module:
    """Build family `name` on `device` (the card unless the caller asks for
    the CPU). weights_path: None -> the flax-like random init (from
    `generator`, else seed 0); '*.pth' / '*.pt' / '*.bin' -> a state dict
    under the reference's names; '*.npz' -> the JAX package's flat tree."""
    if name not in MODELS:
        raise KeyError(f"unknown model {name!r}; have {sorted(MODELS)}")
    device = require_device(device, "load_model")
    entry = MODELS[name]
    model = entry["build"](cfg, dtype).to(device)
    if weights_path is None:
        g = generator or torch.Generator(device).manual_seed(0)
        init_flax_like(model, g)
    elif weights_path.endswith(".npz"):
        with np.load(weights_path) as npz:
            tree = convert.unflatten_npz(npz)
        model.load_state_dict(convert.to_torch(entry["from_jax"](tree, cfg),
                                               device))
    elif weights_path.endswith((".pth", ".pt", ".bin")):
        model.load_state_dict(load_state(weights_path, device))
    else:
        raise ValueError(f"unsupported weights format: {weights_path}")
    return model


def save_npz(path: str, tree: Any) -> None:
    """Flatten a nested dict of arrays or tensors to an npz of "a/b/c"
    keys (the JAX package's layout: pass a DVAE's whole variables, its
    "codebook" collection included)."""
    flat = {}

    def rec(t, prefix=""):
        if isinstance(t, dict):
            for k, v in t.items():
                rec(v, f"{prefix}{k}/")
        else:
            flat[prefix.rstrip("/")] = (t.detach().cpu().numpy()
                                        if torch.is_tensor(t)
                                        else np.asarray(t))

    rec(tree)
    np.savez(path, **flat)


unflatten_npz = convert.unflatten_npz
