"""TextToSpeech — the zero-shot path (port of xtts_tpu/infer/api.py).

    text -> tokens -> GPT int8 AR codes          (infer/qdecode.py: K1 at
                                                  B=1, int8 or, with
                                                  XTTS_DECODE_BITS=4, int4;
                                                  K4 or the chain at B>1)
         -> [K > 1: CLVP rerank]                 (models/clvp.py)
         -> codes padded to a bucket -> teacher-forced GPT latent
         -> AA-diffusion with CFG                 (diffusion/gaussian.py,
            (spaced p / ddim / dpm++2m / unipc,     diffusion/solvers.py,
            or a continuous-time solver),           models/aa_diffusion.py, K2)
            the ReferenceNet hoisted, or every
            k-th step's features (refnet_interval)
         -> Vocos (iSTFT or IMDCT head) -> 24 kHz (models/vocos.py)
         or the shortcut: codes -> DVAE decode -> Vocos (models/dvae.py)
         or HiFi-GAN: latent -> HifiDecoder -> wav (models/hifigan.py)

Every TTSSettings knob of the JAX package is here except compact_rows
(compacting decode waves), which is not ported: CLVP reranking, the
shortcut and HiFi-GAN renders, batched sentences (infer/serving.py) and
continuous serving (infer/slots.py), the cache ladder, the int8-KV engines,
sentence streaming, the presets, multi-clip conditioning, per-row diffusion
noise, the speculative render, the sparse ReferenceNet hoist, text
bucketing on or off, and all ten sampler names; also
fix_autoregressive_output and from_pretrained.

Randomness comes from an explicit torch.Generator on the model's device;
one generator feeds the AR sampling and then the diffusion noise. The
render also takes one generator a row (slot serving's per-request noise).
"""
from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch

from xtts_tpu_torch.core.config import XTTSConfig
from xtts_tpu_torch.diffusion.gaussian import (SPACED_SAMPLERS,
                                               GaussianDiffusion, randn_rows)
from xtts_tpu_torch.dsp.mel import MelFrontend
from xtts_tpu_torch.infer.qdecode import (generate_speech_quantized,
                                          quantize_gpt_decode)
from xtts_tpu_torch.models.aa_diffusion import (AADiffusion,
                                                denormalize_tacotron_mel,
                                                nearest_resize_time,
                                                normalize_tacotron_mel)
from xtts_tpu_torch.models.clvp import CLVP
from xtts_tpu_torch.models.dvae import DVAE
from xtts_tpu_torch.models.gpt import UnifiedVoice
from xtts_tpu_torch.models.gpt_infer import GenerateResult, generate_speech
from xtts_tpu_torch.models.hifigan import HifiDecoder, hifigan_samples
from xtts_tpu_torch.models.vocos import Vocos
from xtts_tpu_torch.nn.blocks import init_flax_like
from xtts_tpu_torch.utils import convert
from xtts_tpu_torch.utils.registry import (MODELS, load_state,
                                           require_device)

log = logging.getLogger(__name__)


def bucket_len(n: int, buckets=(32, 64, 128, 256, 402)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def fix_autoregressive_output(codes: np.ndarray, stop_token: int,
                              complain: bool = True) -> np.ndarray:
    """Tortoise calm-token tail fix (ttts/api.py:82-109), on the host.

    Everything from the first stop token on becomes the tortoise DVAE's
    silence code (83), and the final three codes become the ones
    zero-padded audio ends with (45, 45, 248). The constants belong to the
    tortoise English DVAE; the live Mandarin path strips the last 2 codes
    and pads with the stop token instead, as tts_tokens does. Kept quirk:
    the reference guards the tail write with `stm - 3 < len(codes)`, which
    always holds, so the tail is written whenever a stop token exists, even
    over real codes when the stop comes within 3 of the end. Without a stop
    token the codes come back unchanged, with a printed complaint. 1-D int
    codes in; a copy of the same shape out."""
    codes = np.array(codes)
    (idx,) = np.nonzero(codes == stop_token)
    if idx.size == 0:
        if complain:
            print("No stop tokens found in one of the generated voice "
                  "clips. This typically means the spoken audio is too "
                  "long. In some cases, the output will still be good, "
                  "though. Listen to it and if it is missing words, try "
                  "breaking up your input text.")
        return codes
    stm = int(idx.min())
    codes[idx] = 83
    codes[stm:] = 83
    if stm - 3 < codes.shape[0]:  # reference quirk: always true
        codes[-3] = 45
        codes[-2] = 45
        codes[-1] = 248
    return codes


def hoist_plan(sampler: str, b: int, steps: int, refnet_interval: int = 1):
    """The ReferenceNet hoist of one render, as the JAX package decides it
    (api.py:592-603): (hoist, k, n_cached). Features are computed up front
    for every k-th spaced timestep, n_cached = ceil(steps / k) sets, when
    the sampler walks the spaced grid and b * n_cached <= 512;
    XTTS_HOIST_REF=1 / 0 forces the decision within the spaced samplers.
    The continuous-time solvers call the model at float times no table
    holds, so they never hoist and take k = 1."""
    ov = os.environ.get("XTTS_HOIST_REF")
    spaced = sampler in SPACED_SAMPLERS
    k = max(1, int(refnet_interval)) if spaced else 1
    n_cached = -(-steps // k)
    hoist = spaced and ((b * n_cached <= 512) if ov is None else ov == "1")
    return hoist, k, n_cached


def _jax_converters(c: XTTSConfig):
    """Module name -> (JAX variable tree -> the port's state dict)."""
    fams = {"gpt": "gpt", "dvae": "vqvae", "diffusion": "diffusion",
            "vocos": "vocos", "clvp": "clvp", "hifigan": "hifigan"}
    return {mod: (lambda t, f=fam: MODELS[f]["from_jax"](t, c))
            for mod, fam in fams.items()}


@dataclass
class TTSSettings:
    """The reference test.py knobs, and the serving knobs the slices use."""

    top_p: float = 0.8
    temperature: float = 0.8
    repetition_penalty: float = 2.0
    max_mel_tokens: int = 600
    diffusion_temperature: float = 1.0
    sampler: str = "p"              # live path: spaced-50 ancestral
    diffusion_steps: int = 50
    cond_free_k: float = 2.0
    # CLVP candidate reranking (ttts/api.py:397-460): K AR samples a text,
    # the best by contrastive score rendered. 1 = off (the test.py path).
    num_candidates: int = 1
    # segmented KV-cache capacity ladder, e.g. (64, 128, 256): the decode
    # runs against progressively larger caches (token-exact). "auto" takes
    # (128, 256) at >= 16 AR rows and one cache below, as the JAX package;
    # None / () = one cache.
    cache_ladder: Union[str, tuple, None] = "auto"
    # int8 KV cache for the quantized_decode engines: per-(position, head)
    # symmetric int8 K/V, scales folded into the scores and probabilities
    kv_quant: bool = False
    # stop-pad text tokens up to a bucket length (16, 32, ..., 256, the
    # cap), as the JAX package does; False keeps each sentence's length
    pad_text_to_bucket: bool = True
    # render at the max_mel_tokens cap's code bucket without reading the
    # generated length first: the lengths are read after the render is
    # queued. Equal to the default render when the generated length falls
    # in the cap's bucket; otherwise the render is larger and the attention
    # over the longer stop-padded tail can move the kept audio slightly.
    # B=1 diffusion renders only; ignored with use_hifigan, the shortcut
    # and return_intermediates.
    speculative_render: bool = False
    # sparse ReferenceNet hoist: k > 1 computes the ReferenceNet features
    # at every k-th spaced timestep up front and each denoise step reuses
    # the latest cached set (an approximation that brings the hoist back at
    # serving batch sizes, b * ceil(steps / k) <= 512). 1 = the reference's
    # semantics. Spaced samplers only.
    refnet_interval: int = 1

    @classmethod
    def preset(cls, name: str) -> "TTSSettings":
        """Tortoise-style presets (the JAX package's table, api.py:150-164).
        AR samples map to CLVP candidates (K > 1 needs with_clvp=True)."""
        table = {
            "ultra_fast": dict(num_candidates=1, diffusion_steps=15,
                               sampler="dpm++2m"),
            "fast": dict(num_candidates=4, diffusion_steps=25,
                         sampler="dpm++2m"),
            "standard": dict(num_candidates=8, diffusion_steps=50),
            "high_quality": dict(num_candidates=8, diffusion_steps=100),
        }
        if name not in table:
            raise KeyError(f"unknown preset {name!r}; have {sorted(table)}")
        return cls(**table[name])


class TextToSpeech:
    """Holds the GPT, DVAE, diffusion, vocoder (and CLVP) modules on one
    device: the card unless the caller passes device="cpu"."""

    def __init__(self, cfg: XTTSConfig = XTTSConfig(), device="cuda",
                 dtype=torch.float32, quantized_decode: bool = False,
                 with_clvp: bool = False, with_hifigan: bool = False,
                 generator: Optional[torch.Generator] = None,
                 init: bool = True, tokenizer=None):
        """quantized_decode: int8 weight-only AR engines (K1 at B=1, K4 or
        the per-layer chain at B > 1; XTTS_DECODE_BITS=4, read by
        requantize(), gives K1 the int4 stack). with_clvp: attach the CLVP
        reranker that num_candidates > 1 needs. with_hifigan: attach the
        HifiDecoder that use_hifigan renders through. init=False leaves the
        weights for from_jax / load_state_dict. tokenizer: a
        VoiceBpeTokenizer for tts() text framing (None: the shipped
        default; from_pretrained takes a tokenizer.json)."""
        self.device = require_device(device, "TextToSpeech")
        self.cfg = cfg
        self.dtype = dtype
        self.mel = MelFrontend(cfg.mel, self.device)
        self.gpt = UnifiedVoice(cfg.gpt, dtype).to(self.device).eval()
        self.dvae = DVAE(cfg.vqvae, dtype).to(self.device).eval()
        # K2 in the consumer attention (JAX's serving switch)
        self.diffusion = AADiffusion(cfg.diffusion, dtype,
                                     flash=True).to(self.device).eval()
        self.vocos = Vocos(cfg.vocos, dtype).to(self.device).eval()
        self.clvp = (CLVP(cfg.clvp, dtype).to(self.device).eval()
                     if with_clvp else None)
        self.hifigan = (HifiDecoder(cfg.hifigan, dtype).to(self.device).eval()
                        if with_hifigan else None)
        self._spk_mel = None
        self.quantized_decode = quantized_decode
        self.last_oov: Dict[str, int] = {}
        self.tokenizer = tokenizer
        self._qtree = None
        # place_on_mesh: the serving replicas, one a device; on a replica,
        # serving_replica leaves K1's B=1 stack out of its decode tree
        self.replicas = None
        self.serving_replica = False
        if init:
            self.init_random(generator)

    def modules(self):
        mods = {"gpt": self.gpt, "dvae": self.dvae,
                "diffusion": self.diffusion, "vocos": self.vocos}
        if self.clvp is not None:
            mods["clvp"] = self.clvp
        if self.hifigan is not None:
            mods["hifigan"] = self.hifigan
        return mods

    def requantize(self) -> None:
        """Rebuild the int8 decode tree and K1's weight stack from the
        current GPT weights; the stack is int4 if XTTS_DECODE_BITS=4 is set
        now (qdecode.attach_fused_stack)."""
        self._qtree = (quantize_gpt_decode(
            self.gpt, include_fused=not self.serving_replica)
                       if self.quantized_decode else None)

    @torch.no_grad()
    def place_on_mesh(self, devices) -> None:
        """Serve over several devices (xtts_tpu/infer/api.py:394-416): a
        replica of every model on each of `devices`, the mesh's data axis
        (a device may repeat). synthesize_batch then splits its rows across
        them. The replicas' int8 decode trees leave out K1's B=1 stack,
        which stays with this model, off the mesh, as in JAX. The devices
        are of this model's device type: a replica's draws start from the
        wave generator's state. Call after the weights load;
        place_on_mesh(None) drops the replicas."""
        if devices is None:
            self.replicas = None
            return
        if not len(devices):
            raise ValueError("place_on_mesh needs at least one device")
        kinds = {torch.device(d).type for d in devices}
        if kinds != {self.device.type}:
            raise ValueError(f"place_on_mesh: devices of {sorted(kinds)} for "
                             f"a model on {self.device.type}")
        reps = []
        for d in devices:
            r = TextToSpeech(self.cfg, device=d, dtype=self.dtype,
                             quantized_decode=self.quantized_decode,
                             with_clvp=self.clvp is not None,
                             with_hifigan=self.hifigan is not None,
                             init=False, tokenizer=self.tokenizer)
            for name, m in self.modules().items():
                r.modules()[name].load_state_dict(m.state_dict())
            r.serving_replica = True
            r.requantize()
            reps.append(r)
        self.replicas = reps

    @torch.no_grad()
    def init_random(self, generator: Optional[torch.Generator] = None):
        """Random weights from the flax modules' init distributions."""
        g = generator
        if g is None:
            g = torch.Generator(self.device).manual_seed(0)
        for m in self.modules().values():
            init_flax_like(m, g)
        self.requantize()

    @classmethod
    @torch.no_grad()
    def from_jax(cls, variables: Mapping[str, Any],
                 cfg: XTTSConfig = XTTSConfig(), **kw) -> "TextToSpeech":
        """Carry JAX variable trees into the port: "gpt", "diffusion" and
        "vocos" (flax variables dicts of arrays), and "dvae" (params and the
        codebook collection), "clvp" and "hifigan" where given; a module
        without a tree keeps random weights."""
        tts = cls(cfg, init=False, **kw)
        conv = _jax_converters(cfg)
        g = torch.Generator(tts.device).manual_seed(0)
        for name, m in tts.modules().items():
            if name in variables:
                m.load_state_dict(convert.to_torch(conv[name](
                    variables[name]), tts.device))
            else:
                init_flax_like(m, g)
        tts.requantize()
        return tts

    @classmethod
    @torch.no_grad()
    def from_pretrained(cls, model_dir: str,
                        cfg: Optional[XTTSConfig] = None,
                        **kw) -> "TextToSpeech":
        """Per-model weights from a directory (xtts_tpu/infer/api.py:277):
        an xtts_config.json there overrides `cfg`, a tokenizer.json becomes
        the tokenizer, and each of gpt, vqvae (or dvae), diffusion, vocos
        (and clvp / hifigan when enabled) loads from <name>.pth / .pt / .bin
        (a state dict under the reference's names, the port's own layout,
        or one wrapped as {"model": ...}; the Vocos heads' fixed window and
        twiddle buffers, which the port computes, are dropped) or
        <name>.npz (the JAX package's flat "a/b/c" tree,
        utils/registry.save_npz, carried as from_jax carries it). A model without a file keeps random weights, with a
        warning. The int8 decode tree is rebuilt from what was loaded."""
        cfg_path = os.path.join(model_dir, "xtts_config.json")
        if cfg is None:
            cfg = (XTTSConfig.from_json(cfg_path)
                   if os.path.exists(cfg_path) else XTTSConfig())
        tok_path = os.path.join(model_dir, "tokenizer.json")
        if "tokenizer" not in kw and os.path.exists(tok_path):
            from xtts_tpu_torch.text.tokenizer import VoiceBpeTokenizer
            kw["tokenizer"] = VoiceBpeTokenizer(tok_path)
        tts = cls(cfg, init=False, **kw)
        g = torch.Generator(tts.device).manual_seed(0)
        conv = _jax_converters(cfg)
        for key, m in tts.modules().items():
            stems = ("vqvae", "dvae") if key == "dvae" else (key,)
            hits = [os.path.join(model_dir, stem + ext) for stem in stems
                    for ext in (".npz", ".pth", ".pt", ".bin")
                    if os.path.exists(os.path.join(model_dir, stem + ext))]
            if not hits:
                log.warning("from_pretrained: no weights for %r in %s "
                            "(random init kept)", stems[0], model_dir)
                init_flax_like(m, g)
                continue
            path = hits[0]
            if path.endswith(".npz"):
                with np.load(path) as npz:
                    tree = convert.unflatten_npz(npz)
                sd = convert.to_torch(conv[key](tree), tts.device)
            else:
                sd = load_state(path, tts.device)
            m.load_state_dict(sd)
        tts.requantize()
        return tts

    # ------------------------------------------------------------------

    def _generator(self, seed: int = 0) -> torch.Generator:
        return torch.Generator(self.device).manual_seed(seed)

    def cond_mel_from_wav(self, wav) -> torch.Tensor:
        """Reference audio (T,) or (1, T) -> conditioning mel (1, mel, T')."""
        return self.mel(wav)

    def cond_mels_from_wavs(self, wavs) -> torch.Tensor:
        """Several reference clips -> stacked conditioning mels (1, n_clips,
        mel, T'). Every clip is zero-padded at its end to the longest one,
        so the mels stack on dim 1; get_conditioning then averages the
        per-clip encoder outputs (api.py:379-393)."""
        arrs = [np.asarray(w, np.float32).reshape(-1) for w in wavs]
        n = max(a.shape[0] for a in arrs)
        return torch.stack([self.mel(np.pad(a, (0, n - a.shape[0])))
                            for a in arrs], dim=1)

    def _cond_mel_from_cond(self, cond_wav) -> torch.Tensor:
        """One clip (array) -> (1, mel, T'); a list of clips -> the stacked
        (1, n_clips, mel, T') of cond_mels_from_wavs (one clip in a list
        takes the 3-D path)."""
        if isinstance(cond_wav, (list, tuple)):
            return (self.cond_mels_from_wavs(cond_wav) if len(cond_wav) > 1
                    else self.cond_mel_from_wav(cond_wav[0]))
        return self.cond_mel_from_wav(cond_wav)

    def _spk_mel16_from_cond(self, cond_wav) -> torch.Tensor:
        """The HiFi-GAN speaker mel of the first clip of a list (or of the
        one clip)."""
        first = (cond_wav[0] if isinstance(cond_wav, (list, tuple))
                 else cond_wav)
        return self.speaker_mel_from_wav(first)

    def cond_mel_bucketed(self, wav, bucket_seconds=(3.0, 6.0, 10.0)
                          ) -> torch.Tensor:
        """Reference clip -> conditioning mel at a shared length bucket: the
        clip is zero-padded up to the next bucket (or head-cropped to the
        last), so per-request voices of one serving batch stack on a common
        T (SynthesisRequest.cond_mel), as the reference pads or crops
        conditioning clips to one length (ttts/api.py:68-79)."""
        sr = self.cfg.mel.sample_rate
        w = np.asarray(wav, np.float32).reshape(-1)
        for sec in bucket_seconds:
            n = int(sec * sr)
            if len(w) <= n:
                return self.mel(np.pad(w, (0, n - len(w))))
        return self.mel(w[:int(bucket_seconds[-1] * sr)])

    def speaker_mel_from_wav(self, wav, bucket_seconds=(3.0, 6.0, 10.0)
                             ) -> torch.Tensor:
        """Reference clip at cfg.mel.sample_rate -> (1, T, 64) 16 kHz log-mel
        for the HiFi-GAN speaker encoder: resampled to 16 kHz, zero-padded
        up to a length bucket (cropped past the last), so per-request
        speaker mels of one batch share T (api.py:418-442)."""
        from xtts_tpu_torch.data.audio import resample
        from xtts_tpu_torch.dsp.mel import SPEAKER_ENCODER_MEL_CONFIG
        if self._spk_mel is None:
            self._spk_mel = MelFrontend(SPEAKER_ENCODER_MEL_CONFIG,
                                        self.device)
        sr16 = SPEAKER_ENCODER_MEL_CONFIG.sample_rate
        w = resample(np.asarray(wav, np.float32).reshape(-1),
                     self.cfg.mel.sample_rate, sr16)
        for sec in bucket_seconds:
            n = int(sec * sr16)
            if len(w) <= n:
                w = np.pad(w, (0, n - len(w)))
                break
        else:
            w = w[:int(bucket_seconds[-1] * sr16)]
        return self._spk_mel(w).transpose(1, 2)

    def _generate(self, cond, text, generator, settings: TTSSettings):
        """AR generation through the engine the JAX package would pick: K1
        at one row (quantized_decode); K4 with XTTS_FUSED_SERVING=1 at 8 or
        16 rows and no kv_quant; else the per-layer chain."""
        if settings.cache_ladder == "auto":
            ladder = (128, 256) if text.shape[0] >= 16 else None
        else:
            ladder = (tuple(settings.cache_ladder) if settings.cache_ladder
                      else None)
        kw = dict(max_gen=settings.max_mel_tokens, top_p=settings.top_p,
                  temperature=settings.temperature,
                  repetition_penalty=settings.repetition_penalty,
                  cache_ladder=ladder)
        if self._qtree is not None:
            b = cond.shape[0]
            fserv = (os.environ.get("XTTS_FUSED_SERVING") == "1"
                     and b in (8, 16) and not settings.kv_quant)
            return generate_speech_quantized(
                self.gpt, self._qtree, cond, text, generator,
                quantize_kv_cache=settings.kv_quant, use_fused_serving=fserv,
                use_fused=not self.serving_replica, **kw)
        if settings.kv_quant:
            raise ValueError("TTSSettings.kv_quant needs "
                             "TextToSpeech(quantized_decode=True)")
        return generate_speech(self.gpt, cond, text, generator, **kw)

    def _pad_codes(self, codes: torch.Tensor, ns: torch.Tensor,
                   n_b: int) -> torch.Tensor:
        """Rows keep their first ns[i] codes; the rest of the n_b bucket
        fills with the stop token (on the codes' device)."""
        stop = self.cfg.gpt.stop_mel_token
        if codes.shape[1] >= n_b:
            sliced = codes[:, :n_b]
        else:
            sliced = torch.nn.functional.pad(
                codes, (0, n_b - codes.shape[1]), value=stop)
        pos = torch.arange(n_b, device=codes.device)[None, :]
        return torch.where(pos < ns[:, None], sliced,
                           torch.full_like(sliced, stop))

    def _code_buckets(self):
        m = self.cfg.gpt.max_mel_tokens
        ladder = [64, 128, 192, 256, 320, 384, 448, 512]
        return tuple([b for b in ladder if b < m] + [m])

    @torch.no_grad()
    def _diffusion_mel_impl(self, latent, cond_mel_norm, generator,
                            temperature: float = 1.0, steps: int = 50,
                            sampler: str = "p", cond_free_k: float = 2.0,
                            noise: Optional[torch.Tensor] = None,
                            refnet_interval: int = 1):
        """latent (B, D, N) -> mel (B, mel, 4N): CLIP context hoisted, CFG
        batched into one 2B BaseModel pass per step, and the ReferenceNet
        features of every k-th spaced timestep (k = refnet_interval)
        computed up front in one batched call where hoist_plan admits it;
        each step then takes the set of its index // k, found on the
        device. noise: optional x_T (B, mel, 4N); else drawn from
        `generator` and scaled by `temperature`. generator: one
        torch.Generator, or one a row: each row's x_T and in-loop noise
        then come from its own (gaussian.randn_rows; JAX's per-row keys,
        api.py:633-641)."""
        gd = GaussianDiffusion.spaced(1000, steps,
                                      conditioning_free_k=cond_free_k)
        b, _, t_lat = latent.shape
        out_len = t_lat * 4
        shape = (b, self.cfg.diffusion.in_channels, out_len)
        dm = self.diffusion
        ctx = dm.encode_reference(cond_mel_norm)
        hint = nearest_resize_time(latent.transpose(1, 2),
                                   out_len).transpose(1, 2)
        uncond = dm.uncond_hint(b, out_len)
        tmap = torch.as_tensor(gd.timestep_map, device=latent.device)
        hoist, k, nc = hoist_plan(sampler, b, gd.num_timesteps,
                                  refnet_interval)
        control_all = None
        if hoist:
            sub = torch.arange(0, gd.num_timesteps, k, device=latent.device)
            t_all = tmap[sub].repeat_interleave(b)
            ca = dm.reference_features(cond_mel_norm.repeat(nc, 1, 1),
                                       t_all, ctx.repeat(nc, 1, 1))
            control_all = [c.reshape(nc, b, *c.shape[1:]) for c in ca]
        h2 = torch.cat([hint.to(uncond.dtype), uncond], dim=0)
        ctx2 = torch.cat([ctx, ctx], dim=0)

        def model_fn(x, t_orig):
            if control_all is not None:
                si = torch.searchsorted(tmap, t_orig[:1])   # stays on device
                control = [c.index_select(0, si // k)[0]
                           for c in control_all]
            else:
                control = dm.reference_features(cond_mel_norm, t_orig, ctx)
            out = dm.denoise(torch.cat([x, x], dim=0),
                             torch.cat([t_orig, t_orig], dim=0), h2, ctx2,
                             [torch.cat([c, c], dim=0) for c in control])
            return out[:b].float(), out[b:].float()

        if noise is None:
            noise = randn_rows(shape, generator, latent.device) * temperature
        mel = gd.sample_loop(model_fn, shape, generator, noise=noise,
                             sampler=sampler, device=latent.device)
        return denormalize_tacotron_mel(mel)[:, :, :out_len]

    @torch.no_grad()
    def _latent_and_mel(self, cond_mel, text_tokens, codes, lens, generator,
                        settings: TTSSettings, noise=None,
                        text_lens: Optional[torch.Tensor] = None):
        """Padded codes (B, n_b) -> teacher-forced latent (B, D, n_b) ->
        diffusion mel (B, mel, 4 n_b). text_lens: true text lengths
        (default: every row's full width)."""
        c = self.cfg
        if text_lens is None:
            text_lens = torch.full((text_tokens.shape[0],),
                                   text_tokens.shape[-1], device=self.device)
        latent = self.gpt(cond_mel, text_tokens, text_lens, codes,
                          lens * c.gpt.mel_length_compression,
                          return_latent=True).transpose(1, 2)
        # stacked clips (B, n_clips, mel, T): the ReferenceNet / CLIP refer
        # mel is the first clip (only the GPT conditioning averages)
        diff_cond = cond_mel if cond_mel.dim() == 3 else cond_mel[:, 0]
        mel = self._diffusion_mel_impl(
            latent, normalize_tacotron_mel(diff_cond),
            generator, settings.diffusion_temperature,
            steps=settings.diffusion_steps, sampler=settings.sampler,
            cond_free_k=settings.cond_free_k, noise=noise,
            refnet_interval=settings.refnet_interval)
        return latent, mel

    @torch.no_grad()
    def _render(self, cond_mel, text_tokens, codes, lens, generator,
                settings: TTSSettings, noise=None,
                text_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Padded codes (B, n_b) -> teacher-forced latent -> diffusion ->
        Vocos wav (B, 4 n_b hop)."""
        _, mel = self._latent_and_mel(cond_mel, text_tokens, codes, lens,
                                      generator, settings, noise=noise,
                                      text_lens=text_lens)
        return self.vocos(mel).float()

    @torch.no_grad()
    def _render_hifigan(self, cond_mel, text_tokens, codes, lens, spk_mel16,
                        text_lens: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
        """Padded codes (B, n_b) -> teacher-forced GPT latent -> HifiDecoder
        wav (B, hifigan_samples(n_b)), skipping diffusion and Vocos (the
        reference's latent -> HiFi-GAN path, hifigan_vocoder.py:744-756).
        spk_mel16 (1 or B, T, 64) from speaker_mel_from_wav."""
        if self.hifigan is None:
            raise ValueError("use_hifigan needs TextToSpeech(with_hifigan=True)")
        if spk_mel16 is None:
            raise ValueError("use_hifigan needs spk_mel16 "
                             "(speaker_mel_from_wav of the reference clip)")
        b = codes.shape[0]
        if text_lens is None:
            text_lens = torch.full((b,), text_tokens.shape[-1],
                                   device=self.device)
        spk = spk_mel16.to(self.device)
        if spk.shape[0] == 1 and b > 1:
            spk = spk.repeat(b, 1, 1)
        latent = self.gpt(cond_mel, text_tokens, text_lens, codes,
                          lens * self.cfg.gpt.mel_length_compression,
                          return_latent=True)
        return self.hifigan(latent, ref_mel16k=spk)

    @torch.no_grad()
    def _render_shortcut(self, codes: torch.Tensor):
        """The test.py:152-154 shortcut: codes -> DVAE decode -> Vocos.
        Returns (wav (B, 4 n_b hop), mel (B, mel, 4 n_b))."""
        mel, _ = self.dvae.decode(codes)
        return self.vocos(mel).float(), mel

    def _rerank_one(self, text: torch.Tensor, res: GenerateResult):
        """K candidate rows for one text -> the CLVP winner's row."""
        if self.clvp is None:
            raise ValueError("num_candidates > 1 needs "
                             "TextToSpeech(with_clvp=True)")
        code_mask = (torch.arange(res.codes.shape[1], device=self.device)
                     [None] < res.lengths[:, None]).long()
        scores = self.clvp.rerank(
            text, torch.clamp(res.codes, 0,
                              self.cfg.clvp.num_speech_tokens - 1), code_mask)
        best = int(torch.argmax(scores))
        return GenerateResult(res.codes[best:best + 1],
                              res.lengths[best:best + 1], res.steps)

    @torch.no_grad()
    def tts_tokens(self, text_tokens, cond_mel: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   settings: TTSSettings = TTSSettings(),
                   use_diffusion: bool = True, use_hifigan: bool = False,
                   spk_mel16: Optional[torch.Tensor] = None,
                   return_intermediates: bool = False) -> Dict[str, Any]:
        """Synthesize one text from prepared tokens. Returns a dict with
        'wav' (np.ndarray (1, n * 1024), or (1, hifigan_samples(n)) with
        use_hifigan), 'codes', 'lengths', 'steps' (AR decode iterations)
        and host-clock 'ar_seconds' / 'render_seconds'. num_candidates
        K > 1 draws K rows in one AR pass and renders the CLVP winner;
        use_diffusion=False renders through the DVAE shortcut; use_hifigan
        (with_hifigan=True, spk_mel16 from speaker_mel_from_wav) through
        the HifiDecoder. return_intermediates adds 'latent' (1, D, n) and
        'mel' (1, bins, 4n) as numpy (the diffusion's, or the shortcut's
        DVAE mel), the render run stage by stage.

        Timing: by default the generated length is read before the render
        (a device sync), so 'ar_seconds' ends with the AR and
        'render_seconds' is the render up to the wav on the host. With
        settings.speculative_render (diffusion renders, no intermediates)
        the render is queued at the cap's code bucket with no read in
        between: 'ar_seconds' then ends when the AR loop returns (its last
        host read of the done flags), and 'render_seconds' covers the
        queued render, the lengths read that waits for it, and the wav's
        copy to the host."""
        g = generator if generator is not None else self._generator(0)
        text = torch.as_tensor(np.asarray(text_tokens), dtype=torch.long,
                               device=self.device)
        if text.dim() == 1:
            text = text[None]
        if text.shape[0] != 1:
            raise ValueError("tts_tokens synthesizes one text")
        cond_mel = cond_mel.to(self.device)
        t0 = time.perf_counter()
        k = settings.num_candidates
        if k > 1:
            reps = (k,) + (1,) * (cond_mel.dim() - 1)
            res = self._rerank_one(text[0], self._generate(
                cond_mel.repeat(reps), text.repeat(k, 1), g, settings))
        else:
            res = self._generate(cond_mel, text, g, settings)
        spec = (settings.speculative_render and use_diffusion
                and not return_intermediates and not use_hifigan)
        if spec:
            # bucket by the cap: nothing is read before the render
            n_b = bucket_len(max(settings.max_mel_tokens - 2, 1),
                             self._code_buckets())
            n = None
        else:
            n = max(int(res.lengths[0]) - 2, 1)  # strip 2 (reference test.py)
            n_b = bucket_len(n, self._code_buckets())
        t1 = time.perf_counter()          # int() above synchronized
        lens = torch.clamp(res.lengths - 2, 1, n_b)
        codes = self._pad_codes(res.codes, lens, n_b)
        out: Dict[str, Any] = {}
        comp = self.cfg.vqvae.compression
        if use_hifigan:
            wav = self._render_hifigan(cond_mel, text, codes, lens, spk_mel16)
            keep = hifigan_samples(self.cfg.hifigan, n)
        else:
            if not use_diffusion:
                wav, mel = self._render_shortcut(codes)
                if return_intermediates:
                    out["mel"] = mel[:, :, :n * comp].float().cpu().numpy()
            elif return_intermediates:
                latent, mel = self._latent_and_mel(cond_mel, text, codes,
                                                   lens, g, settings)
                wav = self.vocos(mel).float()
                out["latent"] = latent[:, :, :n].float().cpu().numpy()
                out["mel"] = mel[:, :, :n * comp].float().cpu().numpy()
            else:
                wav = self._render(cond_mel, text, codes, lens, g, settings)
            if spec:
                # the render is queued; this read waits for it on the stream
                n = max(int(res.lengths[0]) - 2, 1)
            keep = n * comp * self.cfg.vocos.hop_length
        wav = wav[:, :keep].cpu().numpy()
        out.update({"wav": wav, "codes": res.codes.cpu().numpy(),
                    "lengths": res.lengths.cpu().numpy(), "steps": res.steps,
                    "ar_seconds": t1 - t0,
                    "render_seconds": time.perf_counter() - t1})
        return out

    def _text_to_token_lists(self, text: str, lang: str,
                             settings: TTSSettings):
        # the text frontend (jieba, tokenizers) loads only when text is given
        from xtts_tpu_torch.text.chinese import oov_stats
        from xtts_tpu_torch.text.frontend import (sentence_to_tokens,
                                                  split_sentences)
        token_lists = []
        oov_before = oov_stats()
        cap = self.cfg.gpt.max_text_tokens
        stop = self.cfg.gpt.stop_text_token
        for sent in split_sentences(text):
            tokens = sentence_to_tokens(
                sent, lang, tokenizer=self.tokenizer,
                start_token=self.cfg.gpt.start_text_token, stop_token=stop)
            if len(tokens) > cap:
                log.warning("sentence of %d tokens exceeds max_text_tokens="
                            "%d; truncating", len(tokens), cap)
                tokens = np.concatenate([tokens[:cap - 1],
                                         np.array([stop], np.int32)])
            if settings.pad_text_to_bucket:
                tb = bucket_len(len(tokens), (16, 32, 64, 128, 256, cap))
                tokens = np.pad(tokens, (0, max(0, tb - len(tokens))),
                                constant_values=stop)
            token_lists.append(tokens)
        oov_after = oov_stats()
        self.last_oov = {c: n - oov_before.get(c, 0)
                         for c, n in oov_after.items()
                         if n > oov_before.get(c, 0)}
        if self.last_oov:
            log.warning("g2p dropped %d hanzi with no reading this request: "
                        "%s", sum(self.last_oov.values()),
                        "".join(sorted(self.last_oov)))
        return token_lists

    def _split(self, generator: torch.Generator) -> torch.Generator:
        """A new generator on the model's device seeded from `generator`:
        one independent stream per sentence, as the JAX package splits its
        key per sentence."""
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                                 device=generator.device))
        return torch.Generator(self.device).manual_seed(seed)

    def stream_tokens(self, token_lists, cond_mel: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      settings: TTSSettings = TTSSettings(),
                      use_diffusion: bool = True, use_hifigan: bool = False,
                      spk_mel16: Optional[torch.Tensor] = None):
        """Generator over prepared sentences: yields tts_tokens' result for
        each, in order, as soon as it is rendered. Sentence i draws from the
        i-th generator split off `generator` (default seed 0)."""
        g = generator if generator is not None else self._generator(0)
        for tokens in token_lists:
            yield self.tts_tokens(tokens, cond_mel, self._split(g), settings,
                                  use_diffusion=use_diffusion,
                                  use_hifigan=use_hifigan,
                                  spk_mel16=spk_mel16)

    def tts_stream(self, text: str, cond_wav, generator=None,
                   settings: TTSSettings = TTSSettings(), lang: str = "ZH",
                   use_diffusion: bool = True, use_hifigan: bool = False):
        """Generator: each sentence's 24 kHz waveform as soon as it is
        rendered, so the time to first audio is one sentence's latency
        (api.py:859-880). np.concatenate(list(tts_stream(...))) equals
        tts(batch_sentences=False) with the same generator seed."""
        cond_mel = self._cond_mel_from_cond(cond_wav)
        spk = self._spk_mel16_from_cond(cond_wav) if use_hifigan else None
        for out in self.stream_tokens(
                self._text_to_token_lists(text, lang, settings), cond_mel,
                generator, settings, use_diffusion=use_diffusion,
                use_hifigan=use_hifigan, spk_mel16=spk):
            yield out["wav"][0]

    def tts(self, text: str, cond_wav, generator=None,
            settings: TTSSettings = TTSSettings(), lang: str = "ZH",
            use_diffusion: bool = True, batch_sentences: bool = True,
            use_hifigan: bool = False, aligner=None) -> np.ndarray:
        """Full text in, 24 kHz waveform out, sentence-split. With
        batch_sentences (the default) several sentences run as one batched
        AR pass and one render (infer/serving.synthesize_batch); otherwise
        one tts_tokens call per sentence, in order (tts_stream's sentences,
        concatenated). use_hifigan renders through the HifiDecoder
        (with_hifigan=True).

        aligner: a utils.alignment.Wav2VecAlignment. When given and `text`
        holds [bracketed] spans, the text is spoken without the brackets
        and the bracketed speech is then cut from the waveform by CTC
        forced alignment (the reference's redaction,
        ttts/api.py:180-181,536-540; xtts_tpu/infer/api.py:899-938)."""
        redact_text = None
        if aligner is not None and "[" in text:
            redact_text = text
            text = text.replace("[", "").replace("]", "")
        g = generator if generator is not None else self._generator(0)
        cond_mel = self._cond_mel_from_cond(cond_wav)
        token_lists = self._text_to_token_lists(text, lang, settings)
        if not token_lists:
            return np.zeros(0, np.float32)
        spk = self._spk_mel16_from_cond(cond_wav) if use_hifigan else None
        if batch_sentences and len(token_lists) > 1:
            from xtts_tpu_torch.infer.serving import (SynthesisRequest,
                                                      synthesize_batch)
            wavs = synthesize_batch(
                self, [SynthesisRequest(t) for t in token_lists], cond_mel,
                settings, use_diffusion=use_diffusion, generator=g,
                use_hifigan=use_hifigan, spk_mel16=spk)
        else:
            wavs = [out["wav"][0] for out in self.stream_tokens(
                token_lists, cond_mel, g, settings,
                use_diffusion=use_diffusion, use_hifigan=use_hifigan,
                spk_mel16=spk)]
        wav = np.concatenate(wavs)
        if redact_text is not None:
            return np.asarray(aligner.redact(wav, redact_text))
        return wav
