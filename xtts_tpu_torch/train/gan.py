"""GAN training for the HiFi-GAN decoder (port of xtts_tpu/train/gan.py;
reference ttts/hifigan/losses.py:9-489 and train_ms.py:62-121).

Losses: the multi-resolution STFT loss (spectral convergence + log
magnitude L1 at three resolutions), LSGAN generator and discriminator
losses, and feature matching. `GANTrainer` takes one step as JAX's jitted
step does: the discriminator's update against the generator's output
(held fixed), then the generator's against the updated discriminator.
Each has its own clip-by-global-norm and AdamW(b1 0.8, b2 0.99, weight
decay 1e-4: optax.adamw's default), written out as the Trainer's
(train/trainer.py clip_adamw_), at a constant learning rate.

The generator's input is the frozen GPT's latent of the frozen DVAE's
codes (K3 on the card), computed once a step and used by both updates
(JAX's jit computes the same value in both of its calls).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from xtts_tpu_torch.dsp.spectral import stft
from xtts_tpu_torch.train.trainer import AdamWState, Trainer, clip_adamw_

GAN_B1, GAN_B2, GAN_WEIGHT_DECAY = 0.8, 0.99, 1e-4


def stft_magnitude(wav: torch.Tensor, n_fft: int, hop: int,
                   win: int) -> torch.Tensor:
    return stft(wav, n_fft, hop, win, magnitude=True, mag_eps=1e-9)


def stft_loss(y_hat: torch.Tensor, y: torch.Tensor, n_fft: int, hop: int,
              win: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(spectral convergence, log-magnitude L1) at one resolution."""
    s_hat = stft_magnitude(y_hat, n_fft, hop, win)
    s = stft_magnitude(y, n_fft, hop, win)
    sc = (torch.linalg.vector_norm(s - s_hat)
          / torch.clamp(torch.linalg.vector_norm(s), min=1e-8))
    mag = (torch.log(torch.clamp(s, min=1e-5))
           - torch.log(torch.clamp(s_hat, min=1e-5))).abs().mean()
    return sc, mag


def multi_scale_stft_loss(y_hat: torch.Tensor, y: torch.Tensor,
                          n_ffts=(1024, 2048, 512), hops=(120, 240, 50),
                          wins=(600, 1200, 240)) -> torch.Tensor:
    """The mean over the resolutions of sc + mag (the reference's three)."""
    total = 0.0
    for n_fft, hop, win in zip(n_ffts, hops, wins):
        sc, mag = stft_loss(y_hat, y, n_fft, hop, win)
        total = total + sc + mag
    return total / len(n_ffts)


def feature_matching_loss(feats_hat, feats_real) -> torch.Tensor:
    """Mean over every feature map of the mean L1 to the real one (held
    fixed)."""
    total, n = 0.0, 0
    for fh, fr in zip(feats_hat, feats_real):
        for a, b in zip(fh, fr):
            total = total + (a - b.detach()).abs().mean()
            n += 1
    return total / max(n, 1)


def generator_adv_loss(scores_hat: Sequence[torch.Tensor]) -> torch.Tensor:
    """LSGAN: mean over the discriminators of mean (D(G(z)) - 1)^2."""
    return sum(((s - 1.0) ** 2).mean() for s in scores_hat) / len(scores_hat)


def discriminator_adv_loss(scores_real: Sequence[torch.Tensor],
                           scores_fake: Sequence[torch.Tensor]
                           ) -> torch.Tensor:
    """LSGAN: mean over the discriminators of (D(x) - 1)^2 + D(G(z))^2."""
    total = 0.0
    for sr, sf in zip(scores_real, scores_fake):
        total = total + ((sr - 1.0) ** 2).mean() + (sf ** 2).mean()
    return total / len(scores_real)


@dataclass
class GANLossWeights:
    """ttts/hifigan/config.json loss weights."""

    stft: float = 45.0
    feat_match: float = 2.0
    adv: float = 1.0


@dataclass
class GANState:
    """The two parameter sets (the modules' own tensors, updated in place),
    their optimizer states and the step."""

    g_params: Dict[str, torch.Tensor]
    d_params: Dict[str, torch.Tensor]
    g_opt: AdamWState
    d_opt: AdamWState
    step: int


def make_hifigan_generator_fn(decoder, gpt, dvae):
    """The generator of the GAN: frozen DVAE codes (K3) -> the frozen GPT's
    latents, conditioned on the crop's own mel with four zero text ids ->
    the HifiDecoder's waveform, conditioned on ref_mel16k, cut or
    zero-padded to the crop and returned in f32 (the losses and the
    discriminators run in f32).

    batch: {'wav' (B, T), 'mel' (B, bins, F), 'refer_mel16' (B, T16, 64),
    'wav_length' (B,)}. gen_fn(batch, latent=None); gen_fn.latent_of(batch)
    is the frozen half alone, under no_grad."""

    @torch.no_grad()
    def latent_of(batch) -> torch.Tensor:
        mel = batch["mel"]
        b = mel.shape[0]
        codes = dvae.get_codebook_indices(mel)
        text = torch.zeros((b, 4), dtype=torch.long, device=mel.device)
        lens = torch.full((b,), 4, dtype=torch.long, device=mel.device)
        return gpt(mel, text, lens, codes, batch["wav_length"],
                   return_latent=True)

    def gen_fn(batch, latent: Optional[torch.Tensor] = None) -> torch.Tensor:
        if latent is None:
            latent = latent_of(batch)
        wav_hat = decoder(latent, ref_mel16k=batch["refer_mel16"])
        t = batch["wav"].shape[1]
        if wav_hat.shape[1] >= t:
            wav_hat = wav_hat[:, :t]
        else:
            wav_hat = torch.nn.functional.pad(wav_hat,
                                              (0, t - wav_hat.shape[1]))
        return wav_hat.float()

    gen_fn.latent_of = latent_of
    return gen_fn


def _grads(loss: torch.Tensor, params: Dict[str, torch.Tensor]):
    got = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params.values(), got)]


class GANTrainer:
    """generator: the trained decoder module; discriminator: the
    HifiganDiscriminator; gen_fn(batch, latent) -> fake wav (B, T) (see
    make_hifigan_generator_fn). The real wav is batch['wav']."""

    def __init__(self, generator: torch.nn.Module,
                 discriminator: torch.nn.Module, gen_fn: Callable,
                 g_lr: float = 2e-4, d_lr: float = 2e-4,
                 weights: GANLossWeights = GANLossWeights(),
                 grad_clip: float = 1.0,
                 stft_resolutions: Optional[Tuple[Sequence[int],
                                                  Sequence[int],
                                                  Sequence[int]]] = None):
        self.generator, self.disc, self.gen = generator, discriminator, gen_fn
        self.g_lr, self.d_lr = g_lr, d_lr
        self.weights = weights
        self.grad_clip = grad_clip
        # (n_ffts, hops, wins); None: the reference's three resolutions
        self.stft_resolutions = stft_resolutions

    def _stft_loss(self, y_hat, real):
        if self.stft_resolutions is None:
            return multi_scale_stft_loss(y_hat, real)
        n_ffts, hops, wins = self.stft_resolutions
        return multi_scale_stft_loss(y_hat, real, n_ffts=n_ffts, hops=hops,
                                     wins=wins)

    def init_state(self) -> GANState:
        g = {n: p for n, p in self.generator.named_parameters()
             if p.requires_grad}
        d = {n: p for n, p in self.disc.named_parameters()
             if p.requires_grad}
        return GANState(g, d, Trainer.init_opt_state(g),
                        Trainer.init_opt_state(d), 0)

    def _update(self, params, grads, opt, lr):
        return clip_adamw_(params, grads, opt, lr, self.grad_clip,
                           GAN_WEIGHT_DECAY, GAN_B1, GAN_B2)

    def d_step(self, state: GANState, batch, latent):
        """The discriminator's update against the generator's output (held
        fixed), in place. Returns (d_loss, unclipped norm, raw grads)."""
        with torch.no_grad():
            fake = self.gen(batch, latent)
        sr, _ = self.disc(batch["wav"])
        sf, _ = self.disc(fake)
        d_loss = discriminator_adv_loss(sr, sf)
        grads = _grads(d_loss, state.d_params)      # the update leaves them
        return d_loss.detach(), self._update(state.d_params, grads,
                                             state.d_opt, self.d_lr), grads

    def g_step(self, state: GANState, batch, latent):
        """The generator's update against the discriminator as it stands,
        in place. Returns (g_loss, its parts, unclipped norm, raw grads)."""
        real = batch["wav"]
        y_hat = self.gen(batch, latent)
        sf, ff = self.disc(y_hat)
        with torch.no_grad():
            _, fr = self.disc(real)
        adv = generator_adv_loss(sf)
        fm = feature_matching_loss(ff, fr)
        stft_l = self._stft_loss(y_hat, real)
        w = self.weights
        g_loss = w.adv * adv + w.feat_match * fm + w.stft * stft_l
        grads = _grads(g_loss, state.g_params)
        parts = {"g_adv": adv.detach(), "g_fm": fm.detach(),
                 "g_stft": stft_l.detach()}
        return (g_loss.detach(), parts,
                self._update(state.g_params, grads, state.g_opt, self.g_lr),
                grads)

    def step(self, state: GANState, batch):
        """One discriminator update, then one generator update against the
        updated discriminator; in place. The frozen latent is computed once
        for both. Returns (state, metrics): d_loss, g_loss, g_adv, g_fm,
        g_stft and both unclipped gradient norms."""
        latent = self.gen.latent_of(batch)
        d_loss, d_norm, _ = self.d_step(state, batch, latent)
        g_loss, parts, g_norm, _ = self.g_step(state, batch, latent)
        state.step += 1
        return state, {"d_loss": d_loss, "g_loss": g_loss, **parts,
                       "d_grad_norm": d_norm, "g_grad_norm": g_norm}

    # checkpoints: {g, d, g_opt, d_opt, step}, as JAX's CLI writes them

    @staticmethod
    def payload(state: GANState):
        opt = lambda o: {"count": o.count, "mu": o.mu, "nu": o.nu}
        return {"g": state.g_params, "d": state.d_params,
                "g_opt": opt(state.g_opt), "d_opt": opt(state.d_opt),
                "step": state.step}

    @staticmethod
    @torch.no_grad()
    def load_payload(state: GANState, out) -> GANState:
        """Copy a restored payload into `state`'s own tensors."""
        for group, key in ((state.g_params, "g"), (state.d_params, "d")):
            for k, v in group.items():
                v.copy_(out[key][k])
        for opt, key in ((state.g_opt, "g_opt"), (state.d_opt, "d_opt")):
            for k in opt.mu:
                opt.mu[k].copy_(out[key]["mu"][k])
                opt.nu[k].copy_(out[key]["nu"][k])
            opt.count = int(out[key]["count"])
        state.step = int(out["step"])
        return state
