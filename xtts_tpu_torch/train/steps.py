"""Per-family loss functions for the Trainer (port of the vqvae and gpt
halves of xtts_tpu/train/steps.py).

* DVAE: smooth_l1 + 0.5 SSIM + 0.25 commitment, and the EMA codebook
  update computed from the batch under the old codebook
  (ttts/vqvae/train_ms.py:163-166, ttts/gpt/config.json "vqvae");
* GPT: 0.01 text CE + 1.0 mel CE over the codes of a frozen f32 DVAE
  (ttts/gpt/train_ms.py:216-222).

Each returns `loss_fn(batch, generator) -> (loss, aux)`. The nearest-code
search of both is K3 on the card: the DVAE's own quantizer, and the frozen
DVAE that turns target mels into the GPT's targets.
"""
from __future__ import annotations

from typing import Optional

import torch

from xtts_tpu_torch.models.dvae import (DVAE, BalanceState, balance_codebook,
                                        ema_codebook_update)
from xtts_tpu_torch.models.gpt import UnifiedVoice


def make_dvae_loss(model: DVAE, commitment_weight: float = 0.25,
                   ema_decay: float = 0.99):
    """batch: {'mel': (B, bins, T)}. aux["new_state_cols"] holds the
    codebook buffers after the EMA update (and the balancing heuristic
    where the config turns it on), which the Trainer writes after the
    backward pass."""

    def loss_fn(batch, generator: Optional[torch.Generator] = None):
        recon, ssim_l, commit, _, (osum, esum) = model(batch["mel"])
        loss = recon + ssim_l + commitment_weight * commit
        new_cb = ema_codebook_update(model.codebook_state(), osum, esum,
                                     decay=ema_decay, eps=model.cfg.ema_eps)
        cb = model.codebook
        if hasattr(cb, "bal_hist"):
            # balancing heuristic (xtts_dvae.py:53-85)
            new_cb, bal, _ = balance_codebook(
                new_cb, BalanceState(cb.bal_hist, cb.bal_total), osum,
                generator, window=model.cfg.balance_window)
        new_cols = {"codebook.embed": new_cb.embed,
                    "codebook.cluster_size": new_cb.cluster_size,
                    "codebook.embed_avg": new_cb.embed_avg}
        if hasattr(cb, "bal_hist"):
            new_cols.update({"codebook.bal_hist": bal.hist,
                             "codebook.bal_total": bal.total})
        aux = {"recon": recon.detach(), "ssim": ssim_l.detach(),
               "commitment": commit.detach(), "new_state_cols": new_cols}
        return loss, aux

    return loss_fn


def make_gpt_loss(gpt: UnifiedVoice, dvae: DVAE, text_weight: float = 0.01,
                  mel_weight: float = 1.0):
    """batch: {'cond_mel', 'text', 'text_lengths', 'mel', 'wav_lengths'};
    the mel codes come from the frozen DVAE under no_grad, online, as
    ttts/gpt/train_ms.py:216-217 does."""

    def loss_fn(batch, generator: Optional[torch.Generator] = None):
        codes = dvae.get_codebook_indices(batch["mel"])
        loss_text, loss_mel = gpt(batch["cond_mel"], batch["text"],
                                  batch["text_lengths"], codes,
                                  batch["wav_lengths"])
        loss = text_weight * loss_text + mel_weight * loss_mel
        return loss, {"loss_text": loss_text.detach(),
                      "loss_mel": loss_mel.detach()}

    return loss_fn
