"""UnifiedVoice: GPT-2 over [cond ; text ; mel codes] (port of
xtts_tpu/models/gpt.py).

Parameter names are the reference's (text_embedding, mel_pos_embedding.emb,
gpt.h.{i}.*, conditioning_encoder.attn.{i}.*, final_norm, mel_head, ...), so
xtts_tpu.utils.convert.unified_voice_from_reference maps a state_dict()
back onto the JAX tree. The teacher-forced forward returns the text and
mel cross-entropies (`masked_ce`) as the trainer takes them; GPTConfig.remat
checkpoints each GPT block in training (nn/remat.py). With use_perceiver
the conditioning is the perceiver resampler's 32 latents
(perceiver_encoder.*, ttts/gpt/perceiver.py) instead of the encoder's one
vector.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from xtts_tpu_torch.core.config import GPTConfig
from xtts_tpu_torch.nn.blocks import (AttentionBlock, Conv1d, Embedding,
                                      LayerNorm, Linear, PerceiverResampler)
from xtts_tpu_torch.nn.transformer import GPT2Stack, KVCache, cache_index


class ConditioningEncoder(nn.Module):
    """1x1 conv mel->dim + N AttentionBlocks, first-token pooling."""

    def __init__(self, spec_dim: int, embedding_dim: int, attn_blocks: int = 6,
                 num_heads: int = 4, dtype=torch.float32):
        super().__init__()
        self.init = Conv1d(spec_dim, embedding_dim, 1, dtype=dtype)
        self.attn = nn.ModuleList([AttentionBlock(embedding_dim, num_heads,
                                                  dtype)
                                   for _ in range(attn_blocks)])

    def forward(self, mel_btc):
        h = self.init.pointwise(mel_btc)
        for blk in self.attn:
            h = blk(h)
        return h[:, 0]


class LearnedPositionEmbeddings(nn.Module):
    def __init__(self, seq_len: int, dim: int):
        super().__init__()
        self.emb = Embedding(seq_len, dim)

    def forward(self, idx):
        return self.emb(idx)


class UnifiedVoice(nn.Module):
    def __init__(self, cfg: GPTConfig = GPTConfig(), dtype=torch.float32):
        super().__init__()
        c = self.cfg = cfg
        self.dtype = dtype
        if c.use_perceiver:
            self.perceiver_encoder = PerceiverResampler(
                c.model_dim, dim_context=c.mel_bins,
                num_latents=c.perceiver_latents, dtype=dtype)
        else:
            self.conditioning_encoder = ConditioningEncoder(
                c.mel_bins, c.model_dim, attn_blocks=c.cond_attn_blocks,
                num_heads=c.heads, dtype=dtype)
        self.text_embedding = Embedding(c.number_text_tokens * c.types + 1,
                                        c.model_dim)
        self.mel_embedding = Embedding(c.number_mel_codes, c.model_dim)
        self.mel_pos_embedding = LearnedPositionEmbeddings(
            c.max_mel_positions, c.model_dim)
        self.text_pos_embedding = LearnedPositionEmbeddings(
            c.max_text_positions, c.model_dim)
        self.gpt = GPT2Stack(c.layers, c.model_dim, c.heads, dtype,
                             remat=c.remat)
        self.final_norm = LayerNorm(c.model_dim, eps=1e-5)
        self.text_head = Linear(c.model_dim, c.number_text_tokens * c.types + 1,
                                dtype=dtype)
        self.mel_head = Linear(c.model_dim, c.number_mel_codes, dtype=dtype)

    # ---------------- conditioning ----------------

    def get_conditioning(self, cond_mel_bct: torch.Tensor) -> torch.Tensor:
        """(B, mel, T) or (B, n_clips, mel, T) -> (B, n_cond, dim): n_cond 1
        (the encoder) or perceiver_latents (the perceiver).

        A 4-D input is several reference clips stacked on dim 1
        (TextToSpeech.cond_mels_from_wavs): each clip runs through the
        encoder and the outputs are averaged (gpt.py:107-116). The
        perceiver conditioning takes one clip only, so a 4-D input with
        use_perceiver is refused."""
        if cond_mel_bct.dim() == 4:
            if self.cfg.use_perceiver:
                raise ValueError(
                    "multi-clip conditioning needs the plain conditioning "
                    "encoder: the perceiver path takes one clip only")
            b, n, c, t = cond_mel_bct.shape
            x = cond_mel_bct.reshape(b * n, c, t).transpose(1, 2)
            enc = self.conditioning_encoder(x).reshape(b, n, -1)
            return enc.mean(dim=1)[:, None]
        x = cond_mel_bct.transpose(1, 2)
        if self.cfg.use_perceiver:
            return self.perceiver_encoder(x)
        return self.conditioning_encoder(x)[:, None]

    # ---------------- teacher-forced forward ----------------

    @staticmethod
    def _set_padding(tokens, lengths, fill: int):
        pos = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
        return torch.where(pos < lengths[:, None], tokens,
                           torch.full_like(tokens, fill))

    @staticmethod
    def _build_aligned(tokens, start: int, stop: int):
        """inp = [start; x], tar = [x; stop]."""
        return (F.pad(tokens, (1, 0), value=start),
                F.pad(tokens, (0, 1), value=stop))

    def forward(self, cond_mel, text_inputs, text_lengths, mel_codes,
                wav_lengths, return_latent: bool = False,
                return_logits: bool = False, count_total=None):
        """Teacher-forced forward (ttts/gpt/model.py:478-557). Returns
        (loss_text, loss_mel), with `return_logits` also the mel logits, or
        the latents feeding the diffusion decoder when `return_latent`
        (final two positions stripped). count_total: maps this batch's
        count of valid targets to the global batch's (data parallelism:
        each cross-entropy is then this rank's share of the global mean)."""
        c = self.cfg
        if text_inputs.shape[1] > c.max_text_tokens:
            raise ValueError(
                f"text length {text_inputs.shape[1]} exceeds "
                f"GPTConfig.max_text_tokens={c.max_text_tokens}; the text "
                f"position table would index out of bounds")
        if mel_codes.shape[1] > c.max_mel_tokens:
            raise ValueError(
                f"mel-code length {mel_codes.shape[1]} exceeds "
                f"GPTConfig.max_mel_tokens={c.max_mel_tokens}; the mel "
                f"position table would index out of bounds")
        conds = self.get_conditioning(cond_mel)
        mel_code_lengths = torch.ceil(
            wav_lengths / c.mel_length_compression).long() + 1
        mel_codes = self._set_padding(mel_codes, mel_code_lengths,
                                      c.stop_mel_token)
        text_inputs = self._set_padding(text_inputs, text_lengths,
                                        c.stop_text_token)
        text_inputs = F.pad(text_inputs, (0, 1), value=c.stop_text_token)
        mel_codes = F.pad(mel_codes, (0, 1), value=c.stop_mel_token)
        text_inp, text_tar = self._build_aligned(
            text_inputs, c.start_text_token, c.stop_text_token)
        mel_inp, mel_tar = self._build_aligned(mel_codes, c.start_mel_token,
                                               c.stop_mel_token)
        dev = text_inp.device
        text_emb = (self.text_embedding(text_inp) + self.text_pos_embedding(
            torch.arange(text_inp.shape[1], device=dev)))
        mel_emb = (self.mel_embedding(mel_inp) + self.mel_pos_embedding(
            torch.arange(mel_inp.shape[1], device=dev)))
        emb = torch.cat([conds.to(text_emb.dtype), text_emb, mel_emb], dim=1)
        _, normed = self.gpt(emb)
        enc = self.final_norm(normed[:, 1:]).to(emb.dtype)
        t_text, t_mel = text_inp.shape[1], mel_inp.shape[1]
        mel_latent = enc[:, -t_mel:]
        if return_latent:
            return mel_latent[:, :-2]
        text_logits = self.text_head(enc[:, :t_text])
        mel_logits = self.mel_head(mel_latent)
        # targets past length + 1 are ignored (model.py:545-549): the real
        # tokens and exactly one stop token count
        text_mask = (torch.arange(t_text, device=dev)[None, :]
                     <= text_lengths[:, None])
        mel_mask = (torch.arange(t_mel, device=dev)[None, :]
                    <= mel_code_lengths[:, None])
        loss_text = masked_ce(text_logits, text_tar, text_mask, count_total)
        loss_mel = masked_ce(mel_logits, mel_tar, mel_mask, count_total)
        if return_logits:
            return loss_text, loss_mel, mel_logits
        return loss_text, loss_mel

    # ---------------- inference building blocks ----------------

    def encode_prefix(self, cond_mel, text_inputs):
        """Generation prefix: conds + [start; text; stop; stop] embedding +
        the decode tail. Returns (prefix, n_cond)."""
        c = self.cfg
        if text_inputs.shape[1] > c.max_text_tokens:
            raise ValueError(
                f"text length {text_inputs.shape[1]} exceeds "
                f"GPTConfig.max_text_tokens={c.max_text_tokens}: the text "
                f"position table (max_text_tokens+2) would be indexed out "
                f"of bounds. Split or truncate the sentence.")
        text_inputs = F.pad(text_inputs, (0, 1), value=c.stop_text_token)
        text_inp, _ = self._build_aligned(text_inputs, c.start_text_token,
                                          c.stop_text_token)
        dev = text_inp.device
        text_emb = (self.text_embedding(text_inp) + self.text_pos_embedding(
            torch.arange(text_inp.shape[1], device=dev)))
        conds = self.get_conditioning(cond_mel).to(text_emb.dtype)
        b = text_inputs.shape[0]
        # the reference's fake-inputs quirk (ttts/gpt/model.py:574-584): the
        # tail is n_cond tokens, ids [1] * (n_cond - 1) + [start] at mel
        # positions 0..n_cond-1; with the plain encoder just the start
        # token at position 0
        n_tail = conds.shape[1] if c.decode_position_quirk else 1
        tail = torch.full((b, n_tail), 1, dtype=torch.long, device=dev)
        tail[:, -1] = c.start_mel_token
        tail_emb = (self.mel_embedding(tail) + self.mel_pos_embedding(
            torch.arange(n_tail, device=dev))[None])
        prefix = torch.cat([conds, text_emb, tail_emb.to(text_emb.dtype)],
                           dim=1)
        return prefix, conds.shape[1]

    def prefill(self, prefix_emb, cache: KVCache,
                prefix_mask: Optional[torch.Tensor] = None):
        """Seed the KV cache with the prefix; logits for the first code."""
        _, normed, cache = self.gpt.prefill(prefix_emb, cache, prefix_mask)
        last = normed[:, -1:]
        logits = self.mel_head(self.final_norm(last).to(last.dtype))
        return logits[:, 0], cache

    def decode_one(self, token, mel_pos, cache: KVCache, index):
        """One AR step: embed `token` (B,) at `mel_pos`, attend to the cache
        up to `index` (each an int or a one-element tensor on the token's
        device, never read back); returns (logits (B, V), cache)."""
        pos = cache_index(mel_pos, token.device,
                          self.mel_pos_embedding.emb.weight.shape[0],
                          "the mel position").reshape(1)
        emb = self.mel_embedding(token[:, None]) + self.mel_pos_embedding(pos)[None]
        normed, cache = self.gpt.decode_step(emb.to(self.dtype), cache, index)
        logits = self.mel_head(self.final_norm(normed).to(normed.dtype))
        return logits[:, 0], cache


def masked_ce(logits: torch.Tensor, targets: torch.Tensor,
              mask: torch.Tensor, count_total=None) -> torch.Tensor:
    """Cross-entropy over the positions where `mask` holds, in f32 (the
    mean over them; F.cross_entropy(ignore_index=-1) of the reference).
    count_total: the count's global total (see UnifiedVoice.forward)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets[..., None].long())[..., 0]
    mask = mask.float()
    count = mask.sum() if count_total is None else count_total(mask.sum())
    return (nll * mask).sum() / torch.clamp(count, min=1.0)
