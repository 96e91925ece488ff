"""CLVP — contrastive text/speech-code reranker, inference parts (port of
xtts_tpu/models/clvp.py; reference ttts/clvp/model.py:19-140).

Two encoder towers (text BPE tokens, mel-VQ codes) -> masked-mean pooled,
L2-normalised latents -> temperature-scaled cosine scores. `rerank` scores
K speech-code candidates against one text; `rerank_batch` K candidates for
each of B texts in one pass (BASELINE config #5). Parameter names are the
reference's. `forward(..., return_loss=True)` is the training loss, the
symmetric InfoNCE over the batch (ttts/clvp/model.py:133-140), and
`make_clvp_loss` its Trainer closure.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from xtts_tpu_torch.core.config import CLVPConfig
from xtts_tpu_torch.nn.blocks import Embed, Linear
from xtts_tpu_torch.nn.encoder import (TortoiseEncoder, TransformerEncoder,
                                       masked_mean)


class CLVP(nn.Module):
    def __init__(self, cfg: CLVPConfig = CLVPConfig(), dtype=torch.float32):
        super().__init__()
        c = self.cfg = cfg
        self.dtype = dtype
        self.text_emb = Embed(c.num_text_tokens, c.dim_text)
        self.speech_emb = Embed(c.num_speech_tokens, c.dim_speech)
        if c.use_xformers:
            self.text_transformer = TransformerEncoder(
                c.text_enc_depth, c.dim_text, c.text_heads, dtype)
            self.speech_transformer = TransformerEncoder(
                c.speech_enc_depth, c.dim_speech, c.speech_heads, dtype)
        else:
            # the reference sizes the speech position table by
            # num_speech_tokens, not a seq_len (ttts/clvp/model.py:98)
            self.text_transformer = TortoiseEncoder(
                c.text_enc_depth, c.dim_text, c.text_heads, dtype)
            self.speech_transformer = TortoiseEncoder(
                c.speech_enc_depth, c.dim_speech, c.speech_heads, dtype)
            self.text_pos_emb = Embed(c.text_seq_len, c.dim_text)
            self.speech_pos_emb = Embed(c.num_speech_tokens, c.dim_speech)
        self.to_text_latent = Linear(c.dim_text, c.dim_latent, bias=False,
                                     dtype=dtype)
        self.to_speech_latent = Linear(c.dim_speech, c.dim_latent,
                                       bias=False, dtype=dtype)
        self.temperature = nn.Parameter(torch.ones(1))

    def reset_flax(self, g):
        with torch.no_grad():
            self.temperature.fill_(1.0)

    @staticmethod
    def _normalize(lat: torch.Tensor) -> torch.Tensor:
        return lat / torch.linalg.vector_norm(lat, dim=-1, keepdim=True)

    def embed_text(self, text: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.text_emb(text).to(self.dtype)
        if not self.cfg.use_xformers:
            if text.shape[1] > self.cfg.text_seq_len:
                raise ValueError(
                    f"text length {text.shape[1]} exceeds CLVP "
                    f"text_seq_len={self.cfg.text_seq_len} (position table)")
            h = h + self.text_pos_emb(
                torch.arange(text.shape[1], device=text.device)).to(h.dtype)
        h = self.text_transformer(h, mask)
        return self._normalize(self.to_text_latent(masked_mean(h, mask)))

    def embed_speech(self, codes: torch.Tensor,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.speech_emb(codes).to(self.dtype)
        if not self.cfg.use_xformers:
            if codes.shape[1] > self.cfg.num_speech_tokens:
                raise ValueError(
                    f"code length {codes.shape[1]} exceeds the CLVP speech "
                    f"position table (num_speech_tokens="
                    f"{self.cfg.num_speech_tokens})")
            h = h + self.speech_pos_emb(
                torch.arange(codes.shape[1], device=codes.device)).to(h.dtype)
        h = self.speech_transformer(h, mask)
        return self._normalize(self.to_speech_latent(masked_mean(h, mask)))

    def forward(self, text: torch.Tensor, codes: torch.Tensor,
                text_mask: Optional[torch.Tensor] = None,
                code_mask: Optional[torch.Tensor] = None,
                return_loss: bool = False) -> torch.Tensor:
        """Similarity logits (B, B) scaled by the learned temperature
        (under no_grad); with return_loss, the symmetric InfoNCE loss, the
        mean of the text-to-speech and speech-to-text cross-entropies with
        the diagonal as labels (f32)."""
        with torch.set_grad_enabled(return_loss and torch.is_grad_enabled()):
            tl = self.embed_text(text, text_mask)
            sl = self.embed_speech(codes, code_mask)
            if not return_loss:
                return (torch.einsum("id,jd->ij", tl, sl)
                        * torch.exp(self.temperature))
            return self.contrastive_loss(tl, sl)

    def contrastive_loss(self, tl: torch.Tensor,
                         sl: torch.Tensor) -> torch.Tensor:
        """The symmetric InfoNCE over text and speech latents (B, D)."""
        logits = (torch.einsum("id,jd->ij", tl, sl)
                  * torch.exp(self.temperature)).float()
        labels = torch.arange(logits.shape[0], device=logits.device)
        return (F.cross_entropy(logits, labels)
                + F.cross_entropy(logits.t(), labels)) / 2

    @torch.no_grad()
    def rerank(self, text: torch.Tensor, candidate_codes: torch.Tensor,
               code_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """text (T,), candidate_codes (K, S) -> (K,) scores."""
        tl = self.embed_text(text[None])
        sl = self.embed_speech(candidate_codes, code_mask)
        return (sl @ tl[0]) * torch.exp(self.temperature)[0]

    @torch.no_grad()
    def rerank_batch(self, texts: torch.Tensor, candidate_codes: torch.Tensor,
                     text_mask: Optional[torch.Tensor] = None,
                     code_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """texts (B, T); candidate_codes and code_mask (B, K, S) -> (B, K)
        scores, K candidates for each of B texts in one pass."""
        b, k, s = candidate_codes.shape
        tl = self.embed_text(texts, text_mask)
        sl = self.embed_speech(
            candidate_codes.reshape(b * k, s),
            None if code_mask is None else code_mask.reshape(b * k, s))
        return (torch.einsum("bkd,bd->bk", sl.reshape(b, k, -1), tl)
                * torch.exp(self.temperature)[0])


def make_clvp_loss(model: CLVP, mesh=None):
    """Trainer closure: batch {'text', 'codes', 'text_mask', 'code_mask'}
    -> the InfoNCE loss (JAX make_clvp_loss). On a mesh (parallel/mesh.py)
    every data rank's latents are gathered, so the loss contrasts the
    global batch as on one device, and each rank returns its share."""
    from xtts_tpu_torch.parallel import mesh as pmesh

    def loss_fn(batch, generator: Optional[torch.Generator] = None):
        if mesh is None:
            loss = model(batch["text"], batch["codes"],
                         batch.get("text_mask"), batch.get("code_mask"),
                         return_loss=True)
            return loss, {}
        tl = model.embed_text(batch["text"], batch.get("text_mask"))
        sl = model.embed_speech(batch["codes"], batch.get("code_mask"))
        loss = model.contrastive_loss(
            pmesh.gather_rows(tl, mesh, differentiable=True),
            pmesh.gather_rows(sl, mesh, differentiable=True))
        return pmesh.mean_share(loss, mesh), {}

    loss_fn.mesh = mesh
    return loss_fn
