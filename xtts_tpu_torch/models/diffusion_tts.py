"""The legacy tortoise denoiser DiffusionTts (port of
xtts_tpu/models/diffusion_tts.py; the reference's
ttts/diffusion/model.py:134-341).

Superseded on the live Mandarin path by AA_diffusion (models/aa_diffusion.py)
and built by the tortoise api and the registry ("diffusion_tts"), as in the
JAX package.

Structure (the reference ctor, :150-211): x --conv3--> [cat with the
timestep-integrated code embedding] --1x1--> N DiffusionLayers (scale-shift
ResBlock + relative-position AttentionBlock) + 3 plain scale-shift ResBlocks
--> norm / SiLU / conv3 --> [eps ; var]. The conditioning is either VQ codes
(embedding + 3 attention blocks, code_converter) or GPT latents (conv + 4
attention blocks, latent_conditioner), modulated by the contextual
embedder's (scale, shift) over a reference mel, nearest-upsampled to the
target length and run through 3 timestep-integrated DiffusionLayers.

As JAX: channels-last (B, T, C) inside, (B, C, T) at the boundary (x, the
output, the code prediction, latents and the reference mel);
timestep_independent's embedding and `precomputed_aligned_embeddings` are
channels-last as JAX's. Under `train` the layer drop is a keep-mask a layer
(the first and last always kept) and the unconditioned share a mask a row,
both drawn from the caller's torch.Generator, as JAX draws them from its
'drop' and 'uncond' streams (:262-269; the reference skips a dropped layer
in Python, :311-319), and so is the dropout. Parameter names are the
reference's, so xtts_tpu/utils/convert.py diffusion_tts_from_reference
reads a state_dict() and utils/convert.py diffusion_tts_from_jax writes
one. No kernel: the attention blocks carry a relative-position bias, which
flash_mha does not take, as in JAX.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from xtts_tpu_torch.nn.blocks import (AttentionBlock, Conv1d, Embed,
                                      GroupNorm32, Linear, normal_,
                                      timestep_embedding)


def _conv_cl(conv: Conv1d, x: torch.Tensor) -> torch.Tensor:
    """A Conv1d on channels-last (B, T, C)."""
    return conv(x.transpose(1, 2)).transpose(1, 2)


def _dropout(x: torch.Tensor, p: float, train: bool,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout drawn from `generator` (nothing unless train and
    p > 0)."""
    if not train or p <= 0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


class TimestepResBlock(nn.Module):
    """guided-diffusion ResBlock, 1-D, with the reference's efficient
    config (ttts/diffusion/model.py:60-121): 1x1 in and skip convs, a
    kernel_size out conv, optional scale-shift norm. (B, T, C)."""

    def __init__(self, channels: int, emb_channels: int, out_channels: int,
                 dropout: float = 0.0, use_scale_shift_norm: bool = False,
                 kernel_size: int = 3, dtype=torch.float32):
        super().__init__()
        self.dropout = dropout
        self.use_scale_shift_norm = use_scale_shift_norm
        pad = {1: 0, 3: 1, 5: 2}[kernel_size]
        self.in_layers = nn.ModuleList([
            GroupNorm32(channels), nn.SiLU(),
            Conv1d(channels, out_channels, 1, dtype=dtype)])
        self.emb_layers = nn.ModuleList([
            nn.SiLU(),
            Linear(emb_channels,
                   2 * out_channels if use_scale_shift_norm else out_channels,
                   dtype=dtype)])
        self.out_layers = nn.ModuleList([
            GroupNorm32(out_channels), nn.SiLU(), nn.Dropout(dropout),
            Conv1d(out_channels, out_channels, kernel_size, padding=pad,
                   dtype=dtype)])
        self.skip_connection = (Conv1d(channels, out_channels, 1, dtype=dtype)
                                if out_channels != channels else None)

    def forward(self, x, emb, train: bool = False,
                generator: Optional[torch.Generator] = None):
        h = self.in_layers[2].pointwise(
            F.silu(self.in_layers[0].channels_last(x)))
        eo = self.emb_layers[1](F.silu(emb))[:, None, :]
        norm = self.out_layers[0]
        if self.use_scale_shift_norm:
            scale, shift = eo.chunk(2, dim=-1)
            h = norm.channels_last(h) * (1 + scale) + shift
        else:
            h = norm.channels_last(h + eo)
        h = _dropout(F.silu(h), self.dropout, train, generator)
        h = _conv_cl(self.out_layers[3], h)
        skip = (x if self.skip_connection is None
                else self.skip_connection.pointwise(x))
        return skip + h


class DiffusionLayer(nn.Module):
    """A scale-shift ResBlock and a relative-position AttentionBlock
    (ttts/diffusion/model.py:124-132)."""

    def __init__(self, channels: int, num_heads: int, dropout: float = 0.0,
                 dtype=torch.float32):
        super().__init__()
        self.resblk = TimestepResBlock(channels, channels, channels,
                                       dropout=dropout,
                                       use_scale_shift_norm=True, dtype=dtype)
        self.attn = AttentionBlock(channels, num_heads, dtype=dtype,
                                   relative_pos_embeddings=True)

    def forward(self, x, emb, train: bool = False,
                generator: Optional[torch.Generator] = None):
        return self.attn(self.resblk(x, emb, train, generator))


def _attn_blocks(n: int, channels: int, heads: int, dtype) -> list:
    return [AttentionBlock(channels, heads, dtype=dtype,
                           relative_pos_embeddings=True) for _ in range(n)]


class DiffusionTts(nn.Module):
    """ttts/diffusion/model.py:134-341 with the reference ctor's defaults."""

    def __init__(self, model_channels: int = 512, num_layers: int = 8,
                 in_channels: int = 100, in_latent_channels: int = 512,
                 in_tokens: int = 8193, out_channels: int = 200,
                 dropout: float = 0.0, num_heads: int = 16,
                 layer_drop: float = 0.1,
                 unconditioned_percentage: float = 0.1,
                 dtype=torch.float32):
        super().__init__()
        mc = self.model_channels = model_channels
        self.in_channels, self.dtype = in_channels, dtype
        self.layer_drop = layer_drop
        self.unconditioned_percentage = unconditioned_percentage
        self.inp_block = Conv1d(in_channels, mc, 3, padding=1, dtype=dtype)
        self.time_embed = nn.ModuleList([Linear(mc, mc, dtype=dtype),
                                         nn.SiLU(),
                                         Linear(mc, mc, dtype=dtype)])
        self.code_embedding = Embed(in_tokens, mc)
        self.code_converter = nn.ModuleList(
            _attn_blocks(3, mc, num_heads, dtype))
        self.code_norm = GroupNorm32(mc)
        self.latent_conditioner = nn.ModuleList(
            [Conv1d(in_latent_channels, mc, 3, padding=1, dtype=dtype)]
            + _attn_blocks(4, mc, num_heads, dtype))
        self.contextual_embedder = nn.ModuleList(
            [Conv1d(in_channels, mc, 3, stride=2, padding=1, dtype=dtype),
             Conv1d(mc, 2 * mc, 3, stride=2, padding=1, dtype=dtype)]
            + _attn_blocks(5, 2 * mc, num_heads, dtype))
        self.unconditioned_embedding = nn.Parameter(torch.zeros(1, mc, 1))
        self.conditioning_timestep_integrator = nn.ModuleList(
            [DiffusionLayer(mc, num_heads, dropout, dtype) for _ in range(3)])
        self.integrating_conv = Conv1d(2 * mc, mc, 1, dtype=dtype)
        self.mel_head = Conv1d(mc, in_channels, 3, padding=1, dtype=dtype)
        self.layers = nn.ModuleList(
            [DiffusionLayer(mc, num_heads, dropout, dtype)
             for _ in range(num_layers)]
            + [TimestepResBlock(mc, mc, mc, dropout=dropout,
                                use_scale_shift_norm=True, dtype=dtype)
               for _ in range(3)])
        self.out = nn.ModuleList([GroupNorm32(mc), nn.SiLU(),
                                  Conv1d(mc, out_channels, 3, padding=1,
                                         dtype=dtype)])

    def reset_flax(self, g):
        normal_(self.unconditioned_embedding, 1.0, g)

    def get_conditioning(self, cond_mel: torch.Tensor) -> torch.Tensor:
        """Reference mel (B, C, T) -> the (B, 2 mc) contextual vector
        (ttts/diffusion/model.py:225-233, one conditioning clip)."""
        ce = self.contextual_embedder
        x = ce[1](ce[0](cond_mel)).transpose(1, 2)
        for blk in ce[2:]:
            x = blk(x)
        return x.mean(dim=1)

    def timestep_independent(self, aligned_conditioning: torch.Tensor,
                             conditioning_latent: torch.Tensor,
                             expected_seq_len: int, return_code_pred: bool,
                             train: bool = False,
                             generator: Optional[torch.Generator] = None):
        """(ttts/diffusion/model.py:235-263). aligned_conditioning: integer
        VQ codes (B, T) or GPT latents (B, C_lat, T); conditioning_latent
        (B, 2 mc) from get_conditioning. Returns the (B, expected_seq_len,
        mc) embedding (channels-last, as JAX) and, with return_code_pred,
        the code prediction (B, in_channels, expected_seq_len)."""
        cond_scale, cond_shift = conditioning_latent.chunk(2, dim=1)
        if not aligned_conditioning.is_floating_point():
            code_emb = self.code_embedding(aligned_conditioning)
            for blk in self.code_converter:
                code_emb = blk(code_emb)
        else:
            lc = self.latent_conditioner
            code_emb = lc[0](aligned_conditioning).transpose(1, 2)
            for blk in lc[1:]:
                code_emb = blk(code_emb)
        code_emb = (self.code_norm.channels_last(code_emb)
                    * (1 + cond_scale[:, None]) + cond_shift[:, None])
        b = code_emb.shape[0]
        uncond = torch.zeros((b, 1, 1), dtype=torch.bool,
                             device=code_emb.device)
        if train and self.unconditioned_percentage > 0:
            uncond = (torch.rand((b, 1, 1), generator=generator,
                                 device=code_emb.device)
                      < self.unconditioned_percentage)
            code_emb = torch.where(
                uncond, self.unconditioned_embedding.transpose(1, 2),
                code_emb)
        # nearest upsample along time to the mel length (:258)
        t_in = code_emb.shape[1]
        idx = ((torch.arange(expected_seq_len, device=code_emb.device) * t_in)
               // expected_seq_len).clamp(0, t_in - 1)
        expanded = code_emb[:, idx]
        if not return_code_pred:
            return expanded
        mel_pred = _conv_cl(self.mel_head, expanded) * ~uncond
        return expanded, mel_pred.transpose(1, 2)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                aligned_conditioning: Optional[torch.Tensor] = None,
                conditioning_latent: Optional[torch.Tensor] = None,
                precomputed_aligned_embeddings: Optional[torch.Tensor] = None,
                conditioning_free: bool = False,
                return_code_pred: bool = False, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """x (B, C, T) noisy mel -> (B, 2C, T) [eps ; var]
        (ttts/diffusion/model.py:265-331); with return_code_pred also the
        code prediction (None without code conditioning). `generator`
        draws the train-time layer drop, unconditioned rows and dropout."""
        b, _, t = x.shape
        mc = self.model_channels
        mel_pred = None
        if conditioning_free:
            code_emb = self.unconditioned_embedding.transpose(1, 2).expand(
                b, t, mc).to(self.dtype)
        elif precomputed_aligned_embeddings is not None:
            code_emb = precomputed_aligned_embeddings
        else:
            if conditioning_latent.dim() > 2:
                conditioning_latent = self.get_conditioning(
                    conditioning_latent)
            code_emb, mel_pred = self.timestep_independent(
                aligned_conditioning, conditioning_latent, t, True, train,
                generator)

        emb = timestep_embedding(timesteps, mc).to(self.dtype)
        emb = self.time_embed[2](F.silu(self.time_embed[0](emb)))
        for lyr in self.conditioning_timestep_integrator:
            code_emb = lyr(code_emb, emb, train, generator)

        h = _conv_cl(self.inp_block, x.transpose(1, 2))
        h = self.integrating_conv.pointwise(torch.cat([h, code_emb], dim=-1))
        n = len(self.layers)
        for i, lyr in enumerate(self.layers):
            y = lyr(h, emb, train, generator)
            h = self._maybe_drop(h, y, i, n, train, generator)
        h = F.silu(self.out[0].channels_last(h.float()))
        out = _conv_cl(self.out[2], h).transpose(1, 2)
        if return_code_pred:
            return out, mel_pred
        return out

    def _maybe_drop(self, x, y, i: int, n: int, train: bool,
                    generator: Optional[torch.Generator]):
        """The stochastic layer drop as a keep-mask, the first and last
        layers always kept (:311-314)."""
        if not train or self.layer_drop <= 0 or i == 0 or i == n - 1:
            return y
        keep = torch.rand((), generator=generator,
                          device=x.device) >= self.layer_drop
        return torch.where(keep, y, x)
