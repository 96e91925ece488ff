"""DiscreteVAE mel quantizer, inference parts (port of
xtts_tpu/models/dvae.py).

Architecture of the shipped config (channels 100, hidden 512, num_layers 2,
kernel 3, 3 resblocks, codebook 8192 x 512, UpsampledConv decoder):

  encoder: conv s2 100->512 +act | conv s2 512->1024 +act
           | ResBlock(1024) x3 | conv1x1 1024->512
  decoder: conv1x1 512->1024 | ResBlock(1024) x3
           | nearest-up x2 + conv 1024->1024 +act
           | nearest-up x2 + conv 1024->512  +act | conv1x1 512->100

Module and buffer names are the reference's (encoder.{i}.0, encoder.{j}.net.*,
decoder.{i}.0.conv, codebook.embed, ...), so
xtts_tpu.utils.convert.dvae_from_reference reads a state_dict() directly.
The nearest-code search is K3 (ops/vq.py). Training (losses, EMA codebook
updates, the balancing heuristic) is not ported; nor are transposed-conv
decoders (use_transposed_convs, off in the shipped config).

Layout: (B, C, T) inside, as torch convs want; (B, N, D) pre-VQ logits and
(B, mel, T) mels at the API edges, as in the JAX module.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn as nn

from xtts_tpu_torch.core.config import DVAEConfig
from xtts_tpu_torch.nn.blocks import Conv1d
from xtts_tpu_torch.ops.vq import vq_nearest


def _activation(name: str) -> nn.Module:
    """relu | silu, like the reference ctor (xtts_dvae.py:246-251)."""
    if name == "relu":
        return nn.ReLU()
    if name == "silu":
        return nn.SiLU()
    raise NotImplementedError(f"DVAE activation {name!r} (relu|silu)")


class ResBlock(nn.Module):
    """conv3-act-conv3-act-conv1 + x (ttts/vqvae/xtts_dvae.py:172-184)."""

    def __init__(self, chan: int, act: str = "relu", dtype=torch.float32):
        super().__init__()
        self.net = nn.Sequential(
            Conv1d(chan, chan, 3, padding=1, dtype=dtype), _activation(act),
            Conv1d(chan, chan, 3, padding=1, dtype=dtype), _activation(act),
            Conv1d(chan, chan, 1, dtype=dtype))

    def forward(self, x):
        return self.net(x) + x


class UpsampledConv(nn.Module):
    """Nearest x stride along time, then a conv (xtts_dvae.py:187-197)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int,
                 dtype=torch.float32):
        super().__init__()
        self.stride = stride
        self.conv = Conv1d(cin, cout, kernel, padding=(kernel - 1) // 2,
                           dtype=dtype)

    def forward(self, x):
        return self.conv(torch.repeat_interleave(x, self.stride, dim=-1))


class DVAEEncoder(nn.Sequential):
    """(B, mel, T) -> (B, codebook_dim, T/4) pre-VQ logits."""

    def __init__(self, cfg: DVAEConfig, dtype=torch.float32):
        c = cfg
        chans = [c.hidden_dim * 2 ** i for i in range(c.num_layers)]
        pad = (c.kernel_size - 1) // 2
        layers = []
        cin = c.channels
        for cout in chans:
            layers.append(nn.Sequential(
                Conv1d(cin, cout, c.kernel_size, stride=c.stride, padding=pad,
                       dtype=dtype), _activation(c.activation)))
            cin = cout
        layers += [ResBlock(chans[-1], c.activation, dtype)
                   for _ in range(c.num_resnet_blocks)]
        layers.append(Conv1d(chans[-1], c.codebook_dim, 1, dtype=dtype))
        super().__init__(*layers)


class DVAEDecoder(nn.Sequential):
    """(B, codebook_dim, N) -> (B, mel, 4N), and the penultimate (B, C, 4N)."""

    def __init__(self, cfg: DVAEConfig, dtype=torch.float32):
        c = cfg
        if c.use_transposed_convs:
            raise NotImplementedError("transposed-conv DVAE decoders are not "
                                      "ported (the shipped config uses "
                                      "UpsampledConv)")
        enc_chans = [c.hidden_dim * 2 ** i for i in range(c.num_layers)]
        dec_chans = list(reversed(enc_chans))
        inner = dec_chans[0]
        layers = [Conv1d(c.codebook_dim, inner, 1, dtype=dtype)]
        layers += [ResBlock(inner, c.activation, dtype)
                   for _ in range(c.num_resnet_blocks)]
        for cin, cout in list(zip([inner] + dec_chans,
                                  dec_chans))[:c.num_layers]:
            layers.append(nn.Sequential(
                UpsampledConv(cin, cout, c.kernel_size, c.stride, dtype),
                _activation(c.activation)))
        layers.append(Conv1d(dec_chans[-1], c.channels, 1, dtype=dtype))
        super().__init__(*layers)

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        for layer in list(self)[:-1]:
            x = layer(x)
        return self[-1](x), x


class Codebook(nn.Module):
    """The EMA codebook buffers (Quantize registers, xtts_dvae.py:67-70)."""

    def __init__(self, dim: int, n_embed: int):
        super().__init__()
        self.register_buffer("embed", torch.zeros(dim, n_embed))
        self.register_buffer("cluster_size", torch.zeros(n_embed))
        self.register_buffer("embed_avg", torch.zeros(dim, n_embed))

    def reset_flax(self, g):
        with torch.no_grad():
            self.embed.normal_(0.0, 1.0, generator=g)
            self.cluster_size.zero_()
            self.embed_avg.copy_(self.embed)


class QuantizeResult(NamedTuple):
    quantized: torch.Tensor    # (B, N, dim) codebook vectors of the codes
    codes: torch.Tensor        # (B, N) int64


def quantize(x: torch.Tensor, embed: torch.Tensor) -> QuantizeResult:
    """Nearest code (K3) and its codebook vector (xtts_dvae.py:87-130);
    x (B, N, dim), embed (dim, n_embed)."""
    codes = vq_nearest(x, embed)
    return QuantizeResult(embed.t()[codes], codes)


class DVAE(nn.Module):
    """encode(mel) -> (B, N, D) logits; get_codebook_indices(mel) -> (B, N)
    codes; decode(codes) -> (mel (B, mel, 4N), penult (B, C, 4N))."""

    def __init__(self, cfg: DVAEConfig = DVAEConfig(), dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.encoder = DVAEEncoder(cfg, dtype)
        self.decoder = DVAEDecoder(cfg, dtype)
        self.codebook = Codebook(cfg.codebook_dim, cfg.num_tokens)

    def encode(self, mel_bct: torch.Tensor) -> torch.Tensor:
        return self.encoder(mel_bct).transpose(1, 2)

    @torch.no_grad()
    def get_codebook_indices(self, mel_bct: torch.Tensor) -> torch.Tensor:
        return quantize(self.encode(mel_bct), self.codebook.embed).codes

    @torch.no_grad()
    def decode(self, codes: torch.Tensor):
        # clip: AR stop/start ids (>= num_tokens) may reach a decode
        # request; the JAX module saturates them, as here
        idx = torch.clamp(codes, 0, self.cfg.num_tokens - 1)
        emb = self.codebook.embed.t()[idx]                  # (B, N, D)
        return self.decoder(emb.transpose(1, 2))
