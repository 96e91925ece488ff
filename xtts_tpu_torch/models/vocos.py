"""Vocos vocoder: ConvNeXt backbone + iSTFT head (port of
xtts_tpu/models/vocos.py; the mel-24khz configuration only — no
AdaLayerNorm, Encodec or IMDCT heads).

mel (B, 100, T) -> waveform (B, T * hop). Parameter names are the
pretrained checkpoint's (backbone.embed, backbone.convnext.{i}.*,
backbone.final_layer_norm, head.out), as convert.vocos_from_pretrained
reads them.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from xtts_tpu_torch.core.config import VocosConfig
from xtts_tpu_torch.dsp.spectral import istft
from xtts_tpu_torch.nn.blocks import Conv1d, LayerNorm, Linear


class ConvNeXtBlock(nn.Module):
    """Depthwise conv7 -> LN -> pointwise Linear -> GELU -> Linear ->
    layer scale -> residual. (B, C, T) in and out."""

    def __init__(self, dim: int, intermediate_dim: int,
                 layer_scale_init: float, dtype=torch.float32):
        super().__init__()
        self.layer_scale_init = layer_scale_init
        self.dwconv = Conv1d(dim, dim, 7, padding=3, groups=dim, dtype=dtype)
        self.norm = LayerNorm(dim, eps=1e-6)
        self.pwconv1 = Linear(dim, intermediate_dim, dtype=dtype)
        self.pwconv2 = Linear(intermediate_dim, dim, dtype=dtype)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale_init))

    def reset_flax(self, g):
        with torch.no_grad():
            self.gamma.fill_(self.layer_scale_init)

    def forward(self, x):
        res = x
        x = self.dwconv(x).transpose(1, 2)
        x = self.norm(x).to(res.dtype)
        x = self.pwconv2(F.gelu(self.pwconv1(x)))
        return res + (self.gamma * x).transpose(1, 2)


class VocosBackbone(nn.Module):
    def __init__(self, cfg: VocosConfig, dtype=torch.float32):
        super().__init__()
        self.embed = Conv1d(cfg.input_channels, cfg.dim, 7, padding=3,
                            dtype=dtype)
        self.norm = LayerNorm(cfg.dim, eps=1e-6)
        self.convnext = nn.ModuleList([
            ConvNeXtBlock(cfg.dim, cfg.intermediate_dim, 1.0 / cfg.num_layers,
                          dtype) for _ in range(cfg.num_layers)])
        self.final_layer_norm = LayerNorm(cfg.dim, eps=1e-6)

    def forward(self, mel_bct):
        x = self.embed(mel_bct)
        x = self.norm(x.transpose(1, 2)).to(x.dtype).transpose(1, 2)
        for blk in self.convnext:
            x = blk(x)
        x = x.transpose(1, 2)
        return self.final_layer_norm(x).to(x.dtype)      # (B, T, C)


class ISTFTHead(nn.Module):
    """Linear -> (log-magnitude, phase) -> complex spectrum -> iSTFT."""

    def __init__(self, cfg: VocosConfig, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.out = Linear(cfg.dim, cfg.n_fft + 2, dtype=dtype)

    def forward(self, x_btc):
        c = self.cfg
        mag, phase = self.out(x_btc).float().chunk(2, dim=-1)
        mag = torch.clamp(torch.exp(mag), max=1e2)
        real = (mag * torch.cos(phase)).transpose(1, 2)
        imag = (mag * torch.sin(phase)).transpose(1, 2)
        return istft(real, imag, c.n_fft, c.hop_length, padding=c.padding)


class Vocos(nn.Module):
    """mel (B, n_mels, T) -> wav (B, samples)."""

    def __init__(self, cfg: VocosConfig = VocosConfig(), dtype=torch.float32):
        super().__init__()
        if cfg.head != "istft":
            raise NotImplementedError(f"Vocos head {cfg.head!r} is not "
                                      f"ported (istft only)")
        self.cfg = cfg
        self.backbone = VocosBackbone(cfg, dtype)
        self.head = ISTFTHead(cfg, dtype)

    def forward(self, mel_bct):
        return self.head(self.backbone(mel_bct))
