"""Vocos vocoder: ConvNeXt backbone + Fourier head (port of
xtts_tpu/models/vocos.py).

mel (B, 100, T) -> waveform. Heads (VocosConfig.head): "istft" (the live
charactr/vocos-mel-24khz checkpoint, T * hop samples), "imdct_symexp" and
"imdct_cos" (T * mdct_frame_len / 2 samples); an unknown name raises
ValueError. Also here, as in the JAX module, the pieces of the
Encodec-conditioned variant: the AdaLayerNorm backbone (a per-bandwidth
scale and shift), the ResBlock backbone and the Encodec token features
(the Encodec encoder itself is injected; nothing is downloaded).

Parameter names are the reference checkpoint's (backbone.embed,
backbone.norm[.scale / .shift], backbone.convnext.{i}.*,
backbone.final_layer_norm, head.out; the ResBlock backbone's embed and
resnet.{i}.convs1 / convs2 / gamma, with the weight norm folded), as
utils.convert writes them.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from xtts_tpu_torch.core.config import VocosConfig
from xtts_tpu_torch.dsp.spectral import imdct, istft
from xtts_tpu_torch.nn.blocks import Conv1d, LayerNorm, Linear


def symexp(x: torch.Tensor) -> torch.Tensor:
    """sign(x) * (exp(|x|) - 1)."""
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1.0)


def _mel_perceptual_scale(sample_rate: int, out_dim: int) -> np.ndarray:
    """Per-output-bin 1 - f / f_max over an HTK mel grid: the
    IMDCTSymExpHead's last-layer init scale (ttts/vocoder/heads.py:94-101)."""
    m_max = 2595.0 * np.log10(1.0 + (sample_rate // 2) / 700.0)
    m_pts = np.linspace(0.0, m_max, out_dim)
    f_pts = 700.0 * (10.0 ** (m_pts / 2595.0) - 1.0)
    return (1.0 - f_pts / f_pts.max()).astype(np.float32)


class AdaLayerNorm(nn.Module):
    """LayerNorm (eps 1e-6, no affine parameters) whose scale and shift are
    embeddings of a class id, the Encodec bandwidth (init: scale 1, shift
    0). cond_id: a 0-d id, a (1,) id, or (B,) ids, one a row.

    The JAX module multiplies x (B, T, C) by the (B, C) embeddings of (B,)
    ids, which broadcasts only for B == 1 (or B == T); here (B,) ids take
    row by row, which at B == 1 is the same."""

    def __init__(self, num_embeddings: int, dim: int):
        super().__init__()
        self.dim = dim
        self.scale = nn.Embedding(num_embeddings, dim)
        self.shift = nn.Embedding(num_embeddings, dim)
        self.reset_flax(None)

    def reset_flax(self, g):
        with torch.no_grad():
            self.scale.weight.fill_(1.0)
            self.shift.weight.zero_()

    def forward(self, x, cond_id):                  # x (B, T, C)
        cond_id = torch.as_tensor(cond_id, dtype=torch.long,
                                  device=x.device)
        scale, shift = self.scale(cond_id), self.shift(cond_id)
        if cond_id.dim() == 1:                      # (B, C) -> (B, 1, C)
            scale, shift = scale[:, None], shift[:, None]
        x = F.layer_norm(x.float(), (self.dim,), eps=1e-6)
        return x * scale + shift


class ConvNeXtBlock(nn.Module):
    """Depthwise conv7 -> LN (or AdaLayerNorm) -> pointwise Linear -> GELU
    -> Linear -> layer scale -> residual. (B, C, T) in and out."""

    def __init__(self, dim: int, intermediate_dim: int,
                 layer_scale_init: float, dtype=torch.float32,
                 adanorm_num_embeddings: int = 0):
        super().__init__()
        self.layer_scale_init = layer_scale_init
        self.dwconv = Conv1d(dim, dim, 7, padding=3, groups=dim, dtype=dtype)
        self.norm = (AdaLayerNorm(adanorm_num_embeddings, dim)
                     if adanorm_num_embeddings else LayerNorm(dim, eps=1e-6))
        self.pwconv1 = Linear(dim, intermediate_dim, dtype=dtype)
        self.pwconv2 = Linear(intermediate_dim, dim, dtype=dtype)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale_init))

    def reset_flax(self, g):
        with torch.no_grad():
            self.gamma.fill_(self.layer_scale_init)

    def forward(self, x, cond_id=None):
        res = x
        x = self.dwconv(x).transpose(1, 2)
        if isinstance(self.norm, AdaLayerNorm):
            x = self.norm(x, cond_id).to(res.dtype)
        else:
            x = self.norm(x).to(res.dtype)
        x = self.pwconv2(F.gelu(self.pwconv1(x)))
        return res + (self.gamma * x).transpose(1, 2)


class VocosBackbone(nn.Module):
    """Embed conv7 + LN + N ConvNeXt blocks + final LN; mel (B, C, T) ->
    (B, T, dim). adanorm_num_embeddings > 0 takes the Encodec variant's
    AdaLayerNorm keyed by cond_id in place of the first LN and the
    blocks' LNs."""

    def __init__(self, cfg: VocosConfig, dtype=torch.float32,
                 adanorm_num_embeddings: int = 0):
        super().__init__()
        n_emb = adanorm_num_embeddings
        self.embed = Conv1d(cfg.input_channels, cfg.dim, 7, padding=3,
                            dtype=dtype)
        self.norm = (AdaLayerNorm(n_emb, cfg.dim) if n_emb
                     else LayerNorm(cfg.dim, eps=1e-6))
        self.convnext = nn.ModuleList([
            ConvNeXtBlock(cfg.dim, cfg.intermediate_dim, 1.0 / cfg.num_layers,
                          dtype, adanorm_num_embeddings=n_emb)
            for _ in range(cfg.num_layers)])
        self.final_layer_norm = LayerNorm(cfg.dim, eps=1e-6)

    def forward(self, mel_bct, cond_id=None):
        x = self.embed(mel_bct).transpose(1, 2)
        if isinstance(self.norm, AdaLayerNorm):
            x = self.norm(x, cond_id).to(x.dtype)
        else:
            x = self.norm(x).to(x.dtype)
        x = x.transpose(1, 2)
        for blk in self.convnext:
            x = blk(x, cond_id)
        x = x.transpose(1, 2)
        return self.final_layer_norm(x).to(x.dtype)      # (B, T, C)


class VocosResBlock1(nn.Module):
    """HiFi-GAN-V1 dilated resblock without upsampling, with per-branch
    layer-scale gammas (dim, 1) when layer_scale_init is nonzero.
    (B, C, T) in and out."""

    def __init__(self, dim: int, kernel_size: int = 3,
                 dilations=(1, 3, 5), lrelu_slope: float = 0.1,
                 layer_scale_init: float = 0.0, dtype=torch.float32):
        super().__init__()
        self.lrelu_slope = lrelu_slope
        self.layer_scale_init = layer_scale_init
        # "SAME" padding of an odd kernel: d (k - 1) / 2 a side
        self.convs1 = nn.ModuleList([
            Conv1d(dim, dim, kernel_size, padding=d * (kernel_size - 1) // 2,
                   dilation=d, dtype=dtype) for d in dilations])
        self.convs2 = nn.ModuleList([
            Conv1d(dim, dim, kernel_size, padding=(kernel_size - 1) // 2,
                   dtype=dtype) for _ in dilations])
        self.gamma = (nn.ParameterList([
            nn.Parameter(torch.full((dim, 1), layer_scale_init))
            for _ in dilations]) if layer_scale_init else None)

    def reset_flax(self, g):
        if self.gamma is not None:
            with torch.no_grad():
                for p in self.gamma:
                    p.fill_(self.layer_scale_init)

    def forward(self, x):
        for i, (c1, c2) in enumerate(zip(self.convs1, self.convs2)):
            h = c1(F.leaky_relu(x, self.lrelu_slope))
            h = c2(F.leaky_relu(h, self.lrelu_slope))
            if self.gamma is not None:
                h = self.gamma[i] * h
            x = x + h
        return x


class VocosResNetBackbone(nn.Module):
    """The ResBlock backbone: embed conv3 + num_blocks VocosResBlock1 with
    layer scale 1 / num_blocks / 3; mel (B, C, T) -> (B, T, dim)."""

    def __init__(self, cfg: VocosConfig, num_blocks: int = 3,
                 dtype=torch.float32):
        super().__init__()
        self.embed = Conv1d(cfg.input_channels, cfg.dim, 3, padding=1,
                            dtype=dtype)
        ls = 1.0 / num_blocks / 3
        self.resnet = nn.Sequential(*[
            VocosResBlock1(cfg.dim, layer_scale_init=ls, dtype=dtype)
            for _ in range(num_blocks)])

    def forward(self, mel_bct, cond_id=None):
        return self.resnet(self.embed(mel_bct)).transpose(1, 2)


def encodec_features(codes: torch.Tensor, codebook_weights: torch.Tensor,
                     bins: int) -> torch.Tensor:
    """Sum each quantizer's codebook embedding in one gather: codes
    (num_q, B, T) + stacked weights (num_q * bins, D) -> (B, D, T)."""
    num_q = codes.shape[0]
    offsets = (torch.arange(num_q, device=codes.device) * bins).reshape(
        -1, 1, 1)
    emb = F.embedding(codes.long() + offsets, codebook_weights)
    return emb.sum(dim=0).transpose(1, 2)


class EncodecFeatures:
    """Encodec-token features for the multi-bandwidth Vocos variant. The
    Encodec encoder is an external pretrained model, so it is injected:
    `encode_fn(audio (B, T), bandwidth) -> codes (num_q, B, frames)`."""

    def __init__(self, encode_fn, codebook_weights, bins: int = 1024,
                 bandwidths=(1.5, 3.0, 6.0, 12.0)):
        self.encode_fn = encode_fn
        self.codebook_weights = torch.as_tensor(codebook_weights)
        self.bins = bins
        self.bandwidths = tuple(bandwidths)

    def __call__(self, audio, bandwidth_id: int) -> torch.Tensor:
        codes = self.encode_fn(audio, self.bandwidths[int(bandwidth_id)])
        return encodec_features(
            torch.as_tensor(codes, dtype=torch.long,
                            device=self.codebook_weights.device),
            self.codebook_weights, self.bins)


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


class _RowScaledLinear(Linear):
    """A Linear whose flax init is scaled per output row (the mel-grid init
    of IMDCTSymExpHead); the scale is not a parameter or buffer, so the
    state dict stays the reference's."""

    def __init__(self, in_features: int, out_features: int,
                 row_scale: Optional[np.ndarray], dtype=torch.float32):
        super().__init__(in_features, out_features, dtype=dtype)
        self.row_scale = row_scale

    def reset_flax(self, g):
        super().reset_flax(g)
        if self.row_scale is not None:
            with torch.no_grad():
                self.weight.mul_(torch.as_tensor(
                    self.row_scale, device=self.weight.device)[:, None])


def _clip_audio(cfg: VocosConfig, audio: torch.Tensor) -> torch.Tensor:
    return torch.clamp(audio, -1.0, 1.0) if cfg.clip_audio else audio


class IMDCTSymExpHead(nn.Module):
    """Linear -> symexp -> clip to [-100, 100] -> IMDCT. With
    cfg.head_sample_rate the Linear's init is scaled per output bin by the
    1 - f / f_max mel-grid factor. clip_audio clips the AUDIO to [-1, 1],
    as the JAX module does (the reference clips and returns the
    coefficients, heads.py:117-118, the wrong tensor)."""

    def __init__(self, cfg: VocosConfig, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        out_dim = cfg.mdct_frame_len // 2
        scale = (_mel_perceptual_scale(cfg.head_sample_rate, out_dim)
                 if cfg.head_sample_rate is not None else None)
        self.out = _RowScaledLinear(cfg.dim, out_dim, scale, dtype=dtype)

    def forward(self, x_btc):
        c = self.cfg
        coeffs = torch.clamp(symexp(self.out(x_btc).float()), -1e2, 1e2)
        return _clip_audio(c, imdct(coeffs, c.mdct_frame_len, c.padding))


class IMDCTCosHead(nn.Module):
    """Linear -> exp(m) cos(p), the magnitude clipped to 100 -> IMDCT;
    clip_audio as IMDCTSymExpHead's."""

    def __init__(self, cfg: VocosConfig, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.out = Linear(cfg.dim, cfg.mdct_frame_len, dtype=dtype)

    def forward(self, x_btc):
        c = self.cfg
        m, p = self.out(x_btc).float().chunk(2, dim=-1)
        m = torch.clamp(torch.exp(m), max=1e2)
        return _clip_audio(c, imdct(m * torch.cos(p), c.mdct_frame_len,
                                    c.padding))


_HEADS = {"istft": ISTFTHead, "imdct_symexp": IMDCTSymExpHead,
          "imdct_cos": IMDCTCosHead}


class Vocos(nn.Module):
    """mel (B, n_mels, T) -> wav (B, samples)."""

    def __init__(self, cfg: VocosConfig = VocosConfig(), dtype=torch.float32):
        super().__init__()
        if cfg.head not in _HEADS:
            raise ValueError(f"unknown Vocos head {cfg.head!r}; "
                             f"have {sorted(_HEADS)}")
        self.cfg = cfg
        self.backbone = VocosBackbone(cfg, dtype)
        self.head = _HEADS[cfg.head](cfg, dtype)

    def forward(self, mel_bct):
        return self.head(self.backbone(mel_bct))
