"""HiFi-GAN latent decoder: GPT latents -> waveform, speaker-conditioned
(port of xtts_tpu/models/hifigan.py).

HifiganGenerator (conv_pre, transposed-conv upsampling, MRF resblocks,
per-layer speaker conditioning, conv_post, tanh), ResNetSpeakerEncoder (an
SE-ResNet d-vector over a 64-bin 16 kHz log-mel) and HifiDecoder (latent
-> one linear resize -> generator). This is the render that skips the
diffusion and Vocos.

Parameter names are the reference's (hifigan_vocoder.py), in the layout
after remove_weight_norm (a plain `weight`), so the JAX package's
convert.hifigan_from_reference reads a port state_dict() directly
(affine norm mode). The port runs torch's (B, C, T) and (B, C, F, T)
layouts; the public functions keep the JAX package's (B, T, C) at their
edges. Upsampling is nn.ConvTranspose1d(k, stride=s, padding=(k - s) // 2),
exact against flax's "SAME" transposed conv for k = 2s (the bridge flips
the kernel); every shipped and tested geometry has k = 2s.

Dtype: parameters f32; convs and dense layers compute in `dtype`; norms in
f32, as the port's other modules.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from xtts_tpu_torch.core.config import HiFiGANConfig
from xtts_tpu_torch.nn.blocks import Conv1d, Linear, _cast, lecun_normal_

LRELU_SLOPE = 0.1


def linear_resize_time(x: torch.Tensor, new_len: int) -> torch.Tensor:
    """(B, T, C) -> (B, new_len, C) linear interpolation, align_corners
    False (F.interpolate mode='linear' semantics)."""
    t = x.shape[1]
    scale = t / new_len
    pos = (torch.arange(new_len, dtype=torch.float32, device=x.device)
           + 0.5) * scale - 0.5
    pos = torch.clamp(pos, 0.0, t - 1)
    lo = torch.floor(pos).long()
    hi = torch.clamp(lo + 1, max=t - 1)
    frac = (pos - lo)[None, :, None]
    return x[:, lo] * (1 - frac) + x[:, hi] * frac


class ConvTranspose1d(nn.ConvTranspose1d):
    """nn.ConvTranspose1d computing in `dtype`; weight (in, out, k)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int,
                 dtype=torch.float32):
        super().__init__(cin, cout, k, stride=stride,
                         padding=(k - stride) // 2)
        self.compute_dtype = dtype

    def reset_flax(self, g):
        with torch.no_grad():
            lecun_normal_(self.weight, self.kernel_size[0] * self.in_channels,
                          g)
            self.bias.zero_()

    def forward(self, x):
        dt = self.compute_dtype
        return F.conv_transpose1d(x.to(dt), self.weight.to(dt),
                                  _cast(self.bias, dt), self.stride,
                                  self.padding)


class Conv2d(nn.Conv2d):
    """nn.Conv2d on (B, C, F, T) computing in `dtype`."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int = 0, bias: bool = True, dtype=torch.float32):
        super().__init__(cin, cout, k, stride=stride, padding=padding,
                         bias=bias)
        self.compute_dtype = dtype

    def reset_flax(self, g):
        with torch.no_grad():
            fan_in = self.in_channels * self.kernel_size[0] * self.kernel_size[1]
            lecun_normal_(self.weight, fan_in, g)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        dt = self.compute_dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), _cast(self.bias, dt),
                        self.stride, self.padding)


def _pad(k: int, d: int = 1) -> int:
    return d * (k - 1) // 2


class ResBlock1(nn.Module):
    """3 x (lrelu -> dilated conv -> lrelu -> conv) with residuals
    (hifigan_vocoder.py:58-130). (B, C, T) in and out."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilations: Sequence[int] = (1, 3, 5), dtype=torch.float32):
        super().__init__()
        self.convs1 = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, padding=_pad(kernel_size, d),
                   dtype=dtype, dilation=d) for d in dilations)
        self.convs2 = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, padding=_pad(kernel_size),
                   dtype=dtype) for _ in dilations)

    def forward(self, x):
        for c1, c2 in zip(self.convs1, self.convs2):
            h = c1(F.leaky_relu(x, LRELU_SLOPE))
            x = x + c2(F.leaky_relu(h, LRELU_SLOPE))
        return x


class ResBlock2(nn.Module):
    """2 x (lrelu -> dilated conv) with residuals (hifigan type 2)."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilations: Sequence[int] = (1, 3), dtype=torch.float32):
        super().__init__()
        self.convs = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, padding=_pad(kernel_size, d),
                   dtype=dtype, dilation=d) for d in dilations)

    def forward(self, x):
        for c in self.convs:
            x = x + c(F.leaky_relu(x, LRELU_SLOPE))
        return x


class HifiganGenerator(nn.Module):
    """conv_pre -> [lrelu, upsample, + speaker cond, MRF mean]* -> lrelu
    (slope 0.01, the reference's F.leaky_relu default) -> conv_post (no
    bias) -> tanh (hifigan_vocoder.py:220-377). (B, C_in, T) ->
    (B, out_channels, T * prod(upsample_rates))."""

    def __init__(self, in_channels: int, out_channels: int = 1,
                 resblock_type: str = "1",
                 resblock_dilation_sizes=((1, 3, 5),) * 3,
                 resblock_kernel_sizes=(3, 7, 11),
                 upsample_kernel_sizes=(16, 16, 4, 4),
                 upsample_initial_channel: int = 512,
                 upsample_rates=(8, 8, 2, 2), cond_channels: int = 0,
                 cond_in_each_up_layer: bool = False, dtype=torch.float32):
        super().__init__()
        rb = ResBlock1 if resblock_type == "1" else ResBlock2
        ch0 = upsample_initial_channel
        self.n_kernels = len(resblock_kernel_sizes)
        self.conv_pre = Conv1d(in_channels, ch0, 7, padding=3, dtype=dtype)
        self.cond_layer = (Conv1d(cond_channels, ch0, 1, dtype=dtype)
                           if cond_channels else None)
        self.ups = nn.ModuleList()
        self.conds = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            cin, ch = ch0 // 2 ** i, ch0 // 2 ** (i + 1)
            self.ups.append(ConvTranspose1d(cin, ch, k, u, dtype=dtype))
            if cond_channels and cond_in_each_up_layer:
                self.conds.append(Conv1d(cond_channels, ch, 1, dtype=dtype))
            for ks, ds in zip(resblock_kernel_sizes, resblock_dilation_sizes):
                self.resblocks.append(rb(ch, ks, tuple(ds), dtype=dtype))
        self.conv_post = Conv1d(ch0 // 2 ** len(upsample_rates), out_channels,
                                7, padding=3, bias=False, dtype=dtype)

    def forward(self, x, g: Optional[torch.Tensor] = None):
        """x (B, C_in, T); g (B, cond_channels) speaker d-vector."""
        o = self.conv_pre(x)
        if g is not None and self.cond_layer is not None:
            o = o + self.cond_layer(g[:, :, None])
        for i, up in enumerate(self.ups):
            o = up(F.leaky_relu(o, LRELU_SLOPE))
            if g is not None and len(self.conds):
                o = o + self.conds[i](g[:, :, None])
            blocks = self.resblocks[i * self.n_kernels:(i + 1) * self.n_kernels]
            z = None
            for blk in blocks:
                r = blk(o)
                z = r if z is None else z + r
            o = z / self.n_kernels
        o = self.conv_post(F.leaky_relu(o, 0.01))
        return torch.tanh(o)


# ---------------------------------------------------------------------------
# speaker encoder (d-vector)
# ---------------------------------------------------------------------------

class _ChannelNorm(nn.Module):
    """The speaker encoder's norm over the channel axis (dim 1).

    mode "layer": LayerNorm over channels, eps 1e-6 (flax nn.LayerNorm, the
    JAX package's training default); weight, bias. mode "affine": the
    reference's eval-mode BatchNorm, weight, bias, running_mean and
    running_var (eps 1e-5) folded into one scale and shift, the layout of
    converted reference checkpoints."""

    def __init__(self, channels: int, mode: str = "layer"):
        super().__init__()
        if mode not in ("layer", "affine"):
            raise ValueError(f"norm mode {mode!r}: 'layer' or 'affine'")
        self.mode = mode
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        if mode == "affine":
            self.register_buffer("running_mean", torch.zeros(channels))
            self.register_buffer("running_var", torch.ones(channels))

    def reset_flax(self, g):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        x = x.float()
        if self.mode == "layer":
            return F.layer_norm(x.movedim(1, -1), (x.shape[1],), self.weight,
                                self.bias, 1e-6).movedim(-1, 1)
        scale = self.weight * torch.rsqrt(self.running_var + 1e-5)
        shift = self.bias - self.running_mean * scale
        return x * scale.reshape(shape) + shift.reshape(shape)


class _SELayer(nn.Module):
    """Squeeze-excite over (B, C, F, T) (hifigan_vocoder.py:378-393)."""

    def __init__(self, channels: int, reduction: int = 8,
                 dtype=torch.float32):
        super().__init__()
        self.fc = nn.Sequential(
            Linear(channels, max(1, channels // reduction), dtype=dtype),
            nn.ReLU(), Linear(max(1, channels // reduction), channels,
                              dtype=dtype), nn.Sigmoid())

    def forward(self, x):
        s = self.fc(x.mean(dim=(2, 3)))
        return x * s[:, :, None, None].to(x.dtype)


class _SEBasicBlock(nn.Module):
    """conv1 -> relu -> bn1 -> conv2 -> bn2 -> SE -> + shortcut -> relu
    (hifigan_vocoder.py:396-427): biasless 3x3 convs with padding 1 on both
    sides (explicit, as the JAX module pads)."""

    def __init__(self, cin: int, channels: int, stride: int = 1,
                 norm_mode: str = "layer", dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(cin, channels, 3, stride, 1, bias=False,
                            dtype=dtype)
        self.bn1 = _ChannelNorm(channels, norm_mode)
        self.conv2 = Conv2d(channels, channels, 3, 1, 1, bias=False,
                            dtype=dtype)
        self.bn2 = _ChannelNorm(channels, norm_mode)
        self.se = _SELayer(channels, dtype=dtype)
        self.downsample = None
        if cin != channels or stride != 1:
            self.downsample = nn.Sequential(
                Conv2d(cin, channels, 1, stride, 0, bias=False, dtype=dtype),
                _ChannelNorm(channels, norm_mode))
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype
        h = self.bn1(F.relu(self.conv1(x))).to(dt)
        h = self.se(self.bn2(self.conv2(h)).to(dt))
        res = x if self.downsample is None else self.downsample(x).to(dt)
        return F.relu(res + h)


def instance_norm_time(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-channel normalization over time of (B, T, F): population
    variance, eps 1e-5 (hifigan_vocoder.py:495, 576)."""
    mean = x.mean(dim=1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


class ResNetSpeakerEncoder(nn.Module):
    """SE-ResNet d-vector network (hifigan_vocoder.py:461-654): (B, T, 64)
    16 kHz log-mel -> l2-normed (B, proj_dim). Attentive statistics pooling
    over time after a channel-major (C, F) collapse."""

    def __init__(self, proj_dim: int = 512, layers=(3, 4, 6, 3),
                 num_filters=(32, 64, 128, 256), norm_mode: str = "layer",
                 n_mels: int = 64, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv2d(1, num_filters[0], 3, 1, 1, dtype=dtype)
        self.bn1 = _ChannelNorm(num_filters[0], norm_mode)
        cin, f = num_filters[0], n_mels
        for si, (n, ch) in enumerate(zip(layers, num_filters)):
            blocks = []
            for bi in range(n):
                stride = 2 if (bi == 0 and si > 0) else 1
                blocks.append(_SEBasicBlock(cin, ch, stride, norm_mode,
                                            dtype=dtype))
                cin = ch
                if stride == 2:
                    f = (f - 1) // 2 + 1
            setattr(self, f"layer{si + 1}", nn.Sequential(*blocks))
        self.n_stages = len(layers)
        feat = cin * f
        self.attention = nn.Sequential(
            Conv1d(feat, 128, 1, dtype=dtype), nn.ReLU(),
            _ChannelNorm(128, norm_mode), Conv1d(128, feat, 1, dtype=dtype))
        self.fc = Linear(2 * feat, proj_dim, dtype=dtype)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = instance_norm_time(mel.float()).transpose(1, 2)[:, None]  # B1FT
        x = self.bn1(F.relu(self.conv1(x))).to(dt)
        for si in range(self.n_stages):
            x = getattr(self, f"layer{si + 1}")(x)
        b, c, f, t = x.shape
        x = x.reshape(b, c * f, t)                 # channel-major collapse
        w = self.attention[2](F.relu(self.attention[0](x))).to(dt)
        w = torch.softmax(self.attention[3](w).float(), dim=2)
        x = x.float()
        mu = (x * w).sum(dim=2)
        sg = torch.sqrt(torch.clamp((x * x * w).sum(dim=2) - mu * mu,
                                    min=1e-5))
        h = self.fc(torch.cat([mu, sg], dim=1)).float()
        return h / torch.linalg.vector_norm(h, dim=-1, keepdim=True)


# ---------------------------------------------------------------------------
# HifiDecoder
# ---------------------------------------------------------------------------

def hifigan_frames(cfg: HiFiGANConfig, n_latents: int) -> int:
    """Latent count -> generator input frames: the reference's two
    interpolations (1024/256, then out_sr/in_sr) folded into one resize."""
    return int(round(n_latents * (cfg.ar_mel_length_compression
                                  / cfg.output_hop_length)
                     * (cfg.output_sample_rate / cfg.input_sample_rate)))


def hifigan_samples(cfg: HiFiGANConfig, n_latents: int) -> int:
    """Latent count -> output waveform samples."""
    return hifigan_frames(cfg, n_latents) * math.prod(cfg.upsample_rates)


class HifiDecoder(nn.Module):
    """GPT latents (B, T_lat, D) + a speaker d-vector -> (B, T_wav)
    (hifigan_vocoder.py:655-771)."""

    def __init__(self, cfg: HiFiGANConfig = HiFiGANConfig(),
                 dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.waveform_decoder = HifiganGenerator(
            cfg.decoder_input_dim, 1, cfg.resblock_type,
            cfg.resblock_dilation_sizes, cfg.resblock_kernel_sizes,
            cfg.upsample_kernel_sizes, cfg.upsample_initial_channel,
            cfg.upsample_rates, cfg.d_vector_dim,
            cfg.cond_d_vector_in_each_upsampling_layer, dtype=dtype)
        self.speaker_encoder = ResNetSpeakerEncoder(
            cfg.d_vector_dim, norm_mode=cfg.speaker_norm_mode, dtype=dtype)

    def forward(self, latents: torch.Tensor, g: Optional[torch.Tensor] = None,
                ref_mel16k: Optional[torch.Tensor] = None) -> torch.Tensor:
        """latents (B, T_lat, D); g (B, d_vector_dim), or ref_mel16k
        (B, T, 64) to derive it. Returns (B, T_wav) f32."""
        if g is None:
            if ref_mel16k is None:
                raise ValueError("need a speaker d-vector g or ref_mel16k")
            g = self.speaker_encoder(ref_mel16k)
        z = linear_resize_time(latents.float(),
                               hifigan_frames(self.cfg, latents.shape[1]))
        wav = self.waveform_decoder(z.transpose(1, 2), g=g)
        return wav[:, 0].float()

    def speaker_embedding(self, mel16k: torch.Tensor) -> torch.Tensor:
        """(B, T, 64) 16 kHz log-mel -> (B, d_vector_dim)."""
        return self.speaker_encoder(mel16k)
