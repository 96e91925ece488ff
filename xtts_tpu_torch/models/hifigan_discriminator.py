"""HiFi-GAN discriminators: multi-period (MPD) and multi-scale (MSD) (port
of xtts_tpu/models/hifigan_discriminator.py; reference
ttts/hifigan/hifigan_discriminator.py:9-216).

MPD folds the waveform into (T / p, p) frames for each period p in (2, 3,
5, 7, 11) and runs strided (k, 1) 2-D convs; MSD runs grouped 1-D convs
on the waveform average-pooled x1, x2 and x4. Each returns its score and
its per-layer feature maps for the feature-matching loss. As in JAX:
LeakyReLU 0.1, no weight or spectral norm, "SAME" padding (the lower
half of an odd total first), a reflect pad to a whole period, and a
4-wide stride-2 average pool padded by 1. Parameter names follow the
reference's (mpd.discriminators.<i>.convs.<j>, .conv_post; likewise
msd). Layout (B, C, T) and (B, C, T / p, p); features keep it.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from xtts_tpu_torch.nn.blocks import Conv1d, _cast, lecun_normal_

LRELU_SLOPE = 0.1


def same_pad(t: int, k: int, s: int) -> Tuple[int, int]:
    """flax / XLA "SAME" padding of a length-t axis: (low, high)."""
    total = max((-(-t // s) - 1) * s + k - t, 0)
    return total // 2, total - total // 2


class _ConvK1(nn.Conv2d):
    """A (k, 1) conv with stride (s, 1) and SAME padding along the frames
    axis, on (B, C, T / p, p), computing in `dtype`."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 dtype=torch.float32):
        super().__init__(cin, cout, (k, 1), stride=(stride, 1))
        self.compute_dtype = dtype

    def reset_flax(self, g):
        with torch.no_grad():
            lecun_normal_(self.weight, self.in_channels * self.kernel_size[0],
                          g)
            self.bias.zero_()

    def forward(self, x):
        dt = self.compute_dtype
        lo, hi = same_pad(x.shape[2], self.kernel_size[0], self.stride[0])
        x = F.pad(x.to(dt), (0, 0, lo, hi))
        return F.conv2d(x, self.weight.to(dt), _cast(self.bias, dt),
                        self.stride)


class _SameConv1d(Conv1d):
    """Conv1d with flax's SAME padding for any stride."""

    def forward(self, x):
        lo, hi = same_pad(x.shape[-1], self.kernel_size[0], self.stride[0])
        return super().forward(F.pad(x, (lo, hi)))


class DiscriminatorP(nn.Module):
    """One period discriminator: wav (B, T) -> (score (B, N), features)."""

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3,
                 dtype=torch.float32):
        super().__init__()
        self.period = period
        chans = (1, 32, 128, 512, 1024)
        self.convs = nn.ModuleList(
            [_ConvK1(chans[i], chans[i + 1], kernel_size, stride, dtype)
             for i in range(4)]
            + [_ConvK1(1024, 1024, kernel_size, 1, dtype)])
        self.conv_post = _ConvK1(1024, 1, 3, 1, dtype)

    def forward(self, x):
        b, t = x.shape
        pad = (-t) % self.period
        if pad:
            x = F.pad(x[:, None], (0, pad), mode="reflect")[:, 0]
        x = x.reshape(b, 1, -1, self.period)
        feats: List[torch.Tensor] = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            feats.append(x)
        x = self.conv_post(x)
        feats.append(x)
        return x.reshape(b, -1), feats


# (channels, kernel, stride, groups) of the scale discriminator's convs
_MSD_SPEC = ((128, 15, 1, 1), (128, 41, 2, 4), (256, 41, 2, 16),
             (512, 41, 4, 16), (1024, 41, 4, 16), (1024, 41, 1, 16),
             (1024, 5, 1, 1))


class DiscriminatorS(nn.Module):
    """One scale discriminator: grouped 1-D convs on (B, T)."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        convs, cin = [], 1
        for ch, k, s, g in _MSD_SPEC:
            convs.append(_SameConv1d(cin, ch, k, stride=s,
                                     groups=g if cin % g == 0 else 1,
                                     dtype=dtype))
            cin = ch
        self.convs = nn.ModuleList(convs)
        self.conv_post = _SameConv1d(1024, 1, 3, dtype=dtype)

    def forward(self, x):
        b = x.shape[0]
        x = x[:, None]
        feats: List[torch.Tensor] = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            feats.append(x)
        x = self.conv_post(x)
        feats.append(x)
        return x.reshape(b, -1), feats


def avg_pool_1d(x: torch.Tensor, window: int = 4,
                stride: int = 2) -> torch.Tensor:
    """(B, T) -> (B, T') window means, zero-padded by (window - stride) // 2
    on both sides (the padding counted in the mean)."""
    pad = (window - stride) // 2
    return F.avg_pool1d(F.pad(x, (pad, pad))[:, None], window, stride)[:, 0]


class _Discriminators(nn.Module):
    def __init__(self, discriminators: Sequence[nn.Module]):
        super().__init__()
        self.discriminators = nn.ModuleList(discriminators)


class HifiganDiscriminator(nn.Module):
    """MPD (periods 2, 3, 5, 7, 11) + MSD (scales x1, x2, x4)."""

    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11),
                 scales: int = 3, dtype=torch.float32):
        super().__init__()
        self.periods = tuple(periods)
        self.mpd = _Discriminators([DiscriminatorP(p, dtype=dtype)
                                    for p in self.periods])
        self.msd = _Discriminators([DiscriminatorS(dtype)
                                    for _ in range(scales)])

    def forward(self, wav: torch.Tensor):
        """wav (B, T) -> (scores, features): a list over the
        discriminators, MPD first."""
        scores, feats = [], []
        for d in self.mpd.discriminators:
            s, f = d(wav)
            scores.append(s)
            feats.append(f)
        x = wav
        for i, d in enumerate(self.msd.discriminators):
            if i > 0:
                x = avg_pool_1d(x)
            s, f = d(x)
            scores.append(s)
            feats.append(f)
        return scores, feats
