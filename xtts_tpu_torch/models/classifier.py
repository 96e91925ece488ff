"""Audio quality (clean / noise) mel classifier (port of
xtts_tpu/models/classifier.py; reference ttts/classifier/model.py:64-151,
AudioMiniEncoderWithClassifierHead), which filters noisy crawled clips
(ttts/prepare/filter_noise.py:21-25).

A conv pyramid (k5 residual blocks, each level closed by a k5 stride-4
conv that doubles the channels), GroupNorm / SiLU / 1x1 to the embedding,
an attention stack, the first token as the summary, and a linear head.
Parameter names are the reference's (enc.init.0, enc.res.<i>, enc.final,
enc.attn.<a>, head), so its state dict loads as it is. The model takes
(B, T, spec_dim) channels-last mels, as JAX's does.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from xtts_tpu_torch.core.config import ClassifierConfig
from xtts_tpu_torch.nn.blocks import AttentionBlock, Conv1d, GroupNorm32, Linear


class _ResBlock(nn.Module):
    """norm / SiLU / conv, then norm / SiLU / dropout / zero-init conv, plus
    the input (classifier/model.py:10-79). (B, C, T)."""

    def __init__(self, channels: int, kernel_size: int = 5,
                 dtype=torch.float32):
        super().__init__()
        pad = kernel_size // 2
        self.in_layers = nn.ModuleList([
            GroupNorm32(channels), nn.SiLU(),
            Conv1d(channels, channels, kernel_size, padding=pad,
                   dtype=dtype)])
        self.out_layers = nn.ModuleList([
            GroupNorm32(channels), nn.SiLU(), nn.Dropout(0.0),
            Conv1d(channels, channels, kernel_size, padding=pad, dtype=dtype,
                   zero_init=True)])

    def forward(self, x):
        h = self.in_layers[2](F.silu(self.in_layers[0](x)))
        return x + self.out_layers[3](F.silu(self.out_layers[0](h)))


class _Downsample(nn.Module):
    """Downsample(use_conv=True): k5, stride `factor`, pad 2, channels
    doubled (ttts/utils/utils.py:344-369)."""

    def __init__(self, channels: int, factor: int, dtype=torch.float32):
        super().__init__()
        self.op = Conv1d(channels, 2 * channels, 5, stride=factor, padding=2,
                         dtype=dtype)

    def forward(self, x):
        return self.op(x)


class AudioMiniEncoder(nn.Module):
    """(B, C=spec_dim, T) -> (B, embedding_dim): the summary token."""

    def __init__(self, c: ClassifierConfig, dtype=torch.float32):
        super().__init__()
        ch = c.base_channels
        self.init = nn.ModuleList([Conv1d(c.spec_dim, ch, 3, padding=1,
                                          dtype=dtype)])
        res = []
        for _ in range(c.depth):
            res += [_ResBlock(ch, c.kernel_size, dtype)
                    for _ in range(c.resnet_blocks)]
            res.append(_Downsample(ch, c.downsample_factor, dtype))
            ch *= 2
        self.res = nn.ModuleList(res)
        self.final = nn.ModuleList([GroupNorm32(ch), nn.SiLU(),
                                    Conv1d(ch, c.embedding_dim, 1,
                                           dtype=dtype)])
        self.attn = nn.ModuleList([
            AttentionBlock(c.embedding_dim, c.num_attn_heads, dtype)
            for _ in range(c.attn_blocks)])

    def forward(self, mel_bct):
        h = self.init[0](mel_bct)
        for blk in self.res:
            h = blk(h)
        h = self.final[2](F.silu(self.final[0](h))).transpose(1, 2)
        for blk in self.attn:
            h = blk(h)
        return h[:, 0]


class AudioClassifier(nn.Module):
    """AudioMiniEncoder + a linear class head (f32)."""

    def __init__(self, cfg: ClassifierConfig = ClassifierConfig(),
                 dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.enc = AudioMiniEncoder(cfg, dtype)
        self.head = Linear(cfg.embedding_dim, cfg.classes)

    def forward(self, mel_btc: torch.Tensor) -> torch.Tensor:
        """mel (B, T, spec_dim) -> (B, classes) f32 logits."""
        return self.head(self.enc(mel_btc.transpose(1, 2)).float())


def make_noise_scorer(model: AudioClassifier, crop_frames: int = 200):
    """P(noise) of one cached mel (bins, T), padded or cut to crop_frames
    (ttts/classifier/infer.py:26-67; pair with data/prepare.filter_noise)."""
    dev = next(model.parameters()).device

    @torch.no_grad()
    def score_fn(mel) -> float:
        mel = np.asarray(mel, np.float32)
        if mel.shape[-1] < crop_frames:
            mel = np.pad(mel, ((0, 0), (0, crop_frames - mel.shape[-1])))
        x = torch.from_numpy(np.ascontiguousarray(mel[:, :crop_frames].T))
        logits = model(x[None].to(dev))
        return float(torch.softmax(logits, dim=-1)[0, 1])

    return score_fn


def make_classifier_loss(model: AudioClassifier, mesh=None):
    """Trainer closure: batch {'mel' (B, T, bins), 'label' (B,)} -> softmax
    CE and the accuracy. With cfg.distribute_zero_label, a clean (label 0)
    target moves 20% of its mass evenly onto the other classes
    (ttts/classifier/model.py:138-148). On a mesh (parallel/mesh.py), this
    rank's shares of both."""
    from xtts_tpu_torch.parallel.mesh import mean_share

    def loss_fn(batch, generator: Optional[torch.Generator] = None):
        logits = model(batch["mel"])
        labels = batch["label"].long()
        n = logits.shape[-1]
        logp = torch.log_softmax(logits, dim=-1)
        if model.cfg.distribute_zero_label:
            target = F.one_hot(labels, n).float()
            extra = torch.full((n,), 0.2 / (n - 1), device=logits.device)
            extra[0] = -0.2
            target = target + extra[None, :] * (labels == 0)[:, None]
            loss = -(target * logp).sum(-1).mean()
        else:
            loss = -logp.gather(1, labels[:, None]).mean()
        acc = (logits.argmax(-1) == labels).float().mean()
        return mean_share(loss, mesh), {"acc": mean_share(acc.detach(), mesh)}

    loss_fn.mesh = mesh
    return loss_fn
