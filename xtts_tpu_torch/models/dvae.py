"""DiscreteVAE mel quantizer (port of xtts_tpu/models/dvae.py).

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
The nearest-code search is K3 (ops/vq.py), in inference and in training:
`forward(mel, train=True)` returns JAX's (recon, ssim, commitment,
recon_mel, (onehot_sum, embed_sum)) through a straight-through quantizer,
and `ema_codebook_update` / `balance_codebook` fold the batch statistics
into the codebook buffers, as the trainer does after the backward pass.

The transposed-conv decoder (use_transposed_convs, the reference class's
default; off in the shipped config) keeps its weight as a plain conv's
(out, in, k) under `decoder.{1+R+i}.0.conv`, the layout the JAX package's
input-dilated conv and its converters use, and runs it as the equivalent
conv_transpose1d.

Layout: (B, C, T) inside, as torch convs want; (B, N, D) pre-VQ logits and
(B, mel, T) mels at the API edges, as in the JAX module.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

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


class TransposedConv(nn.Module):
    """torch ConvTranspose1d(k, stride, padding=(k-1)//2) as JAX computes
    it: a conv of kernel (out, in, k) over the input dilated by `stride`
    with zeros, padded by (k-1)//2 (out length stride * (L - 1) + 1 + 2 pad
    - k + 1), run as conv_transpose1d on the flipped, transposed kernel."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int,
                 dtype=torch.float32):
        super().__init__()
        self.stride, self.pad = stride, (kernel - 1) // 2
        self.conv = Conv1d(cin, cout, kernel, dtype=dtype)

    def forward(self, x):
        c = self.conv
        dt = c.compute_dtype
        w = c.weight.to(dt).flip(-1).transpose(0, 1)
        return F.conv_transpose1d(x.to(dt), w, c.bias.to(dt),
                                  stride=self.stride,
                                  padding=c.kernel_size[0] - 1 - self.pad)


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
        up = TransposedConv if c.use_transposed_convs else UpsampledConv
        enc_chans = [c.hidden_dim * 2 ** i for i in range(c.num_layers)]
        dec_chans = list(reversed(enc_chans))
        inner = dec_chans[0]
        layers = [Conv1d(c.codebook_dim, inner, 1, dtype=dtype)]
        layers += [ResBlock(inner, c.activation, dtype)
                   for _ in range(c.num_resnet_blocks)]
        for cin, cout in list(zip([inner] + dec_chans,
                                  dec_chans))[:c.num_layers]:
            layers.append(nn.Sequential(
                up(cin, cout, c.kernel_size, c.stride, dtype),
                _activation(c.activation)))
        layers.append(Conv1d(dec_chans[-1], c.channels, 1, dtype=dtype))
        super().__init__(*layers)

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        for layer in list(self)[:-1]:
            x = layer(x)
        return self[-1](x), x


class Codebook(nn.Module):
    """The EMA codebook buffers (Quantize registers, xtts_dvae.py:67-70)."""

    def __init__(self, dim: int, n_embed: int, balancing: bool = False):
        super().__init__()
        self.register_buffer("embed", torch.zeros(dim, n_embed))
        self.register_buffer("cluster_size", torch.zeros(n_embed))
        self.register_buffer("embed_avg", torch.zeros(dim, n_embed))
        if balancing:
            # the tumbling-window usage histogram of balance_codebook
            self.register_buffer("bal_hist", torch.zeros(n_embed))
            self.register_buffer("bal_total", torch.zeros(()))

    def reset_flax(self, g):
        with torch.no_grad():
            self.embed.normal_(0.0, 1.0, generator=g)
            self.cluster_size.zero_()
            self.embed_avg.copy_(self.embed)
            if hasattr(self, "bal_hist"):
                self.bal_hist.zero_()
                self.bal_total.zero_()


class QuantizeResult(NamedTuple):
    quantized: torch.Tensor    # (B, N, dim) codebook vectors of the codes
    codes: torch.Tensor        # (B, N) int64


def quantize(x: torch.Tensor, embed: torch.Tensor) -> QuantizeResult:
    """Nearest code (K3) and its codebook vector (xtts_dvae.py:87-130);
    x (B, N, dim), embed (dim, n_embed)."""
    codes = vq_nearest(x, embed)
    return QuantizeResult(embed.t()[codes], codes)


class TrainQuantizeResult(NamedTuple):
    quantized: torch.Tensor        # straight-through (B, N, dim), f32
    codes: torch.Tensor            # (B, N) int64
    commitment_loss: torch.Tensor
    onehot_sum: torch.Tensor       # (n_embed,) batch statistics for the EMA
    embed_sum: torch.Tensor        # (dim, n_embed)


def quantize_train(x: torch.Tensor,
                   embed: torch.Tensor) -> TrainQuantizeResult:
    """Nearest code (K3, which carries no gradient) + straight-through
    estimator + commitment loss + the EMA statistics (xtts_dvae.py:87-127,
    xtts_tpu/models/dvae.py quantize). The statistics come from a one-hot
    product, not an index_add, so they are deterministic on the card."""
    codes = vq_nearest(x, embed)
    quant = embed.t()[codes]                                 # f32
    commitment = ((quant.detach() - x) ** 2).mean()
    st = x + (quant - x).detach()
    with torch.no_grad():
        flat = x.detach().reshape(-1, x.shape[-1]).float()
        onehot = F.one_hot(codes.reshape(-1), embed.shape[1]).float()
        onehot_sum = onehot.sum(0)
        embed_sum = flat.t() @ onehot
    return TrainQuantizeResult(st, codes, commitment, onehot_sum, embed_sum)


class CodebookState(NamedTuple):
    """The EMA codebook buffers (Quantize registers, xtts_dvae.py:67-70)."""

    embed: torch.Tensor          # (dim, n_embed)
    cluster_size: torch.Tensor   # (n_embed,)
    embed_avg: torch.Tensor      # (dim, n_embed)


class BalanceState(NamedTuple):
    """Tumbling-window code-usage histogram of the balancing heuristic."""

    hist: torch.Tensor     # (n_embed,) f32
    total: torch.Tensor    # () f32


@torch.no_grad()
def ema_codebook_update(cb: CodebookState, onehot_sum: torch.Tensor,
                        embed_sum: torch.Tensor, decay: float = 0.99,
                        eps: float = 1e-5) -> CodebookState:
    """EMA cluster update (xtts_dvae.py:104-117). Under data parallelism the
    caller all-reduces (onehot_sum, embed_sum) first, as the reference does
    at :108-110."""
    cluster_size = cb.cluster_size * decay + onehot_sum * (1 - decay)
    embed_avg = cb.embed_avg * decay + embed_sum * (1 - decay)
    n = cluster_size.sum()
    smoothed = (cluster_size + eps) / (n + cluster_size.shape[0] * eps) * n
    return CodebookState(embed_avg / smoothed[None, :], cluster_size,
                         embed_avg)


@torch.no_grad()
def balance_codebook(cb: CodebookState, bal: BalanceState,
                     onehot_sum: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     window: int = 64000, hi: float = 0.9, lo: float = 0.01):
    """Codebook balancing heuristic (xtts_dvae.py:53-85; the JAX package's
    tumbling-window form, xtts_tpu/models/dvae.py balance_codebook): add
    the step's code counts to the window's histogram; once it holds
    `window` codes, every code whose share is > hi or < lo gets one fresh
    gaussian as its embed and embed_avg and a zero cluster size, and the
    window restarts. The fresh values are drawn from `generator` (on the
    codebook's device), so they match JAX's mask and counts, not its
    values. Returns (new_cb, new_bal, n_reset); the draw and the rewrite
    run only at a window boundary, which costs one host read a step."""
    hist = bal.hist + onehot_sum
    total = bal.total + onehot_sum.sum()
    if float(total) < window:
        return cb, BalanceState(hist, total), 0
    h = hist / torch.clamp(total, min=1.0)
    mask = (h > hi) | (h < lo)
    rand = torch.empty_like(cb.embed).normal_(generator=generator)
    keep = torch.where(mask[None, :], 0.0, 1.0)
    embed = cb.embed * keep + rand * (1.0 - keep)
    embed_avg = cb.embed_avg * keep + rand * (1.0 - keep)
    cluster_size = torch.where(mask, 0.0, cb.cluster_size)
    return (CodebookState(embed, cluster_size, embed_avg),
            BalanceState(torch.zeros_like(hist), torch.zeros_like(total)),
            int(mask.sum()))


class DVAE(nn.Module):
    """encode(mel) -> (B, N, D) logits; get_codebook_indices(mel) -> (B, N)
    codes; decode(codes) -> (mel (B, mel, 4N), penult (B, C, 4N))."""

    def __init__(self, cfg: DVAEConfig = DVAEConfig(), dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.encoder = DVAEEncoder(cfg, dtype)
        self.decoder = DVAEDecoder(cfg, dtype)
        self.codebook = Codebook(cfg.codebook_dim, cfg.num_tokens,
                                 cfg.balancing_heuristic)

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

    def codebook_state(self) -> CodebookState:
        cb = self.codebook
        return CodebookState(cb.embed, cb.cluster_size, cb.embed_avg)

    def forward(self, mel_bct: torch.Tensor, train: bool = True):
        """Training forward (xtts_dvae.py:366-390): returns (recon_loss,
        ssim_loss, commitment_loss, recon_mel (B, mel, T), (onehot_sum,
        embed_sum)). train=False decodes the codes' own vectors instead of
        the straight-through ones."""
        c = self.cfg
        q = quantize_train(self.encode(mel_bct), self.codebook.embed)
        dec_in = (q.quantized if train
                  else self.codebook.embed.t()[q.codes])
        out, _ = self.decoder(dec_in.transpose(1, 2))
        out = out[..., :mel_bct.shape[-1]]
        if c.smooth_l1_loss:
            recon = smooth_l1(mel_bct, out)
        else:
            recon = ((mel_bct - out) ** 2).mean()
        ssim_l = torch.zeros((), device=mel_bct.device)
        if c.ssim_loss_weight > 0:
            ssim_l = (1.0 - ssim(mel_bct[:, None], out[:, None])) \
                * c.ssim_loss_weight
        return (recon, ssim_l, q.commitment_loss, out,
                (q.onehot_sum, q.embed_sum))


def smooth_l1(a: torch.Tensor, b: torch.Tensor,
              beta: float = 1.0) -> torch.Tensor:
    d = (a - b).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta).mean()


def _gaussian_window(size: int = 11, sigma: float = 1.5,
                     device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - size // 2
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def ssim(img1: torch.Tensor, img2: torch.Tensor,
         window_size: int = 11) -> torch.Tensor:
    """Mean SSIM over (B, 1, H, W) image pairs (ttts/vqvae/ssim.py:1-82),
    the gaussian filter as two 1-D VALID convs, in f32; the window shrinks
    (odd) for images smaller than 11 px."""
    window_size = min(window_size, img1.shape[2], img1.shape[3])
    if window_size % 2 == 0:
        window_size -= 1
    img1, img2 = img1.float(), img2.float()
    g = _gaussian_window(window_size, device=img1.device)
    kh, kw = g[None, None, :, None], g[None, None, None, :]

    def blur(x):
        return F.conv2d(F.conv2d(x, kh), kw)

    mu1, mu2 = blur(img1), blur(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = blur(img1 * img1) - mu1_sq
    s2 = blur(img2 * img2) - mu2_sq
    s12 = blur(img1 * img2) - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * s12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    return ssim_map.mean()
