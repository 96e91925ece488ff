"""AA_diffusion: ReferenceNet-conditioned UNet1D diffusion decoder (port of
xtts_tpu/models/aa_diffusion.py).

Three towers: the CLIP reference encoder (refer_enc), the ReferenceNet
(refer_model, exports each SpatialTransformer's block input) and the
BaseModel (base_model, whose consumer self-attention runs over [x ; refer]).
Parameter names are the reference's torch names (refer_enc.visual.*,
{refer,base}_model.blocks.*, base_model.hint_converter, base_model.out.*,
unconditioned_cat_embedding), so convert.aa_diffusion_from_reference reads
a state_dict() directly.

Layout: (B, C, T) in the ResBlocks and at the API, (B, T, C) inside the
transformer blocks; the ReferenceNet features are (B, Tr, C) as in JAX.

`flash` (JAX's switch, default False): a self-attention with Tq * Tk >=
2^19 then runs kernel K2 (nn/flash_attn.py) for CUDA tensors; on the main
path that is the consumer attn1 over [x ; refer], differentiable (K2's
backward kernels). The serving API builds the model with flash=True; the
trainers keep the default, as JAX's do. `forward` is the reference's
training forward (JAX's __call__): the uncond-hint substitution and,
under `train`, the CLIP encoder's PatchDropout.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from xtts_tpu_torch.core.config import (CLIPRefConfig,
                                        DiffusionModelConfig)
from xtts_tpu_torch.nn.blocks import (Conv1d, GroupNorm32, LayerNorm, Linear,
                                      lecun_normal_, normal_,
                                      timestep_embedding)
from xtts_tpu_torch.nn.flash_attn import flash_mha, use_flash
from xtts_tpu_torch.nn.remat import remat_call


class CrossAttention(nn.Module):
    """Biasless q/k/v projections, f32 softmax; K2 where `flash` is set
    and the size gate admits the shapes (`use_flash`: XTTS_FLASH_ATTN=0
    closes it, as it closes the JAX package's)."""

    def __init__(self, query_dim: int, context_dim: Optional[int] = None,
                 heads: int = 8, dim_head: int = 64, dtype=torch.float32,
                 flash: bool = False):
        super().__init__()
        inner = heads * dim_head
        context_dim = context_dim or query_dim
        self.heads, self.dim_head = heads, dim_head
        self.flash = flash
        self.to_q = Linear(query_dim, inner, bias=False, dtype=dtype)
        self.to_k = Linear(context_dim, inner, bias=False, dtype=dtype)
        self.to_v = Linear(context_dim, inner, bias=False, dtype=dtype)
        self.to_out = nn.ModuleList([Linear(inner, query_dim, dtype=dtype),
                                     nn.Dropout(0.0)])

    def forward(self, x, context=None):
        ctx = x if context is None else context
        h, dh = self.heads, self.dim_head
        q = self.to_q(x).unflatten(-1, (h, dh))
        k = self.to_k(ctx).unflatten(-1, (h, dh))
        v = self.to_v(ctx).unflatten(-1, (h, dh))
        if self.flash and use_flash(q.shape[1], k.shape[1]):
            out = flash_mha(q, k, v, dh ** -0.5)
        else:
            sim = torch.einsum("bihd,bjhd->bhij", q, k) * (dh ** -0.5)
            attn = torch.softmax(sim.float(), dim=-1).to(sim.dtype)
            out = torch.einsum("bhij,bjhd->bihd", attn, v)
        return self.to_out[0](out.flatten(-2))


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int, dtype=torch.float32):
        super().__init__()
        self.proj = Linear(dim, inner * 2, dtype=dtype)

    def forward(self, x):
        a, gate = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(gate)          # exact-erf GELU


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4, dtype=torch.float32):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult, dtype),
                                  nn.Dropout(0.0),
                                  Linear(dim * mult, dim, dtype=dtype)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    """refer=None: producer (returns (y, its input)); refer given: consumer
    (self-attention over [x ; refer], queries for the x rows only)."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int,
                 dtype=torch.float32, flash: bool = False):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.norm3 = LayerNorm(dim, eps=1e-6)
        self.attn1 = CrossAttention(dim, heads=heads, dim_head=dim_head,
                                    dtype=dtype, flash=flash)
        self.attn2 = CrossAttention(dim, context_dim=context_dim, heads=heads,
                                    dim_head=dim_head, dtype=dtype)
        self.ff = FeedForward(dim, dtype=dtype)

    def forward(self, x, context, refer=None):
        t_len = x.shape[1]
        if refer is None:
            xa = self.attn1(self.norm1(x).to(x.dtype)) + x
        else:
            xa = torch.cat([x, refer.to(x.dtype)], dim=1)
            xa_n = self.norm1(xa).to(xa.dtype)
            # the refer rows are truncated right after attn1, so their
            # queries are dead: attend from the x rows only
            xa = self.attn1(xa_n[:, :t_len], context=xa_n) + x
        y = self.attn2(self.norm2(xa).to(xa.dtype), context) + xa
        y = self.ff(self.norm3(y).to(y.dtype)) + y
        return (y, x) if refer is None else y


class SpatialTransformer1D(nn.Module):
    """GroupNorm -> 1x1 proj_in -> transformer blocks -> zero-init 1x1
    proj_out -> + input. (B, C, T) in and out."""

    def __init__(self, channels: int, heads: int, dim_head: int,
                 context_dim: int, depth: int = 1, dtype=torch.float32,
                 flash: bool = False):
        super().__init__()
        inner = heads * dim_head
        self.norm = GroupNorm32(channels, groups=32, eps=1e-6)
        self.proj_in = Conv1d(channels, inner, 1, dtype=dtype)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, heads, dim_head, context_dim, dtype,
                                  flash)
            for _ in range(depth)])
        self.proj_out = Conv1d(inner, channels, 1, dtype=dtype,
                               zero_init=True)

    def forward(self, x, context, refer=None):
        h = self.proj_in.pointwise(self.norm(x).transpose(1, 2))
        produced = None
        for blk in self.transformer_blocks:
            if refer is None:
                h, produced = blk(h, context)
            else:
                h = blk(h, context, refer)
        out = self.proj_out.pointwise(h).transpose(1, 2) + x
        return (out, produced) if refer is None else out


class UNetResBlock(nn.Module):
    """openaimodel ResBlock, 1-D, no scale-shift norm, identity skip.

    No dropout, whatever cfg.dropout says, as in JAX: its trunk never
    passes deterministic=False to the block, in training either
    (xtts_tpu/models/aa_diffusion.py:82-83, :321)."""

    def __init__(self, channels: int, emb_dim: int, dtype=torch.float32):
        super().__init__()
        self.in_layers = nn.ModuleList([
            GroupNorm32(channels, groups=32), nn.SiLU(),
            Conv1d(channels, channels, 3, padding=1, dtype=dtype)])
        self.emb_layers = nn.ModuleList([nn.SiLU(),
                                         Linear(emb_dim, channels, dtype=dtype)])
        self.out_layers = nn.ModuleList([
            GroupNorm32(channels, groups=32), nn.SiLU(), nn.Dropout(0.0),
            Conv1d(channels, channels, 3, padding=1, dtype=dtype,
                   zero_init=True)])

    def forward(self, x, emb):
        h = self.in_layers[2](F.silu(self.in_layers[0](x)))
        h = h + self.emb_layers[1](F.silu(emb))[:, :, None]
        h = self.out_layers[3](F.silu(self.out_layers[0](h)))
        return x + h


class UNetTrunk(nn.Module):
    """Shared trunk of BaseModel / ReferenceNet: initial conv + per level
    [ResBlock, SpatialTransformer] x num_res_blocks + a closing ResBlock.
    base=True adds the BaseModel's hint_converter and output head.
    cfg.remat checkpoints each ResBlock and SpatialTransformer while
    gradients are recorded (nn/remat.py; JAX's maybe_remat)."""

    def __init__(self, cfg: DiffusionModelConfig, dtype=torch.float32,
                 base: bool = False, flash: bool = False):
        super().__init__()
        c = self.cfg = cfg
        self.dtype = dtype
        mc = c.model_channels
        self.time_embed = nn.ModuleList([Linear(mc, 4 * mc, dtype=dtype),
                                         nn.SiLU(),
                                         Linear(4 * mc, 4 * mc, dtype=dtype)])
        blocks = [nn.ModuleList([Conv1d(c.in_channels, mc, 3, padding=1,
                                        dtype=dtype)])]
        for _level in c.channel_mult:
            for _ in range(c.num_res_blocks):
                blocks.append(nn.ModuleList([
                    UNetResBlock(mc, 4 * mc, dtype),
                    SpatialTransformer1D(mc, c.num_heads, mc // c.num_heads,
                                         c.context_dim,
                                         depth=c.transformer_depth,
                                         dtype=dtype, flash=flash)]))
            blocks.append(nn.ModuleList([UNetResBlock(mc, 4 * mc, dtype)]))
        self.blocks = nn.ModuleList(blocks)
        if base:
            self.hint_converter = Conv1d(c.in_latent_channels, mc, 3,
                                         padding=1, dtype=dtype)
            self.out = nn.ModuleList([
                GroupNorm32(mc, groups=32), nn.SiLU(),
                Conv1d(mc, c.out_channels, 3, padding=1, dtype=dtype,
                       zero_init=True)])

    def time_emb(self, t):
        e = timestep_embedding(t, self.cfg.model_channels).to(self.dtype)
        return self.time_embed[2](F.silu(self.time_embed[0](e)))

    def run(self, x, emb, context, refers=None, hint=None):
        """x (B, C_in, T). refers: ReferenceNet features (consumer) or None
        (producer: returns (h, features))."""
        h = self.blocks[0][0](x)
        if hint is not None:
            h = h + hint
        produced: List[torch.Tensor] = []
        ri = 0
        remat = self.cfg.remat
        for blk in self.blocks[1:]:
            h = remat_call(blk[0], remat, h, emb)
            if len(blk) == 2:
                if refers is None:
                    h, p = remat_call(blk[1], remat, h, context)
                    produced.append(p)
                else:
                    h = remat_call(blk[1], remat, h, context, refers[ri])
                ri += 1
        return (h, produced) if refers is None else h


class _MultiheadAttention(nn.Module):
    """Parameters of torch nn.MultiheadAttention (in_proj_weight/bias packed
    [q; k; v], out_proj); computes flax MultiHeadDotProductAttention."""

    def __init__(self, dim: int, heads: int, dtype=torch.float32):
        super().__init__()
        self.heads, self.dtype = heads, dtype
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = Linear(dim, dim, dtype=dtype)

    def reset_flax(self, g):
        dim = self.in_proj_weight.shape[1]
        for w in self.in_proj_weight.data.split(dim):
            lecun_normal_(w, dim, g)
        with torch.no_grad():
            self.in_proj_bias.zero_()

    def forward(self, x):
        dt = self.dtype
        qkv = F.linear(x.to(dt), self.in_proj_weight.to(dt),
                       self.in_proj_bias.to(dt))
        q, k, v = (a.unflatten(-1, (self.heads, -1))
                   for a in qkv.chunk(3, dim=-1))
        q = q / (q.shape[-1] ** 0.5)
        w = torch.einsum("bqhd,bkhd->bhqk", q, k)
        w = torch.softmax(w.float(), dim=-1).to(dt)
        return self.out_proj(torch.einsum("bhqk,bkhd->bqhd", w, v).flatten(-2))


class _MLP(nn.Module):
    def __init__(self, width: int, hidden: int, dtype=torch.float32):
        super().__init__()
        self.c_fc = Linear(width, hidden, dtype=dtype)
        self.c_proj = Linear(hidden, width, dtype=dtype)

    def forward(self, x):
        return self.c_proj(F.gelu(self.c_fc(x)))


class _ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, mlp_ratio: float,
                 dtype=torch.float32):
        super().__init__()
        self.ln_1 = LayerNorm(width, eps=1e-6)
        self.attn = _MultiheadAttention(width, heads, dtype)
        self.ln_2 = LayerNorm(width, eps=1e-6)
        self.mlp = _MLP(width, int(width * mlp_ratio), dtype)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x).to(x.dtype))
        return x + self.mlp(self.ln_2(x).to(x.dtype))


class _Transformer(nn.Module):
    def __init__(self, width, layers, heads, mlp_ratio, dtype):
        super().__init__()
        self.resblocks = nn.ModuleList([
            _ResidualAttentionBlock(width, heads, mlp_ratio, dtype)
            for _ in range(layers)])


class _VisionTower(nn.Module):
    def __init__(self, c: CLIPRefConfig, dtype=torch.float32):
        super().__init__()
        self.cfg = c
        self.conv1 = Conv1d(c.in_channels, c.width, c.patch_size,
                            stride=c.patch_size, bias=False, dtype=dtype)
        self.class_embedding = nn.Parameter(torch.zeros(c.width))
        self.positional_embedding = nn.Parameter(
            torch.zeros(c.max_patches + 1, c.width))
        self.ln_pre = LayerNorm(c.width, eps=1e-6)
        self.transformer = _Transformer(c.width, c.layers,
                                        c.width // c.head_width, c.mlp_ratio,
                                        dtype)
        self.ln_post = LayerNorm(c.width, eps=1e-6)

    def reset_flax(self, g):
        normal_(self.class_embedding, self.cfg.width ** -0.5, g)
        normal_(self.positional_embedding, self.cfg.width ** -0.5, g)


def patch_keep(n: int, p: float) -> int:
    """Patches PatchDropout keeps of n at rate p (JAX's static count)."""
    return max(1, int(n * (1.0 - p)))


def patch_dropout(x: torch.Tensor, p: float,
                  rand: torch.Tensor) -> torch.Tensor:
    """PatchDropout (JAX :348-358): the cls token, then the patch_keep
    patches of each row with the largest `rand` (B, n), in descending
    order of `rand` (lax.top_k's)."""
    cls_tok, patches = x[:, :1], x[:, 1:]
    _, idx = torch.topk(rand.to(x.device), patch_keep(patches.shape[1], p),
                        dim=1)
    patches = torch.gather(patches, 1,
                           idx[..., None].expand(-1, -1, x.shape[-1]))
    return torch.cat([cls_tok, patches], dim=1)


class CLIPRefEncoder(nn.Module):
    """ViT over the reference mel; returns the L2-normalized token
    sequence (B, 1 + T // patch, width), or under `train` (with
    cfg.patch_dropout > 0) the cls token and the kept patches."""

    def __init__(self, cfg: CLIPRefConfig, dtype=torch.float32):
        super().__init__()
        self.visual = _VisionTower(cfg, dtype)

    def num_patches(self, t_mel: int) -> int:
        return t_mel // self.visual.cfg.patch_size

    def forward(self, mel_bct, train: bool = False,
                generator: Optional[torch.Generator] = None,
                patch_rand: Optional[torch.Tensor] = None):
        """patch_rand (B, n): the draw PatchDropout ranks (a standard
        normal from `generator` when not given)."""
        vt = self.visual
        p = vt.cfg.patch_size
        t = mel_bct.shape[-1] - mel_bct.shape[-1] % p
        x = vt.conv1(mel_bct[..., :t]).transpose(1, 2)
        cls = vt.class_embedding.to(x.dtype)[None, None].expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1)
        x = x + vt.positional_embedding[:x.shape[1]].to(x.dtype)
        if train and vt.cfg.patch_dropout > 0.0:
            if patch_rand is None:
                patch_rand = torch.randn(
                    (x.shape[0], x.shape[1] - 1), generator=generator,
                    device=generator.device if generator is not None
                    else x.device)
            x = patch_dropout(x, vt.cfg.patch_dropout, patch_rand)
        x = vt.ln_pre(x).to(x.dtype)
        for blk in vt.transformer.resblocks:
            x = blk(x)
        x = vt.ln_post(x).to(x.dtype)
        return x / torch.linalg.norm(x.float(), dim=-1,
                                     keepdim=True).to(x.dtype)


def nearest_resize_time(x_btc: torch.Tensor, t_out: int) -> torch.Tensor:
    """F.interpolate(mode='nearest') along the time axis of (B, T, C)."""
    t_in = x_btc.shape[1]
    idx = (torch.arange(t_out, device=x_btc.device) * t_in) // t_out
    return x_btc[:, idx]


class AADiffusion(nn.Module):
    """Full model; API in (B, C, T) like the reference."""

    def __init__(self, cfg: DiffusionModelConfig = DiffusionModelConfig(),
                 dtype=torch.float32, flash: bool = False):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.refer_enc = CLIPRefEncoder(cfg.clip, dtype)
        self.refer_model = UNetTrunk(cfg, dtype, flash=flash)
        self.base_model = UNetTrunk(cfg, dtype, base=True, flash=flash)
        self.unconditioned_cat_embedding = nn.Parameter(
            torch.zeros(1, cfg.in_latent_channels, 1))

    def reset_flax(self, g):
        normal_(self.unconditioned_cat_embedding, 1.0, g)

    def encode_reference(self, refer_bct):
        """CLIP context tokens (timestep-independent)."""
        return self.refer_enc(refer_bct)

    def reference_features(self, refer_bct, t, refer_cross):
        """ReferenceNet features for timesteps t: list of (B, Tr, C)."""
        emb = self.refer_model.time_emb(t)
        _, produced = self.refer_model.run(refer_bct, emb, refer_cross)
        return produced

    def denoise(self, x_bct, t, hint_bct, refer_cross, control):
        """BaseModel pass; hint_bct (B, latent, Tx) already resized.
        Returns (B, out_channels, Tx): [eps ; var fraction]."""
        bm = self.base_model
        hint = bm.hint_converter(hint_bct)
        h = bm.run(x_bct, bm.time_emb(t), refer_cross, refers=control,
                   hint=hint)
        return bm.out[2](F.silu(bm.out[0](h)))

    def uncond_hint(self, b: int, t_len: int):
        """(B, latent, T) tiled unconditioned embedding."""
        return self.unconditioned_cat_embedding.expand(b, -1, t_len)

    def forward(self, x_bct, t, hint_bct, refer_bct,
                conditioning_free: bool = False,
                uncond_mask: Optional[torch.Tensor] = None,
                train: bool = False,
                generator: Optional[torch.Generator] = None,
                patch_rand: Optional[torch.Tensor] = None):
        """The reference's forward (aa_model.py:329-339; JAX __call__).
        uncond_mask (B,) bool: the training CFG dropout, drawn by the
        caller (those rows take the unconditioned embedding as hint).
        train: the CLIP encoder's PatchDropout, ranked by patch_rand (B, n)
        or a normal draw from `generator`. Returns (B, out_channels, T)."""
        b, _, t_x = x_bct.shape
        if conditioning_free:
            hint_bct = self.uncond_hint(b, t_x)
        else:
            if uncond_mask is not None:
                uc = self.uncond_hint(b, hint_bct.shape[-1])
                hint_bct = torch.where(uncond_mask[:, None, None],
                                       uc.to(hint_bct.dtype), hint_bct)
            hint_bct = nearest_resize_time(hint_bct.transpose(1, 2),
                                           t_x).transpose(1, 2)
        refer_cross = self.refer_enc(refer_bct, train=train,
                                     generator=generator,
                                     patch_rand=patch_rand)
        control = self.reference_features(refer_bct, t, refer_cross)
        return self.denoise(x_bct, t, hint_bct, refer_cross, control)


TACOTRON_MEL_MAX = 5.5451774444795624753378569716654
TACOTRON_MEL_MIN = -16.118095650958319788125940182791


def normalize_tacotron_mel(mel):
    """clamp + 0.18215 scale."""
    return torch.clamp(mel, min=-TACOTRON_MEL_MAX) * 0.18215


def denormalize_tacotron_mel(norm_mel):
    return norm_mel / 0.18215
