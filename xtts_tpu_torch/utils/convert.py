"""JAX parameter trees (as numpy) -> the port's state dicts.

The inverse of xtts_tpu/utils/convert.py's *_from_reference functions: the
port's modules carry the reference's torch names, so these produce exactly
the state dict a reference checkpoint would hold. Layout rules:

* flax Dense kernel (in, out) -> torch Linear weight (out, in);
* HF GPT2 Conv1D keeps (in, out) as it is;
* flax Conv kernel (k, in, out) on channels-last -> torch Conv1d weight
  (out, in, k) on (B, C, T); a 1x1 conv stored as a flax Dense (in, out)
  becomes (out, in, 1);
* flax LayerNorm/GroupNorm {scale, bias} -> {weight, bias};
* flax Embed {embedding} -> {weight};
* flax MultiHeadDotProductAttention q/k/v (E, H, hd) kernels -> the packed
  nn.MultiheadAttention in_proj_weight (3E, E).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

SD = Dict[str, np.ndarray]


def _params(tree: Mapping[str, Any]) -> Mapping[str, Any]:
    return tree["params"] if "params" in tree else tree


def _a(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _dense(sd: SD, prefix: str, p: Mapping[str, Any]) -> None:
    sd[prefix + ".weight"] = _a(p["kernel"]).T
    if "bias" in p:
        sd[prefix + ".bias"] = _a(p["bias"])


def _conv1d_hf(sd: SD, prefix: str, p: Mapping[str, Any]) -> None:
    sd[prefix + ".weight"] = _a(p["kernel"])
    sd[prefix + ".bias"] = _a(p["bias"])


def _conv(sd: SD, prefix: str, p: Mapping[str, Any]) -> None:
    sd[prefix + ".weight"] = np.transpose(_a(p["kernel"]), (2, 1, 0))
    if "bias" in p:
        sd[prefix + ".bias"] = _a(p["bias"])


def _conv1x1(sd: SD, prefix: str, p: Mapping[str, Any]) -> None:
    sd[prefix + ".weight"] = _a(p["kernel"]).T[:, :, None]
    if "bias" in p:
        sd[prefix + ".bias"] = _a(p["bias"])


def _norm(sd: SD, prefix: str, p: Mapping[str, Any]) -> None:
    sd[prefix + ".weight"] = _a(p["scale"])
    sd[prefix + ".bias"] = _a(p["bias"])


def unflatten_npz(npz) -> Dict[str, Any]:
    """A flat "a/b/c"-keyed npz (the JAX package's utils/registry.save_npz)
    -> the nested variable tree. A params-only file gets its "params"
    level back."""
    out: Dict[str, Any] = {}
    for key in npz.files:
        cur = out
        parts = key.split("/")
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = np.asarray(npz[key])
    return out if "params" in out else {"params": out}


# the reference's fixed (non-learned) buffers the port computes instead:
# the Vocos heads' ISTFT window and IMDCT window / twiddles
FIXED_BUFFER_PREFIXES = ("head.istft.", "head.imdct.")


def drop_fixed_buffers(sd: Mapping[str, Any]) -> Dict[str, Any]:
    return {k: v for k, v in sd.items()
            if not k.startswith(FIXED_BUFFER_PREFIXES)}


def to_torch(sd: SD, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.array(v, copy=True), device=device)
            for k, v in sd.items()}


# ---------------------------------------------------------------------------

def unified_voice_from_jax(tree: Mapping[str, Any], layers: int,
                           cond_attn_blocks: int = 6) -> SD:
    """The conditioning is the perceiver's where the tree holds a
    perceiver_encoder (use_perceiver), else the encoder's."""
    p = _params(tree)
    sd: SD = {
        "text_embedding.weight": _a(p["text_embedding"]["embedding"]),
        "mel_embedding.weight": _a(p["mel_embedding"]["embedding"]),
        "text_pos_embedding.emb.weight":
            _a(p["text_pos_embedding"]["embedding"]),
        "mel_pos_embedding.emb.weight":
            _a(p["mel_pos_embedding"]["embedding"]),
    }
    g = p["gpt"]
    for i in range(layers):
        h, pre = g[f"h_{i}"], f"gpt.h.{i}."
        _norm(sd, pre + "ln_1", h["ln_1"])
        _conv1d_hf(sd, pre + "attn.c_attn", h["attn"]["c_attn"])
        _conv1d_hf(sd, pre + "attn.c_proj", h["attn"]["c_proj"])
        _norm(sd, pre + "ln_2", h["ln_2"])
        _conv1d_hf(sd, pre + "mlp.c_fc", h["mlp"]["c_fc"])
        _conv1d_hf(sd, pre + "mlp.c_proj", h["mlp"]["c_proj"])
    _norm(sd, "gpt.ln_f", g["ln_f"])
    _norm(sd, "final_norm", p["final_norm"])
    _dense(sd, "text_head", p["text_head"])
    _dense(sd, "mel_head", p["mel_head"])
    if "perceiver_encoder" in p:
        _perceiver(sd, "perceiver_encoder.", p["perceiver_encoder"])
        return sd
    ce = p["conditioning_encoder"]
    _conv(sd, "conditioning_encoder.init", ce["init"])
    for i in range(cond_attn_blocks):
        blk, pre = ce[f"attn_{i}"], f"conditioning_encoder.attn.{i}."
        _conv1x1(sd, pre + "qkv", blk["qkv"])
        _conv1x1(sd, pre + "proj_out", blk["proj_out"])
        _norm(sd, pre + "norm", blk["GroupNorm32_0"]["GroupNorm_0"])
    return sd


def _perceiver(sd: SD, prefix: str, p: Mapping[str, Any]) -> None:
    """JAX PerceiverResampler -> the reference's names (the inverse of
    xtts_tpu/utils/convert.py perceiver_from_reference)."""
    sd[prefix + "latents"] = _a(p["latents"])
    sd[prefix + "norm.gamma"] = _a(p["norm"]["gamma"])
    if "proj_context" in p:
        _dense(sd, prefix + "proj_context", p["proj_context"])
    i = 0
    while f"attn_{i}" in p:
        pre = f"{prefix}layers.{i}."
        for name in ("to_q", "to_kv", "to_out"):
            _dense(sd, pre + "0." + name, p[f"attn_{i}"][name])
        _dense(sd, pre + "1.0", p[f"ff_{i}"]["Dense_0"])
        _dense(sd, pre + "1.2", p[f"ff_{i}"]["Dense_1"])
        i += 1


def _clip(sd: SD, p: Mapping[str, Any], layers: int,
          prefix: str = "refer_enc.visual.") -> None:
    sd[prefix + "conv1.weight"] = np.transpose(_a(p["conv1"]["kernel"]),
                                               (2, 1, 0))
    sd[prefix + "class_embedding"] = _a(p["class_embedding"])
    sd[prefix + "positional_embedding"] = _a(p["positional_embedding"])
    _norm(sd, prefix + "ln_pre", p["ln_pre"])
    _norm(sd, prefix + "ln_post", p["ln_post"])
    for i in range(layers):
        rp = f"{prefix}transformer.resblocks.{i}."
        _norm(sd, rp + "ln_1", p[f"ln1_{i}"])
        _norm(sd, rp + "ln_2", p[f"ln2_{i}"])
        a = p[f"attn_{i}"]
        e = _a(a["query"]["kernel"]).shape[0]
        sd[rp + "attn.in_proj_weight"] = np.concatenate(
            [_a(a[n]["kernel"]).reshape(e, e).T
             for n in ("query", "key", "value")])
        sd[rp + "attn.in_proj_bias"] = np.concatenate(
            [_a(a[n]["bias"]).reshape(e) for n in ("query", "key", "value")])
        sd[rp + "attn.out_proj.weight"] = _a(a["out"]["kernel"]).reshape(e, e).T
        sd[rp + "attn.out_proj.bias"] = _a(a["out"]["bias"])
        _dense(sd, rp + "mlp.c_fc", p[f"mlp_fc_{i}"])
        _dense(sd, rp + "mlp.c_proj", p[f"mlp_proj_{i}"])


def _resblock(sd: SD, prefix: str, p: Mapping[str, Any]) -> None:
    _norm(sd, prefix + "in_layers.0", p["GroupNorm32_0"]["GroupNorm_0"])
    _conv(sd, prefix + "in_layers.2", p["in_conv"])
    _dense(sd, prefix + "emb_layers.1", p["emb_proj"])
    _norm(sd, prefix + "out_layers.0", p["GroupNorm32_1"]["GroupNorm_0"])
    _conv(sd, prefix + "out_layers.3", p["out_conv"])


def _spatial_transformer(sd: SD, prefix: str, p: Mapping[str, Any],
                         depth: int) -> None:
    _norm(sd, prefix + "norm", p["norm"]["GroupNorm_0"])
    _conv1x1(sd, prefix + "proj_in", p["proj_in"])
    _conv1x1(sd, prefix + "proj_out", p["proj_out"])
    for d in range(depth):
        b, bp = p[f"block_{d}"], f"{prefix}transformer_blocks.{d}."
        for n in ("norm1", "norm2", "norm3"):
            _norm(sd, bp + n, b[n])
        for att in ("attn1", "attn2"):
            for n in ("to_q", "to_k", "to_v"):
                _dense(sd, f"{bp}{att}.{n}", b[att][n])
            _dense(sd, f"{bp}{att}.to_out.0", b[att]["to_out"])
        _dense(sd, bp + "ff.net.0.proj", b["ff"]["proj_in"])
        _dense(sd, bp + "ff.net.2", b["ff"]["proj_out"])


def _unet_trunk(sd: SD, prefix: str, p: Mapping[str, Any], cfg) -> None:
    _conv(sd, prefix + "blocks.0.0", p["in_conv"])
    _dense(sd, prefix + "time_embed.0", p["time_fc1"])
    _dense(sd, prefix + "time_embed.2", p["time_fc2"])
    blk, ri, ai = 1, 0, 0
    for _level in cfg.channel_mult:
        for _ in range(cfg.num_res_blocks):
            _resblock(sd, f"{prefix}blocks.{blk}.0.", p[f"res_blocks_{ri}"])
            _spatial_transformer(sd, f"{prefix}blocks.{blk}.1.",
                                 p[f"attn_blocks_{ai}"],
                                 cfg.transformer_depth)
            ri, ai, blk = ri + 1, ai + 1, blk + 1
        _resblock(sd, f"{prefix}blocks.{blk}.0.", p[f"res_blocks_{ri}"])
        ri, blk = ri + 1, blk + 1


def aa_diffusion_from_jax(tree: Mapping[str, Any], cfg) -> SD:
    """cfg: DiffusionModelConfig."""
    p = _params(tree)
    sd: SD = {}
    _clip(sd, p["refer_enc"], cfg.clip.layers)
    _unet_trunk(sd, "refer_model.", p["refer_model"], cfg)
    _unet_trunk(sd, "base_model.", p["base_model"], cfg)
    _conv(sd, "base_model.hint_converter", p["hint_converter"])
    _norm(sd, "base_model.out.0", p["out_norm"]["GroupNorm_0"])
    _conv(sd, "base_model.out.2", p["out_conv"])
    sd["unconditioned_cat_embedding"] = np.transpose(
        _a(p["unconditioned_cat_embedding"]), (0, 2, 1))
    return sd


def _vocos_norm(sd: SD, prefix: str, p: Mapping[str, Any]) -> None:
    """A LayerNorm {scale, bias}, or an AdaLayerNorm's {scale, shift}
    embeddings (Encodec variant) -> <prefix>.weight / .bias, or
    <prefix>.scale.weight / .shift.weight."""
    if "embedding" in p.get("scale", {}):
        sd[prefix + ".scale.weight"] = _a(p["scale"]["embedding"])
        sd[prefix + ".shift.weight"] = _a(p["shift"]["embedding"])
    else:
        _norm(sd, prefix, p)


def vocos_backbone_from_jax(tree: Mapping[str, Any], num_layers: int = 8,
                            prefix: str = "") -> SD:
    """VocosBackbone params (plain or AdaLayerNorm) -> the reference's
    names under `prefix`."""
    bb = _params(tree)
    sd: SD = {}
    _conv(sd, prefix + "embed", bb["embed"])
    _vocos_norm(sd, prefix + "norm", bb["norm"])
    for i in range(num_layers):
        blk, pre = bb[f"convnext_{i}"], f"{prefix}convnext.{i}."
        _conv(sd, pre + "dwconv", blk["dwconv"])
        _vocos_norm(sd, pre + "norm", blk.get("norm", blk.get("LayerNorm_0")))
        _dense(sd, pre + "pwconv1", blk["pwconv1"])
        _dense(sd, pre + "pwconv2", blk["pwconv2"])
        sd[pre + "gamma"] = _a(blk["gamma"])
    _norm(sd, prefix + "final_layer_norm", bb["final_layer_norm"])
    return sd


def vocos_from_jax(tree: Mapping[str, Any], num_layers: int = 8) -> SD:
    """Vocos params (any head: istft, imdct_symexp and imdct_cos each hold
    one Dense "out") -> the reference's names."""
    p = _params(tree)
    sd = vocos_backbone_from_jax(p["backbone"], num_layers, "backbone.")
    _dense(sd, "head.out", p["head"]["out"])
    return sd


def vocos_resnet_backbone_from_jax(tree: Mapping[str, Any],
                                   num_blocks: int = 3,
                                   num_dilations: int = 3) -> SD:
    """VocosResNetBackbone params -> the reference's names with the weight
    norm folded (embed, resnet.{i}.convs1.{j} / convs2.{j} / gamma.{j} of
    shape (dim, 1))."""
    p = _params(tree)
    sd: SD = {}
    _conv(sd, "embed", p["embed"])
    for i in range(num_blocks):
        blk = p[f"resnet_{i}"]
        for j in range(num_dilations):
            pre = f"resnet.{i}."
            _conv(sd, f"{pre}convs1.{j}", blk[f"convs1_{j}"])
            _conv(sd, f"{pre}convs2.{j}", blk[f"convs2_{j}"])
            if f"gamma_{j}" in blk:
                sd[f"{pre}gamma.{j}"] = _a(blk[f"gamma_{j}"])[:, None]
    return sd


def dvae_from_jax(tree: Mapping[str, Any], num_layers: int = 2,
                  num_resnet_blocks: int = 3) -> SD:
    """DVAE variables ({"params", "codebook"}) -> the reference's names
    (the inverse of xtts_tpu/utils/convert.py dvae_from_reference)."""
    p, cb = tree["params"], tree["codebook"]
    enc, dec = p["encoder"], p["decoder"]
    L, R = num_layers, num_resnet_blocks
    sd: SD = {}

    def resblock(prefix: str, blk: Mapping[str, Any]) -> None:
        for j in range(3):
            _conv(sd, f"{prefix}.net.{2 * j}", blk[f"Conv_{j}"])

    for i in range(L):
        _conv(sd, f"encoder.{i}.0", enc[f"Conv_{i}"])
    for j in range(R):
        resblock(f"encoder.{L + j}", enc[f"res{j}"])
    _conv(sd, f"encoder.{L + R}", enc["to_codes"])
    _conv(sd, "decoder.0", dec["from_codes"])
    for j in range(R):
        resblock(f"decoder.{1 + j}", dec[f"res{j}"])
    for i in range(L):
        _conv(sd, f"decoder.{1 + R + i}.0.conv", dec[f"up{i}"])
    _conv(sd, f"decoder.{1 + R + L}", dec["to_mel"])
    for k in cb:      # embed, cluster_size, embed_avg (+ bal_hist, bal_total)
        sd[f"codebook.{k}"] = _a(cb[k])
    return sd


def clvp_from_jax(tree: Mapping[str, Any], cfg) -> SD:
    """CLVP params -> the port's names; cfg: CLVPConfig. The live tortoise
    towers take the reference's names (the inverse of
    xtts_tpu/utils/convert.py clvp_from_reference)."""
    p = _params(tree)
    sd: SD = {}
    for name in ("text_emb", "speech_emb", "text_pos_emb", "speech_pos_emb"):
        if name in p:
            sd[name + ".weight"] = _a(p[name]["embedding"])
    for side, depth in (("text", cfg.text_enc_depth),
                        ("speech", cfg.speech_enc_depth)):
        tp, pre = p[f"{side}_transformer"], f"{side}_transformer."
        for i in range(depth):
            if cfg.use_xformers:
                b, bp = tp[f"block_{i}"], f"{pre}blocks.{i}."
                sd[bp + "norm1.scale"] = _a(b["norm1"]["scale"])
                sd[bp + "norm2.scale"] = _a(b["norm2"]["scale"])
                _dense(sd, bp + "attn.qkv", b["attn"]["qkv"])
                _dense(sd, bp + "attn.out", b["attn"]["out"])
                _dense(sd, bp + "ff.wi", b["ff"]["wi"])
                _dense(sd, bp + "ff.wo", b["ff"]["wo"])
                continue
            b, lp = tp[f"layer_{i}"], f"{pre}layers.layers.{i}."
            sd[lp + "0.scale"] = _a(b["scale_attn"]).reshape(1, 1, -1)
            _norm(sd, lp + "0.fn.norm", b["norm_attn"])
            _dense(sd, lp + "0.fn.fn.to_qkv", b["attn"]["to_qkv"])
            _dense(sd, lp + "0.fn.fn.to_out.0", b["attn"]["to_out"])
            sd[lp + "1.scale"] = _a(b["scale_ff"]).reshape(1, 1, -1)
            _norm(sd, lp + "1.fn.norm", b["norm_ff"])
            _dense(sd, lp + "1.fn.fn.net.0", b["ff_in"])
            _dense(sd, lp + "1.fn.fn.net.3", b["ff_out"])
        if cfg.use_xformers:
            sd[pre + "final_norm.scale"] = _a(tp["final_norm"]["scale"])
    _dense(sd, "to_text_latent", p["to_text_latent"])
    _dense(sd, "to_speech_latent", p["to_speech_latent"])
    sd["temperature"] = _a(p["temperature"]).reshape(1)
    return sd


def _channel_norm(sd: SD, prefix: str, p: Mapping[str, Any]) -> None:
    """_ChannelNorm: flax LayerNorm {LayerNorm_0: {scale, bias}} (mode
    "layer") -> {weight, bias}; the affine mode's {scale, shift} -> an
    eval BatchNorm whose statistics fold to exactly that affine (mean 0,
    var + 1e-5 == 1 in f32)."""
    if "LayerNorm_0" in p:
        _norm(sd, prefix, p["LayerNorm_0"])
        return
    sd[prefix + ".weight"] = _a(p["scale"])
    sd[prefix + ".bias"] = _a(p["shift"])
    sd[prefix + ".running_mean"] = np.zeros_like(_a(p["scale"]))
    sd[prefix + ".running_var"] = np.full_like(
        _a(p["scale"]), np.float32(1.0) - np.float32(1e-5))


def _conv2d(sd: SD, prefix: str, p: Mapping[str, Any]) -> None:
    """flax Conv (kT, kF, in, out) on (B, T, F, C) -> torch Conv2d
    (out, in, kF, kT) on (B, C, F, T)."""
    sd[prefix + ".weight"] = np.transpose(_a(p["kernel"]), (3, 2, 1, 0))
    if "bias" in p:
        sd[prefix + ".bias"] = _a(p["bias"])


def hifigan_from_jax(tree: Mapping[str, Any], cfg) -> SD:
    """HifiDecoder variables (either speaker norm mode) -> the port's
    HifiDecoder state dict, under the reference's names. A flax "SAME"
    transposed-conv kernel (k, in, out) becomes torch's (in, out, k)
    flipped along k (the inverse of convert.py's _convtranspose1d_wn)."""
    p = _params(tree)
    g, s = p["waveform_decoder"], p["speaker_encoder"]
    sd: SD = {}
    w = "waveform_decoder."
    _conv(sd, w + "conv_pre", g["conv_pre"])
    _conv(sd, w + "conv_post", g["conv_post"])
    _conv1x1(sd, w + "cond_layer", g["cond_layer"])
    nk = len(cfg.resblock_kernel_sizes)
    for i in range(len(cfg.upsample_rates)):
        up = g[f"up_{i}"]
        sd[f"{w}ups.{i}.weight"] = np.ascontiguousarray(
            np.transpose(_a(up["kernel"])[::-1], (1, 2, 0)))
        sd[f"{w}ups.{i}.bias"] = _a(up["bias"])
        if f"cond_up_{i}" in g:
            _conv1x1(sd, f"{w}conds.{i}", g[f"cond_up_{i}"])
        for j in range(nk):
            blk = g[f"res_{i}_{j}"]
            rp = f"{w}resblocks.{i * nk + j}."
            for m in range(len(cfg.resblock_dilation_sizes[j])):
                if cfg.resblock_type == "1":
                    _conv(sd, f"{rp}convs1.{m}", blk[f"c1_{m}"])
                    _conv(sd, f"{rp}convs2.{m}", blk[f"c2_{m}"])
                else:
                    _conv(sd, f"{rp}convs.{m}", blk[f"c_{m}"])
    e = "speaker_encoder."
    _conv2d(sd, e + "conv1", s["stem"])
    _channel_norm(sd, e + "bn1", s["stem_norm"])
    for name, blk in s.items():
        if not name.startswith("stage"):
            continue
        si, bi = (int(v) for v in name[len("stage"):].split("_block"))
        bp = f"{e}layer{si + 1}.{bi}."
        _conv2d(sd, bp + "conv1", blk["conv1"])
        _channel_norm(sd, bp + "bn1", blk["norm1"])
        _conv2d(sd, bp + "conv2", blk["conv2"])
        _channel_norm(sd, bp + "bn2", blk["norm2"])
        _dense(sd, bp + "se.fc.0", blk["se"]["fc1"])
        _dense(sd, bp + "se.fc.2", blk["se"]["fc2"])
        if "short" in blk:
            _conv2d(sd, bp + "downsample.0", blk["short"])
            _channel_norm(sd, bp + "downsample.1", blk["short_norm"])
    _conv1x1(sd, e + "attention.0", s["asp_fc"])
    _channel_norm(sd, e + "attention.2", s["asp_norm"])
    _conv1x1(sd, e + "attention.3", s["asp_att"])
    _dense(sd, e + "fc", s["proj"])
    return sd


def classifier_from_jax(tree: Mapping[str, Any], cfg) -> SD:
    """AudioClassifier params -> the reference's names (the inverse of
    xtts_tpu/utils/convert.py classifier_from_reference); cfg:
    ClassifierConfig."""
    p = _params(tree)
    e, sd = p["encoder"], {}
    _conv(sd, "enc.init.0", e["init"])
    i = 0
    for d in range(cfg.depth):
        for r in range(cfg.resnet_blocks):
            b, pre = e[f"res_{d}_{r}"], f"enc.res.{i}."
            _norm(sd, pre + "in_layers.0", b["GroupNorm32_0"]["GroupNorm_0"])
            _conv(sd, pre + "in_layers.2", b["in_conv"])
            _norm(sd, pre + "out_layers.0", b["out_norm"]["GroupNorm_0"])
            _conv(sd, pre + "out_layers.3", b["out_conv"])
            i += 1
        _conv(sd, f"enc.res.{i}.op", e[f"down_{d}"])
        i += 1
    _norm(sd, "enc.final.0", e["final_norm"]["GroupNorm_0"])
    _conv(sd, "enc.final.2", e["final"])
    for a in range(cfg.attn_blocks):
        b, pre = e[f"attn_{a}"], f"enc.attn.{a}."
        _norm(sd, pre + "norm", b["GroupNorm32_0"]["GroupNorm_0"])
        _conv1x1(sd, pre + "qkv", b["qkv"])
        _conv1x1(sd, pre + "proj_out", b["proj_out"])
    _dense(sd, "head", p["head"])
    return sd


def hifigan_discriminator_from_jax(tree: Mapping[str, Any],
                                   periods=(2, 3, 5, 7, 11),
                                   scales: int = 3) -> SD:
    """HifiganDiscriminator params -> the port's (reference) names: a
    period discriminator's flax (k, 1, in, out) kernels on (B, T/p, p, C)
    become Conv2d (out, in, k, 1) on (B, C, T/p, p); the scale
    discriminators' grouped (k, in/g, out) kernels Conv1d (out, in/g, k)."""
    p = _params(tree)
    sd: SD = {}
    for i, per in enumerate(periods):
        dp, pre = p[f"mpd_{per}"], f"mpd.discriminators.{i}."
        for j in range(5):
            c = dp[f"c{j}"]
            sd[f"{pre}convs.{j}.weight"] = np.transpose(_a(c["kernel"]),
                                                        (3, 2, 0, 1))
            sd[f"{pre}convs.{j}.bias"] = _a(c["bias"])
        sd[pre + "conv_post.weight"] = np.transpose(
            _a(dp["post"]["kernel"]), (3, 2, 0, 1))
        sd[pre + "conv_post.bias"] = _a(dp["post"]["bias"])
    for i in range(scales):
        ds, pre = p[f"msd_{i}"], f"msd.discriminators.{i}."
        for j in range(7):
            _conv(sd, f"{pre}convs.{j}", ds[f"c{j}"])
        _conv(sd, pre + "conv_post", ds["post"])
    return sd


def _attn_block_rel(sd: SD, prefix: str, p: Mapping[str, Any]) -> None:
    """nn.blocks.AttentionBlock with the relative position bias."""
    _norm(sd, prefix + "norm", p["GroupNorm32_0"]["GroupNorm_0"])
    _conv1x1(sd, prefix + "qkv", p["qkv"])
    _conv1x1(sd, prefix + "proj_out", p["proj_out"])
    sd[prefix + "relative_pos_embeddings.relative_attention_bias.weight"] = \
        _a(p["rel_pos"]["relative_attention_bias"]["embedding"])


def _ts_resblock(sd: SD, prefix: str, p: Mapping[str, Any]) -> None:
    """models.diffusion_tts.TimestepResBlock."""
    _norm(sd, prefix + "in_layers.0", p["GroupNorm32_0"]["GroupNorm_0"])
    _conv(sd, prefix + "in_layers.2", p["in_conv"])
    _dense(sd, prefix + "emb_layers.1", p["emb_layers"])
    _norm(sd, prefix + "out_layers.0", p["out_norm"]["GroupNorm_0"])
    _conv(sd, prefix + "out_layers.3", p["out_conv"])
    if "skip" in p:
        _conv(sd, prefix + "skip_connection", p["skip"])


def diffusion_tts_from_jax(tree: Mapping[str, Any], layers: int = 8) -> SD:
    """The legacy DiffusionTts params (num_layers `layers`) -> the port's
    (the reference's) names: the inverse of xtts_tpu/utils/convert.py
    diffusion_tts_from_reference."""
    p, sd = _params(tree), {}
    _conv(sd, "inp_block", p["inp_block"])
    _dense(sd, "time_embed.0", p["time_embed_0"])
    _dense(sd, "time_embed.2", p["time_embed_1"])
    sd["code_embedding.weight"] = _a(p["code_embedding"]["embedding"])
    _norm(sd, "code_norm", p["code_norm"]["GroupNorm_0"])
    _conv(sd, "latent_conditioner.0", p["latent_conditioner_conv"])
    _conv(sd, "contextual_embedder.0", p["contextual_conv1"])
    _conv(sd, "contextual_embedder.1", p["contextual_conv2"])
    sd["unconditioned_embedding"] = np.transpose(
        _a(p["unconditioned_embedding"]), (0, 2, 1))
    _conv(sd, "integrating_conv", p["integrating_conv"])
    _conv(sd, "mel_head", p["mel_head"])
    _norm(sd, "out.0", p["out_norm"]["GroupNorm_0"])
    _conv(sd, "out.2", p["out_conv"])
    blocks = ([(f"code_converter.{i}.", f"code_converter_{i}")
               for i in range(3)]
              + [(f"latent_conditioner.{i + 1}.",
                  f"latent_conditioner_attn_{i}") for i in range(4)]
              + [(f"contextual_embedder.{i + 2}.", f"contextual_attn_{i}")
                 for i in range(5)])
    for prefix, name in blocks:
        _attn_block_rel(sd, prefix, p[name])
    layer_names = ([(f"conditioning_timestep_integrator.{i}.",
                     f"conditioning_timestep_integrator_{i}")
                    for i in range(3)]
                   + [(f"layers.{i}.", f"layers_{i}") for i in range(layers)])
    for prefix, name in layer_names:
        _ts_resblock(sd, prefix + "resblk.", p[name]["resblk"])
        _attn_block_rel(sd, prefix + "attn.", p[name]["attn"])
    for j in range(3):
        _ts_resblock(sd, f"layers.{layers + j}.", p[f"final_res_{j}"])
    return sd


def random_latent_from_jax(tree: Mapping[str, Any]) -> SD:
    """JAX RandomLatentConverter (fc_{i} Dense) -> the port's fc.{i}."""
    p, sd = _params(tree), {}
    i = 0
    while f"fc_{i}" in p:
        _dense(sd, f"fc.{i}", p[f"fc_{i}"])
        i += 1
    return sd


# ---------------------------------------------------------------------------
# training state (xtts_tpu/train/trainer.py TrainState -> the port's)

def _find_adam(tree):
    """The optax ScaleByAdamState (count, mu, nu) inside an optimizer state
    (for the Trainer's chain: (clip's EmptyState, (ScaleByAdamState,
    EmptyState, ScaleByScheduleState)))."""
    if all(hasattr(tree, a) for a in ("count", "mu", "nu")):
        return tree
    if isinstance(tree, (tuple, list)):
        for t in tree:
            hit = _find_adam(t)
            if hit is not None:
                return hit
    return None


def adamw_state_from_jax(opt_state, to_state_dict, names, device):
    """optax's Adam moments and count, as numpy arrays, -> the port's
    AdamWState over the parameters `names`. to_state_dict maps a JAX
    variables tree ({"params": ...} and any collections) to a port state
    dict; moments are elementwise, so it carries them as it carries the
    parameters (transposes and packings included)."""
    from xtts_tpu_torch.train.trainer import AdamWState
    adam = _find_adam(opt_state)
    if adam is None:
        raise ValueError("no ScaleByAdamState (count, mu, nu) in opt_state")

    def moments(tree):
        sd = to_state_dict(tree)
        return {n: torch.as_tensor(np.array(sd[n], np.float32, copy=True),
                                   device=device) for n in names}
    return AdamWState(int(np.asarray(adam.count)), moments(adam.mu),
                      moments(adam.nu))


def train_state_from_jax(jax_state, trainer, to_state_dict, device):
    """A JAX TrainState (params, opt_state, state_cols, step; numpy leaves)
    -> the port Trainer's TrainState: the parameters and the collections
    (the DVAE's "codebook", the "ema" copies) copied into the trainer's
    model, the optimizer state and the step carried. to_state_dict: as in
    adamw_state_from_jax."""
    cols = dict(jax_state.state_cols or {})
    ema = cols.pop("ema", None)
    sd = to_state_dict({"params": jax_state.params, **cols})
    trainer.model.load_state_dict(to_torch(sd, device))
    state = trainer.init_state()
    names = list(state.params)

    def with_cols(params):
        return {"params": params, **cols}
    state.opt_state = adamw_state_from_jax(
        jax_state.opt_state, lambda t: to_state_dict(with_cols(t)), names,
        device)
    if ema is not None:
        esd = to_state_dict(with_cols(ema))
        with torch.no_grad():
            for n in names:
                state.state_cols["ema." + n].copy_(torch.as_tensor(
                    np.asarray(esd[n], np.float32)))
    state.step = int(np.asarray(jax_state.step))
    return state
