"""Typed configuration system of the port (its own copy of
xtts_tpu/core/config.py: the port imports nothing of the JAX package).

Field names, defaults and the JSON round trip are the JAX package's, so a
config written by one package loads in the other
(tests/test_torch_port_config.py holds them field for field). Every model
and trainer has a dataclass config with defaults mirroring the reference's
shipped configs (ttts/gpt/config.json, ttts/diffusion/config.yaml), JSON
round-tripping, and nested access.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple


def _asdict(obj) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _asdict(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_asdict(x) for x in obj]
    return obj


def _relist(v):
    """Recursively convert lists (from JSON) to tuples."""
    if isinstance(v, list):
        return tuple(_relist(x) for x in v)
    return v


class ConfigBase:
    """Mixin: to_dict / to_json / from_dict with nested dataclass support."""

    def to_dict(self) -> dict:
        return _asdict(self)

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    @classmethod
    def from_dict(cls, d: dict):
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name not in d:
                continue
            v = d[f.name]
            # nested dataclass support: resolve the nested type from either a
            # plain default or a default_factory
            nested = None
            if dataclasses.is_dataclass(f.default.__class__) \
                    and not isinstance(f.default, dataclasses._MISSING_TYPE):
                nested = f.default.__class__
            elif f.default_factory is not dataclasses.MISSING \
                    and dataclasses.is_dataclass(f.default_factory):
                nested = f.default_factory
            if nested is not None and isinstance(v, dict):
                kwargs[f.name] = nested.from_dict(v)
            elif isinstance(v, list) and f.name not in ("betas",):
                # JSON round-trips tuples as lists; freeze back for hashability
                kwargs[f.name] = _relist(v)
            else:
                kwargs[f.name] = v
        return cls(**kwargs)

    @classmethod
    def from_json(cls, path: str):
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class MelConfig(ConfigBase):
    """100-bin 24 kHz log-mel front-end (ttts/gpt/config.json "mel" block,
    ttts/vocoder/feature_extractors.py:73-99)."""

    sample_rate: int = 24000
    n_fft: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    n_mels: int = 100
    mel_fmin: float = 0.0
    mel_fmax: Optional[float] = None  # None -> sample_rate / 2
    power: float = 1.0
    mel_scale: str = "htk"       # torchaudio default ("htk") or "slaney"
    mel_norm: Optional[str] = None  # None or "slaney"
    padding: str = "center"      # "center" (reflect) or "same"
    log_clip: float = 1e-5


@dataclass(frozen=True)
class DVAEConfig(ConfigBase):
    """DiscreteVAE over mel (ttts/gpt/config.json "vqvae",
    ttts/vqvae/xtts_dvae.py:202-403)."""

    channels: int = 100          # mel bins
    num_tokens: int = 8192       # codebook size
    hidden_dim: int = 512
    num_resnet_blocks: int = 3
    codebook_dim: int = 512
    num_layers: int = 2          # stride-2 conv layers -> 4x compression
    kernel_size: int = 3
    stride: int = 2
    use_transposed_convs: bool = False
    activation: str = "relu"
    smooth_l1_loss: bool = True
    ssim_loss_weight: float = 0.5
    ema_decay: float = 0.99
    ema_eps: float = 1e-5
    compression: int = 4         # num_layers stride-2 => 2**num_layers
    # Quantize(balancing_heuristic=...) — re-randomize over/under-used
    # codes each 64k-code window (xtts_dvae.py:53-85). Off by default in
    # the reference too; see models/dvae.py balance_codebook for caveats.
    balancing_heuristic: bool = False
    balance_window: int = 64000


@dataclass(frozen=True)
class GPTConfig(ConfigBase):
    """UnifiedVoice GPT (ttts/gpt/config.json "gpt", ttts/gpt/model.py:293-362)."""

    layers: int = 15
    model_dim: int = 1024
    heads: int = 16
    max_mel_tokens: int = 604
    max_text_tokens: int = 402
    max_conditioning_inputs: int = 1
    mel_length_compression: int = 1024   # wav samples per mel code
    number_text_tokens: int = 256
    start_text_token: int = 255
    # the reference ctor default (ttts/gpt/model.py:295): config.json never
    # overrides it, so live checkpoints were trained with text stop id 1
    stop_text_token: int = 1
    number_mel_codes: int = 8194
    start_mel_token: int = 8192
    stop_mel_token: int = 8193
    # Reference AR-decode position quirk: inference_speech's fake_inputs
    # double-count the cond slot (len = conds + emb, ttts/gpt/model.py:574),
    # so GPT2InferenceModel embeds generated code t at mel position t+1
    # (attention_mask.shape[1] - mel_len, :147-149) — position 1 is never
    # used, diverging from the teacher-forced arange positions. Reference
    # checkpoints were *inferenced* this way, so reproducing it is required
    # for token-level parity; set False for the train-consistent convention.
    decode_position_quirk: bool = True
    use_perceiver: bool = False
    perceiver_latents: int = 32
    cond_attn_blocks: int = 6
    mel_bins: int = 100
    types: int = 1
    # per-block gradient checkpointing: none | dots | dots_no_batch | full
    # (HF gradient_checkpointing equivalent, ttts/gpt/model.py:257)
    remat: str = "none"
    # derived sequence geometry (matches build_hf_gpt_transformer at
    # ttts/gpt/model.py:344-345): mel positions = max_mel+2+max_cond,
    # text positions = max_text+2
    @property
    def max_mel_positions(self) -> int:
        return self.max_mel_tokens + 2 + self.max_conditioning_inputs

    @property
    def max_text_positions(self) -> int:
        return self.max_text_tokens + 2

    @property
    def n_positions(self) -> int:
        return self.max_mel_positions + self.max_text_positions


@dataclass(frozen=True)
class CLIPRefConfig(ConfigBase):
    """CLIP-style reference-mel encoder (ttts/diffusion/config.yaml "clip",
    ttts/diffusion/cldm/cond_emb.py:144-186)."""

    # pooled-path output projection dim (cond_emb.py:106). The LIVE path —
    # encode_image's full-sequence early return (transformer.py:503-520),
    # what AA_diffusion consumes — never applies that projection, so this
    # field only documents the reference config (context_dim == width)
    embed_dim: int = 512
    width: int = 512
    layers: int = 6
    head_width: int = 64
    mlp_ratio: float = 4.0
    patch_size: int = 32
    in_channels: int = 100
    # the reference treats image_size as 2-D even for 1-D mels, so its
    # positional table has grid^2 (+1 cls) rows = (1000//32)^2
    # (transformer.py:358-371); only the first T+1 rows are ever used, but
    # the table shape must match for checkpoint conversion
    max_patches: int = (1000 // 32) ** 2
    patch_dropout: float = 0.4


@dataclass(frozen=True)
class DiffusionModelConfig(ConfigBase):
    """AA_diffusion: BaseModel UNet1D + ReferenceNet + CLIP ref encoder
    (ttts/diffusion/config.yaml base_diffusion/refer_diffusion/clip,
    ttts/diffusion/aa_model.py:307-339)."""

    in_channels: int = 100
    out_channels: int = 200          # epsilon + learned-range variance
    model_channels: int = 512
    num_res_blocks: int = 2
    channel_mult: Tuple[int, ...] = (1, 1)
    num_heads: int = 8
    transformer_depth: int = 1
    context_dim: int = 512
    dropout: float = 0.0
    in_latent_channels: int = 1024   # GPT latent dim -> hint_converter
    unconditioned_percentage: float = 0.1
    # per-block gradient checkpointing over ResBlocks + SpatialTransformers
    # (LDM use_checkpoint equivalent, ldm/modules/attention.py:270-272)
    remat: str = "none"
    clip: CLIPRefConfig = field(default_factory=CLIPRefConfig)


@dataclass(frozen=True)
class DiffusionProcessConfig(ConfigBase):
    """Gaussian diffusion process (ttts/utils/diffusion.py usage in
    test.py:84-86 / ttts/diffusion/train_ms.py:132-137)."""

    timesteps: int = 1000
    schedule: str = "linear"
    # the next three document the only combination the live reference uses
    # (epsilon + learned_range + mse, train_ms.py:132-137); GaussianDiffusion
    # hardcodes that math, so any other value is rejected at construction
    model_mean_type: str = "epsilon"
    model_var_type: str = "learned_range"
    loss_type: str = "mse"
    # inference default step count (test.py:84); runtime knob is
    # TTSSettings.diffusion_steps
    sampling_timesteps: int = 50
    sampler: str = "dpm++2m"
    conditioning_free: bool = True
    conditioning_free_k: float = 2.0
    ramp_conditioning_free: bool = True

    def __post_init__(self):
        fixed = {"model_mean_type": "epsilon",
                 "model_var_type": "learned_range", "loss_type": "mse"}
        for k, want in fixed.items():
            if getattr(self, k) != want:
                raise NotImplementedError(
                    f"{k}={getattr(self, k)!r}: only {want!r} is implemented "
                    f"(the only mode the reference's live path uses)")


@dataclass(frozen=True)
class VocosConfig(ConfigBase):
    """Vocos vocoder (ttts/vocoder/config.yaml, ttts/vocoder/models.py:26-88)."""

    input_channels: int = 100
    dim: int = 512
    intermediate_dim: int = 1536
    num_layers: int = 8
    n_fft: int = 1024
    hop_length: int = 256
    padding: str = "same"
    # Fourier head (ttts/vocoder/heads.py): "istft" (the live
    # charactr/vocos-mel-24khz checkpoint), "imdct_symexp", "imdct_cos"
    head: str = "istft"
    mdct_frame_len: int = 1024          # IMDCT heads only
    head_sample_rate: Optional[int] = None  # imdct_symexp mel-scale init
    clip_audio: bool = False


@dataclass(frozen=True)
class CLVPConfig(ConfigBase):
    """CLVP contrastive reranker (ttts/clvp/config.json, ttts/clvp/model.py:19-140)."""

    # live values: ttts/clvp/config.json "clvp" + ctor defaults
    # (ttts/clvp/model.py:27-45); use_xformers defaults False there, so live
    # checkpoints use the tortoise tower with learned positions
    dim_text: int = 768
    dim_speech: int = 768
    dim_latent: int = 768
    num_text_tokens: int = 256
    text_enc_depth: int = 20
    text_seq_len: int = 120
    text_heads: int = 16
    num_speech_tokens: int = 8192
    speech_enc_depth: int = 20
    speech_heads: int = 16
    # reference xtransformers max_seq_len (absolute-pos fallback table);
    # the rotary encoders here are length-free, so this only documents the
    # reference config (clvp/config.json)
    speech_seq_len: int = 250
    use_xformers: bool = False


@dataclass(frozen=True)
class ClassifierConfig(ConfigBase):
    """Audio quality (clean/noise) mel classifier (ttts/classifier/config.json,
    ttts/classifier/model.py:64-151)."""

    spec_dim: int = 100
    classes: int = 2
    base_channels: int = 32
    depth: int = 5
    resnet_blocks: int = 2
    attn_blocks: int = 4
    num_attn_heads: int = 4
    dropout: float = 0.0
    embedding_dim: int = 512
    downsample_factor: int = 4
    kernel_size: int = 5
    distribute_zero_label: bool = False


@dataclass(frozen=True)
class HiFiGANConfig(ConfigBase):
    """XTTS-v2-style HifiDecoder: GPT latent -> waveform
    (ttts/hifigan/config.json:15-30, ttts/hifigan/hifigan_vocoder.py:655-771)."""

    input_sample_rate: int = 22050
    output_sample_rate: int = 24000
    output_hop_length: int = 256
    ar_mel_length_compression: int = 1024
    decoder_input_dim: int = 1024
    resblock_type: str = "1"
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5),) * 3
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    upsample_rates: Tuple[int, ...] = (8, 8, 2, 2)
    upsample_initial_channel: int = 512
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 4, 4)
    d_vector_dim: int = 512
    cond_d_vector_in_each_upsampling_layer: bool = True
    # mirrors dsp.mel.SPEAKER_ENCODER_MEL_CONFIG.sample_rate (the actual
    # source of truth for speaker_mel_from_wav) — hifigan/config.json parity
    speaker_encoder_audio_config_sr: int = 16000
    # "layer" for our own training; "affine" = folded eval-mode BatchNorm,
    # the layout produced by hifigan_from_reference checkpoint conversion
    speaker_norm_mode: str = "layer"


@dataclass(frozen=True)
class TrainConfig(ConfigBase):
    """Shared trainer knobs (ttts/gpt/config.json "train")."""

    train_steps: int = 100000
    val_freq: int = 100
    save_freq: int = 1000
    keep_ckpts: int = 3
    lr: float = 1e-4
    text_weight: float = 0.01
    mel_weight: float = 1.0
    accum_grad: int = 16
    grad_clip: float = 1.0
    warmup_steps: int = 1000
    min_lr_ratio: float = 0.1
    lr_schedule: str = "cosine"   # cosine | linear | exponential | constant
    weight_decay: float = 0.01
    batch_size: int = 8
    seed: int = 0
    dtype: str = "bfloat16"       # compute dtype; params stay f32
    # gradient checkpointing for the trained family's blocks
    # (none | dots | dots_no_batch | full — xtts_tpu/nn/remat.py)
    remat: str = "none"


@dataclass(frozen=True)
class XTTSConfig(ConfigBase):
    """Top-level bundle mirroring ttts/gpt/config.json + diffusion/config.yaml."""

    mel: MelConfig = field(default_factory=MelConfig)
    vqvae: DVAEConfig = field(default_factory=DVAEConfig)
    gpt: GPTConfig = field(default_factory=GPTConfig)
    diffusion: DiffusionModelConfig = field(default_factory=DiffusionModelConfig)
    diffusion_process: DiffusionProcessConfig = field(default_factory=DiffusionProcessConfig)
    vocos: VocosConfig = field(default_factory=VocosConfig)
    clvp: CLVPConfig = field(default_factory=CLVPConfig)
    classifier: ClassifierConfig = field(default_factory=ClassifierConfig)
    hifigan: HiFiGANConfig = field(default_factory=HiFiGANConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
