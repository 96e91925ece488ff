"""The port's own configs (xtts_tpu_torch.core.config) against the JAX
package's: the same field names and defaults, and a JSON file written by
either package loads in the other to an equal config. Exact equality."""
import dataclasses

import pytest

from xtts_tpu.core import config as jcfg
from xtts_tpu_torch.core import config as tcfg

NAMES = ["MelConfig", "DVAEConfig", "GPTConfig", "CLIPRefConfig",
         "DiffusionModelConfig", "DiffusionProcessConfig", "VocosConfig",
         "CLVPConfig", "ClassifierConfig", "HiFiGANConfig", "TrainConfig",
         "XTTSConfig"]


def _fields(cls):
    return [(f.name, f.type) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", NAMES)
def test_same_fields_and_defaults(name):
    j, t = getattr(jcfg, name), getattr(tcfg, name)
    assert t is not j
    assert _fields(t) == _fields(j)
    assert t().to_dict() == j().to_dict()


def test_flagship_defaults():
    assert tcfg.XTTSConfig().to_dict() == jcfg.XTTSConfig().to_dict()
    g = tcfg.GPTConfig()
    assert (g.layers, g.model_dim, g.heads, g.number_mel_codes) == (
        15, 1024, 16, 8194)
    assert (g.max_mel_positions, g.max_text_positions, g.n_positions) == (
        jcfg.GPTConfig().max_mel_positions,
        jcfg.GPTConfig().max_text_positions, jcfg.GPTConfig().n_positions)


KW = dict(
    mel=dict(n_mels=8, mel_fmax=8000.0, mel_scale="slaney"),
    vqvae=dict(channels=8, num_tokens=30, hidden_dim=16, codebook_dim=16),
    gpt=dict(layers=2, model_dim=128, heads=2, number_mel_codes=200,
             start_mel_token=198, stop_mel_token=199, mel_bins=8),
    diffusion=dict(model_channels=64, channel_mult=(1, 2), num_heads=2,
                   clip=dict(width=32, layers=1, head_width=16)),
    vocos=dict(dim=32, intermediate_dim=64, num_layers=1, n_fft=64,
               hop_length=16),
    clvp=dict(dim_text=32, text_enc_depth=1, use_xformers=True),
)


def _build(mod):
    kw = {k: dict(v) for k, v in KW.items()}
    clip = mod.CLIPRefConfig(**kw["diffusion"].pop("clip"))
    return mod.XTTSConfig(
        mel=mod.MelConfig(**kw["mel"]), vqvae=mod.DVAEConfig(**kw["vqvae"]),
        gpt=mod.GPTConfig(**kw["gpt"]),
        diffusion=mod.DiffusionModelConfig(clip=clip, **kw["diffusion"]),
        vocos=mod.VocosConfig(**kw["vocos"]),
        clvp=mod.CLVPConfig(**kw["clvp"]))


def test_same_keyword_arguments_agree():
    assert _build(tcfg).to_dict() == _build(jcfg).to_dict()


@pytest.mark.parametrize("writer,reader", [(jcfg, tcfg), (tcfg, jcfg)])
def test_json_round_trip_across_packages(tmp_path, writer, reader):
    path = str(tmp_path / "xtts_config.json")
    _build(writer).to_json(path)
    got = reader.XTTSConfig.from_json(path)
    assert isinstance(got, reader.XTTSConfig)
    assert got == _build(reader)
    assert got.to_dict() == _build(writer).to_dict()
    assert got.diffusion.channel_mult == (1, 2)       # tuples come back
