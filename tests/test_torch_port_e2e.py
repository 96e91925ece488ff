"""Port parity for the whole slice: tokens -> int8 AR codes -> latent ->
diffusion -> Vocos, xtts_tpu_torch.infer.api.TextToSpeech against
xtts_tpu.infer.api.TextToSpeech on one tiny configuration (f32, CPU), plus
the import and weight-layout guards of the port."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xtts_tpu.core.config import (CLIPRefConfig, DVAEConfig,  # noqa: E402
                                  DiffusionModelConfig, GPTConfig,
                                  HiFiGANConfig, MelConfig, VocosConfig,
                                  XTTSConfig)
from xtts_tpu.infer import api as japi, qdecode as jq  # noqa: E402
from xtts_tpu.utils import convert as jconv  # noqa: E402
from xtts_tpu_torch.core import config as tcfg  # noqa: E402
from xtts_tpu_torch.infer import api as tapi, qdecode as tq  # noqa: E402
from xtts_tpu_torch.nn import flash_attn as tfa  # noqa: E402
from xtts_tpu_torch.ops import decode_step as tds  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
MB = 8
TINY = XTTSConfig(
    mel=MelConfig(n_mels=MB),
    vqvae=DVAEConfig(channels=MB, num_tokens=30, hidden_dim=16,
                     num_resnet_blocks=1, codebook_dim=16, num_layers=2),
    gpt=GPTConfig(layers=2, model_dim=128, heads=2, max_mel_tokens=604,
                  max_text_tokens=64, number_mel_codes=200,
                  start_mel_token=198, stop_mel_token=199, mel_bins=MB,
                  cond_attn_blocks=1),
    diffusion=DiffusionModelConfig(
        in_channels=MB, out_channels=2 * MB, model_channels=64,
        num_res_blocks=1, channel_mult=(1,), num_heads=2, context_dim=32,
        in_latent_channels=128,
        clip=CLIPRefConfig(embed_dim=32, width=32, layers=1, head_width=16,
                           patch_size=4, in_channels=MB, max_patches=64)),
    vocos=VocosConfig(input_channels=MB, dim=32, intermediate_dim=64,
                      num_layers=1, n_fft=64, hop_length=16),
)
TINY_T = tcfg.XTTSConfig.from_dict(TINY.to_dict())
# with a HiFi-GAN decoder narrow enough for the CPU (latent dim = the GPT's)
TINY_H = TINY.replace(hifigan=HiFiGANConfig(
    decoder_input_dim=128, upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
    upsample_initial_channel=32, resblock_kernel_sizes=(3,),
    resblock_dilation_sizes=((1, 3),), d_vector_dim=32))


def randomize(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = randomize(v, rng)
            continue
        v = np.asarray(v)
        if k == "scale":
            x = 1.0 + 0.1 * rng.standard_normal(v.shape)
        elif k == "embedding":
            x = 0.3 * rng.standard_normal(v.shape)
        elif k == "bias" or v.ndim <= 1:
            x = 0.1 * rng.standard_normal(v.shape)
        else:
            x = rng.standard_normal(v.shape) / np.sqrt(np.prod(v.shape[:-1]))
        out[k] = x.astype(np.float32)
    return out


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One PyTorch intra-op thread while a file that drives the model runs
    (imported by the port's other model-level test files): the suite runs
    in parallel workers on shared cores, where each worker's own thread pool
    oversubscribes them and the plain twins' many small ops slow down
    many-fold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def shaped_zeros(init):
    """Zeros shaped like the variables init() returns, by tracing alone,
    with dict keys sorted as a jitted init returns them (randomize draws
    in key order: the same draws as from jax.jit(init)'s output)."""
    return jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                                  jax.eval_shape(init))


def traced_zeros(init):
    """Zeros shaped like the variables init() returns, by tracing alone,
    in init()'s own key order: an eager flax init's dicts keep the order
    the parameters were created in, which jax.eval_shape's output loses
    (it sorts dict keys), and randomize draws in that order."""
    made = []

    def f():
        made.append(init())
        return made[-1]
    shapes = jax.eval_shape(f)

    def rebuild(ordered, shaped):
        if isinstance(ordered, dict):
            return {k: rebuild(ordered[k], shaped[k]) for k in ordered}
        return np.zeros(shaped.shape, shaped.dtype)
    return rebuild(made[0], shapes)


def jax_variables(cfg, key, with_clvp=False):
    """The variables JAX's TextToSpeech.init_random gives for key: the
    DVAE's from its own compiled init (its codebook is used as drawn), the
    gpt, diffusion, vocos (and clvp) parameters as zeros of their traced
    shapes, since every test redraws those (randomize reads shapes and
    names only): tracing compiles nothing."""
    from xtts_tpu.models.aa_diffusion import AADiffusion
    from xtts_tpu.models.clvp import CLVP
    from xtts_tpu.models.dvae import DVAE
    from xtts_tpu.models.gpt import UnifiedVoice
    from xtts_tpu.models.vocos import Vocos
    kg, kd, kf, kv = jax.random.split(key, 4)
    c = cfg
    zeros = shaped_zeros
    out = {
        "gpt": zeros(lambda: UnifiedVoice(c.gpt).init(
            kg, jnp.zeros((1, c.gpt.mel_bins, 64)),
            jnp.zeros((1, 8), jnp.int32), jnp.array([8]),
            jnp.zeros((1, 16), jnp.int32), jnp.array([16 * 1024]))),
        "dvae": jax.jit(DVAE(c.vqvae).init)(
            kd, jnp.zeros((1, c.vqvae.channels, 64))),
        "diffusion": zeros(lambda: AADiffusion(c.diffusion).init(
            kf, jnp.zeros((1, c.diffusion.in_channels, 16)), jnp.array([0]),
            jnp.zeros((1, c.diffusion.in_latent_channels, 4)),
            jnp.zeros((1, c.diffusion.in_channels, 16)))),
        "vocos": zeros(lambda: Vocos(c.vocos).init(
            kv, jnp.zeros((1, c.vocos.input_channels, 16))))}
    if with_clvp:
        out["clvp"] = zeros(lambda: CLVP(c.clvp).init(
            jax.random.fold_in(key, 5), jnp.zeros((1, 8), jnp.int32),
            jnp.zeros((1, 8), jnp.int32)))
    return out


@pytest.fixture(scope="module")
def pair():
    jtts = japi.TextToSpeech(TINY, jax_variables(TINY, jax.random.PRNGKey(0)),
                             quantized_decode=True)
    rng = np.random.default_rng(0)
    vars_np = {name: {"params": randomize(jtts.vars[name]["params"], rng)}
               for name in ("gpt", "diffusion", "vocos")}
    jtts.vars.update(vars_np)
    jtts._qtree = jq.quantize_gpt_decode(jtts.vars["gpt"], TINY.gpt,
                                         include_fused=True)
    ttts = tapi.TextToSpeech.from_jax(vars_np, TINY_T, device="cpu",
                                      quantized_decode=True)
    return jtts, ttts, vars_np


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(1)
    sr = TINY.mel.sample_rate
    t = np.arange(int(0.5 * sr)) / sr
    wav = (0.3 * np.sin(2 * np.pi * 220 * t)
           + 0.1 * rng.standard_normal(t.shape[0])).astype(np.float32)
    text = rng.integers(3, 250, (1, 16)).astype(np.int32)
    return wav, text


def test_cond_mel(pair, inputs):
    jtts, ttts, _ = pair
    wav, _ = inputs
    np.testing.assert_allclose(ttts.cond_mel_from_wav(wav).numpy(),
                               np.asarray(jtts.cond_mel_from_wav(wav)),
                               atol=1e-3)


def test_greedy_int8_codes_token_exact(pair, inputs, monkeypatch):
    """JAX runs its Pallas K1 in interpret mode; the port its plain twin."""
    monkeypatch.setenv("XTTS_FUSED_DECODE", "1")
    jtts, ttts, _ = pair
    wav, text = inputs
    cond = np.array(jtts.cond_mel_from_wav(wav))
    jr = jq.generate_speech_quantized(
        jtts.gpt, jtts.vars["gpt"], jtts._qtree, jnp.asarray(cond),
        jnp.asarray(text), jax.random.PRNGKey(0), max_gen=24,
        do_sample=False, use_fused=True)
    tr = tq.generate_speech_quantized(
        ttts.gpt, ttts._qtree, torch.from_numpy(cond),
        torch.from_numpy(text).long(), None, max_gen=24, do_sample=False)
    np.testing.assert_array_equal(tr.codes.numpy(), np.asarray(jr.codes))
    np.testing.assert_array_equal(tr.lengths.numpy(), np.asarray(jr.lengths))


def _two_clips():
    """Two reference clips of unequal length (ports of
    tests/test_api_e2e.py:124-160)."""
    rng = np.random.default_rng(13)
    return [rng.standard_normal(3000).astype(np.float32) * 0.1,
            rng.standard_normal(4500).astype(np.float32) * 0.1]


def test_multi_clip_cond_mels_and_conditioning(pair):
    """Clips of unequal length stack to (1, 2, mel, T) as the JAX package
    stacks them, and the 4-D get_conditioning (each clip through the
    encoder, the outputs averaged) equals JAX's, both within the file's
    mel tolerance."""
    jtts, ttts, _ = pair
    clips = _two_clips()
    got = ttts.cond_mels_from_wavs(clips)
    want = np.asarray(jtts.cond_mels_from_wavs(clips))
    assert tuple(got.shape) == want.shape and want.shape[:2] == (1, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)
    assert torch.equal(ttts._cond_mel_from_cond(clips), got)
    assert ttts._cond_mel_from_cond(clips[:1]).dim() == 3
    rng = np.random.default_rng(14)
    stacked = rng.standard_normal((2, 3, MB, 20)).astype(np.float32)
    want = np.asarray(jtts.gpt.apply(jtts.vars["gpt"], jnp.asarray(stacked),
                                     method=jtts.gpt.get_conditioning))
    with torch.no_grad():
        got = ttts.gpt.get_conditioning(torch.from_numpy(stacked))
        per = torch.stack([ttts.gpt.get_conditioning(
            torch.from_numpy(stacked[:, j])) for j in range(3)]).mean(0)
    assert tuple(got.shape) == want.shape == (2, 1, TINY.gpt.model_dim)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)
    np.testing.assert_allclose(got.numpy(), per.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_multi_clip_greedy_codes_token_exact(pair, inputs, monkeypatch):
    """tts_tokens on the stacked 4-D mel of two unequal clips: greedy int8
    codes (top_p 1e-4, no repetition penalty) equal the JAX package's on
    the same mel, JAX through its Pallas K1 in interpret mode."""
    monkeypatch.setenv("XTTS_FUSED_DECODE", "1")
    jtts, ttts, _ = pair
    _, text = inputs
    cond = np.asarray(jtts.cond_mels_from_wavs(_two_clips()))
    jr = jtts._generate(jnp.asarray(cond), jnp.asarray(text),
                        jax.random.PRNGKey(0), japi.TTSSettings(
                            top_p=1e-4, repetition_penalty=1.0,
                            max_mel_tokens=24))
    out = ttts.tts_tokens(text, torch.from_numpy(cond),
                          torch.Generator().manual_seed(0),
                          tapi.TTSSettings(top_p=1e-4, repetition_penalty=1.0,
                                           max_mel_tokens=24,
                                           diffusion_steps=2))
    np.testing.assert_array_equal(out["codes"], np.asarray(jr.codes))
    np.testing.assert_array_equal(out["lengths"], np.asarray(jr.lengths))
    assert np.isfinite(out["wav"]).all()


def test_multi_clip_tts_takes_unequal_clips(pair):
    """tts() with a list of unequal clips averages the GPT conditioning and
    renders with the first clip as the diffusion's refer mel (numpy raised
    "inhomogeneous shape" before); a one-clip list takes the 3-D path."""
    _, ttts, _ = pair
    clips = _two_clips()
    settings = tapi.TTSSettings(max_mel_tokens=6, diffusion_steps=2)
    wav = ttts.tts("你好。", clips, torch.Generator().manual_seed(9),
                   settings)
    assert wav.ndim == 1 and wav.size > 0 and np.isfinite(wav).all()
    wav1 = ttts.tts("你好。", clips[:1], torch.Generator().manual_seed(9),
                    settings, use_diffusion=False)
    assert wav1.size > 0 and np.isfinite(wav1).all()


def test_multi_clip_perceiver_refused():
    """The perceiver conditioning takes one clip: a 4-D mel is refused with
    ValueError in JAX and in the port (whose UnifiedVoice builds only the
    plain encoder, so the flag is set after construction). Both refuse
    before touching a parameter, so JAX needs no initialised model."""
    import dataclasses
    from xtts_tpu.models.gpt import UnifiedVoice as JUnifiedVoice
    from xtts_tpu_torch.models.gpt import UnifiedVoice
    jcfg = TINY.gpt.replace(use_perceiver=True, perceiver_latents=4)
    jm = JUnifiedVoice(jcfg)
    with pytest.raises(ValueError, match="one clip"):
        jm.apply({"params": {}}, jnp.zeros((1, 2, MB, 16)),
                 method=jm.get_conditioning)
    m = UnifiedVoice(TINY_T.gpt)
    m.cfg = dataclasses.replace(m.cfg, use_perceiver=True)
    with pytest.raises(ValueError, match="one clip"):
        m.get_conditioning(torch.zeros(1, 2, MB, 16))


def test_render_from_shared_codes_and_xt(pair, inputs):
    """latent -> 4-step DDIM (CFG, ReferenceNet hoisted) -> Vocos from the
    same codes and the same x_T: wav within 1e-3."""
    jtts, ttts, _ = pair
    wav, text = inputs
    cond = np.array(jtts.cond_mel_from_wav(wav))
    n, n_b = 50, 64
    codes = np.full((1, n_b), TINY.gpt.stop_mel_token, np.int32)
    codes[0, :n] = np.random.default_rng(2).integers(0, 198, n)
    lens = np.array([n], np.int32)
    key = jax.random.PRNGKey(3)
    xt = np.array(jax.random.normal(jax.random.split(key)[1],
                                      (1, MB, 4 * n_b)))
    want = np.asarray(jtts._render_full_jit(
        jtts.vars["gpt"], jtts.vars["diffusion"], jtts.vars["vocos"],
        jnp.asarray(cond), japi.normalize_tacotron_mel(jnp.asarray(cond)),
        jnp.asarray(text), jnp.array([16]), jnp.asarray(codes),
        jnp.asarray(lens) * 1024, key, 1.0, steps=4, sampler="ddim",
        cond_free_k=2.0))
    settings = tapi.TTSSettings(sampler="ddim", diffusion_steps=4)
    got = ttts._render(torch.from_numpy(cond), torch.from_numpy(text).long(),
                       torch.from_numpy(codes).long(),
                       torch.from_numpy(lens).long(), None, settings,
                       noise=torch.from_numpy(xt)).numpy()
    assert got.shape == want.shape == (1, 4 * n_b * 16)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_tts_tokens_default_settings(pair, inputs):
    _, ttts, _ = pair
    wav, text = inputs
    tds.reset_launch_counts()
    tfa.flash_mha.launches = 0
    out = ttts.tts_tokens(text, ttts.cond_mel_from_wav(wav),
                          torch.Generator().manual_seed(0))
    n = max(int(out["lengths"][0]) - 2, 1)
    assert out["wav"].shape == (1, n * 4 * 16)
    assert out["wav"].dtype == np.float32 and np.isfinite(out["wav"]).all()
    # CPU tensors never reach a kernel
    assert tds.fused_decode_logits.launches == 0
    assert tfa.flash_mha.launches == 0


def test_tts_text(pair, inputs):
    _, ttts, _ = pair
    wav, _ = inputs
    out = ttts.tts("你好，世界。今天天气真好！", wav,
                   settings=tapi.TTSSettings(max_mel_tokens=30,
                                             diffusion_steps=5))
    assert out.ndim == 1 and out.shape[0] > 0 and out.shape[0] % 64 == 0
    assert np.isfinite(out).all()


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _assert_same_tree(got, want):
    g, w = dict(_flat(got)), dict(_flat(want))
    assert set(g) == set(w), sorted(set(g) ^ set(w))[:5]
    for k in w:
        np.testing.assert_array_equal(g[k], w[k], err_msg="/".join(k))


def test_state_dict_round_trip(pair):
    """port state_dict() -> xtts_tpu.utils.convert *_from_reference gives
    back the JAX parameters the port was built from."""
    _, ttts, vars_np = pair
    sd = {n: {k: v.numpy() for k, v in m.state_dict().items()}
          for n, m in ttts.modules().items()}
    _assert_same_tree(jconv.unified_voice_from_reference(
        sd["gpt"], TINY.gpt.layers, TINY.gpt.cond_attn_blocks),
        vars_np["gpt"]["params"])
    _assert_same_tree(jconv.aa_diffusion_from_reference(
        sd["diffusion"], TINY.diffusion), vars_np["diffusion"]["params"])
    _assert_same_tree(jconv.vocos_from_pretrained(
        sd["vocos"], TINY.vocos.num_layers), vars_np["vocos"]["params"])


def _port_modules():
    """Every module of the port, found on disk (the new ones included)."""
    pkg = REPO / "xtts_tpu_torch"
    return sorted(".".join(p.relative_to(REPO).with_suffix("").parts)
                  .removesuffix(".__init__")
                  for p in pkg.rglob("*.py"))


def test_imports_without_jax():
    """With jax, flax and the JAX package blocked: every port module
    imports, and tts(text) runs end to end on the CPU, through the
    diffusion and through the HiFi-GAN render; the HTTP front end answers
    a POST /tts through the slot pool."""
    mods = _port_modules()
    for m in ("infer.serving", "text.frontend", "models.hifigan",
              "data.audio", "infer.slots", "infer.http",
              "diffusion.solvers", "infer.eval_tools", "data.datasets",
              "data.fileops", "data.asr", "data.prepare", "core.logging",
              "core.checkpoint", "nn.remat", "train.schedules", "train.ema",
              "train.trainer", "train.steps", "train.cli",
              "utils.registry", "diffusion.resample", "models.classifier",
              "models.hifigan_discriminator", "train.gan"):
        assert "xtts_tpu_torch." + m in mods
    code = f"""
import sys, importlib, importlib.abc
class Block(importlib.abc.MetaPathFinder):
    # an import of these fails as on a machine without them (a None entry
    # in sys.modules would also trip scipy's probe for jax arrays)
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "flax", "xtts_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
for m in {mods!r}:
    importlib.import_module(m)
import numpy as np
from xtts_tpu_torch.core.config import XTTSConfig
from xtts_tpu_torch.infer.api import TextToSpeech, TTSSettings
cfg = XTTSConfig.from_dict({TINY_H.to_dict()!r})
tts = TextToSpeech(cfg, device="cpu", quantized_decode=True,
                   with_hifigan=True)
rng = np.random.default_rng(0)
wav = (0.1 * rng.standard_normal(cfg.mel.sample_rate // 2)).astype("float32")
out = tts.tts("你好。今天很好！", wav,
              settings=TTSSettings(max_mel_tokens=12, diffusion_steps=2))
assert out.ndim == 1 and out.shape[0] > 0 and np.isfinite(out).all()
out = tts.tts("你好。今天很好！", wav, settings=TTSSettings(max_mel_tokens=12),
              use_hifigan=True)
assert out.ndim == 1 and out.shape[0] > 0 and np.isfinite(out).all()
import io, json, urllib.request, wave
from xtts_tpu_torch.infer.http import SynthesisService, serve
svc = SynthesisService(tts, wav, settings=TTSSettings(max_mel_tokens=8),
                       max_batch=2, backend="slots")
httpd = serve(svc, "127.0.0.1", 0)
host, port = httpd.server_address[:2]
req = urllib.request.Request(f"http://{{host}}:{{port}}/tts",
                             data=json.dumps({{"text": "你好。"}}).encode())
with urllib.request.urlopen(req, timeout=300) as r:
    with wave.open(io.BytesIO(r.read())) as w:
        assert r.status == 200 and w.getnframes() > 0
assert svc.server.stats()["completed"] == 1
httpd.shutdown()
svc.close()
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "xtts_tpu")]
print("imported", len({mods!r}), "ran tts", out.shape[0], "leaked", bad)
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"imported {len(mods)} ran tts" in proc.stdout
    assert "leaked []" in proc.stdout


def test_no_jax_import_in_package():
    pat = re.compile(r"^\s*(from|import)\s+(jax|flax|xtts_tpu)(\.|\s|$)")
    files = list((REPO / "xtts_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]
    for path in files:
        for line in path.read_text().splitlines():
            assert not pat.match(line), (path, line)


def test_entry_points_default_to_the_card():
    """With no device given, the entry points take the card; on a machine
    without one they raise instead of running on the CPU."""
    from xtts_tpu_torch.dsp.mel import MelFrontend
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the defaults run there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.TextToSpeech(TINY_T)
    with pytest.raises((RuntimeError, AssertionError)):
        MelFrontend(TINY_T.mel)
