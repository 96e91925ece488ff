"""Port parity: Vocos (ConvNeXt backbone + iSTFT or IMDCT head), the
AdaLayerNorm and ResBlock backbones and the Encodec features, f32 on the
CPU, weights carried by utils.convert (vocos_from_jax,
vocos_backbone_from_jax, vocos_resnet_backbone_from_jax). The variants
agree within 1e-4 of the output's peak."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xtts_tpu.core.config import VocosConfig  # noqa: E402
from xtts_tpu.models import vocos as jvo  # noqa: E402
from xtts_tpu_torch.core import config as tcfg  # noqa: E402
from xtts_tpu_torch.models import vocos as tvo  # noqa: E402
from xtts_tpu_torch.nn.blocks import init_flax_like  # noqa: E402
from xtts_tpu_torch.utils import convert  # noqa: E402
from test_torch_port_e2e import traced_zeros  # noqa: E402

CONFIGS = {
    "tiny": VocosConfig(input_channels=8, dim=32, intermediate_dim=64,
                        num_layers=2, n_fft=64, hop_length=16),
    "narrow_24k_fft": VocosConfig(input_channels=16, dim=48,
                                  intermediate_dim=96, num_layers=3),
}


def randomize(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = randomize(v, rng)
            continue
        v = np.asarray(v)
        if k == "scale":
            x = 1.0 + 0.1 * rng.standard_normal(v.shape)
        elif k == "bias" or v.ndim <= 1:
            x = 0.1 * rng.standard_normal(v.shape)
        else:
            x = rng.standard_normal(v.shape) / np.sqrt(np.prod(v.shape[:-1]))
        out[k] = x.astype(np.float32)
    return out


def _pair(cfg, seed=0):
    jm = jvo.Vocos(cfg)
    # the eager init's shapes and key order by tracing alone (randomize
    # redraws every leaf: the same draws)
    init = traced_zeros(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, cfg.input_channels, 8))))
    params = randomize(init["params"], np.random.default_rng(seed))
    tm = tvo.Vocos(tcfg.VocosConfig.from_dict(cfg.to_dict())).eval()
    tm.load_state_dict(convert.to_torch(device="cpu", sd=convert.vocos_from_jax(
        params, cfg.num_layers)))
    return jm, {"params": params}, tm


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_wav_parity(name):
    cfg = CONFIGS[name]
    jm, jv, tm = _pair(cfg)
    mel = np.random.default_rng(1).standard_normal(
        (2, cfg.input_channels, 20)).astype(np.float32)
    want = np.asarray(jm.apply(jv, mel))
    with torch.no_grad():
        got = tm(torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (2, 20 * cfg.hop_length)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_backbone_parity():
    cfg = CONFIGS["tiny"]
    jm, jv, tm = _pair(cfg, seed=2)
    mel = np.random.default_rng(3).standard_normal((1, 8, 11)).astype(
        np.float32)
    bb = jvo.VocosBackbone(cfg)
    want = np.asarray(bb.apply({"params": jv["params"]["backbone"]},
                               jnp.swapaxes(jnp.asarray(mel), 1, 2)))
    with torch.no_grad():
        got = tm.backbone(torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def _close(got, want, rel=1e-4):
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


IMDCT = {
    "symexp": dict(input_channels=8, dim=32, intermediate_dim=64,
                   num_layers=2, head="imdct_symexp", mdct_frame_len=64,
                   head_sample_rate=24000),
    "symexp_clip": dict(input_channels=8, dim=32, intermediate_dim=64,
                        num_layers=2, head="imdct_symexp", mdct_frame_len=64,
                        clip_audio=True),
    "cos": dict(input_channels=8, dim=32, intermediate_dim=64, num_layers=1,
                head="imdct_cos", mdct_frame_len=32),
    "cos_center_clip": dict(input_channels=8, dim=32, intermediate_dim=64,
                            num_layers=1, head="imdct_cos",
                            mdct_frame_len=32, padding="center",
                            clip_audio=True),
}


@pytest.mark.parametrize("name", sorted(IMDCT))
def test_imdct_heads(name):
    """Vocos with each IMDCT head, clip_audio off and on: wav within 1e-4
    of JAX's peak; samples = frames x mdct_frame_len / 2 ("same")."""
    cfg = VocosConfig(**IMDCT[name])
    jm, jv, tm = _pair(cfg, seed=4)
    mel = 3.0 * np.random.default_rng(5).standard_normal(
        (2, cfg.input_channels, 12)).astype(np.float32)
    want = np.asarray(jm.apply(jv, mel))
    with torch.no_grad():
        got = tm(torch.from_numpy(mel)).numpy()
    half = cfg.mdct_frame_len // 2
    assert want.shape[1] == (12 if cfg.padding == "same" else 11) * half
    if cfg.clip_audio:
        assert np.abs(want).max() <= 1.0
    _close(got, want)


def test_imdct_symexp_mel_scaled_init():
    """head_sample_rate scales the head's init per output bin by JAX's
    1 - f / f_max mel-grid factor, in JAX's init and in the port's."""
    base = dict(IMDCT["symexp"], head_sample_rate=None)
    out_dim = base["mdct_frame_len"] // 2
    scale = jvo._mel_perceptual_scale(24000, out_dim)
    np.testing.assert_array_equal(tvo._mel_perceptual_scale(24000, out_dim),
                                  scale)

    def jax_kernel(sr):
        cfg = VocosConfig(**dict(base, head_sample_rate=sr))
        v = jvo.Vocos(cfg).init(jax.random.PRNGKey(3), jnp.zeros((1, 8, 4)))
        return np.asarray(v["params"]["head"]["out"]["kernel"])   # (in, out)

    def port_weight(sr):
        cfg = tcfg.VocosConfig(**dict(base, head_sample_rate=sr))
        m = tvo.Vocos(cfg)
        init_flax_like(m, torch.Generator().manual_seed(3))
        return m.head.out.weight.detach().numpy()                  # (out, in)

    def ratio(scaled, plain):          # least squares a bin
        return (scaled * plain).sum(0) / (plain * plain).sum(0)

    np.testing.assert_allclose(ratio(jax_kernel(24000), jax_kernel(None)),
                               scale, atol=1e-6)
    np.testing.assert_allclose(ratio(port_weight(24000).T,
                                     port_weight(None).T), scale, atol=1e-6)


def _backbone_params(module, x, rng, *args):
    init = traced_zeros(lambda: module.init(jax.random.PRNGKey(0),
                                            jnp.asarray(x), *args))
    return randomize(init["params"], rng)


def test_adanorm_backbone_cond_id_per_row():
    """The AdaLayerNorm (Encodec) backbone: a 0-d bandwidth id on the whole
    batch equals JAX's, and one id a row equals JAX's row by row (JAX
    broadcasts (B, C) embeddings against (T, C) rows, so it takes a (B,)
    id only at B == 1: ROADMAP, faults of the JAX package)."""
    cfg = CONFIGS["tiny"]
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 9, cfg.input_channels)).astype(np.float32)
    jb = jvo.VocosBackbone(cfg, adanorm_num_embeddings=4)
    params = _backbone_params(jb, x, rng, jnp.array(1))
    # scale embeddings around 1, as trained ones sit
    for tree in [params["norm"]] + [params[f"convnext_{i}"]["norm"]
                                    for i in range(cfg.num_layers)]:
        tree["scale"]["embedding"] += 1.0
    tb = tvo.VocosBackbone(tcfg.VocosConfig.from_dict(cfg.to_dict()),
                           adanorm_num_embeddings=4).eval()
    tb.load_state_dict(convert.to_torch(convert.vocos_backbone_from_jax(
        params, cfg.num_layers), "cpu"))
    xt = torch.from_numpy(x).transpose(1, 2)
    with torch.no_grad():
        for cid in (0, 3):
            want = np.asarray(jb.apply({"params": params}, jnp.asarray(x),
                                       jnp.array(cid)))
            _close(tb(xt, torch.tensor(cid)).numpy(), want)
        got = tb(xt, torch.tensor([2, 1])).numpy()
    for row, cid in enumerate((2, 1)):
        want = np.asarray(jb.apply({"params": params},
                                   jnp.asarray(x[row:row + 1]),
                                   jnp.array([cid])))
        _close(got[row:row + 1], want)
    with pytest.raises((TypeError, ValueError)):
        jb.apply({"params": params}, jnp.asarray(x), jnp.array([2, 1]))


def test_resnet_backbone():
    """VocosResNetBackbone (3 dilated ResBlock1s, layer scale 1/9)."""
    cfg = CONFIGS["tiny"]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 15, cfg.input_channels)).astype(np.float32)
    jb = jvo.VocosResNetBackbone(cfg, num_blocks=3)
    params = _backbone_params(jb, x, rng)
    tb = tvo.VocosResNetBackbone(tcfg.VocosConfig.from_dict(cfg.to_dict()),
                                 num_blocks=3).eval()
    tb.load_state_dict(convert.to_torch(
        convert.vocos_resnet_backbone_from_jax(params, 3), "cpu"))
    assert tuple(tb.resnet[0].gamma[0].shape) == (cfg.dim, 1)
    want = np.asarray(jb.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = tb(torch.from_numpy(x).transpose(1, 2)).numpy()
    assert got.shape == (2, 15, cfg.dim)
    _close(got, want)
    init = tvo.VocosResNetBackbone(tcfg.VocosConfig.from_dict(cfg.to_dict()))
    init_flax_like(init, torch.Generator().manual_seed(0))
    assert float(init.resnet[2].gamma[1][0, 0]) == pytest.approx(1 / 9)


def test_encodec_features():
    """The one-gather codebook sum with per-quantizer offsets, and the
    injected encoder's bandwidth lookup."""
    rng = np.random.default_rng(8)
    num_q, bins, d = 3, 16, 8
    weights = rng.standard_normal((num_q * bins, d)).astype(np.float32)
    codes = rng.integers(0, bins, (num_q, 2, 5))
    want = np.asarray(jvo.encodec_features(jnp.asarray(codes, jnp.int32),
                                           jnp.asarray(weights), bins))
    got = tvo.encodec_features(torch.from_numpy(codes),
                               torch.from_numpy(weights), bins).numpy()
    _close(got, want)
    seen = {}

    def encode_fn(audio, bandwidth):
        seen["bw"] = bandwidth
        return codes

    fx = tvo.EncodecFeatures(encode_fn, weights, bins=bins)
    out = fx(torch.zeros(2, 240), bandwidth_id=2)
    assert seen["bw"] == 6.0 and tuple(out.shape) == (2, d, 5)
    _close(out.numpy(), want)


def test_unknown_head_refused():
    """A head JAX does not know raises ValueError, as JAX's Vocos does."""
    with pytest.raises(ValueError, match="unknown Vocos head"):
        jvo.Vocos(VocosConfig(head="dct")).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 100, 4)))
    with pytest.raises(ValueError, match="unknown Vocos head"):
        tvo.Vocos(tcfg.VocosConfig(head="dct"))
