"""Port parity: Vocos (ConvNeXt backbone + iSTFT head), f32 on the CPU,
weights carried by utils.convert.vocos_from_jax."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xtts_tpu.core.config import VocosConfig  # noqa: E402
from xtts_tpu.models import vocos as jvo  # noqa: E402
from xtts_tpu_torch.core import config as tcfg  # noqa: E402
from xtts_tpu_torch.models import vocos as tvo  # noqa: E402
from xtts_tpu_torch.utils import convert  # noqa: E402

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
    init = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, cfg.input_channels, 8)))
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


def test_other_heads_are_refused():
    with pytest.raises(NotImplementedError):
        tvo.Vocos(tcfg.VocosConfig(head="imdct_symexp"))
