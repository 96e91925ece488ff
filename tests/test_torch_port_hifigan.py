"""Port parity: the HiFi-GAN latent decoder (xtts_tpu_torch/models/hifigan.py)
and the speaker front end, against xtts_tpu/models/hifigan.py on tiny
configurations (f32, CPU), weights carried by convert.hifigan_from_jax.

Bounds: waveform within 1e-4 and d-vector within 1e-5 (f32 convolutions in
another summation order); the state dict maps back through the JAX
package's hifigan_from_reference exactly (affine mode: the reference
bridge's layout); resample identical; the speaker mel within 1e-4 mean L1
(the mel front end's bound)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xtts_tpu.core.config import HiFiGANConfig  # noqa: E402
from xtts_tpu.data.audio import resample as jresample  # noqa: E402
from xtts_tpu.dsp.mel import MelFrontend as JMel  # noqa: E402
from xtts_tpu.dsp.mel import SPEAKER_ENCODER_MEL_CONFIG as JSPK  # noqa: E402
from xtts_tpu.models import hifigan as jh  # noqa: E402
from xtts_tpu.utils import convert as jconv  # noqa: E402
from xtts_tpu_torch.core import config as tcfg  # noqa: E402
from xtts_tpu_torch.data.audio import resample as tresample  # noqa: E402
from xtts_tpu_torch.dsp.mel import MelFrontend as TMel  # noqa: E402
from xtts_tpu_torch.dsp.mel import SPEAKER_ENCODER_MEL_CONFIG as TSPK  # noqa
from xtts_tpu_torch.models import hifigan as th  # noqa: E402
from xtts_tpu_torch.utils import convert  # noqa: E402

from test_torch_port_e2e import _assert_same_tree, randomize  # noqa: E402

TINY_HIFI = dict(decoder_input_dim=16, upsample_rates=(4, 2),
                 upsample_kernel_sizes=(8, 4), upsample_initial_channel=32,
                 resblock_kernel_sizes=(3, 5),
                 resblock_dilation_sizes=((1, 3), (1, 3)), d_vector_dim=32)


def _cfgs(**kw):
    cfg = HiFiGANConfig(**{**TINY_HIFI, **kw})
    return cfg, tcfg.HiFiGANConfig.from_dict(cfg.to_dict())


def _pair(mode, seed=0, **kw):
    cfg, cfg_t = _cfgs(speaker_norm_mode=mode, **kw)
    dec = jh.HifiDecoder(cfg)
    # the parameter shapes by tracing alone (a compiled flax init of the
    # speaker encoder takes longer than the whole comparison)
    shapes = jax.eval_shape(lambda: dec.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 16)),
        ref_mel16k=jnp.zeros((1, 16, 64))))["params"]
    params = randomize(jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, np.float32), shapes),
        np.random.default_rng(seed))
    tdec = th.HifiDecoder(cfg_t).eval()
    tdec.load_state_dict(convert.to_torch(
        convert.hifigan_from_jax({"params": params}, cfg_t), "cpu"))
    return cfg, dec, params, tdec


def _inputs(seed=1, b=2, t_lat=11, t_mel=40):
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((b, t_lat, 16)).astype(np.float32)
    mel = (rng.standard_normal((b, t_mel, 64)) - 4.0).astype(np.float32)
    return lat, mel


@pytest.mark.parametrize("mode,rtype", [("layer", "1"), ("affine", "1"),
                                        ("layer", "2")])
def test_hifi_decoder_matches_jax(mode, rtype):
    cfg, dec, params, tdec = _pair(mode, resblock_type=rtype)
    lat, mel = _inputs()
    want, dvec = jax.jit(lambda p, x, m: (
        dec.apply({"params": p}, x, ref_mel16k=m),
        dec.apply({"params": p}, m, method=dec.speaker_embedding)))(
            params, jnp.asarray(lat), jnp.asarray(mel))
    with torch.no_grad():
        got = tdec(torch.from_numpy(lat), ref_mel16k=torch.from_numpy(mel))
        tdvec = tdec.speaker_embedding(torch.from_numpy(mel))
    n = th.hifigan_samples(cfg, lat.shape[1])
    assert got.shape == want.shape == (2, n)
    np.testing.assert_allclose(tdvec.numpy(), np.asarray(dvec), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    assert float(np.abs(np.asarray(want)).std()) > 1e-3   # not a flat wav


def test_state_dict_bridges_back_through_reference_converter():
    """port state_dict() -> xtts_tpu.utils.convert.hifigan_from_reference
    (affine mode) gives back the JAX parameters exactly."""
    cfg, _, params, tdec = _pair("affine", seed=2)
    sd = {k: v.numpy() for k, v in tdec.state_dict().items()}
    _assert_same_tree(jconv.hifigan_from_reference(sd, cfg), params)


def test_linear_resize_and_lengths():
    x = np.random.default_rng(3).standard_normal((2, 7, 5)).astype(
        np.float32)
    for n in (7, 13, 30):
        np.testing.assert_allclose(
            th.linear_resize_time(torch.from_numpy(x), n).numpy(),
            np.asarray(jh.linear_resize_time(jnp.asarray(x), n)), atol=1e-6)
    for shipped in (HiFiGANConfig(), HiFiGANConfig(**TINY_HIFI)):
        c_t = tcfg.HiFiGANConfig.from_dict(shipped.to_dict())
        for n in (1, 50, 298, 320):
            assert th.hifigan_frames(c_t, n) == jh.hifigan_frames(shipped, n)
            assert (th.hifigan_samples(c_t, n)
                    == jh.hifigan_samples(shipped, n))


def test_instance_norm_time():
    x = np.random.default_rng(4).standard_normal((2, 9, 6)).astype(
        np.float32) * 3 + 1
    np.testing.assert_allclose(
        th.instance_norm_time(torch.from_numpy(x)).numpy(),
        np.asarray(jh.instance_norm_time(jnp.asarray(x))), atol=1e-5)


def test_speaker_front_end():
    """resample 24 k -> 16 k identical; the 16 kHz 64-bin speaker mel of
    the resampled clip within 1e-4 mean L1."""
    rng = np.random.default_rng(5)
    sr = 24000
    t = np.arange(sr // 2) / sr
    wav = (0.3 * np.sin(2 * np.pi * 220 * t)
           + 0.05 * rng.standard_normal(t.shape[0])).astype(np.float32)
    w16 = tresample(wav, sr, 16000)
    np.testing.assert_array_equal(w16, jresample(wav, sr, 16000))
    assert tresample(wav, sr, sr) is wav
    assert TSPK.to_dict() == JSPK.to_dict()
    got = TMel(TSPK, "cpu")(w16).numpy()
    want = np.asarray(JMel(JSPK)(w16))
    assert got.shape == want.shape and got.shape[1] == 64
    assert np.abs(got - want).mean() < 1e-4
