"""Port parity: mel front-end and spectral ops (xtts_tpu_torch/dsp vs
xtts_tpu/dsp), same numpy inputs on both sides, f32 on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from xtts_tpu.core.config import MelConfig  # noqa: E402
from xtts_tpu.dsp import mel as jmel, spectral as jspec  # noqa: E402
from xtts_tpu_torch.core import config as tcfg  # noqa: E402
from xtts_tpu_torch.dsp import mel as tmel, spectral as tspec  # noqa: E402

MEL_CONFIGS = {
    "center_htk": MelConfig(),
    "same_slaney": MelConfig(n_mels=80, mel_fmax=8000.0, mel_scale="slaney",
                             mel_norm="slaney", padding="same"),
    "power2_16k": MelConfig(sample_rate=16000, n_mels=64, n_fft=512,
                            win_length=400, hop_length=160, power=2.0),
}


def _wav(seed, n=12000, b=1):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 24000.0
    return (0.3 * np.sin(2 * np.pi * 220 * t)[None]
            + 0.1 * rng.standard_normal((b, n))).astype(np.float32)


@pytest.mark.parametrize("name", sorted(MEL_CONFIGS))
def test_mel_frontend_l1(name):
    cfg = MEL_CONFIGS[name]
    wav = _wav(1, b=2)
    want = np.asarray(jmel.MelFrontend(cfg)(wav))
    got = tmel.MelFrontend(tcfg.MelConfig.from_dict(cfg.to_dict()),
                           device="cpu")(wav).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).mean() < 1e-4, np.abs(got - want).mean()


def test_mel_filterbank_and_safe_log():
    for scale, norm in (("htk", None), ("slaney", "slaney")):
        np.testing.assert_array_equal(
            tmel.mel_filterbank(24000, 1024, 100, 0.0, None, scale, norm),
            jmel.mel_filterbank(24000, 1024, 100, 0.0, None, scale, norm))
    x = np.abs(np.random.default_rng(2).standard_normal(64)).astype(
        np.float32) * 1e-4
    np.testing.assert_allclose(tmel.safe_log(torch.from_numpy(x)).numpy(),
                               np.asarray(jmel.safe_log(jnp.asarray(x))),
                               rtol=1e-6)


@pytest.mark.parametrize("n_fft,hop,win", [(1024, 256, 1024), (512, 160, 400),
                                           (64, 16, 64)])
def test_stft_complex(n_fft, hop, win):
    x = _wav(3, n=4000, b=2)
    want = np.asarray(jspec.stft(jnp.asarray(x), n_fft, hop, win))
    got = tspec.stft(torch.from_numpy(x), n_fft, hop, win).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got.real, want.real, atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(got.imag, want.imag, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("padding", ["same", "center"])
def test_istft(padding):
    rng = np.random.default_rng(4)
    re = rng.standard_normal((2, 513, 40)).astype(np.float32)
    im = rng.standard_normal((2, 513, 40)).astype(np.float32)
    want = np.asarray(jspec.istft(jnp.asarray(re), jnp.asarray(im), 1024, 256,
                                  padding=padding))
    got = tspec.istft(torch.from_numpy(re), torch.from_numpy(im), 1024, 256,
                      padding=padding).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_frame_overlap_add_and_window():
    x = _wav(5, n=1000, b=2)
    np.testing.assert_array_equal(
        tspec.frame_signal(torch.from_numpy(x), 64, 16).numpy(),
        np.asarray(jspec.frame_signal(jnp.asarray(x), 64, 16)))
    fr = np.random.default_rng(6).standard_normal((2, 9, 32)).astype(
        np.float32)
    np.testing.assert_allclose(
        tspec.overlap_add(torch.from_numpy(fr), 8, 96).numpy(),
        np.asarray(jspec.overlap_add(jnp.asarray(fr), 8, 96)), atol=1e-6)
    np.testing.assert_allclose(tspec.hann_window(400, device="cpu").numpy(),
                               np.asarray(jspec.hann_window(400)), atol=1e-7)
    y = tspec._reflect_pad_1d(torch.from_numpy(x), 7).numpy()
    np.testing.assert_array_equal(
        y, np.asarray(jspec._reflect_pad_1d(jnp.asarray(x), 7)))


@pytest.mark.parametrize("b,n,win,hop,extra", [(2, 9, 32, 8, 0),
                                               (1, 300, 1024, 256, 0),
                                               (3, 50, 1024, 512, 0),
                                               (2, 7, 64, 16, 5),
                                               (2, 6, 30, 8, 0)])
def test_overlap_add_is_the_sequential_scatter_add(b, n, win, hop, extra):
    """overlap_add sums the frames in frame order (slabs of hop samples,
    where the hop divides the window): bit for bit the sequential
    scatter-add (index_add_ on the CPU), signed zeros included."""
    fr = torch.from_numpy(np.random.default_rng(n).standard_normal(
        (b, n, win)).astype(np.float32))
    fr[0, 0, :3] = -0.0
    size = (n - 1) * hop + win + extra
    idx = tspec._frame_index(n, win, hop, "cpu").reshape(-1)
    want = torch.zeros(b, size).index_add_(1, idx, fr.reshape(b, -1))
    got = tspec.overlap_add(fr, hop, size)
    assert torch.equal(got, want)
    assert torch.equal(torch.signbit(got), torch.signbit(want))


@pytest.mark.parametrize("padding", ["same", "center"])
@pytest.mark.parametrize("frame_len", [64, 1024])
def test_mdct_imdct(padding, frame_len):
    """mdct and imdct against JAX's (the f32 cosine-basis products, sine
    window, TDAC overlap-add, edge trim), within 1e-4 of the peak."""
    half = frame_len // 2
    x = _wav(7, n=24 * half, b=2)
    want = np.asarray(jspec.mdct(jnp.asarray(x), frame_len, padding))
    got = tspec.mdct(torch.from_numpy(x), frame_len, padding).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    c = np.random.default_rng(8).standard_normal(
        (2, 20, half)).astype(np.float32)
    want = np.asarray(jspec.imdct(jnp.asarray(c), frame_len, padding))
    got = tspec.imdct(torch.from_numpy(c), frame_len, padding).numpy()
    n_out = 20 * half if padding == "same" else 19 * half
    assert got.shape == want.shape == (2, n_out)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("padding", ["same", "center"])
def test_mdct_tdac_round_trip(padding):
    """imdct(mdct(x)) gives x back (time-domain aliasing cancels between
    overlapping frames) away from the first and last half frame, and
    equals JAX's round trip; atol 1e-4 (f32 sums of 64 terms)."""
    frame_len, half = 64, 32
    x = _wav(9, n=40 * half, b=2)
    y = tspec.imdct(tspec.mdct(torch.from_numpy(x), frame_len, padding),
                    frame_len, padding).numpy()
    yj = np.asarray(jspec.imdct(jspec.mdct(jnp.asarray(x), frame_len,
                                           padding), frame_len, padding))
    assert y.shape == x.shape
    np.testing.assert_allclose(y[:, half:-half], x[:, half:-half], atol=1e-4)
    np.testing.assert_allclose(y, yj, atol=1e-4)
