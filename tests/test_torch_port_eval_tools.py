"""Port parity: the offline evaluation tools (xtts_tpu_torch/infer/
eval_tools.py, data/datasets.py MelCache) against xtts_tpu/infer/
eval_tools.py on the CPU, over wav files written to a temp dir; DVAE and
Vocos weights carried by utils.convert. Codes bit-exact, codebook usage
equal, mel L1 and MCD within 1e-4 (relative for the MCD, in dB)."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xtts_tpu.core.config import DVAEConfig, MelConfig, VocosConfig  # noqa: E402
from xtts_tpu.data.audio import load_wav as jload  # noqa: E402
from xtts_tpu.dsp import mel as jmel  # noqa: E402
from xtts_tpu.infer import eval_tools as jev  # noqa: E402
from xtts_tpu.models import dvae as jdv, vocos as jvo  # noqa: E402
from xtts_tpu_torch.core import config as tcfg  # noqa: E402
from xtts_tpu_torch.data.audio import save_wav  # noqa: E402
from xtts_tpu_torch.data.datasets import MelCache  # noqa: E402
from xtts_tpu_torch.dsp import mel as tmel  # noqa: E402
from xtts_tpu_torch.infer import eval_tools as tev  # noqa: E402
from xtts_tpu_torch.models import dvae as tdv, vocos as tvo  # noqa: E402
from xtts_tpu_torch.utils import convert  # noqa: E402
from test_torch_port_vocos import randomize  # noqa: E402

MEL = MelConfig(n_mels=8)
DV = DVAEConfig(channels=8, num_tokens=30, hidden_dim=16,
                num_resnet_blocks=1, codebook_dim=16, num_layers=2)
VO = VocosConfig(input_channels=8, dim=32, intermediate_dim=64, num_layers=1,
                 n_fft=64, hop_length=16)


@pytest.fixture(scope="module")
def models():
    jd = jdv.DVAE(DV)
    init = jax.jit(jd.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8, 32)))
    dvars = {"params": randomize(init["params"], np.random.default_rng(0)),
             "codebook": {k: np.asarray(v)
                          for k, v in init["codebook"].items()}}
    td = tdv.DVAE(tcfg.DVAEConfig.from_dict(DV.to_dict())).eval()
    td.load_state_dict(convert.to_torch(convert.dvae_from_jax(
        dvars, DV.num_layers, DV.num_resnet_blocks), "cpu"))
    jv = jvo.Vocos(VO)
    vinit = jax.jit(jv.init)(jax.random.PRNGKey(1), jnp.zeros((1, 8, 8)))
    vvars = {"params": randomize(vinit["params"], np.random.default_rng(1))}
    tv = tvo.Vocos(tcfg.VocosConfig.from_dict(VO.to_dict())).eval()
    tv.load_state_dict(convert.to_torch(convert.vocos_from_jax(
        vvars, VO.num_layers), "cpu"))
    return (jd, dvars, jv, vvars, jmel.MelFrontend(MEL), td, tv,
            tmel.MelFrontend(tcfg.MelConfig.from_dict(MEL.to_dict()),
                             device="cpu"))


def _clip(seed, seconds):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 24000)) / 24000.0
    return (0.3 * np.sin(2 * np.pi * (150 + 40 * seed) * t)
            + 0.05 * rng.standard_normal(t.shape[0])).astype(np.float32)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("clips")
    paths = []
    for i in range(3):          # one length: JAX's eager ops compile once
        p = str(d / f"clip{i}.wav")
        save_wav(p, _clip(i, 0.5))
        paths.append(p)
    return paths


def test_dvae_roundtrip(models, clips):
    """One clip's mel (each package's front end on the same wav): codes
    bit-exact, reconstruction and mel L1 within 1e-4."""
    jd, dvars, _, _, jm, td, _, tm = models
    for p in clips:
        wav, _ = jload(p, 24000)
        want = jev.dvae_roundtrip(jd, dvars, np.asarray(jm(wav))[0])
        got = tev.dvae_roundtrip(td, tm(wav)[0])
        np.testing.assert_array_equal(got["codes"], want["codes"])
        assert got["unique_codes"] == want["unique_codes"]
        assert got["mel_l1"] == pytest.approx(want["mel_l1"], abs=1e-4)
        np.testing.assert_allclose(got["recon"], want["recon"], atol=1e-4)


def test_evaluate_dvae(models, clips, tmp_path):
    """evaluate_dvae over the wav list and over cached `.mel.npy` paths:
    the summary (mel L1 mean within 1e-4, codebook usage, n), the JSON
    lines, the Vocos renders of the reconstructions, and a path without a
    mel skipped, as JAX's."""
    jd, dvars, jv, vvars, jm, td, tv, tm = models
    paths = clips + [str(tmp_path / "missing.wav")]
    want = jev.evaluate_dvae(jd, dvars, paths,
                             out_jsonl=str(tmp_path / "j.jsonl"), vocos=jv,
                             vocos_vars=vvars, wav_dir=str(tmp_path / "jw"),
                             mel_fn=jm)
    got = tev.evaluate_dvae(td, paths, out_jsonl=str(tmp_path / "t.jsonl"),
                            vocos=tv, wav_dir=str(tmp_path / "tw"),
                            mel_fn=tm)
    assert got["n"] == want["n"] == 3
    assert got["codebook_usage"] == want["codebook_usage"]
    assert got["mel_l1_mean"] == pytest.approx(want["mel_l1_mean"], abs=1e-4)
    jl = [json.loads(x) for x in open(tmp_path / "j.jsonl")]
    tl = [json.loads(x) for x in open(tmp_path / "t.jsonl")]
    assert [r["unique_codes"] for r in tl] == [r["unique_codes"] for r in jl]
    for i in range(3):
        a, _ = jload(str(tmp_path / "tw" / f"clip{i}_recon.wav"))
        b, _ = jload(str(tmp_path / "jw" / f"clip{i}_recon.wav"))
        assert a.shape == b.shape and np.abs(a - b).max() <= 2 / 32768
    # cached mels (the port's front end, saved beside each wav) are read
    # instead of the wav, with or without a front end
    for p in clips:
        np.save(p + ".mel.npy", tm(jload(p, 24000)[0])[0].numpy())
    assert MelCache(None)(clips[0]).shape[0] == 8
    got_c = tev.evaluate_dvae(td, clips)
    want_c = jev.evaluate_dvae(jd, dvars, [p + ".mel.npy" for p in clips])
    assert got_c["codebook_usage"] == want_c["codebook_usage"]
    assert got_c["mel_l1_mean"] == pytest.approx(want_c["mel_l1_mean"],
                                                 abs=1e-4)
    assert tev.evaluate_dvae(td, [str(tmp_path / "missing.wav")])["n"] == 0


@pytest.mark.parametrize("n_a,n_b", [(9000, 9000), (20000, 13000)])
def test_mel_l1_and_mcd(models, n_a, n_b):
    """The render distances on random waveforms of equal and unequal
    length (the shared length, 8192-sample buckets)."""
    _, _, _, _, jm, _, _, tm = models
    rng = np.random.default_rng(n_a + n_b)
    a = (0.2 * rng.standard_normal(n_a)).astype(np.float32)
    b = (0.2 * rng.standard_normal(n_b)).astype(np.float32)
    assert tev.mel_l1(tm, a, b) == pytest.approx(jev.mel_l1(jm, a, b),
                                                 abs=1e-4)
    want = jev.mcd(jm, a, b)
    assert want > 1.0
    assert tev.mcd(tm, a, b) == pytest.approx(want, rel=1e-4)
    assert tev.mel_l1(tm, a, a) == 0.0 and tev.mcd(tm, a, a) == 0.0
