"""The port's data layer (xtts_tpu_torch/data/) against the JAX package's
(xtts_tpu/data/) on the CPU: the audio splitters, filelists, bucketing,
the six datasets, collation, batch_iterator with and without prefetch,
fileops and the prepare stages, each given the same inputs and seeds.
Tolerance: none — every output, batch and RNG draw is equal bit for bit
(both are numpy on the host; mels come from the same `.mel.npy` caches or
the same numpy mel function). The DVAE codes of cache_vq_codes are equal
too (the port's K3 twin against JAX's XLA argmin, f32)."""
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xtts_tpu.data import (asr as jasr, audio as jaudio,  # noqa: E402
                           datasets as jds, fileops as jfo,
                           prepare as jprep)
from xtts_tpu_torch.data import (asr as tasr, audio as taudio,  # noqa: E402
                                 datasets as tds, fileops as tfo,
                                 prepare as tprep)

SR = 24000
MB = 10


class Tok:
    """A stand-in tokenizer: characters -> ids 3-250."""

    vocab_size = 251

    def encode(self, s):
        return [3 + ord(c) % 248 for c in s]


def _numpy_mel(wav):
    """A deterministic mel-shaped function of the wav, numpy only."""
    f = len(wav) // 256
    fr = wav[:f * 256].reshape(f, 256)
    spec = np.abs(np.fft.rfft(fr, axis=-1))[:, :MB].T
    return np.log(spec + 1e-3).astype(np.float32)[None]


def _speechy(seed, seconds):
    """Tones with silent gaps (seeded), as a VAD input."""
    rng = np.random.default_rng(seed)
    parts = []
    for _ in range(int(seconds)):
        n = int(SR * rng.uniform(0.3, 1.2))
        if rng.random() < 0.5:
            parts.append(1e-4 * rng.standard_normal(n))
        else:
            t = np.arange(n) / SR
            parts.append(0.3 * np.sin(2 * np.pi * rng.uniform(120, 400) * t))
    return np.concatenate(parts).astype(np.float32)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """7 wavs of 1-4 s with cached mels, a filelist, vq caches for three."""
    d = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    entries = []
    for i in range(7):
        n = int(SR * (1 + 0.5 * i))
        t = np.arange(n) / SR
        w = (0.3 * np.sin(2 * np.pi * (150 + 30 * i) * t)
             + 0.05 * rng.standard_normal(n)).astype(np.float32)
        p = str(d / f"w{i}.wav")
        taudio.save_wav(p, w)
        np.save(p + ".mel.npy", _numpy_mel(w)[0])
        if i < 3:
            np.save(p + ".melvq.npy", rng.integers(0, 30, 20 + i))
        entries.append(jds.FilelistEntry(f"k{i}", p, "spk", "zh",
                                         f"raw {i}", "ni3 hao3 " * (i + 1)))
    return d, entries


# ---------------------------------------------------------------------------
# audio


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_audio_splitters_equal(seed):
    wav = _speechy(seed, 30)
    for fn, kw in (("detect_silence_ms", {}),
                   ("split_on_silence_ranges", {}),
                   ("silence_split_segments", dict(keep_min_sec=0.5)),
                   ("energy_vad_segments", dict(keep_min_sec=0.5))):
        assert (getattr(taudio, fn)(wav, SR, **kw)
                == getattr(jaudio, fn)(wav, SR, **kw)), fn


@pytest.mark.parametrize("deterministic", [False, True])
def test_prompt_slice_and_pad_mask(deterministic):
    wav = np.random.default_rng(3).standard_normal(SR * 8).astype(np.float32)
    for seed in range(4):
        a = taudio.get_prompt_slice(wav, SR, deterministic=deterministic,
                                    rng=np.random.default_rng(seed))
        b = jaudio.get_prompt_slice(wav, SR, deterministic=deterministic,
                                    rng=np.random.default_rng(seed))
        np.testing.assert_array_equal(a, b)
    lens = np.array([3, 7, 1])
    np.testing.assert_array_equal(taudio.make_pad_mask(lens),
                                  jaudio.make_pad_mask(lens))
    np.testing.assert_array_equal(taudio.make_pad_mask(lens, 9),
                                  jaudio.make_pad_mask(lens, 9))


# ---------------------------------------------------------------------------
# filelists, bucketing, datasets


def test_filelist_jsonl_and_buckets(tmp_path, corpus):
    _, entries = corpus
    port = [tds.FilelistEntry(*vars(e).values()) for e in entries]
    tds.write_filelist(str(tmp_path / "a.txt"), port)
    jds.write_filelist(str(tmp_path / "b.txt"), entries)
    assert (tmp_path / "a.txt").read_text() == (tmp_path / "b.txt").read_text()
    with open(tmp_path / "a.txt", "a") as f:
        f.write("bad|line\n")
    assert ([vars(e) for e in tds.read_filelist(str(tmp_path / "a.txt"))]
            == [vars(e) for e in jds.read_filelist(str(tmp_path / "a.txt"))])
    (tmp_path / "r.jsonl").write_text('{"path": "a", "text": "x"}\n\n'
                                      '{"path": "b", "text": "y"}\n')
    assert (tds.read_jsonl(str(tmp_path / "r.jsonl"))
            == jds.read_jsonl(str(tmp_path / "r.jsonl")))
    assert tds.TEXT_BUCKETS == jds.TEXT_BUCKETS
    assert tds.MEL_BUCKETS == jds.MEL_BUCKETS
    for n in (1, 32, 33, 304, 999):
        assert (tds.next_bucket(n, tds.TEXT_BUCKETS)
                == jds.next_bucket(n, jds.TEXT_BUCKETS))
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    for length, axis in ((2, -1), (7, 1), (4, 0)):
        np.testing.assert_array_equal(tds.pad_to(x, length, axis, 1.5),
                                      jds.pad_to(x, length, axis, 1.5))


def _dataset_pair(name, corpus):
    d, entries = corpus
    port_entries = [tds.FilelistEntry(*vars(e).values()) for e in entries]
    if name == "vqvae":
        return (tds.VQVAEMelDataset(port_entries, tds.MelCache(), 60, seed=4),
                jds.VQVAEMelDataset(entries, jds.MelCache(), 60, seed=4))
    if name == "gpt":
        return (tds.GptTTSDataset(port_entries, tds.MelCache(), Tok(),
                                  max_mel=300, seed=5),
                jds.GptTTSDataset(entries, jds.MelCache(), Tok(),
                                  max_mel=300, seed=5))
    if name == "diffusion":
        return (tds.DiffusionDataset(port_entries, tds.MelCache(), Tok(),
                                     max_mel=200, max_refer=150, seed=6),
                jds.DiffusionDataset(entries, jds.MelCache(), Tok(),
                                     max_mel=200, max_refer=150, seed=6))
    if name == "classifier":
        paths = [e.wav_path + ".mel.npy" for e in entries]
        return (tds.ClassifierDataset(paths[:4], paths[4:], tds.MelCache(),
                                      crop_frames=100, seed=7),
                jds.ClassifierDataset(paths[:4], paths[4:], jds.MelCache(),
                                      crop_frames=100, seed=7))
    if name == "hifigan":
        return (tds.HifiGANDataset(port_entries, Tok(), _numpy_mel, _numpy_mel,
                                   crop_samples=8 * 1024, refer_sec=0.5,
                                   seed=8),
                jds.HifiGANDataset(entries, Tok(), _numpy_mel, _numpy_mel,
                                   crop_samples=8 * 1024, refer_sec=0.5,
                                   seed=8))
    return (tds.CLVPDataset(port_entries, Tok(), max_codes=21),
            jds.CLVPDataset(entries, Tok(), max_codes=21))


def _same(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    assert set(a) == set(b)
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("name", ["vqvae", "gpt", "diffusion", "classifier",
                                  "hifigan", "clvp"])
def test_datasets_equal(name, corpus):
    """Two passes over every sample: the draws of each dataset's generator
    come in JAX's order."""
    tds_, jds_ = _dataset_pair(name, corpus)
    assert len(tds_) == len(jds_)
    for _ in range(2):
        for i in range(len(tds_)):
            _same(tds_[i], jds_[i])


def test_gpt_dataset_rejects_past_the_caps(corpus):
    tds_, jds_ = _dataset_pair("gpt", corpus)
    tds_.max_mel = jds_.max_mel = 100
    got = [tds_[i] is None for i in range(len(tds_))]
    assert got == [jds_[i] is None for i in range(len(jds_))] and any(got)


@pytest.mark.parametrize("prefetch", [0, 2])
def test_collate_and_batch_iterator_equal(corpus, prefetch):
    pads = ({"text": 0, "mel": 1, "cond_mel": 1},
            {"text": (8, 16, 32, 64), "mel": (100, 200, 400),
             "cond_mel": (100, 200, 400)})
    got_batches = []
    for pkg, ds in zip((tds, jds), _dataset_pair("gpt", corpus)):
        coll = lambda s, pkg=pkg: pkg.collate_bucketed(s, *pads)
        it = pkg.batch_iterator(ds, 3, coll, seed=9, epochs=3,
                                prefetch=prefetch if pkg is tds else 0)
        got_batches.append(list(it))
    assert len(got_batches[0]) == len(got_batches[1]) == 6
    for a, b in zip(*got_batches):
        _same(a, b)
    assert tds.collate_bucketed([None], {}, {}) is None


def test_prefetch_thread_exits_when_the_consumer_breaks():
    def endless():
        i = 0
        while True:
            yield {"x": np.full(3, i)}
            i += 1
    before = {t.ident for t in threading.enumerate()}
    it = tds.prefetch_iterator(endless(), depth=2)
    for n, b in enumerate(it):
        if n == 4:
            break
    it.close()
    deadline = time.time() + 5
    while time.time() < deadline and any(
            t.name == "prefetch-fill" and t.ident not in before
            for t in threading.enumerate()):
        time.sleep(0.05)
    assert not [t for t in threading.enumerate()
                if t.name == "prefetch-fill" and t.ident not in before]

    def bad():
        yield 1
        raise RuntimeError("loader died")
    with pytest.raises(RuntimeError, match="loader died"):
        list(tds.prefetch_iterator(bad(), depth=2))


def test_batch_iterator_refuses_an_empty_epoch(corpus):
    tds_, _ = _dataset_pair("gpt", corpus)
    tds_.max_mel = 1
    with pytest.raises(RuntimeError, match="no usable batches"):
        next(tds.batch_iterator(tds_, 2, lambda s: tds.collate_bucketed(
            s, {}, {})))


# ---------------------------------------------------------------------------
# fileops, asr, prepare


def test_fileops_equal(corpus):
    _, entries = corpus
    paths = [e.wav_path for e in entries] + ["/nonexistent.wav"]
    tt, tp, tf = tfo.corpus_duration(paths, max_workers=2)
    jt, jp, jf = jfo.corpus_duration(paths, max_workers=2)
    assert (tt, tp, len(tf)) == (jt, jp, len(jf)) and len(tf) == 1
    res, fails = tfo.do_to_files([1, 2, 0, 4], lambda x: 8 // x,
                                 max_workers=2)
    assert res == [8, 4, None, 2] and len(fails) == 1
    with pytest.raises(ZeroDivisionError):
        tfo.do_to_files([0], lambda x: 1 // x, on_error="raise")


def test_asr_interface_with_fakes(tmp_path):
    for text in ("你好世界啊", "短", "hello 你好世界", "今天天气很好"):
        assert tasr.accept_transcript(text) == jasr.accept_transcript(text)

    class Feats:
        def __init__(self, wav):
            self.input_features = torch.tensor(wav[None, :400])

    class Proc:
        class feature_extractor:
            def __new__(cls, wav, sampling_rate, return_tensors):
                assert sampling_rate == 16000
                return Feats(np.asarray(wav, np.float32))

        class tokenizer:
            @staticmethod
            def get_decoder_prompt_ids(language, task):
                raise KeyError(language)

            @staticmethod
            def batch_decode(ids, skip_special_tokens=True):
                return [" 你好世界 " + str(int(ids[0][0]))]

    class Model:
        config = type("C", (), {"max_target_positions": 64})()

        def to(self, device):
            return self

        def eval(self):
            return self

        def generate(self, feats, max_new_tokens, **kw):
            assert max_new_tokens == 56 and not kw
            return (feats[:, :1] * 0 + 7).long()

    asr = tasr.WhisperASR(model=Model(), processor=Proc(), device="cpu")
    p = str(tmp_path / "x.wav")
    taudio.save_wav(p, 0.1 * np.ones(SR, np.float32))
    assert asr(p) == "你好世界 7"
    out = tmp_path / "o.jsonl"
    tprep.vad_asr_to_jsonl([p, p], str(out), asr_fn=asr)
    assert len(out.read_text().splitlines()) == 2
    with pytest.raises(RuntimeError, match="No ASR backend"):
        tprep.transcribe(p)


def test_prepare_stages_equal(tmp_path, corpus):
    d, entries = corpus
    long = str(tmp_path / "long.wav")
    taudio.save_wav(long, np.concatenate([_speechy(5, 40)] * 2))
    outs = []
    for pkg in (tprep, jprep):
        for method in ("silence", "energy"):
            clips = pkg.vad_split_file(long, str(tmp_path / f"{pkg.__name__}"
                                                 f"{method}"), method=method,
                                       keep_min_sec=1.0)
            outs.append([open(c, "rb").read() for c in clips])
    assert outs[0] == outs[2] and outs[1] == outs[3] and outs[0]
    wav, _ = taudio.load_wav(entries[2].wav_path)
    assert (tprep.high_freq_energy_ratio(wav, SR)
            == jprep.high_freq_energy_ratio(wav, SR))
    mels = [e.wav_path + ".mel.npy" for e in entries]
    score = lambda m: float(m.mean() > -2.0)
    assert (tprep.filter_noise(mels, score) == jprep.filter_noise(mels, score))
    port_entries = [tds.FilelistEntry(*vars(e).values()) for e in entries]
    n1 = tprep.build_bpe_corpus(port_entries, str(tmp_path / "c1.txt"))
    n2 = jprep.build_bpe_corpus(entries, str(tmp_path / "c2.txt"))
    assert n1 == n2 and ((tmp_path / "c1.txt").read_text()
                         == (tmp_path / "c2.txt").read_text())
    # mel caches through a numpy mel function, over copies of three wavs
    for pkg, sub in ((tprep, "p"), (jprep, "j")):
        os.makedirs(tmp_path / sub)
        paths = []
        for e in entries[:3]:
            q = str(tmp_path / sub / os.path.basename(e.wav_path))
            with open(e.wav_path, "rb") as f, open(q, "wb") as g:
                g.write(f.read())
            paths.append(q)
        assert pkg.cache_mels(paths, _numpy_mel) == 3
        assert pkg.cache_mels(paths, _numpy_mel) == 0      # cached
    for e in entries[:3]:
        name = os.path.basename(e.wav_path) + ".mel.npy"
        np.testing.assert_array_equal(np.load(tmp_path / "p" / name),
                                      np.load(tmp_path / "j" / name))


def test_cache_vq_codes_equal(tmp_path, corpus):
    """cache_vq_codes through the port's DVAE (K3's twin on the CPU) and
    through JAX's, with the weights carried: identical codes."""
    from xtts_tpu.core.config import DVAEConfig
    from xtts_tpu.models import dvae as jdv
    from xtts_tpu_torch.core import config as tcfg
    from xtts_tpu_torch.models import dvae as tdv
    from xtts_tpu_torch.utils import convert
    d, entries = corpus
    cfg = DVAEConfig(channels=MB, num_tokens=30, hidden_dim=16,
                     num_resnet_blocks=1, codebook_dim=16, num_layers=2)
    jm = jdv.DVAE(cfg)
    jv = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, MB, 32)))
    jv = jax.tree_util.tree_map(np.asarray, jv)
    tm = tdv.DVAE(tcfg.DVAEConfig.from_dict(cfg.to_dict())).eval()
    tm.load_state_dict(convert.to_torch(convert.dvae_from_jax(
        jv, cfg.num_layers, cfg.num_resnet_blocks), "cpu"))
    jfn = jax.jit(lambda m: jm.apply(jv, m, method=jm.get_codebook_indices))
    got = {}
    for pkg, sub, fn in ((tprep, "p", tm), (jprep, "j", jfn)):
        os.makedirs(tmp_path / sub)
        paths = []
        for e in entries[3:6]:
            q = str(tmp_path / sub / os.path.basename(e.wav_path))
            np.save(q + ".mel.npy", np.load(e.wav_path + ".mel.npy"))
            paths.append(q)
        assert pkg.cache_vq_codes(paths + [str(tmp_path / "none.wav")],
                                  fn) == 3
        got[sub] = [np.load(q + ".melvq.npy") for q in paths]
    for a, b in zip(got["p"], got["j"]):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
