"""Port parity for the tools: utils/latents.py (RandomLatentConverter, its
weights carried by utils.convert.random_latent_from_jax, and
random_conditioning_latent), utils/alignment.py (max_alignment,
find_redactions, align_from_logits, Wav2VecAlignment.align / redact on a
fake CTC model), TextToSpeech.tts(aligner=...) and data/spider.py (a fake
listing and fetch), each against the JAX package's on the same inputs.

Tolerances: the latent MLP within rtol / atol 1e-5 (f32 products in
another order); everything else equal.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xtts_tpu.data import spider as jsp  # noqa: E402
from xtts_tpu.utils import alignment as jal, latents as jlat  # noqa: E402
from xtts_tpu_torch.data import spider as tsp  # noqa: E402
from xtts_tpu_torch.utils import alignment as tal, latents as tlat  # noqa: E402
from xtts_tpu_torch.utils import convert  # noqa: E402
from test_torch_port_e2e import shaped_zeros  # noqa: E402
from test_torch_port_gpt import randomize  # noqa: E402

# ---------------------------------------------------------------------------
# latents


def test_random_latent_converter():
    jm = jlat.RandomLatentConverter(channels=16)
    params = randomize(shaped_zeros(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16))))["params"],
        np.random.default_rng(0))
    tm = tlat.RandomLatentConverter(16)
    tm.load_state_dict(convert.to_torch(convert.random_latent_from_jax(
        params), "cpu"))
    noise = np.random.default_rng(1).standard_normal((3, 16)).astype(
        np.float32)
    want = np.asarray(jm.apply({"params": params}, noise))
    with torch.no_grad():
        got = tm(torch.from_numpy(noise)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    a = tlat.random_conditioning_latent(tm, torch.Generator().manual_seed(4),
                                        batch=2)
    b = tlat.random_conditioning_latent(tm, torch.Generator().manual_seed(4),
                                        batch=2)
    assert a.shape == (2, 16) and torch.equal(a, b)
    noise = torch.randn((2, 16), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        assert torch.equal(a, tm(noise))


# ---------------------------------------------------------------------------
# alignment

PAIRS = [("hello world", "helo wrld"), ("abc", "xyz"), ("abcabc", "cab"),
         ("the cat sat", "the cat sat"), ("", "abc"), ("aaa", "a"),
         ("mississippi", "misisipi"), ("xy", "")]


@pytest.mark.parametrize("s1,s2", PAIRS)
def test_max_alignment(s1, s2):
    assert tal.max_alignment(s1, s2) == jal.max_alignment(s1, s2)


@pytest.mark.parametrize("text", ["[I am sad,] please feed me.",
                                  "a [b] c [d]", "no brackets", "[all]"])
def test_find_redactions(text):
    assert tal.find_redactions(text) == jal.find_redactions(text)


def test_align_from_logits():
    rng = np.random.default_rng(2)
    for seed in range(4):
        logits = rng.standard_normal((40, 12)).astype(np.float32)
        ids = list(rng.integers(1, 12, 6))
        assert (tal.align_from_logits(logits, ids)
                == jal.align_from_logits(logits, ids))


VOCAB = "_abcdefghijklmnopqrstuvwxyz ,.'"


def encode(s):
    """One id a character, as the reference's character tokenizer; the
    skip character '~' gets an id the model never emits."""
    return [VOCAB.index(c) if c in VOCAB else len(VOCAB) for c in s]


def decode(ids):
    out, last = [], None
    for i in ids:
        if i != last and i != 0:
            out.append(VOCAB[i])
        last = i
    return "".join(out)


def fake_ctc(spoken, frames_per_char=3, drop=()):
    """A CTC model that 'hears' `spoken` (characters at indices in `drop`
    left out): each character for frames_per_char frames then a blank."""
    rows = []
    for i, c in enumerate(spoken):
        ids = [0] if i in drop else [VOCAB.index(c)] * frames_per_char
        for t in ids + [0]:
            row = np.full(len(VOCAB), -5.0, np.float32)
            row[t] = 5.0
            rows.append(row)
    logits = np.stack(rows)
    return lambda wav: logits


@pytest.mark.parametrize("drop", [(), (4, 9)])
def test_wav2vec_align_and_redact(drop):
    text = "[i am sad,] please feed me."
    bare = text.replace("[", "").replace("]", "")
    fn = fake_ctc(bare, drop=drop)
    wav = np.arange(len(fn(None)) * 320, dtype=np.float32)
    t = tal.Wav2VecAlignment(fn, encode, decode)
    j = jal.Wav2VecAlignment(model_fn=fn, encode=encode, decode=decode)
    assert t.align(wav, bare) == j.align(wav, bare)
    got, want = t.redact(wav, text), j.redact(wav, text)
    assert got.size and got.size < wav.size
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(t.redact(wav, bare), wav)


def test_wav2vec_needs_the_model():
    with pytest.raises(RuntimeError, match="model_fn"):
        tal.Wav2VecAlignment(None, encode, decode)


def test_tts_redacts_with_the_aligner():
    """tts(aligner=...) speaks the text without its brackets and hands the
    waveform and the bracketed text to aligner.redact, as JAX's tts does;
    without brackets the aligner is not called."""
    from test_torch_port_e2e import TINY_T
    from xtts_tpu_torch.infer.api import TextToSpeech, TTSSettings

    class Fake:
        def __init__(self):
            self.calls = []

        def redact(self, wav, text):
            self.calls.append((wav.copy(), text))
            return wav[: wav.size // 2]

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tts = TextToSpeech(TINY_T, device="cpu",
                           generator=torch.Generator().manual_seed(1))
        wav = (0.1 * np.random.default_rng(0).standard_normal(
            TINY_T.mel.sample_rate // 2)).astype(np.float32)
        s = TTSSettings(max_mel_tokens=8)
        fake = Fake()
        out = tts.tts("你好[今天]。", wav, torch.Generator().manual_seed(2), s,
                      use_diffusion=False, aligner=fake)
        plain = tts.tts("你好今天。", wav, torch.Generator().manual_seed(2), s,
                        use_diffusion=False)
        none = tts.tts("你好。", wav, torch.Generator().manual_seed(2), s,
                       use_diffusion=False, aligner=fake)
    finally:
        torch.set_num_threads(n)
    assert len(fake.calls) == 1 and fake.calls[0][1] == "你好[今天]。"
    np.testing.assert_array_equal(fake.calls[0][0], plain)
    np.testing.assert_array_equal(out, plain[: plain.size // 2])
    assert none.size > 0


# ---------------------------------------------------------------------------
# spider


def _crawl(mod, root):
    pages = {"ch1": ["http://h/a.mp3", "http://h/b.mp3?x=1"],
             "ch2": RuntimeError("gone"), "ch3": ["http://h/c/"]}
    fetched = []

    def listing(ch):
        v = pages[ch]
        if isinstance(v, Exception):
            raise v
        return v

    def fetch(url):
        fetched.append(url)
        if "b.mp3" in url:
            raise IOError("timeout")
        return url.encode()

    jl = root / "urls.jsonl"
    n = mod.crawl_episode_urls(["ch1", "ch2", "ch3"], str(jl), listing)
    (root / "out").mkdir()
    (root / "out" / "a.mp3").write_bytes(b"old")     # resumed, not fetched
    paths = mod.download_audio(str(jl), str(root / "out"), fetch)
    files = {p.name: p.read_bytes() for p in (root / "out").iterdir()}
    return (n, [json.loads(x) for x in jl.read_text().splitlines()],
            [p.split("/")[-1] for p in paths], files, fetched)


def test_spider_against_jax(tmp_path):
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    assert _crawl(tsp, tmp_path / "t") == _crawl(jsp, tmp_path / "j")


def test_spider_needs_injected_backends(tmp_path):
    with pytest.raises(RuntimeError, match="listing_fn"):
        tsp.crawl_episode_urls(["a"], str(tmp_path / "u.jsonl"))
    (tmp_path / "u.jsonl").write_text('{"channel": "a", "url": "u"}\n')
    with pytest.raises(RuntimeError, match="fetch_fn"):
        tsp.download_audio(str(tmp_path / "u.jsonl"), str(tmp_path / "o"))
