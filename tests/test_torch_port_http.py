"""The port's HTTP front end (xtts_tpu_torch/infer/http.py) on the CPU,
with the WAV IO and TextToSpeech.from_pretrained it rests on.

The cases of tests/test_serve_http.py, ported to the port's
SynthesisService on device="cpu" and run over both backends (BatchServer
waves and the ContinuousBatcher slot pool): JSON in, WAV out, sentences
through the shared backend, the per-request voice cache, /healthz and
/metrics, 400 / 404, 503 on a full queue and 504 on a queue timeout. Then,
against the JAX package: wav_bytes byte for byte; load_wav / save_wav on
int16, int32 and uint8 files (mono and stereo, resampled or not); and
from_pretrained on a directory of .npz (the JAX package's save_npz) or
.pth (the port's state dicts) checkpoints with an xtts_config.json gives
JAX's greedy codes."""
import io
import json
import threading
import urllib.error
import urllib.request
import wave

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xtts_tpu.data import audio as jaudio  # noqa: E402
from xtts_tpu.infer import api as japi, http as jhttp  # noqa: E402
from xtts_tpu.infer import qdecode as jq  # noqa: E402
from xtts_tpu.utils.registry import save_npz  # noqa: E402
from xtts_tpu_torch.data import audio as taudio  # noqa: E402
from xtts_tpu_torch.infer import api as tapi, http as thttp  # noqa: E402
from xtts_tpu_torch.infer import qdecode as tq  # noqa: E402

from test_torch_port_e2e import (TINY, TINY_T, jax_variables,  # noqa: E402,F401,E501
                                 one_torch_thread, randomize)

BACKENDS = ["waves", "slots"]


@pytest.fixture(scope="module")
def tts():
    return tapi.TextToSpeech(TINY_T, device="cpu", quantized_decode=True)


@pytest.fixture(scope="module", params=BACKENDS)
def svc(request, tts):
    s = thttp.SynthesisService(
        tts, np.zeros(4000, np.float32),
        settings=tapi.TTSSettings(max_mel_tokens=8), max_batch=4,
        window_ms=5.0, backend=request.param)
    yield s
    s.close()


@pytest.fixture(scope="module")
def url(svc):
    httpd = thttp.serve(svc, "127.0.0.1", 0)
    host, port = httpd.server_address[:2]
    yield f"http://{host}:{port}"
    httpd.shutdown()


def _post(url, payload):
    req = urllib.request.Request(
        url + "/tts", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=300)


def test_healthz(url):
    with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
        assert r.status == 200
        assert json.loads(r.read())["ok"] is True


def test_tts_returns_wav(url, svc):
    with _post(url, {"text": "你好。世界！"}) as r:
        assert r.status == 200
        assert r.headers["Content-Type"] == "audio/wav"
        data = r.read()
    with wave.open(io.BytesIO(data)) as w:
        assert w.getframerate() == svc.sample_rate
        assert w.getnchannels() == 1 and w.getsampwidth() == 2
        assert w.getnframes() > 0


def test_concurrent_requests_share_the_backend(url):
    """Two handler threads submit into one backend; both succeed."""
    out = {}

    def hit(k):
        with _post(url, {"text": "你好。"}) as r:
            out[k] = (r.status, len(r.read()))

    ts = [threading.Thread(target=hit, args=(i,)) for i in range(2)]
    [t.start() for t in ts]
    [t.join() for t in ts]
    assert len(out) == 2
    assert all(v[0] == 200 and v[1] > 44 for v in out.values())  # > header


def test_per_request_voice_path(url, svc, tmp_path_factory):
    p = str(tmp_path_factory.mktemp("voice") / "ref.wav")
    rng = np.random.default_rng(1)
    taudio.save_wav(p, (rng.standard_normal(6000) * 0.1).astype(np.float32),
                    24000)
    with _post(url, {"text": "你好。", "voice_path": p}) as r:
        assert r.status == 200 and len(r.read()) > 44
    assert p in svc._voice_cache          # cached after first use
    with _post(url, {"text": "你好。", "voice_path": p}) as r:
        assert r.status == 200


def test_bad_request_and_unknown_path(url):
    for body in ({"lang": "ZH"}, [1, 2]):     # no "text"; not an object
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(url, body)
        assert ei.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(url + "/nope", timeout=60)
    assert ei.value.code == 404


def test_metrics_endpoint(url, svc):
    """GET /metrics surfaces the backend's serving stats after traffic."""
    with _post(url, {"text": "你好。"}) as r:
        assert r.status == 200
        r.read()
    with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
        m = json.loads(r.read())
    assert m["completed"] >= 1 and m["failed"] == 0
    assert m["latency_mean_s"] > 0
    if svc.server.__class__.__name__ == "BatchServer":
        assert m["waves"] >= 1
    else:
        assert m["segments"] >= 1 and 0 < m["slot_occupancy"] <= 1


@pytest.mark.parametrize("backend", BACKENDS)
def test_backpressure_503_and_timeout_504(tts, backend):
    """A full queue maps ServerBusy to 503; a server-side queue timeout
    maps TimeoutError to 504."""
    cond = np.zeros(4000, np.float32)
    for knobs, code in ((dict(max_pending=0), 503),
                        (dict(request_timeout_s=0.0), 504)):
        s = thttp.SynthesisService(
            tts, cond, settings=tapi.TTSSettings(max_mel_tokens=8),
            max_batch=1, window_ms=1.0, backend=backend, **knobs)
        httpd = thttp.serve(s, "127.0.0.1", 0)
        host, port = httpd.server_address[:2]
        try:
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(f"http://{host}:{port}", {"text": "你好。"})
            assert ei.value.code == code
        finally:
            httpd.shutdown()
            s.close()


def test_slots_backend_http(tts):
    """backend='slots': warmup drives real requests through the pool, then
    the JSON / WAV contract with a two-sentence text."""
    svc = thttp.SynthesisService(
        tts, np.zeros(4000, np.float32),
        settings=tapi.TTSSettings(max_mel_tokens=8), max_batch=2,
        backend="slots")
    try:
        assert svc.warmup(text_lens=(8,), render_sizes=(1,)) == 1
        httpd = thttp.serve(svc, "127.0.0.1", 0)
        host, port = httpd.server_address[:2]
        url = f"http://{host}:{port}"
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            assert json.loads(r.read())["ok"] is True
        with _post(url, {"text": "你好。再见。"}) as r:
            assert r.status == 200
            assert r.headers["Content-Type"] == "audio/wav"
            with wave.open(io.BytesIO(r.read())) as w:
                assert w.getnframes() > 0
        httpd.shutdown()
    finally:
        svc.close()


def test_slots_backend_rejects_hifigan(tts):
    with pytest.raises(ValueError, match="slots"):
        thttp.SynthesisService(tts, np.zeros(4000, np.float32),
                               use_hifigan=True, backend="slots")


def test_main_takes_the_card():
    """The entry point builds its TextToSpeech on the card; without one it
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        thttp.main(["--ref-wav", "unused.wav"])


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def test_wav_bytes_equal_jax():
    rng = np.random.default_rng(2)
    wav = np.concatenate([np.sin(np.linspace(0, 40, 2400)) * 0.5,
                          1.5 * rng.standard_normal(500)]).astype(np.float32)
    data = thttp.wav_bytes(wav, 24000)
    assert data == jhttp.wav_bytes(wav, 24000)
    with wave.open(io.BytesIO(data)) as w:
        pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
    np.testing.assert_allclose(pcm[:2400] / 32767.0, wav[:2400], atol=1e-4)


@pytest.mark.parametrize("dtype", ["int16", "int32", "uint8", "float32"])
@pytest.mark.parametrize("channels", [1, 2])
def test_load_and_save_wav_like_jax(tmp_path, dtype, channels):
    """The same file reads to the same samples as with JAX's load_wav, at
    its own rate and resampled to 24 kHz; save_wav writes the same bytes."""
    from scipy.io import wavfile
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (1600, channels) if channels > 1 else 1600)
    data = {"int16": (x * 32767).astype(np.int16),
            "int32": (x * 2147483647).astype(np.int32),
            "uint8": (x * 127 + 128).astype(np.uint8),
            "float32": x.astype(np.float32)}[dtype]
    path = str(tmp_path / "in.wav")
    wavfile.write(path, 16000, data)
    for sr in (None, 24000):
        got, got_sr = taudio.load_wav(path, sr)
        want, want_sr = jaudio.load_wav(path, sr)
        assert got_sr == want_sr and got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert got.ndim == 1                 # the stereo file is downmixed
    out_t, out_j = str(tmp_path / "t.wav"), str(tmp_path / "j.wav")
    taudio.save_wav(out_t, got)
    jaudio.save_wav(out_j, want)
    with open(out_t, "rb") as a, open(out_j, "rb") as b:
        assert a.read() == b.read()


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    """Two checkpoint directories of the same random weights (the e2e
    test's): JAX variable trees as <name>.npz, and the port's state dicts
    as <name>.pth; each with the tiny config's xtts_config.json."""
    jtts = japi.TextToSpeech(TINY, jax_variables(TINY, jax.random.PRNGKey(0)),
                             quantized_decode=True)
    rng = np.random.default_rng(0)
    for name in ("gpt", "diffusion", "vocos"):
        jtts.vars[name] = {"params": randomize(jtts.vars[name]["params"],
                                               rng)}
    npz = tmp_path_factory.mktemp("npz")
    pth = tmp_path_factory.mktemp("pth")
    for d in (npz, pth):
        TINY.to_json(str(d / "xtts_config.json"))
    for name, key in (("gpt", "gpt"), ("vqvae", "dvae"),
                      ("diffusion", "diffusion"), ("vocos", "vocos")):
        save_npz(str(npz / f"{name}.npz"),
                 jax.tree_util.tree_map(np.asarray, jtts.vars[key]))
    ported = tapi.TextToSpeech.from_jax(
        {k: jax.tree_util.tree_map(np.asarray, v)
         for k, v in jtts.vars.items()}, TINY_T, device="cpu")
    for key, m in ported.modules().items():
        torch.save(m.state_dict(), str(pth / f"{key}.pth"))
    return str(npz), str(pth)


def test_from_pretrained_gives_jax_greedy_codes(model_dirs, monkeypatch):
    """The port's from_pretrained on the .npz and on the .pth directory
    loads the same weights and gives the greedy int8 codes of JAX's
    from_pretrained on the .npz directory (JAX: K1 in interpret mode; the
    port: its plain twin)."""
    monkeypatch.setenv("XTTS_FUSED_DECODE", "1")
    npz, pth = model_dirs
    jtts = japi.TextToSpeech.from_pretrained(npz, quantized_decode=True)
    assert jtts.cfg == TINY
    jq.attach_fused_stack(jtts._qtree, TINY.gpt)
    a = tapi.TextToSpeech.from_pretrained(npz, device="cpu",
                                          quantized_decode=True)
    b = tapi.TextToSpeech.from_pretrained(pth, device="cpu",
                                          quantized_decode=True)
    assert a.cfg == b.cfg == TINY_T
    for key, m in a.modules().items():
        other = b.modules()[key].state_dict()
        for name, t in m.state_dict().items():
            assert torch.equal(t, other[name]), f"{key}.{name}"
    rng = np.random.default_rng(1)
    cond = rng.standard_normal((1, TINY.mel.n_mels, 40)).astype(np.float32)
    text = rng.integers(3, 250, (1, 16)).astype(np.int32)
    jr = jq.generate_speech_quantized(
        jtts.gpt, jtts.vars["gpt"], jtts._qtree, jnp.asarray(cond),
        jnp.asarray(text), jax.random.PRNGKey(0), max_gen=24,
        do_sample=False, use_fused=True)
    for t in (a, b):
        r = tq.generate_speech_quantized(
            t.gpt, t._qtree, torch.from_numpy(cond),
            torch.from_numpy(text).long(), None, max_gen=24, do_sample=False)
        np.testing.assert_array_equal(r.codes.numpy(), np.asarray(jr.codes))
        np.testing.assert_array_equal(r.lengths.numpy(),
                                      np.asarray(jr.lengths))


def test_from_pretrained_keeps_random_weights_for_a_missing_file(tmp_path,
                                                                 caplog):
    TINY.to_json(str(tmp_path / "xtts_config.json"))
    with caplog.at_level("WARNING"):
        t = tapi.TextToSpeech.from_pretrained(str(tmp_path), device="cpu")
    assert t.cfg == TINY_T
    assert sum("no weights" in r.message for r in caplog.records) == 4
