"""Port parity for the rest of the request API (xtts_tpu_torch/infer/api.py
against xtts_tpu/infer/api.py on the CPU, the tiny configuration and
weights of tests/test_torch_port_e2e.py): fix_autoregressive_output,
pad_text_to_bucket, return_intermediates, speculative_render, the sparse
ReferenceNet hoist (refnet_interval) and its gate, and render_rows with
refnet_interval.

Greedy requests run top_p 1e-4 without repetition penalty (so both
packages pick the top token; JAX through its Pallas K1 in interpret mode)
and render with DDIM from one x_T: JAX's own draw, handed to the port by
replacing its x_T draw (`api.randn_rows`). Tolerances: codes and tokens
exact; latents, mels and waveforms within rtol / atol 1e-3 (the e2e
render tolerance)."""
import numpy as np
import pytest
from hypothesis import given, settings as hsettings, strategies as st

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xtts_tpu.infer import api as japi, qdecode as jq  # noqa: E402
from xtts_tpu.infer import serving as jserv  # noqa: E402
from xtts_tpu_torch.infer import api as tapi  # noqa: E402
from xtts_tpu_torch.infer import serving as tserv  # noqa: E402
from xtts_tpu_torch.utils import convert  # noqa: E402
from test_torch_port_e2e import (MB, TINY, inputs, one_torch_thread,  # noqa: E402,F401
                                 pair)

TOL = dict(rtol=1e-3, atol=1e-3)
STOP = TINY.gpt.stop_mel_token
GREEDY = dict(top_p=1e-4, repetition_penalty=1.0, sampler="ddim",
              diffusion_steps=3)


# ---------------------------------------------------------------------------
# fix_autoregressive_output


@pytest.mark.parametrize("codes", [
    [5, 6, 7, 8, 9, 10],                    # no stop
    [5, 6, 7, 8, 9, STOP],                  # stop last
    [5, 6, 7, 8, STOP, 9],                  # second to last
    [STOP, 5, 6, 7, 8, 9],                  # first
    [5, STOP, 6, STOP, 7, 8, STOP, 9, 10],  # several
    [5, 6, STOP],                           # as long as the tail
])
def test_fix_autoregressive_output_cases(codes, capsys):
    codes = np.array(codes, np.int32)
    before = codes.copy()
    want = japi.fix_autoregressive_output(codes, STOP)
    said = capsys.readouterr().out
    got = tapi.fix_autoregressive_output(codes, STOP)
    assert capsys.readouterr().out == said
    assert ("No stop tokens" in said) == (STOP not in codes)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(codes, before)   # a copy comes back


@hsettings(max_examples=60, deadline=None)
@given(st.lists(st.sampled_from([STOP, 0, 45, 83, 100, 198]), min_size=1,
                max_size=24), st.booleans())
def test_fix_autoregressive_output_drawn(codes, complain):
    """Drawn code arrays, 1-24 long: equal outputs, or, for a stop token in
    fewer than 3 codes, the same IndexError as JAX's (the tail write)."""
    codes = np.array(codes, np.int64)
    try:
        want = japi.fix_autoregressive_output(codes, STOP, complain=complain)
    except IndexError:
        with pytest.raises(IndexError):
            tapi.fix_autoregressive_output(codes, STOP, complain=complain)
        assert STOP in codes and len(codes) < 3
        return
    np.testing.assert_array_equal(
        tapi.fix_autoregressive_output(codes, STOP, complain=complain), want)


# ---------------------------------------------------------------------------
# text framing


@pytest.mark.parametrize("pad", [True, False])
def test_pad_text_to_bucket(pair, pad):
    jtts, ttts, _ = pair
    text = "你好，世界。今天天气真好！我们去公园吧。"
    want = jtts._text_to_token_lists(text, "ZH",
                                     japi.TTSSettings(pad_text_to_bucket=pad))
    got = ttts._text_to_token_lists(text, "ZH",
                                    tapi.TTSSettings(pad_text_to_bucket=pad))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert all(len(t) in (16, 32) for t in got) == pad


# ---------------------------------------------------------------------------
# helpers: one x_T for both packages


def _jax_xt(key, shape):
    """The x_T JAX's tts_tokens / render_rows draw from `key` (one split
    for the render, one inside _diffusion_mel_impl)."""
    k2 = jax.random.split(key)[1]
    return np.asarray(jax.random.normal(jax.random.split(k2)[1], shape))


@pytest.fixture
def shared_xt(monkeypatch):
    """Make the port draw JAX's x_T: set box["key"] before the call."""
    box = {}

    def draw(shape, generator, device):
        return torch.from_numpy(_jax_xt(box["key"], tuple(shape))).to(device)

    monkeypatch.setattr(tapi, "randn_rows", draw)
    return box


@pytest.fixture
def greedy_k1(monkeypatch):
    monkeypatch.setenv("XTTS_FUSED_DECODE", "1")


def _cond(pair, inputs):
    jtts, _, _ = pair
    return np.array(jtts.cond_mel_from_wav(inputs[0]))


# ---------------------------------------------------------------------------
# return_intermediates


@pytest.mark.parametrize("use_diffusion", [True, False])
def test_return_intermediates(pair, inputs, greedy_k1, shared_xt,
                              use_diffusion):
    jtts, ttts, _ = pair
    _, text = inputs
    cond = _cond(pair, inputs)
    # the shared pair carries no DVAE: give the port JAX's (its flax init)
    ttts.dvae.load_state_dict(convert.to_torch(convert.dvae_from_jax(
        jtts.vars["dvae"], TINY.vqvae.num_layers,
        TINY.vqvae.num_resnet_blocks), "cpu"))
    key = jax.random.PRNGKey(5)
    shared_xt["key"] = key
    kw = dict(max_mel_tokens=20, **GREEDY)
    want = jtts.tts_tokens(text, jnp.asarray(cond), key,
                           japi.TTSSettings(**kw),
                           use_diffusion=use_diffusion,
                           return_intermediates=True)
    got = ttts.tts_tokens(text, torch.from_numpy(cond), None,
                          tapi.TTSSettings(**kw),
                          use_diffusion=use_diffusion,
                          return_intermediates=True)
    np.testing.assert_array_equal(got["codes"], want["codes"])
    n = max(int(got["lengths"][0]) - 2, 1)
    assert got["mel"].shape == want["mel"].shape == (1, MB, 4 * n)
    np.testing.assert_allclose(got["mel"], want["mel"], **TOL)
    if use_diffusion:
        assert got["latent"].shape == want["latent"].shape
        assert got["latent"].shape == (1, TINY.gpt.model_dim, n)
        np.testing.assert_allclose(got["latent"], want["latent"], **TOL)
    else:
        assert "latent" not in got and "latent" not in want
    np.testing.assert_allclose(got["wav"], want["wav"], **TOL)


# ---------------------------------------------------------------------------
# speculative render


def test_speculative_equals_default_when_buckets_coincide(pair, inputs):
    """max_mel_tokens 20: the cap's bucket (64) is the length's, so the
    speculative request renders exactly the default's (same generator
    seed, sampled AR, ancestral p sampler): codes and wav bit for bit."""
    _, ttts, _ = pair
    wav, text = inputs
    cond = ttts.cond_mel_from_wav(wav)
    outs = [ttts.tts_tokens(text, cond, torch.Generator().manual_seed(7),
                            tapi.TTSSettings(max_mel_tokens=20,
                                             diffusion_steps=3,
                                             speculative_render=spec))
            for spec in (False, True)]
    np.testing.assert_array_equal(outs[0]["codes"], outs[1]["codes"])
    np.testing.assert_array_equal(outs[0]["lengths"], outs[1]["lengths"])
    assert np.array_equal(outs[0]["wav"], outs[1]["wav"])


@pytest.fixture
def early_stop(pair):
    """The stop logit's bias raised by 1 in both packages' weights (the
    greedy request then stops after 9 codes, well before a 100-code cap),
    restored afterwards."""
    jtts, ttts, _ = pair
    gp = jtts.vars["gpt"]["params"]
    bias = np.array(gp["mel_head"]["bias"])
    raised = bias.copy()
    raised[STOP] += 1.0
    jtts.vars["gpt"] = {"params": dict(gp, mel_head=dict(gp["mel_head"],
                                                         bias=raised))}
    jtts._qtree = jq.quantize_gpt_decode(jtts.vars["gpt"], TINY.gpt,
                                         include_fused=True)
    with torch.no_grad():
        ttts.gpt.mel_head.bias[STOP] += 1.0
    ttts.requantize()
    yield
    jtts.vars["gpt"] = {"params": gp}
    jtts._qtree = jq.quantize_gpt_decode(jtts.vars["gpt"], TINY.gpt,
                                         include_fused=True)
    with torch.no_grad():
        ttts.gpt.mel_head.bias[STOP] = float(bias[STOP])
    ttts.requantize()


def test_speculative_at_a_larger_cap_bucket(pair, inputs, greedy_k1,
                                            shared_xt, early_stop):
    """A greedy request that stops early under a 100-code cap: the
    speculative render runs at the cap's bucket (128 codes) while the
    default's length bucket is 64. The speculative wav equals JAX's
    speculative wav from the same x_T within the render tolerance, and
    keeps the default wav's length."""
    jtts, ttts, _ = pair
    _, text = inputs
    cond = _cond(pair, inputs)
    key = jax.random.PRNGKey(11)
    shared_xt["key"] = key
    kw = dict(max_mel_tokens=100, speculative_render=True, **GREEDY)
    want = jtts.tts_tokens(text, jnp.asarray(cond), key,
                           japi.TTSSettings(**kw))
    got = ttts.tts_tokens(text, torch.from_numpy(cond), None,
                          tapi.TTSSettings(**kw))
    np.testing.assert_array_equal(got["codes"], want["codes"])
    np.testing.assert_array_equal(got["lengths"], want["lengths"])
    n = max(int(got["lengths"][0]) - 2, 1)
    buckets = ttts._code_buckets()
    assert tapi.bucket_len(n, buckets) < tapi.bucket_len(98, buckets) == 128
    assert got["wav"].shape == want["wav"].shape == (1, n * 4 * 16)
    np.testing.assert_allclose(got["wav"], want["wav"], **TOL)
    default = ttts.tts_tokens(text, torch.from_numpy(cond), None,
                              tapi.TTSSettings(max_mel_tokens=100, **GREEDY))
    assert default["wav"].shape == got["wav"].shape
    np.testing.assert_array_equal(default["codes"], got["codes"])


# ---------------------------------------------------------------------------
# refnet_interval


@pytest.fixture(scope="module")
def shared_codes(pair, inputs):
    jtts, _, _ = pair
    cond = np.array(jtts.cond_mel_from_wav(inputs[0]))
    n, n_b = 50, 64
    codes = np.full((1, n_b), STOP, np.int32)
    codes[0, :n] = np.random.default_rng(2).integers(0, 198, n)
    key = jax.random.PRNGKey(3)
    xt = np.array(jax.random.normal(jax.random.split(key)[1],
                                    (1, MB, 4 * n_b)))
    return cond, codes, np.array([n], np.int32), key, xt


def _port_render(ttts, text, shared_codes, settings):
    cond, codes, lens, _, xt = shared_codes
    return ttts._render(torch.from_numpy(cond), torch.from_numpy(text).long(),
                        torch.from_numpy(codes).long(),
                        torch.from_numpy(lens).long(), None, settings,
                        noise=torch.from_numpy(xt)).numpy()


@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_refnet_interval_render(pair, inputs, shared_codes, k):
    """latent -> 4-step DDIM with the ReferenceNet features of every k-th
    step -> Vocos, from shared codes and x_T, within 1e-3 of JAX's; k = 1
    equal to the port's default bit for bit, k > 1 not (k = 8 >= steps:
    one cached set)."""
    jtts, ttts, _ = pair
    _, text = inputs
    cond, codes, lens, key, _ = shared_codes
    want = np.asarray(jtts._render_full_jit(
        jtts.vars["gpt"], jtts.vars["diffusion"], jtts.vars["vocos"],
        jnp.asarray(cond), japi.normalize_tacotron_mel(jnp.asarray(cond)),
        jnp.asarray(text), jnp.array([16]), jnp.asarray(codes),
        jnp.asarray(lens) * 1024, key, 1.0, steps=4, sampler="ddim",
        cond_free_k=2.0, refnet_interval=k))
    got = _port_render(ttts, text, shared_codes, tapi.TTSSettings(
        sampler="ddim", diffusion_steps=4, refnet_interval=k))
    np.testing.assert_allclose(got, want, **TOL)
    default = _port_render(ttts, text, shared_codes, tapi.TTSSettings(
        sampler="ddim", diffusion_steps=4))
    # k > 1 reuses features computed at other timesteps: another render
    assert np.array_equal(got, default) == (k == 1)


class _FakeDiffusion:
    """Records the batch of each ReferenceNet call (a model of zeros)."""

    def __init__(self, framework):
        self.jax = framework == "jax"
        self.ref_batches = []

    def _zeros(self, *shape):
        return jnp.zeros(shape) if self.jax else torch.zeros(shape)

    # JAX's flax surface: apply(vars, *args, method=...)
    def apply(self, _vars, *args, method):
        return method(*args)

    def encode_reference(self, refer):
        return self._zeros(refer.shape[0], 3, 4)

    def uncond_hint(self, b, t_len):
        return self._zeros(b, 6, t_len)

    def reference_features(self, refer, t, ctx):
        self.ref_batches.append(refer.shape[0])
        return [self._zeros(refer.shape[0], 2, 4)]


def _hoisted(framework, sampler, b, steps, k):
    """(hoisted, cached sets) as the package's _diffusion_mel_impl decides
    them. The call is given no usable noise source (JAX key None, the port
    a generator that is none), so it stops where x_T is drawn: after the
    hoisted ReferenceNet call, if any, before the first step."""
    fake = _FakeDiffusion(framework)
    latent_shape = (b, 6, 4)
    if framework == "jax":
        tts = japi.TextToSpeech.__new__(japi.TextToSpeech)
        tts.cfg, tts.diffusion = TINY, fake
        with pytest.raises(AttributeError, match="ndim"):
            tts._diffusion_mel_impl(
                None, jnp.zeros(latent_shape), jnp.zeros((b, MB, 7)), None,
                1.0, steps=steps, sampler=sampler, refnet_interval=k)
    else:
        tts = tapi.TextToSpeech.__new__(tapi.TextToSpeech)
        tts.cfg = tapi.XTTSConfig.from_dict(TINY.to_dict())
        tts.diffusion = fake
        with pytest.raises(TypeError, match="generator"):
            tts._diffusion_mel_impl(
                torch.zeros(latent_shape), torch.zeros(b, MB, 7), "none",
                1.0, steps=steps, sampler=sampler, refnet_interval=k)
    assert len(fake.ref_batches) <= 1
    return (bool(fake.ref_batches),
            fake.ref_batches[0] // b if fake.ref_batches else 0)


SAMPLERS = ("p", "ddim", "dpm++2m", "unipc", "dpm++2m_solver", "dpm++3m",
            "dpm++fast", "unipc_bh1", "unipc_bh2", "unipc_vary")


@pytest.mark.parametrize("env", [None, "0", "1"])
@pytest.mark.parametrize("sampler", SAMPLERS)
def test_hoist_gate_equals_jax(monkeypatch, sampler, env):
    """Whether the ReferenceNet is hoisted, and how many feature sets are
    cached, over (b, steps, k): the port's decision (hoist_plan, and what
    its _diffusion_mel_impl does) is JAX's, XTTS_HOIST_REF unset, 0 and
    1; the continuous-time solvers never hoist."""
    if env is None:
        monkeypatch.delenv("XTTS_HOIST_REF", raising=False)
    else:
        monkeypatch.setenv("XTTS_HOIST_REF", env)
    for b, steps, k in [(1, 6, 1), (1, 6, 4), (16, 50, 1), (16, 50, 2),
                        (11, 50, 1), (12, 50, 2), (3, 200, 1), (3, 200, 2),
                        (2, 6, 9)]:
        j = _hoisted("jax", sampler, b, steps, k)
        t = _hoisted("torch", sampler, b, steps, k)
        assert t == j, (b, steps, k, t, j)
        plan = tapi.hoist_plan(sampler, b, steps, k)
        assert plan[0] == j[0] and (not plan[0] or plan[2] == j[1])
        assert not j[0] or j[1] == -(-steps // k)
        if sampler not in ("p", "ddim", "dpm++2m", "unipc"):
            assert not j[0]


def test_render_rows_refnet_interval(pair, inputs, shared_xt):
    """serving.render_rows on 2 rows of distinct codes and lengths with
    refnet_interval 2 (hoisted, 2 x 2 cached sets), DDIM from JAX's x_T:
    each row's trimmed waveform within 1e-3 of JAX's render_rows."""
    jtts, ttts, _ = pair
    _, text = inputs
    rng = np.random.default_rng(21)
    cond = np.repeat(_cond(pair, inputs), 2, axis=0)
    texts = np.concatenate([text, rng.integers(3, 250, (1, 16))]).astype(
        np.int32)
    codes = rng.integers(0, 198, (2, 40)).astype(np.int32)
    lengths = np.array([40, 23])
    key = jax.random.PRNGKey(8)
    shared_xt["key"] = key
    kw = dict(sampler="ddim", diffusion_steps=4, refnet_interval=2)
    want = jserv.render_rows(jtts, jnp.asarray(texts), jnp.array([16, 16]),
                             jnp.asarray(cond), jnp.asarray(codes), lengths,
                             japi.TTSSettings(**kw), True, key)
    got = tserv.render_rows(ttts, torch.from_numpy(texts).long(),
                            torch.tensor([16, 16]), torch.from_numpy(cond),
                            torch.from_numpy(codes).long(), lengths,
                            tapi.TTSSettings(**kw), True, None)
    assert tapi.hoist_plan("ddim", 2, 4, 2) == (True, 2, 2)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, np.asarray(w), **TOL)


def test_from_pretrained_drops_the_reference_heads_fixed_buffers(pair,
                                                                  tmp_path):
    """A Vocos state dict as the reference saves it, with the heads' fixed
    buffers (head.istft.window; head.imdct.window / pre_twiddle /
    post_twiddle), loads through from_pretrained: the buffers, which the
    port computes, are dropped and the weights come through."""
    _, ttts, _ = pair
    sd = {k: v.clone() for k, v in ttts.vocos.state_dict().items()}
    sd["head.istft.window"] = torch.hann_window(64)
    sd["head.imdct.window"] = torch.ones(64)
    sd["head.imdct.pre_twiddle"] = torch.ones(64, 2)
    torch.save({"model": sd}, tmp_path / "vocos.pth")
    got = tapi.TextToSpeech.from_pretrained(
        str(tmp_path), tapi.XTTSConfig.from_dict(TINY.to_dict()),
        device="cpu")
    for k, v in ttts.vocos.state_dict().items():
        assert torch.equal(got.vocos.state_dict()[k], v), k
