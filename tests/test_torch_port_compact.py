"""Compacting decode waves (xtts_tpu_torch/infer/compact.py) against the
JAX package's (xtts_tpu/infer/compact.py), on the CPU.

The models are test_torch_port_device_loop's: a 2-layer GPT whose JAX
variables (traced shapes, every leaf redrawn from a seeded numpy
generator) the port takes through utils/convert.py; with the stop logit
biased, greedy rows stop at spread steps, so the waves drop rows at the
rungs (each case asserts that it did). Greedy codes, lengths and steps
must equal JAX's compacting wave token for token on the bf16 chain, the
int8 chain and the int8 cache; a sampled wave without a drop must be the
port's monolithic wave bit for bit (codes and the generator's state
after); with per_row_keys the sampled codes must not change with the
drops."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xtts_tpu.infer import compact as jcompact  # noqa: E402
from xtts_tpu_torch.infer import compact, device_loop  # noqa: E402
from xtts_tpu_torch.infer import qdecode as tq  # noqa: E402
from xtts_tpu_torch.models import gpt_infer as tgi  # noqa: E402

from test_torch_port_device_loop import _build, _inputs  # noqa: E402
from test_torch_port_e2e import one_torch_thread  # noqa: E402,F401

LADDER = (4, 8, 16)
BUCKETS = (1, 2, 4, 8)
MAX_GEN = 24
SPREAD = 3   # _inputs seed: the 6 greedy rows stop at 4, 15, 24, 3, 1, 11


@pytest.fixture(scope="module")
def biased():
    return _build(True)


@pytest.fixture
def takes(monkeypatch):
    """The row counts each compaction went on with."""
    seen = []
    take = device_loop.LoopState.take

    def counted(self, src, idx):
        seen.append(idx.numel())
        take(self, src, idx)
    monkeypatch.setattr(device_loop.LoopState, "take", counted)
    return seen


def _port(tm, qtree, cond, text, **kw):
    return compact.generate_speech_compacting(
        tm, qtree, torch.from_numpy(cond), torch.from_numpy(text).long(),
        **kw)


@pytest.mark.parametrize("engine", ["full", "chain", "kv_quant"])
def test_greedy_codes_equal_jax_through_drops(biased, engine, takes):
    jm, jv, jqt, tm, tqt = biased
    cond, text = _inputs(6, SPREAD)
    kw = dict(max_gen=MAX_GEN, do_sample=False, cache_ladder=LADDER,
              row_buckets=BUCKETS, quantize_kv_cache=engine == "kv_quant")
    jr = jcompact.generate_speech_compacting(
        jm, jv, None if engine == "full" else jqt, jnp.asarray(cond),
        jnp.asarray(text), jax.random.PRNGKey(0), **kw)
    tr = _port(tm, None if engine == "full" else tqt, cond, text, **kw)
    np.testing.assert_array_equal(tr.codes.numpy(), np.asarray(jr.codes))
    np.testing.assert_array_equal(tr.lengths.numpy(),
                                  np.asarray(jr.lengths))
    assert tr.steps == int(jr.steps)
    assert takes and takes[-1] < 6          # the wave did drop rows


@pytest.mark.parametrize("engine", ["full", "chain"])
def test_sampled_without_a_drop_is_the_monolithic_wave(biased, engine,
                                                       takes):
    """Buckets no smaller than the wave: no drop, and the sampled codes,
    lengths, steps and the generator's state after equal the monolithic
    wave's over the same ladder."""
    _, _, _, tm, tqt = biased
    cond, text = _inputs(3, seed=12)
    args = (torch.from_numpy(cond), torch.from_numpy(text).long())
    g0, g1 = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    kw = dict(max_gen=MAX_GEN, cache_ladder=LADDER)
    if engine == "full":
        mono = tgi.generate_speech(tm, *args, g0, **kw)
    else:
        mono = tq.generate_speech_quantized(tm, tqt, *args, g0,
                                            use_fused=False, **kw)
    comp = compact.generate_speech_compacting(
        tm, None if engine == "full" else tqt, *args, g1, row_buckets=(8,),
        **kw)
    assert not takes
    assert torch.equal(comp.codes, mono.codes)
    assert torch.equal(comp.lengths, mono.lengths)
    assert comp.steps == mono.steps
    assert torch.equal(g0.get_state(), g1.get_state())
    assert (mono.lengths < MAX_GEN).any()     # rows stop inside the wave


def test_per_row_keys_codes_do_not_depend_on_drops(biased, takes):
    _, _, _, tm, _ = biased
    cond, text = _inputs(6, SPREAD)
    kw = dict(max_gen=MAX_GEN, cache_ladder=LADDER, per_row_keys=True)
    mono = _port(tm, None, cond, text, row_buckets=(16,),
                 generator=torch.Generator().manual_seed(11), **kw)
    assert not takes
    comp = _port(tm, None, cond, text, row_buckets=BUCKETS,
                 generator=torch.Generator().manual_seed(11), **kw)
    assert takes and takes[-1] < 6
    assert torch.equal(comp.codes, mono.codes)
    assert torch.equal(comp.lengths, mono.lengths)


def test_kv_quant_needs_a_qtree(biased):
    _, _, _, tm, _ = biased
    cond, text = _inputs(2)
    with pytest.raises(ValueError, match="quantized engine"):
        _port(tm, None, cond, text, quantize_kv_cache=True)


@pytest.mark.parametrize("max_gen", [1, 64, 65, 300, 600, 1000])
def test_default_rungs_equal_jax(max_gen):
    assert compact.default_rungs(max_gen) == jcompact.default_rungs(max_gen)


def test_synthesize_batch_runs_compacting_waves(monkeypatch):
    """TTSSettings.compact_rows wired through synthesize_batch: the AR pass
    is a compacting wave over the requests' rows, and every request gets a
    finite waveform of its own, in order."""
    from test_torch_port_e2e import TINY_T
    from xtts_tpu_torch.infer import api as tapi
    from xtts_tpu_torch.infer.serving import (SynthesisRequest,
                                              synthesize_batch)
    calls = []
    real = tapi.generate_speech_compacting

    def counted(*a, **k):
        calls.append(k["row_buckets"])
        return real(*a, **k)
    monkeypatch.setattr(tapi, "generate_speech_compacting", counted)
    tts = tapi.TextToSpeech(TINY_T, device="cpu", quantized_decode=True,
                            generator=torch.Generator().manual_seed(0))
    cond = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, TINY_T.mel.n_mels, 40)).astype(np.float32))
    reqs = [SynthesisRequest(np.array(t, np.int32))
            for t in ([1, 3, 4, 5, 2], [1, 6, 7, 2], [1, 8, 2])]
    settings = tapi.TTSSettings(max_mel_tokens=12, cache_ladder=(4, 8),
                                compact_rows=(1, 2, 4))
    wavs = synthesize_batch(tts, reqs, cond, settings,
                            generator=torch.Generator().manual_seed(1))
    assert calls == [(1, 2, 4)]
    assert len(wavs) == 3
    assert all(w.size > 0 and np.isfinite(w).all() for w in wavs)
