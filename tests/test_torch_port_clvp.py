"""CLVP (models/clvp.py, nn/encoder.py) against the JAX package's on the
CPU, weights carried by utils.convert.clvp_from_jax, both towers (the live
tortoise one and the x-transformers one). Tolerances: similarity logits and
rerank scores within 1e-4 (f32, summed in another order); the same rerank
winners."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xtts_tpu.core.config import CLVPConfig  # noqa: E402
from xtts_tpu.models import clvp as jcl  # noqa: E402
from xtts_tpu.utils import convert as jconv  # noqa: E402
from xtts_tpu_torch.core import config as tcfg  # noqa: E402
from xtts_tpu_torch.models import clvp as tcl  # noqa: E402
from xtts_tpu_torch.utils import convert  # noqa: E402
from test_torch_port_e2e import traced_zeros  # noqa: E402

CONFIGS = {
    "tortoise": CLVPConfig(dim_text=48, dim_speech=48, dim_latent=32,
                           num_text_tokens=40, text_enc_depth=2,
                           text_seq_len=24, text_heads=2,
                           num_speech_tokens=64, speech_enc_depth=2,
                           speech_heads=2),
    "xformers": CLVPConfig(dim_text=32, dim_speech=32, dim_latent=16,
                           num_text_tokens=40, text_enc_depth=2,
                           text_heads=2, num_speech_tokens=64,
                           speech_enc_depth=1, speech_heads=2,
                           use_xformers=True),
}
TOL = dict(rtol=1e-4, atol=1e-4)


def randomize(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = randomize(v, rng)
            continue
        v = np.asarray(v)
        if k == "scale" or k.startswith("scale_"):
            x = 1.0 + 0.3 * rng.standard_normal(v.shape)
        elif k == "embedding":
            x = 0.5 * rng.standard_normal(v.shape)
        elif k == "bias" or v.ndim <= 1:
            x = 0.1 * rng.standard_normal(v.shape)
        else:
            x = rng.standard_normal(v.shape) / np.sqrt(np.prod(v.shape[:-1]))
        out[k] = x.astype(np.float32)
    return out


def _pair(cfg, seed=0):
    jm = jcl.CLVP(cfg)
    # the shapes by tracing alone, in the eager init's key order (an eager
    # flax init costs more than the comparison; randomize redraws every
    # leaf, the same draws as from the eager init)
    init = traced_zeros(lambda: jm.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32),
        jnp.zeros((1, 8), jnp.int32)))
    params = randomize(init["params"], np.random.default_rng(seed))
    tcfg_ = tcfg.CLVPConfig.from_dict(cfg.to_dict())
    tm = tcl.CLVP(tcfg_).eval()
    tm.load_state_dict(convert.to_torch(device="cpu", sd=convert.clvp_from_jax(params,
                                                              tcfg_)))
    return jm, {"params": params}, tm


def _inputs(seed, b=3, k=4, t=20, s=30):
    rng = np.random.default_rng(seed)
    text = rng.integers(0, 40, (b, t)).astype(np.int32)
    codes = rng.integers(0, 64, (b, k, s)).astype(np.int32)
    tmask = np.ones((b, t), np.int32)
    tmask[1, 15:] = 0
    cmask = (np.arange(s)[None, None] < rng.integers(5, s + 1, (b, k, 1))
             ).astype(np.int32)
    return text, codes, tmask, cmask


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_similarity(name):
    jm, jv, tm = _pair(CONFIGS[name])
    text, codes, tmask, cmask = _inputs(1)
    want = np.asarray(jax.jit(jm.apply)(jv, text, codes[:, 0], tmask,
                                        cmask[:, 0]))
    got = tm(torch.from_numpy(text).long(),
             torch.from_numpy(codes[:, 0]).long(), torch.from_numpy(tmask),
             torch.from_numpy(cmask[:, 0])).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_rerank_and_rerank_batch_winners(name):
    jm, jv, tm = _pair(CONFIGS[name], seed=4)
    text, codes, _, cmask = _inputs(2)
    want = np.asarray(jax.jit(lambda v, t, c, m: jm.apply(
        v, t, c, m, method=jm.rerank))(jv, text[0], codes[0], cmask[0]))
    got = tm.rerank(torch.from_numpy(text[0]).long(),
                    torch.from_numpy(codes[0]).long(),
                    torch.from_numpy(cmask[0])).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert got.argmax() == want.argmax()
    want_b = np.asarray(jax.jit(lambda v, t, c, m: jm.apply(
        v, t, c, code_mask=m, method=jm.rerank_batch))(jv, text, codes,
                                                        cmask))
    got_b = tm.rerank_batch(torch.from_numpy(text).long(),
                            torch.from_numpy(codes).long(),
                            code_mask=torch.from_numpy(cmask)).numpy()
    np.testing.assert_allclose(got_b, want_b, **TOL)
    np.testing.assert_array_equal(got_b.argmax(1), want_b.argmax(1))


def test_state_dict_is_the_references():
    """The live tower's port state_dict() -> xtts_tpu's
    clvp_from_reference gives back the JAX parameters."""
    cfg = CONFIGS["tortoise"]
    _, jv, tm = _pair(cfg, seed=5)
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    back = jconv.clvp_from_reference(sd, cfg.text_enc_depth,
                                     cfg.speech_enc_depth)
    flat = lambda t, p=(): [(p + (k,), v) for k, v in t.items()
                            if not isinstance(v, dict)] + sum(
        (flat(v, p + (k,)) for k, v in t.items() if isinstance(v, dict)), [])
    got, want = dict(flat(back)), dict(flat(jv["params"]))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))


def test_position_table_guards():
    _, _, tm = _pair(CONFIGS["tortoise"])
    with pytest.raises(ValueError, match="text_seq_len"):
        tm.embed_text(torch.zeros((1, 25), dtype=torch.long))
    with pytest.raises(ValueError, match="num_speech_tokens"):
        tm.embed_speech(torch.zeros((1, 65), dtype=torch.long))
