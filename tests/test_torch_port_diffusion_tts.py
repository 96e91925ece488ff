"""The legacy DiffusionTts (xtts_tpu_torch/models/diffusion_tts.py) and the
relative-position attention (xtts_tpu_torch/nn/blocks.py) against the JAX
package, on the CPU.

A tiny DiffusionTts (64 channels, 2 layers, 4 heads) takes the JAX module's
variables (zeros of the init's traced shapes, every leaf redrawn from a
seeded numpy generator) through utils/convert.py diffusion_tts_from_jax;
the two then see the same numpy inputs. Tolerance rtol = atol = 2e-4 in
f32, as tests/test_diffusion_tts.py holds JAX against the reference. The
train-time masks are compared where they are deterministic: a layer drop
and an unconditioned share of 0 (nothing dropped) and of 1 (every middle
layer dropped, every row unconditioned).

64 channels and not 32: at 32 a GroupNorm group holds 2 channels, and the
conditioning-free branch feeds its first norm an input that is constant in
time; with this seed one group's two channels are nearly equal, its
variance far below its squared mean, where JAX's GroupNorm (flax's
E[x^2] - E[x]^2) loses most digits of the variance and the branch then
leaves torch's group_norm by more than 2e-4. At 64 (4 channels a group)
every branch agrees within 2e-4."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xtts_tpu.models.diffusion_tts import DiffusionTts as JDiffusionTts  # noqa: E402
from xtts_tpu.nn.blocks import RelativePositionBias as JRelPos  # noqa: E402
from xtts_tpu_torch.models.diffusion_tts import DiffusionTts  # noqa: E402
from xtts_tpu_torch.nn.blocks import RelativePositionBias  # noqa: E402
from xtts_tpu_torch.utils import convert, registry  # noqa: E402

from test_torch_port_e2e import (one_torch_thread, randomize,  # noqa: E402,F401
                                 shaped_zeros, traced_zeros)

MC, LAYERS, IN_CH, LAT_CH, TOKENS, HEADS = 64, 2, 8, 16, 50, 4
B, T = 2, 12
TOL = dict(rtol=2e-4, atol=2e-4)
KW = dict(model_channels=MC, num_layers=LAYERS, in_channels=IN_CH,
          in_latent_channels=LAT_CH, in_tokens=TOKENS, out_channels=2 * IN_CH,
          num_heads=HEADS)


def _data():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, IN_CH, T)).astype(np.float32)
    cond_mel = rng.standard_normal((B, IN_CH, 20)).astype(np.float32)
    latent = rng.standard_normal((B, LAT_CH, 6)).astype(np.float32)
    codes = rng.integers(0, TOKENS, (B, 5)).astype(np.int32)
    ts = np.array([3, 40], np.int32)
    return x, cond_mel, latent, codes, ts


@pytest.fixture(scope="module")
def pair():
    jm = JDiffusionTts(**KW, layer_drop=0.0, unconditioned_percentage=0.0)
    x, cond_mel, latent, _, ts = _data()
    init = traced_zeros(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(ts),
        aligned_conditioning=jnp.asarray(latent),
        conditioning_latent=jnp.asarray(cond_mel)))
    params = randomize(init["params"], np.random.default_rng(1))
    sd = convert.diffusion_tts_from_jax(params, LAYERS)
    tm = DiffusionTts(**KW, layer_drop=0.0,
                      unconditioned_percentage=0.0).eval()
    tm.load_state_dict(convert.to_torch(sd, "cpu"))
    return jm, {"params": params}, tm, sd


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_param_cover(pair):
    """Every JAX leaf lands on one port parameter of its shape, and every
    port parameter comes from one."""
    _, jv, tm, sd = pair
    n_leaves = len(jax.tree_util.tree_leaves(jv["params"]))
    port = tm.state_dict()
    assert len(sd) == n_leaves
    assert set(sd) == set(port)
    assert all(tuple(sd[k].shape) == tuple(port[k].shape) for k in sd)


@pytest.mark.parametrize("branch", ["latent", "codes", "conditioning_free"])
def test_forward_matches_jax(pair, branch):
    jm, jv, tm, _ = pair
    x, cond_mel, latent, codes, ts = _data()
    aligned = codes if branch == "codes" else latent
    free = branch == "conditioning_free"
    want = jm.apply(jv, jnp.asarray(x), jnp.asarray(ts),
                    aligned_conditioning=jnp.asarray(aligned),
                    conditioning_latent=jnp.asarray(cond_mel),
                    conditioning_free=free)
    with torch.no_grad():
        got = tm(_t(x), _t(ts).long(), aligned_conditioning=_t(aligned),
                 conditioning_latent=_t(cond_mel), conditioning_free=free)
    assert got.shape == (B, 2 * IN_CH, T)
    _close(got, want)


def test_precomputed_embeddings_and_code_pred(pair):
    """get_conditioning, timestep_independent with the code prediction
    (channels-last embedding, (B, C, T) prediction) and the forward from
    the precomputed embedding, each against JAX's."""
    jm, jv, tm, _ = pair
    x, cond_mel, latent, _, ts = _data()
    cl = jm.apply(jv, jnp.asarray(cond_mel), method=jm.get_conditioning)
    emb, pred = jm.apply(jv, jnp.asarray(latent), cl, T, True,
                         method=jm.timestep_independent)
    want = jm.apply(jv, jnp.asarray(x), jnp.asarray(ts),
                    precomputed_aligned_embeddings=emb)
    with torch.no_grad():
        tcl = tm.get_conditioning(_t(cond_mel))
        temb, tpred = tm.timestep_independent(_t(latent), tcl, T, True)
        got = tm(_t(x), _t(ts).long(), precomputed_aligned_embeddings=temb)
        out, none = tm(_t(x), _t(ts).long(),
                       precomputed_aligned_embeddings=temb,
                       return_code_pred=True)
    _close(tcl, cl)
    _close(temb, emb)
    _close(tpred, pred)
    _close(got, want)
    assert none is None and torch.equal(out, got)


@pytest.mark.parametrize("share", [0.0, 1.0])
def test_train_masks_match_jax(pair, share):
    """train=True with the layer drop and the unconditioned share at 0
    (nothing masked: the eval output) and at 1 (every middle layer kept
    out, every row unconditioned and its code prediction zeroed), the
    masks drawn from a torch.Generator and from JAX's streams."""
    _, jv, tm, _ = pair
    x, cond_mel, latent, _, ts = _data()
    jm = JDiffusionTts(**KW, layer_drop=share,
                       unconditioned_percentage=share)
    want, wpred = jm.apply(jv, jnp.asarray(x), jnp.asarray(ts),
                           aligned_conditioning=jnp.asarray(latent),
                           conditioning_latent=jnp.asarray(cond_mel),
                           return_code_pred=True, train=True,
                           rngs={"drop": jax.random.PRNGKey(1),
                                 "uncond": jax.random.PRNGKey(2),
                                 "dropout": jax.random.PRNGKey(3)})
    tm.layer_drop = tm.unconditioned_percentage = share
    try:
        with torch.no_grad():
            got, pred = tm(_t(x), _t(ts).long(),
                           aligned_conditioning=_t(latent),
                           conditioning_latent=_t(cond_mel),
                           return_code_pred=True, train=True,
                           generator=torch.Generator().manual_seed(4))
    finally:
        tm.layer_drop = tm.unconditioned_percentage = 0.0
    _close(got, want)
    _close(pred, wpred)
    if share:
        assert not pred.any()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("max_distance", [64, 128])
def test_relative_position_buckets_equal_jax(causal, max_distance):
    rel = np.arange(-400, 401)
    jr = JRelPos(scale=1.0, heads=2, num_buckets=32,
                 max_distance=max_distance, causal=causal)
    want = np.asarray(jr._bucket(jnp.asarray(rel, jnp.int32)))
    tr = RelativePositionBias(1.0, 2, causal=causal, num_buckets=32,
                              max_distance=max_distance)
    got = tr.bucket(torch.from_numpy(rel)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < 32


def test_registry_builds_and_loads_diffusion_tts():
    """load_model("diffusion_tts") builds the port's DiffusionTts with the
    reference ctor's defaults, and the entry's from_jax carries the
    variables of JAX's registry model (traced shapes) onto it."""
    m = registry.load_model("diffusion_tts", device="cpu")
    assert isinstance(m, DiffusionTts)
    assert m.model_channels == 512 and len(m.layers) == 8 + 3
    assert m.code_embedding.weight.shape == (8193, 512)
    assert m.out[2].out_channels == 200
    jm = JDiffusionTts()
    init = shaped_zeros(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 100, 16)), jnp.array([0]),
        aligned_conditioning=jnp.zeros((1, 512, 4)),
        conditioning_latent=jnp.zeros((1, 100, 16))))
    sd = registry.MODELS["diffusion_tts"]["from_jax"](init, None)
    m.load_state_dict(convert.to_torch(sd, "cpu"))
