"""DVAE (models/dvae.py, K3 in get_codebook_indices) against the JAX
package's on the CPU, weights carried by utils.convert.dvae_from_jax.
Tolerances: pre-VQ logits and decoded mels within 1e-4 (f32 convs, summed
in another order); codes identical."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xtts_tpu.core.config import DVAEConfig  # noqa: E402
from xtts_tpu.models import dvae as jdv  # noqa: E402
from xtts_tpu.utils import convert as jconv  # noqa: E402
from xtts_tpu_torch.core import config as tcfg  # noqa: E402
from xtts_tpu_torch.models import dvae as tdv  # noqa: E402
from xtts_tpu_torch.utils import convert  # noqa: E402
from test_torch_port_e2e import traced_zeros  # noqa: E402

CONFIGS = {
    "small": DVAEConfig(channels=8, num_tokens=30, hidden_dim=16,
                        num_resnet_blocks=1, codebook_dim=16, num_layers=2),
    "three_blocks": DVAEConfig(channels=12, num_tokens=128, hidden_dim=32,
                               num_resnet_blocks=3, codebook_dim=24,
                               num_layers=2, activation="silu"),
}
TOL = dict(rtol=1e-4, atol=1e-4)


def randomize(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = randomize(v, rng)
            continue
        v = np.asarray(v)
        x = (0.1 * rng.standard_normal(v.shape) if k == "bias" else
             rng.standard_normal(v.shape) / np.sqrt(np.prod(v.shape[:-1])))
        out[k] = x.astype(np.float32)
    return out


def _pair(cfg, seed=0):
    jm = jdv.DVAE(cfg)

    def init():
        return jm.init(jax.random.PRNGKey(seed),
                       jnp.zeros((1, cfg.channels, 32)))
    # the parameters' shapes in the eager init's key order by tracing
    # (randomize redraws every leaf: the same draws), the codebook from
    # the compiled init (bit for bit the eager init's: a 3x cheaper init)
    variables = {"params": randomize(traced_zeros(init)["params"],
                                     np.random.default_rng(seed)),
                 "codebook": {k: np.asarray(v) for k, v in
                              jax.jit(init)()["codebook"].items()}}
    tm = tdv.DVAE(tcfg.DVAEConfig.from_dict(cfg.to_dict())).eval()
    tm.load_state_dict(convert.to_torch(device="cpu", sd=convert.dvae_from_jax(
        variables, cfg.num_layers, cfg.num_resnet_blocks)))
    return jm, variables, tm


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_round_trip_parity(name):
    cfg = CONFIGS[name]
    jm, jv, tm = _pair(cfg)
    mel = np.random.default_rng(1).standard_normal(
        (2, cfg.channels, 64)).astype(np.float32)
    want_lat = np.asarray(jm.apply(jv, mel, method=jm.encode))
    want_codes = np.asarray(jm.apply(jv, mel,
                                     method=jm.get_codebook_indices))
    want_mel, want_pen = jm.apply(jv, jnp.asarray(want_codes),
                                  method=jm.decode)
    with torch.no_grad():
        got_lat = tm.encode(torch.from_numpy(mel)).numpy()
        got_codes = tm.get_codebook_indices(torch.from_numpy(mel))
        got_mel, got_pen = tm.decode(got_codes)
    np.testing.assert_allclose(got_lat, want_lat, **TOL)
    np.testing.assert_array_equal(got_codes.numpy(), want_codes)
    assert tuple(got_mel.shape) == (2, cfg.channels, 64)
    np.testing.assert_allclose(got_mel.numpy(), np.asarray(want_mel), **TOL)
    np.testing.assert_allclose(got_pen.numpy(), np.asarray(want_pen), **TOL)


def test_decode_clips_out_of_range_codes():
    cfg = CONFIGS["small"]
    jm, jv, tm = _pair(cfg, seed=2)
    codes = np.array([[0, 5, 29, 30, 199, 31]], np.int32)   # stop/start ids
    want, _ = jm.apply(jv, jnp.asarray(codes), method=jm.decode)
    got, _ = tm.decode(torch.from_numpy(codes).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_state_dict_is_the_references():
    """port state_dict() -> xtts_tpu's dvae_from_reference gives back the
    JAX variables."""
    cfg = CONFIGS["three_blocks"]
    _, jv, tm = _pair(cfg, seed=3)
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    back = jconv.dvae_from_reference(sd, cfg.num_layers,
                                     cfg.num_resnet_blocks)
    flat = lambda t, p=(): [(p + (k,), v) for k, v in t.items()
                            if not isinstance(v, dict)] + sum(
        (flat(v, p + (k,)) for k, v in t.items() if isinstance(v, dict)), [])
    got, want = dict(flat(back)), dict(flat(jv))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
