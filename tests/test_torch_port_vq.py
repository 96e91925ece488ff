"""K3 (ops/vq.py): the port's plain twin against the JAX Pallas kernel in
interpret mode and its XLA formula, on the CPU. Codes must be identical,
including a ragged codebook, ragged rows and exact ties (first index)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from xtts_tpu.ops import vq as jvq  # noqa: E402
from xtts_tpu_torch.ops import vq as tvq  # noqa: E402


@pytest.mark.parametrize("n,d,e", [(300, 64, 700), (37, 16, 50),
                                   (257, 32, 512), (8, 512, 1100)])
def test_codes_identical(n, d, e):
    rng = np.random.default_rng(n + e)
    x = rng.standard_normal((n, d)).astype(np.float32)
    emb = rng.standard_normal((d, e)).astype(np.float32)
    pallas = np.asarray(jvq.vq_nearest_pallas(jnp.asarray(x),
                                              jnp.asarray(emb),
                                              interpret=True))
    xla = np.asarray(jvq.vq_nearest_xla(jnp.asarray(x), jnp.asarray(emb)))
    tvq.vq_nearest.launches = 0
    got = tvq.vq_nearest(torch.from_numpy(x), torch.from_numpy(emb)).numpy()
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, xla)
    assert tvq.vq_nearest.launches == 0          # CPU tensors: plain twin


def test_tie_takes_first_index():
    emb = np.zeros((4, 700), np.float32)
    emb[:, 3] = emb[:, 5] = emb[:, 600] = 1.0    # one code, three times
    x = np.ones((5, 4), np.float32)
    want = np.asarray(jvq.vq_nearest_pallas(jnp.asarray(x), jnp.asarray(emb),
                                            interpret=True))
    got = tvq.vq_nearest(torch.from_numpy(x), torch.from_numpy(emb)).numpy()
    assert (got == 3).all() and (want == 3).all()


def test_leading_dims_and_soft_codes():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 16)).astype(np.float32)
    emb = rng.standard_normal((16, 40)).astype(np.float32)
    want = np.asarray(jvq.vq_nearest(jnp.asarray(x), jnp.asarray(emb)))
    got = tvq.vq_nearest(torch.from_numpy(x), torch.from_numpy(emb))
    assert tuple(got.shape) == (2, 9)
    np.testing.assert_array_equal(got.numpy(), want)
    soft = tvq.vq_soft_codes(torch.from_numpy(x), torch.from_numpy(emb))
    np.testing.assert_allclose(soft.numpy(), np.asarray(jvq.vq_soft_codes(
        jnp.asarray(x), jnp.asarray(emb))), rtol=1e-5, atol=1e-4)
