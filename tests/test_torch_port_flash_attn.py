"""Port parity: K2, flash attention for the UNet consumer self-attention.

flash_mha's plain twin (what CPU tensors take) against JAX's flash_mha with
its reference core, on aligned and ragged shapes, f32. The kernel itself is
held against this twin on the card in tests/test_torch_port_kernels.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from xtts_tpu.nn import flash_attn as jfa  # noqa: E402
from xtts_tpu_torch.nn import flash_attn as tfa  # noqa: E402


def _qkv(seed, b, tq, tk, h, dh):
    rng = np.random.default_rng(seed)
    mk = lambda t: rng.standard_normal((b, t, h, dh)).astype(np.float32)
    return mk(tq), mk(tk), mk(tk)


@pytest.mark.parametrize("b,tq,tk,h,dh", [
    (1, 128, 256, 2, 8),      # block multiples
    (2, 130, 150, 2, 8),      # ragged Tq and Tk
    (2, 300, 583, 2, 64),     # the chip check's ragged shape, fewer heads
    (1, 64, 64, 1, 64),
])
def test_plain_matches_jax_reference_core(b, tq, tk, h, dh):
    q, k, v = _qkv(tq + tk, b, tq, tk, h, dh)
    want = np.asarray(jfa.flash_mha(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), dh ** -0.5,
                                    core="reference"))
    got = tfa.flash_mha(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), dh ** -0.5)
    assert got.shape == (b, tq, h, dh)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-6)


def test_gate_matches_jax_threshold():
    assert not tfa.use_flash(512, 1023)
    assert tfa.use_flash(512, 1024)
    assert tfa.use_flash(1280, 1562)
    assert not tfa.use_flash(282, 282)     # ReferenceNet self-attention


def test_cpu_tensor_takes_the_plain_twin():
    q, k, v = (torch.from_numpy(a) for a in _qkv(0, 1, 40, 50, 2, 64))
    tfa.flash_mha.launches = 0
    tfa.flash_mha(q, k, v, 0.125)
    assert tfa.flash_mha.launches == 0
