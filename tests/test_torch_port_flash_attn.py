"""Port parity: K2, flash attention for the UNet consumer self-attention.

flash_mha's plain twin (what CPU tensors take) against JAX's flash_mha with
its reference core, on aligned and ragged shapes, f32; its backward (the
autograd Function's CPU path: flash_mha_plain_lse, flash_mha_bwd_plain)
against jax.grad of the same, against torch autograd and finite
differences. The kernels themselves are held against these twins on the
card in tests/test_torch_port_kernels.py."""
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


# ---------------------------------------------------------------------------
# K2's backward (the Function, its forward twin with lse, its backward twin)


def test_cpu_forward_under_grad_equals_plain_bit_for_bit():
    """With gradients recorded the Function's CPU forward
    (flash_mha_plain_lse) gives flash_mha_plain's bits, so the diffusion
    parity tests read the same outputs."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 2, 130, 150, 2, 64))
    want = tfa.flash_mha_plain(q, k, v, 0.125)
    got = tfa.flash_mha(q.requires_grad_(), k, v, 0.125)
    assert got.grad_fn is not None
    assert torch.equal(got.detach(), want)
    qb, kb, vb = (t.detach().bfloat16() for t in (q, k, v))
    o, _ = tfa.flash_mha_plain_lse(qb, kb, vb, 0.125)
    assert torch.equal(o, tfa.flash_mha_plain(qb, kb, vb, 0.125))


def test_plain_lse_is_logsumexp():
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, 2, 130, 150, 2, 64))
    _, lse = tfa.flash_mha_plain_lse(q, k, v, 0.125)
    sim = torch.einsum("bihd,bjhd->bhij", q, k) * 0.125
    assert lse.shape == (2, 2, 130) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, torch.logsumexp(sim, dim=-1),
                               rtol=1e-6, atol=1e-6)


def test_backward_twin_matches_jax_grad_of_reference_core():
    """flash_mha_bwd_plain against jax.grad of JAX's flash_mha (its padding,
    segment mask and slice, reference core) at the ragged (2, 130 | 150, 2,
    64), f32, JAX's own tolerances for the wrapper's gradients
    (tests/test_flash_attn.py test_grads_match_plain)."""
    import jax
    q, k, v = _qkv(5, 2, 130, 150, 2, 64)
    do = np.random.default_rng(6).standard_normal(q.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: jfa.flash_mha(a, b, c, 0.125,
                                                   core="reference"),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    o, lse = tfa.flash_mha_plain_lse(tq, tk, tv, 0.125)
    got = tfa.flash_mha_bwd_plain(tq, tk, tv, o, lse, torch.from_numpy(do),
                                  0.125)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_twin_matches_autograd_through_plain(dtype):
    """The Function's CPU backward (the twin, from the saved q, k, v, o and
    lse) against torch autograd through flash_mha_plain in f32 on the same
    (dtype-valued) inputs. f32: summation order only (1e-5 of the largest
    gradient); bf16: the twin rounds P, dS and the gradients to bf16, three
    roundings of 2^-9 relative, so within 2^-7 of the largest gradient
    (autograd through the plain version in bf16, which rounds more, lies
    up to 7.6e-3 away)."""
    q, k, v = (torch.from_numpy(a).to(dtype)
               for a in _qkv(7, 2, 70, 90, 2, 64))
    do = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 70, 2, 64)).astype(np.float32)).to(dtype)
    a = [t.clone().requires_grad_() for t in (q, k, v)]
    b = [t.float().requires_grad_() for t in (q, k, v)]
    tfa.flash_mha(*a, 0.125).backward(do)
    tfa.flash_mha_plain(*b, 0.125).backward(do.float())
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    for x, y in zip(a, b):
        assert x.grad.dtype == dtype
        scale = y.grad.abs().max().item()
        assert (x.grad.float() - y.grad).abs().max().item() <= tol * scale


def test_function_gradcheck_float64():
    """The Function's forward and backward (the twins in float64) against
    finite differences."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, t, 2, 16)))
               .requires_grad_() for t in (4, 5, 5))
    assert torch.autograd.gradcheck(
        lambda a, b, c: tfa.flash_mha(a, b, c, 0.3), (q, k, v))


def test_double_backward_raises():
    """Once differentiable, as the Pallas kernel's "Higher-order AD not
    supported"."""
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _qkv(10, 1, 20, 30, 2, 64))
    out = tfa.flash_mha(q, k, v, 0.125)
    g, = torch.autograd.grad((out ** 2).sum(), q, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        g.sum().backward()


def test_cpu_backward_launches_no_kernel():
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _qkv(11, 1, 40, 50, 2, 64))
    for fn in tfa.KERNELS:
        fn.launches = 0
    tfa.flash_mha(q, k, v, 0.125).sum().backward()
    assert all(fn.launches == 0 for fn in tfa.KERNELS)
    assert q.grad is not None and k.grad is not None and v.grad is not None


def test_backward_wrappers_take_the_twin_on_cpu():
    """flash_mha_bwd_dkv and flash_mha_bwd_dq on CPU tensors: the plain
    twin's (dk, dv) and dq, no launch."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(12, 1, 30, 40, 2, 64))
    do = torch.from_numpy(np.random.default_rng(13).standard_normal(
        (1, 30, 2, 64)).astype(np.float32))
    o, lse = tfa.flash_mha_plain_lse(q, k, v, 0.125)
    dq, dk, dv = tfa.flash_mha_bwd_plain(q, k, v, o, lse, do, 0.125)
    delta = tfa._delta(o, do)
    for fn in tfa.KERNELS:
        fn.launches = 0
    got_k, got_v = tfa.flash_mha_bwd_dkv(q, k, v, do, lse, delta, 0.125)
    got_q = tfa.flash_mha_bwd_dq(q, k, v, do, lse, delta, 0.125)
    assert torch.equal(got_q, dq) and torch.equal(got_k, dk)
    assert torch.equal(got_v, dv)
    assert all(fn.launches == 0 for fn in tfa.KERNELS)
