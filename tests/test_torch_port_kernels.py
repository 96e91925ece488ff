"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test is marked `gpu` and skips without a CUDA card: the kernels have
no CPU mode. The file imports no JAX, so it runs on a machine with only
PyTorch + CUDA; there, skip the JAX test harness's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_port_kernels.py

Tolerances: single ops 1e-2 (one bf16 rounding of O(1) values on either
side; int4_gemv relative to max(1, |y|)), the whole decode step, int8 or
int4, 2e-2 relative to the logits' scale (tests/test_decode_step.py's
bound), flash attention 1e-2 against f32 attention on the same bf16
inputs; K3 codes equal up to fp32 ties (the bound at _vq_agree); K4 as K1,
with the new int8 cache rows within +-1. A product with the norm prologue
(ln=) equals layer_norm_rows then the unfused product bit for bit (both
fold the statistics in one order), and its plain twin bit for bit where
the twin repeats the kernel's order (int8_gemv, int4_gemv, with and
without gelu: gelu_new_ordered repeats the kernels' explicitly rounded
gelu_new), else within 1e-2. layer_norm_rows, int8_gemv, int4_gemv,
decode_attention and serving_attention equal their ordered twins bit for
bit; int8_gemm_rows, with gelu too, where its sums are exact (integer
operands). The attention kernels read the cache index from device memory
and equal their int-index launches bit for bit. The AR loop's CUDA graphs
(infer/device_loop.py) give the codes of the same loop run eagerly, for K1,
K1-int4 and K4, greedy and sampled. The slot pool's (infer/slots.py) too,
over both cache forms; its per-row draws in a graph equal eager ones, draw
for draw, and one generator a row draws at one row what the single
generator draws. K2's backward kernels and f32 forward against the f32
twins (tolerances at K2_BWD_TOL), deterministic, on strided head-split
views, where the ring wraps with ragged edges and on planted rows of
large lse; no K2 kernel spills; the wide forwards, bf16 and f32, with
ranks that hold no key, deterministic and on strided views; the f32
pair's dq on a second stream equals the kernels in
turn; K2 on the UNet's training step against flash=False; P9 (the
default f32 TextToSpeech at bucket 320); K2's wide kernels at head widths
256 and 384 and a 512-channel UNet with 256-wide heads rendering through
them; a compacting
wave (infer/compact.py) against the monolithic chain's greedy codes; the
legacy DiffusionTts on the card against the CPU. The training path: K3 at the trainers' row counts, one
vqvae Trainer step on the card against the CPU (loss 1e-4 relative,
gradients rtol 1e-4 / atol 1e-6, EMA codebook 1e-5), and a checkpoint
restored on the card bit for bit.
"""
import contextlib
import math

import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _qtree(g, layers, d, vocab, s_max):
    from xtts_tpu_torch.infer.qdecode import quantize_dense

    def w(i, o):
        return quantize_dense(torch.randn(i, o, generator=g, device="cuda")
                              / math.sqrt(i))

    def vec(n):
        return torch.randn(n, generator=g, device="cuda") * 0.1

    def ln():
        return {"scale": 1.0 + vec(d), "bias": vec(d)}

    return {"layers": [{"ln_1": ln(), "ln_2": ln(), "qkv": w(d, 3 * d),
                        "qkv_b": vec(3 * d), "proj": w(d, d),
                        "proj_b": vec(d), "fc": w(d, 4 * d),
                        "fc_b": vec(4 * d), "out": w(4 * d, d),
                        "out_b": vec(d)} for _ in range(layers)],
            "ln_f": ln(), "final_norm": ln(), "mel_head": w(d, vocab),
            "mel_head_b": vec(vocab),
            "mel_embedding": (torch.randn(vocab, d, generator=g,
                                          device="cuda") * 0.3).bfloat16(),
            "mel_pos_embedding": (torch.randn(s_max, d, generator=g,
                                              device="cuda") * 0.1).bfloat16()}


@pytest.mark.parametrize("rows,d,two", [(1, 1024, False), (1, 1024, True),
                                        (3, 128, False), (2, 4096, True)])
def test_layer_norm_rows(cuda, rows, d, two):
    from xtts_tpu_torch.ops import decode_step as ds
    x = torch.randn(rows, d, generator=cuda, device="cuda") * 3 + 1
    p = [1 + 0.1 * torch.randn(d, generator=cuda, device="cuda")
         for _ in range(4)]
    args = p if two else p[:2]
    got = ds.layer_norm_rows(x, *args)
    want = ds.layer_norm_rows_plain(x, *args)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (rows, d)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                               atol=1e-2)


@pytest.mark.parametrize("rows,d,two", [(1, 1024, False), (1, 1024, True),
                                        (3, 128, False), (2, 4096, True),
                                        (5, 100, True), (4096, 1024, True)])
def test_layer_norm_rows_is_its_ordered_twin_bit_for_bit(cuda, rows, d, two):
    """layer_norm_rows_ordered repeats the kernel's statistics (the 256-way
    partials, the butterflies, the divisions) and its explicitly rounded
    normalisation in order: on the card the two give the same bits, so
    the kernel's rsqrtf and torch.rsqrt agree on every row (4096 rows: 8192
    variances)."""
    from xtts_tpu_torch.ops import decode_step as ds
    x = torch.randn(rows, d, generator=cuda, device="cuda") * 3 + 1
    p = [1 + 0.1 * torch.randn(d, generator=cuda, device="cuda")
         for _ in range(4)]
    args = p if two else p[:2]
    got = ds.layer_norm_rows(x, *args)
    want = ds.layer_norm_rows_ordered(x, *args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("k,n,gelu,mode", [
    (1024, 3072, False, "f32"), (1024, 1024, False, "acc"),
    (1024, 4096, True, "bf16"), (4096, 1024, False, "acc"),
    (1024, 9216, False, "f32"), (128, 32, True, "f32"), (100, 64, False,
                                                          "bf16")])
def test_int8_gemv(cuda, k, n, gelu, mode):
    from xtts_tpu_torch.infer.qdecode import quantize_dense
    from xtts_tpu_torch.ops import decode_step as ds
    q = quantize_dense(torch.randn(k, n, generator=cuda, device="cuda")
                       / math.sqrt(k))
    x = torch.randn(k, generator=cuda, device="cuda").bfloat16()
    bias = torch.randn(n, generator=cuda, device="cuda") * 0.1
    if mode == "acc":
        base = torch.randn(n, generator=cuda, device="cuda")
        got, want = base.clone(), base.clone()
        ds.int8_gemv(x, q["w"], q["scale"], bias, out=got, gelu=gelu)
        ds.int8_gemv_plain(x, q["w"], q["scale"], bias, out=want, gelu=gelu)
    else:
        dt = torch.bfloat16 if mode == "bf16" else torch.float32
        got = ds.int8_gemv(x, q["w"], q["scale"], bias, gelu=gelu,
                           out_dtype=dt)
        want = ds.int8_gemv_plain(x, q["w"], q["scale"], bias, gelu=gelu,
                                  out_dtype=dt)
        assert got.dtype == dt
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                               atol=1e-2)


K1_SHAPES = [(1024, 3072), (1024, 1024), (1024, 4096), (4096, 1024),
             (1024, 9216)]
# int8_gemv's plan edges: a ragged chunk, K split 2, 3 and 16 ways
I8_EDGES = [(100, 64), (2048, 64), (3000, 32), (4096, 32), (12288, 32)]


def test_int8_gemv_plan_is_the_kernels(cuda):
    """int8_gemv_plan (the twin's chunks) equals csrc's gv_splits / gv_lo
    at every K1 shape and over a sweep of K and N."""
    from xtts_tpu_torch.ops import decode_step as ds
    cases = K1_SHAPES + I8_EDGES + [
        (k, n) for k in list(range(16, 5000, 61)) + [8192, 12288]
        for n in (32, 64, 96, 512, 1024, 4096, 9216)]
    for k, n in cases:
        assert ds.kernel_int8_gemv_plan(k, n) == ds.int8_gemv_plan(k, n), \
            (k, n)


@pytest.mark.parametrize("mode", ["f32", "acc", "gelu"])
@pytest.mark.parametrize("k,n", K1_SHAPES + I8_EDGES)
def test_int8_gemv_is_its_twin_bit_for_bit(cuda, k, n, mode):
    """The plain twin sums in the kernel's order (int8_gemv_plan's chunks;
    in each, 64 lanes of strided rows, folded 8 at a time, then the folds
    and the chunks in order), rounds the epilogue's product and sum
    separately and runs gelu_new in the kernel's order, as the kernel
    does: the two give the same bits at every K1 shape and at the plan's
    edges (gelu: bf16 out, as the fc product)."""
    from xtts_tpu_torch.infer.qdecode import quantize_dense
    from xtts_tpu_torch.ops import decode_step as ds
    q = quantize_dense(torch.randn(k, n, generator=cuda, device="cuda")
                       / math.sqrt(k))
    x = torch.randn(k, generator=cuda, device="cuda").bfloat16()
    bias = torch.randn(n, generator=cuda, device="cuda") * 0.1
    if mode == "acc":
        base = torch.randn(n, generator=cuda, device="cuda")
        got, want = base.clone(), base.clone()
        ds.int8_gemv(x, q["w"], q["scale"], bias, out=got)
        ds.int8_gemv_plain(x, q["w"], q["scale"], bias, out=want)
    else:
        kw = (dict(gelu=True, out_dtype=torch.bfloat16) if mode == "gelu"
              else {})
        got = ds.int8_gemv(x, q["w"], q["scale"], bias, **kw)
        want = ds.int8_gemv_plain(x, q["w"], q["scale"], bias, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["f32", "acc", "bf16", "gelu"])
@pytest.mark.parametrize("k,n,groups", [(1024, 3072, 1), (1024, 1024, 1),
                                        (1024, 4096, 1), (4096, 1024, 4),
                                        (1024, 9216, 1), (384, 160, 3),
                                        (100, 64, 1), (4096, 32, 1),
                                        (256, 9248, 1)])
def test_int4_gemv_is_its_twin_bit_for_bit(cuda, k, n, groups, mode):
    """int4_gemv_plain repeats the kernel's split-K sums (lanes, chunks,
    groups, each in order) and its explicitly rounded epilogue and gelu:
    the two give the same bits, at every K1-int4 shape, at a ragged
    chunk (K 100), three groups, K split in 16 chunks (N 32), and blocks
    of two column tiles with a last block of one (N 9248)."""
    from xtts_tpu_torch.ops import decode_step as ds
    x, w, scale, bias = _int4_operands(cuda, k, n, groups)
    if mode == "acc":
        base = torch.randn(n, generator=cuda, device="cuda")
        got, want = base.clone(), base.clone()
        ds.int4_gemv(x, w, scale, bias, out=got)
        ds.int4_gemv_plain(x, w, scale, bias, out=want)
    else:
        dt = torch.float32 if mode == "f32" else torch.bfloat16
        got = ds.int4_gemv(x, w, scale, bias, out_dtype=dt,
                           gelu=mode == "gelu")
        want = ds.int4_gemv_plain(x, w, scale, bias, out_dtype=dt,
                                  gelu=mode == "gelu")
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("heads,s_max,idx", [(16, 360, 0), (16, 360, 299),
                                             (16, 360, 359), (2, 40, 17),
                                             (16, 360, 1), (16, 360, 5),
                                             (16, 16384, 16383)])
def test_decode_attention(cuda, heads, s_max, idx):
    from xtts_tpu_torch.ops import decode_step as ds
    d = heads * 64
    qkv = torch.randn(3 * d, generator=cuda, device="cuda")
    kc = (torch.randn(s_max, d, generator=cuda, device="cuda")
          * 0.5).bfloat16()
    vc = (torch.randn(s_max, d, generator=cuda, device="cuda")
          * 0.5).bfloat16()
    kc2, vc2 = kc.clone(), vc.clone()
    got = ds.decode_attention(qkv, kc, vc, idx, heads)
    want = ds.decode_attention_plain(qkv, kc2, vc2, idx, heads)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                               atol=1e-2)
    torch.testing.assert_close(kc.float(), kc2.float(), rtol=0, atol=0)
    torch.testing.assert_close(vc.float(), vc2.float(), rtol=0, atol=0)


@pytest.mark.parametrize("layers,d,heads,vocab", [(2, 128, 2, 200),
                                                  (15, 1024, 16, 8194)])
def test_decode_step_chain(cuda, layers, d, heads, vocab):
    """16 teacher-forced steps: kernel chain vs plain step."""
    from xtts_tpu_torch.ops import decode_step as ds
    s_max, p_len = 96, 54
    qt = _qtree(cuda, layers, d, vocab, s_max)
    st = ds.stack_qtree(qt, vocab)
    kc = torch.zeros(layers, s_max, d, dtype=torch.bfloat16, device="cuda")
    kc[:, :p_len] = (torch.randn(layers, p_len, d, generator=cuda,
                                 device="cuda") * 0.5).bfloat16()
    vc = kc.roll(1, dims=0).clone()
    kc2, vc2 = kc.clone(), vc.clone()
    ds.reset_launch_counts()
    agree = 0
    for step in range(16):
        tok = (step * 37) % vocab
        x = qt["mel_embedding"][tok][None] + qt["mel_pos_embedding"][step][None]
        got = ds.fused_decode_logits(st, x, kc, vc, p_len + step, layers,
                                     heads)[0][:, :vocab]
        want = ds.fused_decode_logits_plain(st, x, kc2, vc2, p_len + step,
                                            layers, heads)[0][:, :vocab]
        scale = max(1.0, want.abs().max().item())
        assert (got - want).abs().max().item() <= 2e-2 * scale, step
        agree += int(got.argmax() == want.argmax())
    torch.cuda.synchronize()
    assert agree >= 15
    torch.testing.assert_close(kc.float(), kc2.float(), rtol=2e-2, atol=2e-2)
    assert ds.fused_decode_logits.launches == 16
    assert ds.int8_gemv.launches == 16 * (4 * layers + 1)
    assert ds.int8_gemv.ln_launches == 16 * (2 * layers + 1)
    assert ds.layer_norm_rows.launches == 0
    assert (ds.int8_gemv.launches + ds.decode_attention.launches
            == 16 * (5 * layers + 1))


def _int4_operands(g, k, n, groups):
    from xtts_tpu_torch.ops import decode_step as ds
    w4 = torch.randint(-7, 8, (k, n), generator=g,
                       device="cuda").to(torch.int8)
    scale = (torch.rand(groups, n, generator=g, device="cuda") * 0.02
             + 1e-3)
    bias = torch.randn(n, generator=g, device="cuda") * 0.1
    x = torch.randn(k, generator=g, device="cuda").bfloat16()
    return x, ds.pack_int4(w4), scale, bias


@pytest.mark.parametrize("k,n,groups,gelu,mode", [
    (1024, 3072, 1, False, "f32"), (1024, 1024, 1, False, "acc"),
    (1024, 4096, 1, True, "bf16"), (4096, 1024, 4, False, "acc"),
    (1024, 9216, 1, False, "f32"), (4096, 1024, 4, True, "f32"),
    (256, 96, 2, False, "bf16"), (128, 32, 1, True, "acc"),
    (384, 160, 3, False, "f32")])
def test_int4_gemv(cuda, k, n, groups, gelu, mode):
    """Every mode and group count; narrow products (N 96, 160, 32) split K
    over several blocks. Bound: one bf16 rounding of the result relative to
    max(1, |y|), as the other single ops."""
    from xtts_tpu_torch.ops import decode_step as ds
    x, w, scale, bias = _int4_operands(cuda, k, n, groups)
    ds.int4_gemv.launches = 0
    if mode == "acc":
        base = torch.randn(n, generator=cuda, device="cuda")
        got, want = base.clone(), base.clone()
        ds.int4_gemv(x, w, scale, bias, out=got, gelu=gelu)
        ds.int4_gemv_plain(x, w, scale, bias, out=want, gelu=gelu)
    else:
        dt = torch.bfloat16 if mode == "bf16" else torch.float32
        got = ds.int4_gemv(x, w, scale, bias, gelu=gelu, out_dtype=dt)
        want = ds.int4_gemv_plain(x, w, scale, bias, gelu=gelu, out_dtype=dt)
        assert got.dtype == dt and got.shape == (n,)
    torch.cuda.synchronize()
    assert ds.int4_gemv.launches == 1
    scale_y = max(1.0, want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= 1e-2 * scale_y


@pytest.mark.parametrize("layers,d,heads,vocab", [(2, 128, 2, 200),
                                                  (15, 1024, 16, 8194)])
def test_decode_step_chain_int4(cuda, layers, d, heads, vocab):
    """16 teacher-forced steps on the int4 stack: kernel chain vs plain
    step, int4_gemv in every matvec and int8_gemv in none."""
    from xtts_tpu_torch.ops import decode_step as ds
    s_max, p_len = 96, 54
    qt = _qtree(cuda, layers, d, vocab, s_max)
    st = ds.stack_qtree_int4(qt, vocab)
    kc = torch.zeros(layers, s_max, d, dtype=torch.bfloat16, device="cuda")
    kc[:, :p_len] = (torch.randn(layers, p_len, d, generator=cuda,
                                 device="cuda") * 0.5).bfloat16()
    vc = kc.roll(1, dims=0).clone()
    kc2, vc2 = kc.clone(), vc.clone()
    ds.reset_launch_counts()
    agree = 0
    for step in range(16):
        tok = (step * 37) % vocab
        x = qt["mel_embedding"][tok][None] + qt["mel_pos_embedding"][step][None]
        got = ds.fused_decode_logits(st, x, kc, vc, p_len + step, layers,
                                     heads)[0][:, :vocab]
        want = ds.fused_decode_logits_plain(st, x, kc2, vc2, p_len + step,
                                            layers, heads)[0][:, :vocab]
        scale = max(1.0, want.abs().max().item())
        assert (got - want).abs().max().item() <= 2e-2 * scale, step
        agree += int(got.argmax() == want.argmax())
    torch.cuda.synchronize()
    assert agree >= 15
    torch.testing.assert_close(kc.float(), kc2.float(), rtol=2e-2, atol=2e-2)
    assert ds.fused_decode_logits.launches == 16
    assert ds.int4_gemv.launches == 16 * (4 * layers + 1)
    assert ds.int4_gemv.ln_launches == 16 * (2 * layers + 1)
    assert ds.int8_gemv.launches == 0 and ds.layer_norm_rows.launches == 0


@pytest.mark.parametrize("b,tq,tk,h", [(2, 1280, 1562, 8), (2, 300, 583, 8),
                                       (1, 64, 1, 8), (1, 65, 129, 2),
                                       (3, 17, 700, 4)])
def test_flash_mha(cuda, b, tq, tk, h):
    from xtts_tpu_torch.nn import flash_attn as fa
    q, k, v = (torch.randn(b, t, h, 64, generator=cuda,
                           device="cuda").bfloat16() for t in (tq, tk, tk))
    fa.flash_mha.launches = 0
    got = fa.flash_mha(q, k, v, 0.125)
    want = fa.flash_mha_plain(q.float(), k.float(), v.float(), 0.125)
    torch.cuda.synchronize()
    assert fa.flash_mha.launches == 1
    assert (got.float() - want).abs().max().item() < 1e-2


# K2's backward and f32 forward. Tolerances, against the f32 plain twins on
# the same inputs: bf16 gradients within 1e-2 of the tensor's largest (the
# kernels round P, dS and the result to bf16, three roundings of 2^-9
# relative); f32 gradients within 1e-5 of it (f32 sums over up to 2698
# terms in another order); the f32 forward within 5e-5 (exp2's argument
# rounding, ~1e-6 relative, and sums in another order, sqrt(Tk) 2^-24,
# on outputs up to max |v| ~ 4.5); lse within 1e-5.
K2_BWD_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}


def _k2_case(g, dtype, b, tq, tk, h):
    q, k, v = (torch.randn(b, t, h, 64, generator=g, device="cuda").to(dtype)
               for t in (tq, tk, tk))
    do = torch.randn(b, tq, h, 64, generator=g, device="cuda").to(dtype)
    return q, k, v, do


def _k2_rel(got, want, floor):
    return ((got.float() - want).abs().max()
            / max(want.abs().max().item(), floor)).item()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,tq,tk,h", [
    (2, 1280, 1562, 8),        # the main bucket
    (2, 2416, 2698, 8),        # the 604 cap bucket
    (8, 1125, 1425, 8),        # a training step's shape
    (1, 17, 70, 2),            # Tq below one tile
    (2, 130, 150, 2), (1, 65, 129, 2), (3, 1, 700, 4), (1, 64, 2, 8),
    (1, 1, 1, 1)])             # one key: dq = dk = 0 exactly
def test_flash_mha_backward(cuda, dtype, b, tq, tk, h):
    """The autograd Function on the card: the output has a grad_fn, the
    backward launches flash_mha_bwd_dkv and flash_mha_bwd_dq once each,
    and dq, dk, dv match the f32 plain backward (flash_mha_bwd_plain from
    the f32 plain forward's o and lse) on the same inputs. Scales are
    floored at 1e-3 of the largest of the three gradients (dq and dk are
    0 in exact arithmetic at Tk = 1)."""
    from xtts_tpu_torch.nn import flash_attn as fa
    q, k, v, do = _k2_case(cuda, dtype, b, tq, tk, h)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    for fn in fa.KERNELS:
        fn.launches = 0
    out = fa.flash_mha(*leaves, 0.125)
    assert out.grad_fn is not None and out.dtype == dtype
    out.backward(do)
    torch.cuda.synchronize()
    assert [fn.launches for fn in fa.KERNELS] == [1, 1, 1]
    o32, lse32 = fa.flash_mha_plain_lse(q.float(), k.float(), v.float(),
                                        0.125)
    want = fa.flash_mha_bwd_plain(q.float(), k.float(), v.float(), o32,
                                  lse32, do.float(), 0.125)
    floor = 1e-3 * max(w.abs().max().item() for w in want)
    for leaf, w, name in zip(leaves, want, "qkv"):
        assert leaf.grad.dtype == dtype and leaf.grad.shape == w.shape
        assert torch.isfinite(leaf.grad).all()
        err = _k2_rel(leaf.grad, w, floor)
        assert err <= K2_BWD_TOL[dtype], (name, err)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_mha_backward_is_deterministic(cuda, dtype):
    """No atomics: two backward passes give the same bits."""
    from xtts_tpu_torch.nn import flash_attn as fa
    q, k, v, do = _k2_case(cuda, dtype, 2, 1280, 1562, 8)
    o, lse = fa._flash_fwd_cuda(q, k, v, 0.125, True)
    a = fa.flash_mha_bwd(q, k, v, o, lse, do, 0.125)
    b = fa.flash_mha_bwd(q, k, v, o, lse, do, 0.125)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_flash_mha_backward_copies_a_gradient_it_cannot_read(cuda):
    """An output gradient the kernels cannot read as it is (out.sum()'s
    expanded ones, stride 0 on the head dim) is copied contiguous once,
    counted in flash_mha_bwd.copies, and gives the gradients of the same
    values passed contiguous."""
    from xtts_tpu_torch.nn import flash_attn as fa
    q, k, v, _ = _k2_case(cuda, torch.bfloat16, 1, 130, 150, 2)
    a = [t.clone().requires_grad_() for t in (q, k, v)]
    b = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.flash_mha_bwd.copies = 0
    fa.flash_mha(*a, 0.125).sum().backward()
    assert fa.flash_mha_bwd.copies == 1
    fa.flash_mha(*b, 0.125).backward(torch.ones(1, 130, 2, 64,
                                                dtype=torch.bfloat16,
                                                device="cuda"))
    torch.cuda.synchronize()
    assert fa.flash_mha_bwd.copies == 1
    assert all(torch.equal(x.grad, y.grad) for x, y in zip(a, b))


def _k2_bwd_against_twin(q, k, v, do, dtype, got):
    """Each of got = (dq, dk, dv) within K2_BWD_TOL of the f32 plain
    backward (from the f32 plain forward's o and lse) on the same inputs,
    relative to its largest element (floored as in
    test_flash_mha_backward)."""
    from xtts_tpu_torch.nn import flash_attn as fa
    qf, kf, vf = (t.detach().float().contiguous() for t in (q, k, v))
    o32, lse32 = fa.flash_mha_plain_lse(qf, kf, vf, 0.125)
    want = fa.flash_mha_bwd_plain(qf, kf, vf, o32, lse32, do.float(), 0.125)
    floor = 1e-3 * max(w.abs().max().item() for w in want)
    for x, w, name in zip(got, want, "qkv"):
        assert x.dtype == dtype and x.shape == w.shape, name
        assert torch.isfinite(x).all(), name
        err = _k2_rel(x, w, floor)
        assert err <= K2_BWD_TOL[dtype], (name, err)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_mha_backward_reads_strided_views(cuda, dtype):
    """The backward through autograd on q, k and v as head-split views of
    one fused (B, T, 3 x 512) projection (row stride 1536 elements, q cut
    to 600 of 700 rows), dO contiguous: the fused leaf's gradient, read
    back per head, against the f32 twin on contiguous copies."""
    from xtts_tpu_torch.nn import flash_attn as fa
    b, t, tq = 2, 700, 600
    qkv = torch.randn(b, t, 3 * 512, generator=cuda,
                      device="cuda").to(dtype).requires_grad_()
    q, k, v = (x.unflatten(-1, (8, 64)) for x in qkv.split(512, dim=-1))
    q = q[:, :tq]
    assert not q.is_contiguous() and q.stride(1) == 3 * 512
    do = torch.randn(b, tq, 8, 64, generator=cuda, device="cuda").to(dtype)
    for fn in fa.KERNELS:
        fn.launches = 0
    fa.flash_mha_bwd.copies = 0
    fa.flash_mha(q, k, v, 0.125).backward(do)
    torch.cuda.synchronize()
    assert [fn.launches for fn in fa.KERNELS] == [1, 1, 1]
    assert fa.flash_mha_bwd.copies == 0             # dO is read as it is
    grads = qkv.grad.unflatten(-1, (3, 8, 64))
    assert (grads[:, tq:, 0] == 0).all()
    _k2_bwd_against_twin(q, k, v, do, dtype,
                         (grads[:, :tq, 0], grads[:, :, 1], grads[:, :, 2]))


@pytest.mark.parametrize("tk", [319, 320, 321])
@pytest.mark.parametrize("tq", [191, 192, 193])
def test_flash_mha_backward_wraps_the_ring(cuda, tq, tk):
    """bf16, Tq and Tk of 64n - 1, 64n and 64n + 1 (n 3 and 5): the
    streamed tiles wrap the ring several times, with a ragged last tile,
    a whole one, or a tile of one row on either side."""
    from xtts_tpu_torch.nn import flash_attn as fa
    q, k, v, do = _k2_case(cuda, torch.bfloat16, 1, tq, tk, 2)
    o, lse = fa._flash_fwd_cuda(q, k, v, 0.125, True)
    fa.flash_mha_bwd_dkv.launches = fa.flash_mha_bwd_dq.launches = 0
    got = fa.flash_mha_bwd(q, k, v, o, lse, do, 0.125)
    torch.cuda.synchronize()
    assert fa.flash_mha_bwd_dkv.launches == fa.flash_mha_bwd_dq.launches == 1
    _k2_bwd_against_twin(q, k, v, do, torch.bfloat16, got)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rising", [True, False])
def test_flash_mha_backward_rescales_across_tiles(cuda, rising, dtype):
    """test_flash_mha_rescales_across_tiles' planted rows through the
    backward: scores that jump by > 20 across the 64-key tiles (rising or
    falling), so the planted rows' lse is large and P spans many orders of
    magnitude within a row. Held against the twin on the kernels' own
    inputs (o, lse of the forward), which rounds P and dS to the inputs'
    dtype as the kernels do: at these rows the rounding alone moves bf16
    dq by up to ~1.1e-2 of its largest element from the f32 twin (the
    rows of dS sum to 0, but their rounding errors do not, and K carries
    a common offset of up to 1.9 a dimension)."""
    from xtts_tpu_torch.nn import flash_attn as fa
    b, tq, tk, h = 1, 130, 700, 2
    q = torch.randn(b, tq, h, 64, generator=cuda, device="cuda") * 0.3
    k = torch.randn(b, tk, h, 64, generator=cuda, device="cuda") * 0.3
    v = torch.randn(b, tk, h, 64, generator=cuda, device="cuda")
    do = torch.randn(b, tq, h, 64, generator=cuda, device="cuda")
    tile = torch.arange(tk, device="cuda") // 64
    step = tile if rising else tile.max() - tile
    q[:, :3] = 1.0                                   # planted query rows
    k += (1.5 * step.float())[None, :, None, None] / 8.0
    q, k, v, do = (t.to(dtype) for t in (q, k, v, do))
    o, lse = fa._flash_fwd_cuda(q, k, v, 0.125, True)
    got = fa.flash_mha_bwd(q, k, v, o, lse, do, 0.125)
    torch.cuda.synchronize()
    sim = torch.einsum("bihd,bjhd->bhij", q.float(), k.float())[0, 0, 0]
    assert (sim.reshape(-1)[-1] - sim[0]).abs() > 20   # scores really jump
    assert lse[0, 0, :3].abs().min() > 10               # and lse with them
    want = fa.flash_mha_bwd_plain(q, k, v, o, lse, do, 0.125)
    floor = 1e-3 * max(w.float().abs().max().item() for w in want)
    for x, w, name in zip(got, want, "qkv"):
        assert x.dtype == dtype and torch.isfinite(x).all(), name
        err = _k2_rel(x, w.float(), floor)
        assert err <= K2_BWD_TOL[dtype], (name, err)


def test_flash_mha_backward_kernels_do_not_spill(cuda):
    """The bf16 backward kernels hold their four (dkv) or three (dq)
    accumulators and A operands in registers: no local memory; nor does
    the f32 wide pair (its accumulators and partial, keys 128 and
    WIDE)."""
    from xtts_tpu_torch.nn import flash_attn as fa
    attrs = fa.bwd_kernel_attrs()
    for name in ("flash_mha_bwd_dkv", "flash_mha_bwd_dq"):
        for key in (("bf16", 64), ("f32", 128), ("f32", fa.WIDE)):
            regs, local = attrs[(name, *key)]
            assert 0 < regs <= 255 and local == 0, (name, key, regs, local)


def test_flash_kernel_attrs_cover_every_kernel(cuda):
    """kernel_attrs reads registers and local memory of all 27 keys
    (forward, dkv, dq; bf16 and f32; widths 32, 64, 128 and the wide
    kernels, keyed WIDE; the backward's 128 and WIDE keys the wide pairs,
    bf16's wgmma pair and the f32 pair; the forward's 128, WIDE and 384
    keys, and bf16's 512, the wide forwards' instances: bf16's four
    wgmma ones, f32's three 3xTF32 ones); the backward's are
    bwd_kernel_attrs'. No kernel spills."""
    from xtts_tpu_torch.nn import flash_attn as fa
    attrs = fa.kernel_attrs()
    assert len(attrs) == 27
    assert {key[2] for key in attrs} == {32, 64, 128, fa.WIDE, 384, 512}
    assert {key for key in attrs if key[2] in (384, 512)} == {
        ("flash_mha", "bf16", 384), ("flash_mha", "bf16", 512),
        ("flash_mha", "f32", 384)}
    widths = (128, 256, 384, 512, 640, 1152)
    assert [fa.fwd_block_width(w, torch.bfloat16) for w in widths] == [
        128, 256, 384, 512, 384, 384]
    assert [fa.fwd_block_width(w, torch.float32) for w in widths] == [
        128, 256, 384, 256, 384, 384]
    assert all(0 < regs <= 255 and local >= 0
               for regs, local in attrs.values())
    assert {key: a for key, a in attrs.items() if a[1]} == {}
    assert fa.bwd_kernel_attrs() == {key: a for key, a in attrs.items()
                                     if key[0] != "flash_mha"}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,tq,tk,h", [(2, 1280, 1562, 8), (1, 65, 129, 2),
                                       (3, 17, 700, 4), (1, 1, 1, 1)])
def test_flash_mha_lse_and_f32_forward(cuda, dtype, b, tq, tk, h):
    """The forward's lse against the twin's; the output identical bit for
    bit with and without lse; the f32 forward against f32 plain
    attention."""
    from xtts_tpu_torch.nn import flash_attn as fa
    q, k, v, _ = _k2_case(cuda, dtype, b, tq, tk, h)
    o, lse = fa._flash_fwd_cuda(q, k, v, 0.125, True)
    o2, none = fa._flash_fwd_cuda(q, k, v, 0.125, False)
    o32, lse32 = fa.flash_mha_plain_lse(q.float(), k.float(), v.float(),
                                        0.125)
    torch.cuda.synchronize()
    assert none is None and torch.equal(o, o2)
    torch.testing.assert_close(lse, lse32, rtol=1e-5, atol=1e-5)
    bound = 5e-5 if dtype == torch.float32 else 1e-2
    assert (o.float() - o32).abs().max().item() <= bound


# Head widths other than 64 (P11): the tile kernels at 32 and 128 in bf16
# and f32, f32 at 64, a width between (48) zero-padded to 64, and the wide
# kernels at 256 and 384, each forward (with lse) and backward against the
# f32 twins at the tolerances above, the pads counted, the backward's bits
# the same twice.
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("width", [32, 48, 128, 256, 384])
@pytest.mark.parametrize("b,tq,tk,h", [
    (2, 1280, 1562, 4),        # the main bucket at 512 channels
    (1, 17, 70, 2),            # Tq below one tile, a ragged key tile
    (1, 193, 321, 2)])         # the ring wraps, one-row last tiles
def test_flash_mha_head_widths(cuda, dtype, width, b, tq, tk, h):
    _k2_width_case(cuda, dtype, width, b, tq, tk, h)


def _k2_width_case(cuda, dtype, width, b, tq, tk, h):
    """K2 at one head width: the forward (with lse) and the backward
    against the f32 twins at the tolerances above, the launches and pads
    counted, the backward's bits the same twice."""
    from xtts_tpu_torch.nn import flash_attn as fa
    scale = width ** -0.5
    q, k, v, do = (torch.randn(b, t, h, width, generator=cuda,
                               device="cuda").to(dtype)
                   for t in (tq, tk, tk, tq))
    for fn in fa.KERNELS:
        fn.launches = 0
    fa.flash_mha.pads = 0
    o, lse = fa._flash_fwd_cuda(q, k, v, scale, True)
    got = fa.flash_mha_bwd(q, k, v, o, lse, do, scale)
    again = fa.flash_mha_bwd(q, k, v, o, lse, do, scale)
    torch.cuda.synchronize()
    assert [fn.launches for fn in fa.KERNELS] == [1, 2, 2]
    assert fa.flash_mha.pads == (5 if width == 48 else 0)
    assert o.shape == q.shape and o.dtype == dtype
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    qf, kf, vf = (t.float() for t in (q, k, v))
    o32, lse32 = fa.flash_mha_plain_lse(qf, kf, vf, scale)
    torch.testing.assert_close(lse, lse32, rtol=1e-5, atol=1e-5)
    bound = 5e-5 if dtype == torch.float32 else 1e-2
    assert (o.float() - o32).abs().max().item() <= bound
    want = fa.flash_mha_bwd_plain(qf, kf, vf, o32, lse32, do.float(), scale)
    floor = 1e-3 * max(w.abs().max().item() for w in want)
    for x, w, name in zip(got, want, "qkv"):
        assert x.dtype == dtype and x.shape == w.shape, name
        assert torch.isfinite(x).all(), name
        err = _k2_rel(x, w, floor)
        assert err <= K2_BWD_TOL[dtype], (name, err)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_mha_head_width_past_a_cluster(cuda, dtype):
    """Width 1152 (nine 128-column chunks): the wide pairs (bf16 wgmma,
    f32 mma.sync) run clusters of five blocks, four of them owning two
    chunks each (their accumulators in the f32 scratch)."""
    _k2_width_case(cuda, dtype, 1152, 1, 193, 321, 1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("width", [128, 256, 1152])
@pytest.mark.parametrize("tk", [1, 33])
def test_flash_mha_wide_pair_one_key_tile(cuda, dtype, width, tk):
    """The wide pairs where every key lies in one tile (Tk <= 64: D from
    the tile, the one-key rule): one key, where dq and dk are 0 in exact
    arithmetic, and a ragged 33, at one chunk, a cluster of two and past
    a cluster."""
    _k2_width_case(cuda, dtype, width, 1, 70, tk, 2)


def test_flash_mha_f32_wide_pair_reads_strided_views(cuda):
    """The f32 wide pair at width 256 on q, k and v as head-split views of
    one fused (B, T, 3 x 512) projection (row stride 1536 floats) with
    ragged Tq 193 and Tk 321 (q cut to 193 of 321 rows) and dO a
    head-split view of a wider (B, Tq, 2 x 512) tensor: the fused leaf's
    gradient, read back per head, against the f32 twin on contiguous
    copies; no copy of dO, the same bits twice."""
    from xtts_tpu_torch.nn import flash_attn as fa
    b, t, tq, h, w = 1, 321, 193, 2, 256
    qkv = torch.randn(b, t, 3 * h * w, generator=cuda,
                      device="cuda").requires_grad_()
    q, k, v = (x.unflatten(-1, (h, w)) for x in qkv.split(h * w, dim=-1))
    q = q[:, :tq]
    assert not q.is_contiguous() and q.stride(1) == 3 * h * w
    do = torch.randn(b, tq, 2 * h * w, generator=cuda,
                     device="cuda")[..., :h * w].unflatten(-1, (h, w))
    assert not do.is_contiguous()
    for fn in fa.KERNELS:
        fn.launches = 0
    fa.flash_mha_bwd.copies = 0
    fa.flash_mha(q, k, v, w ** -0.5).backward(do)
    torch.cuda.synchronize()
    assert [fn.launches for fn in fa.KERNELS] == [1, 1, 1]
    assert fa.flash_mha_bwd.copies == 0
    grads = qkv.grad.unflatten(-1, (3, h, w))
    assert (grads[:, tq:, 0] == 0).all()
    o, lse = fa._flash_fwd_cuda(q.detach(), k.detach(), v.detach(),
                                w ** -0.5, True)
    again = [fa.flash_mha_bwd(q.detach(), k.detach(), v.detach(), o, lse,
                              do, w ** -0.5) for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(*again))
    qf, kf, vf = (x.detach().contiguous() for x in (q, k, v))
    o32, lse32 = fa.flash_mha_plain_lse(qf, kf, vf, w ** -0.5)
    want = fa.flash_mha_bwd_plain(qf, kf, vf, o32, lse32, do.contiguous(),
                                  w ** -0.5)
    floor = 1e-3 * max(x.abs().max().item() for x in want)
    got = (grads[:, :tq, 0], grads[:, :, 1], grads[:, :, 2])
    for x, y, name in zip(got, want, "qkv"):
        assert torch.isfinite(x).all(), name
        err = _k2_rel(x, y, floor)
        assert err <= K2_BWD_TOL[torch.float32], (name, err)


def _k2_fwd_against_twin(q, k, v, scale):
    """The forward with lse (one launch) against the f32 twin at the
    forward's bounds: output 1e-2 (bf16) or 5e-5 (f32), lse 1e-5; returns
    (o, lse)."""
    from xtts_tpu_torch.nn import flash_attn as fa
    fa.flash_mha.launches = 0
    o, lse = fa._flash_fwd_cuda(q, k, v, scale, True)
    torch.cuda.synchronize()
    assert fa.flash_mha.launches == 1
    assert o.shape == q.shape and torch.isfinite(o).all()
    o32, lse32 = fa.flash_mha_plain_lse(*(t.float() for t in (q, k, v)),
                                        scale)
    torch.testing.assert_close(lse, lse32, rtol=1e-5, atol=1e-5)
    bound = 5e-5 if q.dtype == torch.float32 else 1e-2
    assert (o.float() - o32).abs().max().item() <= bound
    return o, lse


# The wide forwards (bf16 flash_fwd_wgmma_wide, f32 flash_fwd_f32_wide):
# the keys split over a cluster of R ranks, combined once through
# distributed shared memory.
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("width", [128, 256, 384])
@pytest.mark.parametrize("tk", [1, 64, 65, 129])
def test_flash_mha_wide_forward_ranks_without_keys(cuda, width, tk, dtype):
    """Tq 193 over Tk of 1, 64, 65 and 129 (one, one, two and three key
    tiles): the split R comes from the grid, so at one key tile the ranks
    past the first hold none (m = -inf, l = 0 in the combine); the output
    and lse against the twin, finite."""
    from xtts_tpu_torch.nn import flash_attn as fa
    q, k, v = (torch.randn(1, t, 2, width, generator=cuda,
                           device="cuda").to(dtype) for t in (193, tk, tk))
    plan = fa.fwd_plan(1, 193, tk, 2, width, dtype)
    assert 1 <= plan["split"] <= 8 and plan["resident"] >= 1
    if tk <= 64:
        assert plan["split"] > 1, plan
    _k2_fwd_against_twin(q, k, v, width ** -0.5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("width,shape", [(256, (2, 1280, 1562, 2)),
                                         (1152, (1, 193, 321, 1))])
def test_flash_mha_wide_forward_is_deterministic(cuda, width, shape, dtype):
    """The forward's output and lse the same bits twice: the main bucket
    at 256 (ranks combined in rank order) and 1152 (three slices of 384,
    two warpgroups a block, Q streamed beside K)."""
    from xtts_tpu_torch.nn import flash_attn as fa
    b, tq, tk, h = shape
    q, k, v = (torch.randn(b, t, h, width, generator=cuda,
                           device="cuda").to(dtype) for t in (tq, tk, tk))
    o, lse = _k2_fwd_against_twin(q, k, v, width ** -0.5)
    again = fa._flash_fwd_cuda(q, k, v, width ** -0.5, True)
    torch.cuda.synchronize()
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_mha_wide_forward_reads_strided_views(cuda, dtype):
    """The wide forward at width 256 on q, k and v as head-split views of
    one fused (B, T, 3 x 512) projection (row stride 1536), Tq 193 of Tk
    321: against the twin, and the same bits as on contiguous copies."""
    from xtts_tpu_torch.nn import flash_attn as fa
    b, t, tq, h, w = 1, 321, 193, 2, 256
    qkv = torch.randn(b, t, 3 * h * w, generator=cuda,
                      device="cuda").to(dtype)
    q, k, v = (x.unflatten(-1, (h, w)) for x in qkv.split(h * w, dim=-1))
    q = q[:, :tq]
    assert not q.is_contiguous() and q.stride(1) == 3 * h * w
    o, lse = _k2_fwd_against_twin(q, k, v, w ** -0.5)
    oc, lc = fa._flash_fwd_cuda(q.contiguous(), k.contiguous(),
                                v.contiguous(), w ** -0.5, True)
    torch.cuda.synchronize()
    assert torch.equal(o, oc) and torch.equal(lse, lc)


@pytest.mark.parametrize("dh", [100, 256, 1152])
def test_flash_mha_f32_pair_runs_dq_beside_dkv(cuda, dh):
    """flash_mha_bwd_pair runs the f32 wide pair's dq on a second stream
    beside dkv: its (dq, dk, dv) equal flash_mha_bwd_dkv and
    flash_mha_bwd_dq called in turn on one stream, bit for bit, eagerly
    and replayed from a captured CUDA graph; at a width zero-padded to
    128 (the padded operands are read on the second stream), a cluster
    of two and past a cluster (dq's scratch)."""
    from xtts_tpu_torch.nn import flash_attn as fa
    sc = dh ** -0.5
    q, k, v, do = (torch.randn(1, t, 2, dh, generator=cuda, device="cuda")
                   for t in (193, 321, 321, 193))
    o, lse = fa._flash_fwd_cuda(q, k, v, sc, True)
    delta = fa._delta(o, do)
    dk, dv = fa.flash_mha_bwd_dkv(q, k, v, do, lse, delta, sc)
    want = (fa.flash_mha_bwd_dq(q, k, v, do, lse, delta, sc), dk, dv)
    got = fa.flash_mha_bwd_pair(q, k, v, do, lse, delta, sc)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # warm up off the capture
        fa.flash_mha_bwd_pair(q, k, v, do, lse, delta, sc)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        cap = fa.flash_mha_bwd_pair(q, k, v, do, lse, delta, sc)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(cap, want))


@pytest.mark.parametrize("tk", [63, 64, 65, 191, 192, 193])
def test_flash_mha_f32_wraps_the_ring(cuda, tk):
    """f32 at width 64, Tq 130 and Tk of 64n - 1, 64n, 64n + 1: the
    tile kernels' two-stage rings (K / V in the forward and dq, Q / dO and
    their statistics in dkv) wrap with a ragged, whole or one-row last
    tile."""
    from xtts_tpu_torch.nn import flash_attn as fa
    q, k, v, do = _k2_case(cuda, torch.float32, 1, 130, tk, 2)
    o, lse = fa._flash_fwd_cuda(q, k, v, 0.125, True)
    got = fa.flash_mha_bwd(q, k, v, o, lse, do, 0.125)
    o32, lse32 = fa.flash_mha_plain_lse(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert (o - o32).abs().max().item() <= 5e-5
    _k2_bwd_against_twin(q, k, v, do, torch.float32, got)


def test_flash_attn_opt_out_launches_nothing(cuda, monkeypatch):
    """XTTS_FLASH_ATTN=0: a flash=True CrossAttention above the size gate
    launches no K2 kernel and gives the einsum path's bits; without it,
    K2 launches once."""
    from xtts_tpu_torch.models.aa_diffusion import CrossAttention
    from xtts_tpu_torch.nn import flash_attn as fa
    flash = CrossAttention(128, heads=4, dim_head=32, flash=True).cuda()
    plain = CrossAttention(128, heads=4, dim_head=32).cuda()
    plain.load_state_dict(flash.state_dict())
    x = torch.randn(1, 1024, 128, generator=cuda, device="cuda")
    assert fa.use_flash(1024, 1024)
    monkeypatch.setenv("XTTS_FLASH_ATTN", "0")
    fa.flash_mha.launches = 0
    with torch.no_grad():
        off, ref = flash(x), plain(x)
    torch.cuda.synchronize()
    assert fa.flash_mha.launches == 0 and torch.equal(off, ref)
    monkeypatch.delenv("XTTS_FLASH_ATTN")
    with torch.no_grad():
        on = flash(x)
    torch.cuda.synchronize()
    assert fa.flash_mha.launches == 1
    assert (on - ref).abs().max().item() <= 2 * 5e-5 * max(
        1.0, ref.abs().max().item())


def _p9_config(num_heads=2, channels=128):
    """A small configuration whose UNet heads are channels // num_heads
    wide (64 by default) and whose GPT reaches code bucket 320."""
    from xtts_tpu_torch.core.config import (CLIPRefConfig, DVAEConfig,
                                            DiffusionModelConfig, GPTConfig,
                                            MelConfig, VocosConfig,
                                            XTTSConfig)
    mb = 8
    return XTTSConfig(
        mel=MelConfig(n_mels=mb),
        vqvae=DVAEConfig(channels=mb, num_tokens=30, hidden_dim=16,
                         num_resnet_blocks=1, codebook_dim=16, num_layers=2),
        gpt=GPTConfig(layers=2, model_dim=128, heads=2, max_mel_tokens=604,
                      max_text_tokens=64, number_mel_codes=200,
                      start_mel_token=198, stop_mel_token=199, mel_bins=mb,
                      cond_attn_blocks=1),
        diffusion=DiffusionModelConfig(
            in_channels=mb, out_channels=2 * mb, model_channels=channels,
            num_res_blocks=1, channel_mult=(1,), num_heads=num_heads,
            context_dim=32,
            in_latent_channels=128,
            clip=CLIPRefConfig(embed_dim=32, width=32, layers=1,
                               head_width=16, patch_size=4, in_channels=mb,
                               max_patches=128)),
        vocos=VocosConfig(input_channels=mb, dim=32, intermediate_dim=64,
                          num_layers=1, n_fft=64, hop_length=16))


def test_default_f32_tts_renders_bucket_320_through_k2(cuda):
    """P9: TextToSpeech(device="cuda") at its default f32 renders a request
    at code bucket 320 through K2's f32 forward (flash_mha raised
    "takes bf16" there before)."""
    import numpy as np
    from xtts_tpu_torch.infer.api import TextToSpeech, TTSSettings
    from xtts_tpu_torch.nn import flash_attn as fa
    tts = TextToSpeech(_p9_config(), device="cuda")
    assert tts.dtype == torch.float32
    rng = np.random.default_rng(0)
    cond = torch.from_numpy(rng.standard_normal((1, 8, 282)).astype(
        np.float32)).cuda()
    text = rng.integers(3, 200, (1, 20)).astype(np.int32)
    fa.flash_mha.launches = 0
    out = tts.tts_tokens(text, cond, torch.Generator("cuda").manual_seed(1),
                         TTSSettings(max_mel_tokens=300,
                                     speculative_render=True))
    torch.cuda.synchronize()
    assert fa.flash_mha.launches > 0
    assert np.isfinite(out["wav"]).all() and out["wav"].shape[-1] > 0


@pytest.mark.parametrize("num_heads", [4, 1])
def test_f32_tts_renders_bucket_320_at_other_head_widths(cuda, num_heads):
    """P11: a flash=True f32 TextToSpeech whose UNet heads are 32 (4 heads)
    or 128 (1 head) wide renders a request at code bucket 320 through K2
    (it raised "takes (B, T, H, 64)" there before)."""
    import numpy as np
    from xtts_tpu_torch.infer.api import TextToSpeech, TTSSettings
    from xtts_tpu_torch.nn import flash_attn as fa
    tts = TextToSpeech(_p9_config(num_heads), device="cuda")
    assert tts.dtype == torch.float32
    attn = tts.diffusion.base_model.blocks[1][1].transformer_blocks[0].attn1
    assert attn.flash and attn.dim_head == 128 // num_heads
    rng = np.random.default_rng(0)
    cond = torch.from_numpy(rng.standard_normal((1, 8, 282)).astype(
        np.float32)).cuda()
    text = rng.integers(3, 200, (1, 20)).astype(np.int32)
    fa.flash_mha.launches = fa.flash_mha.f32_launches = 0
    fa.flash_mha.pads = 0
    out = tts.tts_tokens(text, cond, torch.Generator("cuda").manual_seed(1),
                         TTSSettings(max_mel_tokens=300,
                                     speculative_render=True))
    torch.cuda.synchronize()
    assert fa.flash_mha.launches > 0
    assert fa.flash_mha.f32_launches == fa.flash_mha.launches
    assert fa.flash_mha.pads == 0
    assert np.isfinite(out["wav"]).all() and out["wav"].shape[-1] > 0


def test_f32_tts_renders_bucket_320_at_head_width_256(cuda):
    """P11's remainder: a flash=True f32 TextToSpeech whose 512-channel UNet
    has 2 heads, 256 wide, renders a request at code bucket 320 through
    K2's wide kernels (it raised ValueError above 128 before); no launch
    pads."""
    import numpy as np
    from xtts_tpu_torch.infer.api import TextToSpeech, TTSSettings
    from xtts_tpu_torch.nn import flash_attn as fa
    tts = TextToSpeech(_p9_config(2, channels=512), device="cuda")
    attn = tts.diffusion.base_model.blocks[1][1].transformer_blocks[0].attn1
    assert attn.flash and attn.dim_head == 256
    rng = np.random.default_rng(0)
    cond = torch.from_numpy(rng.standard_normal((1, 8, 282)).astype(
        np.float32)).cuda()
    text = rng.integers(3, 200, (1, 20)).astype(np.int32)
    fa.flash_mha.launches = fa.flash_mha.f32_launches = 0
    fa.flash_mha.pads = 0
    out = tts.tts_tokens(text, cond, torch.Generator("cuda").manual_seed(1),
                         TTSSettings(max_mel_tokens=300,
                                     speculative_render=True))
    torch.cuda.synchronize()
    assert fa.flash_mha.launches > 0
    assert fa.flash_mha.f32_launches == fa.flash_mha.launches
    assert fa.flash_mha.pads == 0
    assert np.isfinite(out["wav"]).all() and out["wav"].shape[-1] > 0


@pytest.mark.parametrize("remat", ["none", "full"])
def test_flash_unet_training_step_matches_plain(cuda, remat):
    """One f32 training forward and backward of the UNet at 600 | 900
    (consumer attention through the Function: K2's f32 forward and both
    backward kernels; under torch.utils.checkpoint with remat "full")
    against the same weights with flash=False: the gradients within rtol
    1e-3 / atol 1e-4 (the diffusion tolerances of the CPU parity
    tests)."""
    from xtts_tpu_torch.models.aa_diffusion import AADiffusion
    from xtts_tpu_torch.nn import flash_attn as fa
    from xtts_tpu_torch.nn.blocks import init_flax_like
    cfg = _p9_config().diffusion.replace(remat=remat)
    g = torch.Generator("cuda").manual_seed(3)
    plain = AADiffusion(cfg).cuda()
    with torch.no_grad():
        init_flax_like(plain, g)
        for p in plain.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g, device="cuda"))
    flash = AADiffusion(cfg, flash=True).cuda()
    flash.load_state_dict(plain.state_dict())
    x = torch.randn(2, 8, 600, generator=g, device="cuda")
    hint = torch.randn(2, 128, 150, generator=g, device="cuda")
    refer = torch.randn(2, 8, 300, generator=g, device="cuda")
    t = torch.tensor([100, 700], device="cuda")
    patch_rand = torch.randn(2, 300 // 4, generator=g, device="cuda")
    for fn in fa.KERNELS:
        fn.launches = 0
    for m in (plain, flash):
        out = m(x, t, hint, refer, uncond_mask=torch.tensor(
            [False, True], device="cuda"), train=True, patch_rand=patch_rand)
        out.float().pow(2).mean().backward()
    torch.cuda.synchronize()
    assert all(fn.launches > 0 for fn in fa.KERNELS)
    for (n, a), b in zip(flash.named_parameters(), plain.parameters()):
        if b.grad is None:
            assert a.grad is None, n
            continue
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-3, atol=1e-4,
                                   msg=n)


def test_flash_mha_reads_strided_views(cuda):
    """q/k/v as head-split views of wider projections (the model's layout
    after unflatten, and slices of a fused qkv)."""
    from xtts_tpu_torch.nn import flash_attn as fa
    qkv = torch.randn(2, 700, 3 * 512, generator=cuda,
                      device="cuda").bfloat16()
    q, k, v = (t.unflatten(-1, (8, 64)) for t in qkv.split(512, dim=-1))
    assert not q.is_contiguous()
    got = fa.flash_mha(q[:, :600], k, v, 0.125)
    want = fa.flash_mha_plain(q[:, :600].float(), k.float(), v.float(), 0.125)
    torch.cuda.synchronize()
    assert (got.float() - want).abs().max().item() < 1e-2


@pytest.mark.parametrize("tk", [1562, 583, 130, 64, 1])
@pytest.mark.parametrize("tq", [1280, 300, 65, 1])
@pytest.mark.parametrize("b,h", [(1, 8), (2, 8), (1, 16), (2, 16)])
def test_flash_mha_shapes(cuda, b, h, tq, tk):
    """Every (Tq, Tk) edge: whole and ragged 64-query tiles, one key, a
    partial last key tile, and the main path's and chip_smoke's shapes."""
    from xtts_tpu_torch.nn import flash_attn as fa
    q, k, v = (torch.randn(b, t, h, 64, generator=cuda,
                           device="cuda").bfloat16() for t in (tq, tk, tk))
    got = fa.flash_mha(q, k, v, 0.125)
    want = fa.flash_mha_plain(q.float(), k.float(), v.float(), 0.125)
    torch.cuda.synchronize()
    assert got.shape == (b, tq, h, 64) and torch.isfinite(got).all()
    assert (got.float() - want).abs().max().item() < 1e-2


@pytest.mark.parametrize("rising", [True, False])
def test_flash_mha_rescales_across_tiles(cuda, rising):
    """Planted rows whose scores jump from one 64-key tile to the next
    (rising: every tile holds a new row max, so alpha rescales O each tile;
    falling: the first tile holds the max and later tiles add almost
    nothing)."""
    from xtts_tpu_torch.nn import flash_attn as fa
    b, tq, tk, h = 1, 130, 700, 2
    q = torch.randn(b, tq, h, 64, generator=cuda, device="cuda") * 0.3
    k = torch.randn(b, tk, h, 64, generator=cuda, device="cuda") * 0.3
    v = torch.randn(b, tk, h, 64, generator=cuda, device="cuda")
    tile = torch.arange(tk, device="cuda") // 64
    step = tile if rising else tile.max() - tile
    q[:, :3] = 1.0                                   # planted query rows
    k += (1.5 * step.float())[None, :, None, None] / 8.0
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    got = fa.flash_mha(q, k, v, 0.125)
    want = fa.flash_mha_plain(q.float(), k.float(), v.float(), 0.125)
    torch.cuda.synchronize()
    sim = torch.einsum("bihd,bjhd->bhij", q.float(), k.float())[0, 0, 0]
    assert (sim.reshape(-1)[-1] - sim[0]).abs() > 20   # scores really jump
    assert (got.float() - want).abs().max().item() < 1e-2


def test_flash_mha_repeated_calls(cuda):
    """Back-to-back calls (no per-call attribute set or other state) launch
    the same kernel and give the same bits."""
    from xtts_tpu_torch.nn import flash_attn as fa
    q, k, v = (torch.randn(2, t, 8, 64, generator=cuda,
                           device="cuda").bfloat16() for t in (300, 583, 583))
    fa.flash_mha.launches = 0
    outs = [fa.flash_mha(q, k, v, 0.125) for _ in range(4)]
    torch.cuda.synchronize()
    assert fa.flash_mha.launches == 4
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


# ---------------------------------------------------------------------------
# The norm prologue (ln=) of int8_gemv, int4_gemv and int8_gemm_rows: the
# fused call against layer_norm_rows then the unfused product (bit for bit)
# and against the plain twin (1e-2 relative to max(1, |y|)).
# ---------------------------------------------------------------------------

def _norm(g, d, two):
    p = [1 + 0.1 * torch.randn(d, generator=g, device="cuda")
         if i % 2 == 0 else 0.1 * torch.randn(d, generator=g, device="cuda")
         for i in range(4 if two else 2)]
    return tuple(p)


def _fused_vs_unfused(fused, unfused, plain, x32, ln, rows_n, mode, g):
    """Run a product three ways in one output mode; return the outputs."""
    from xtts_tpu_torch.ops import decode_step as ds
    kw = {"f32": dict(), "bf16+gelu": dict(gelu=True,
                                           out_dtype=torch.bfloat16)}.get(
        mode, dict())
    h = ds.layer_norm_rows(x32.reshape(-1, x32.shape[-1]), *ln).reshape(
        x32.shape)
    if mode == "acc":
        base = torch.randn(rows_n, generator=g, device="cuda")
        got, ref, want = base.clone(), base.clone(), base.clone()
        fused(x32, out=got, ln=ln)
        unfused(h, out=ref)
        plain(x32, out=want, ln=ln)
    else:
        got = fused(x32, ln=ln, **kw)
        ref = unfused(h, **kw)
        want = plain(x32, ln=ln, **kw)
    torch.cuda.synchronize()
    return got, ref, want


def _assert_prologue(got, ref, want, exact=False):
    """got == ref (layer_norm_rows + product) bit for bit; got == want (the
    plain twin) bit for bit where `exact` (the gemv, gelu or not), else
    within 1e-2 relative."""
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, ref)
    if exact:
        assert torch.equal(got, want)
    scale_y = max(1.0, want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= 1e-2 * scale_y


@pytest.mark.parametrize("mode", ["f32", "bf16+gelu", "acc"])
@pytest.mark.parametrize("two", [False, True])
@pytest.mark.parametrize("d", [128, 1024])
def test_int8_gemv_norm_prologue(cuda, d, two, mode):
    from xtts_tpu_torch.infer.qdecode import quantize_dense
    from xtts_tpu_torch.ops import decode_step as ds
    n = 3 * d
    q = quantize_dense(torch.randn(d, n, generator=cuda, device="cuda")
                       / math.sqrt(d))
    bias = torch.randn(n, generator=cuda, device="cuda") * 0.1
    x32 = torch.randn(d, generator=cuda, device="cuda") * 3 + 1
    ln = _norm(cuda, d, two)
    ds.reset_launch_counts()
    got, ref, want = _fused_vs_unfused(
        lambda x, **kw: ds.int8_gemv(x, q["w"], q["scale"], bias, **kw),
        lambda x, **kw: ds.int8_gemv(x, q["w"], q["scale"], bias, **kw),
        lambda x, **kw: ds.int8_gemv_plain(x, q["w"], q["scale"], bias, **kw),
        x32, ln, n, mode, cuda)
    assert ds.int8_gemv.ln_launches == 1 and ds.int8_gemv.launches == 2
    _assert_prologue(got, ref, want, exact=True)


@pytest.mark.parametrize("mode", ["f32", "bf16+gelu", "acc"])
@pytest.mark.parametrize("two", [False, True])
@pytest.mark.parametrize("d,groups", [(128, 1), (1024, 1), (1024, 4),
                                      (128, 4)])
def test_int4_gemv_norm_prologue(cuda, d, groups, two, mode):
    from xtts_tpu_torch.ops import decode_step as ds
    n = 3 * d
    _, w, scale, bias = _int4_operands(cuda, d, n, groups)
    x32 = torch.randn(d, generator=cuda, device="cuda") * 3 + 1
    ln = _norm(cuda, d, two)
    ds.reset_launch_counts()
    got, ref, want = _fused_vs_unfused(
        lambda x, **kw: ds.int4_gemv(x, w, scale, bias, **kw),
        lambda x, **kw: ds.int4_gemv(x, w, scale, bias, **kw),
        lambda x, **kw: ds.int4_gemv_plain(x, w, scale, bias, **kw),
        x32, ln, n, mode, cuda)
    assert ds.int4_gemv.ln_launches == 1 and ds.int4_gemv.launches == 2
    _assert_prologue(got, ref, want, exact=True)


@pytest.mark.parametrize("mode", ["f32", "bf16+gelu", "acc"])
@pytest.mark.parametrize("two", [False, True])
@pytest.mark.parametrize("rows,d", [(1, 1024), (8, 1024), (16, 1024),
                                    (32, 1024), (16, 128), (3, 128)])
def test_int8_gemm_rows_norm_prologue(cuda, rows, d, two, mode):
    from xtts_tpu_torch.infer.qdecode import quantize_dense
    from xtts_tpu_torch.ops import serving_step as ss
    n = 4 * d
    q = quantize_dense(torch.randn(d, n, generator=cuda, device="cuda")
                       / math.sqrt(d))
    bias = torch.randn(n, generator=cuda, device="cuda") * 0.1
    x32 = torch.randn(rows, d, generator=cuda, device="cuda") * 3 + 1
    ln = _norm(cuda, d, two)
    ss.reset_launch_counts()
    got, ref, want = _fused_vs_unfused(
        lambda x, **kw: ss.int8_gemm_rows(x, q["w"], q["scale"], bias, **kw),
        lambda x, **kw: ss.int8_gemm_rows(x, q["w"], q["scale"], bias, **kw),
        lambda x, **kw: ss.int8_gemm_rows_plain(x, q["w"], q["scale"], bias,
                                                **kw),
        x32, ln, (rows, n), mode, cuda)
    assert ss.int8_gemm_rows.ln_launches == 1
    assert ss.int8_gemm_rows.launches == 2
    _assert_prologue(got, ref, want)


@pytest.mark.parametrize("rows", [16, 32])
def test_int8_gemm_rows_head_prologue_is_the_pair(cuda, rows):
    """The head + ln_f + final_norm shape (1024 -> 9216, split over K in
    two) equals layer_norm_rows then the unfused product bit for bit."""
    from xtts_tpu_torch.infer.qdecode import quantize_dense
    from xtts_tpu_torch.ops import serving_step as ss
    d, n = 1024, 9216
    q = quantize_dense(torch.randn(d, n, generator=cuda, device="cuda")
                       / math.sqrt(d))
    bias = torch.randn(n, generator=cuda, device="cuda") * 0.1
    x32 = torch.randn(rows, d, generator=cuda, device="cuda") * 3 + 1
    ln = _norm(cuda, d, True)
    got, ref, want = _fused_vs_unfused(
        lambda x, **kw: ss.int8_gemm_rows(x, q["w"], q["scale"], bias, **kw),
        lambda x, **kw: ss.int8_gemm_rows(x, q["w"], q["scale"], bias, **kw),
        lambda x, **kw: ss.int8_gemm_rows_plain(x, q["w"], q["scale"], bias,
                                                **kw),
        x32, ln, (rows, n), "f32", cuda)
    _assert_prologue(got, ref, want)


def test_int8_gemm_rows_staging_paths(cuda):
    """The input reaches shared memory two ways: by cp.async (a bf16 input,
    K % 8 == 0, 16-byte aligned, a chunk of one slab) or by the block's
    threads a slab at a time: here a misaligned bf16 input, and the norm
    prologue over K = 1024 (one slab) and 2048 (two). Each against the
    plain twin (and the pair)."""
    from xtts_tpu_torch.infer.qdecode import quantize_dense
    from xtts_tpu_torch.ops import serving_step as ss
    rows, n = 16, 512
    for k in (1024, 2048):
        q = quantize_dense(torch.randn(k, n, generator=cuda, device="cuda")
                           / math.sqrt(k))
        bias = torch.randn(n, generator=cuda, device="cuda") * 0.1
        buf = torch.randn(rows * k + 4, generator=cuda,
                          device="cuda").bfloat16()
        x = buf[4:].view(rows, k)                  # 8 bytes off 16
        assert x.data_ptr() % 16 == 8
        got = ss.int8_gemm_rows(x, q["w"], q["scale"], bias)
        want = ss.int8_gemm_rows_plain(x, q["w"], q["scale"], bias)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2)
        x32 = torch.randn(rows, k, generator=cuda, device="cuda") * 3 + 1
        got, ref, want = _fused_vs_unfused(
            lambda x, **kw: ss.int8_gemm_rows(x, q["w"], q["scale"], bias,
                                              **kw),
            lambda x, **kw: ss.int8_gemm_rows(x, q["w"], q["scale"], bias,
                                              **kw),
            lambda x, **kw: ss.int8_gemm_rows_plain(x, q["w"], q["scale"],
                                                    bias, **kw),
            x32, _norm(cuda, k, True), (rows, n), "f32", cuda)
        _assert_prologue(got, ref, want)


def test_split_kernels_repeat_bit_for_bit(cuda):
    """The split kernels merge in fixed order: ten calls on the same inputs
    give the same bits (decode_attention at S 360 and 16384;
    int8_gemm_rows split 2, 4 and 8 ways, with and without the prologue;
    int4_gemv at fc, out (four groups), head and K split 16 ways, with and
    without the prologue; int8_gemv at fc + ln_2, out (K split 4 ways)
    and K split 16 ways; serving_attention at index 353 and 2047 of 2048;
    vq_nearest at the DVAE's shape)."""
    from xtts_tpu_torch.infer.qdecode import quantize_dense
    from xtts_tpu_torch.ops import decode_step as ds
    from xtts_tpu_torch.ops import serving_step as ss
    d = 1024
    for s_max, idx in ((360, 300), (16384, 16383)):
        qkv = torch.randn(3 * d, generator=cuda, device="cuda")
        kc = (torch.randn(s_max, d, generator=cuda, device="cuda")
              * 0.5).bfloat16()
        vc = (torch.randn(s_max, d, generator=cuda, device="cuda")
              * 0.5).bfloat16()
        first = ds.decode_attention(qkv, kc, vc, idx, 16)
        for _ in range(9):
            assert torch.equal(ds.decode_attention(qkv, kc, vc, idx, 16),
                               first)
    ln = _norm(cuda, d, True)
    for k, n, rows in ((1024, 4096, 16), (1024, 3072, 32), (4096, 1024, 17)):
        q = quantize_dense(torch.randn(k, n, generator=cuda, device="cuda")
                           / math.sqrt(k))
        bias = torch.randn(n, generator=cuda, device="cuda") * 0.1
        x = torch.randn(rows, k, generator=cuda, device="cuda")
        calls = [lambda: ss.int8_gemm_rows(x.bfloat16(), q["w"], q["scale"],
                                           bias, gelu=True,
                                           out_dtype=torch.bfloat16)]
        if k == d:
            calls.append(lambda: ss.int8_gemm_rows(x, q["w"], q["scale"],
                                                   bias, ln=ln))
        for call in calls:
            first = call()
            for _ in range(9):
                assert torch.equal(call(), first)
    # int4_gemv (split over K, partials merged by the last block of a
    # tile in split order) with and without the prologue, and vq_nearest
    from xtts_tpu_torch.ops import vq
    for k, n, groups in ((1024, 4096, 1), (4096, 1024, 4), (1024, 9216, 1),
                         (4096, 32, 1)):
        x, w, scale, bias = _int4_operands(cuda, k, n, groups)
        calls = [lambda: ds.int4_gemv(x, w, scale, bias)]
        if k == d and groups == 1:
            x32 = torch.randn(k, generator=cuda, device="cuda")
            calls.append(lambda: ds.int4_gemv(x32, w, scale, bias, ln=ln,
                                              gelu=True,
                                              out_dtype=torch.bfloat16))
        for call in calls:
            first = call()
            for _ in range(9):
                assert torch.equal(call(), first)
    from xtts_tpu_torch.infer.qdecode import quantize_dense as qd
    for k, n in ((1024, 4096), (4096, 1024), (4096, 32)):
        q8 = qd(torch.randn(k, n, generator=cuda, device="cuda")
                / math.sqrt(k))
        bias = torch.randn(n, generator=cuda, device="cuda") * 0.1
        x = torch.randn(k, generator=cuda, device="cuda")
        calls = [lambda: ds.int8_gemv(x.bfloat16(), q8["w"], q8["scale"],
                                      bias)]
        if k == d:
            calls.append(lambda: ds.int8_gemv(x, q8["w"], q8["scale"], bias,
                                              ln=ln[:2], gelu=True,
                                              out_dtype=torch.bfloat16))
        for call in calls:
            first = call()
            for _ in range(9):
                assert torch.equal(call(), first)
    for s_max, idx in ((354, 353), (2048, 2047)):
        kc, vc, ks, vs = (t[0].contiguous() for t in _serving_cache(
            cuda, 1, 16, s_max, d, idx))
        qkv = torch.randn(16, 3 * d, generator=cuda, device="cuda")
        first = ss.serving_attention(qkv, kc, vc, ks, vs, idx, 16)
        for _ in range(9):
            assert torch.equal(ss.serving_attention(qkv, kc, vc, ks, vs,
                                                    idx, 16), first)
    xv = torch.randn(3008, 512, generator=cuda, device="cuda")
    emb = torch.randn(512, 8192, generator=cuda, device="cuda")
    first = vq.vq_nearest(xv, emb)
    for _ in range(9):
        assert torch.equal(vq.vq_nearest(xv, emb), first)
    torch.cuda.synchronize()


def test_decode_attention_takes_every_index_of_the_cache(cuda):
    """No index-sized buffer: 0 <= index < S is the only limit."""
    from xtts_tpu_torch.ops import decode_step as ds
    d, s_max = 128, 20000
    qkv = torch.randn(3 * d, generator=cuda, device="cuda")
    kc = torch.zeros(s_max, d, dtype=torch.bfloat16, device="cuda")
    vc = torch.zeros_like(kc)
    ds.decode_attention(qkv, kc, vc, s_max - 1, 2)
    torch.cuda.synchronize()
    for bad in (-1, s_max):
        with pytest.raises(ValueError):
            ds.decode_attention(qkv, kc, vc, bad, 2)


@pytest.mark.parametrize("s_max,idx", [(360, 0), (360, 5), (360, 60),
                                       (360, 299), (16384, 16383)])
def test_decode_attention_is_its_twin_bit_for_bit(cuda, s_max, idx):
    """Kernel and plain twin (split_attention) run the same explicitly
    rounded f32 operations in the same order: on the card they give the
    same bits, and write the same new cache row."""
    from xtts_tpu_torch.ops import decode_step as ds
    d = 1024
    qkv = torch.randn(3 * d, generator=cuda, device="cuda")
    kc = (torch.randn(s_max, d, generator=cuda, device="cuda")
          * 0.5).bfloat16()
    vc = (torch.randn(s_max, d, generator=cuda, device="cuda")
          * 0.5).bfloat16()
    kc2, vc2 = kc.clone(), vc.clone()
    got = ds.decode_attention(qkv, kc, vc, idx, 16)
    want = ds.decode_attention_plain(qkv, kc2, vc2, idx, 16)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(kc, kc2) and torch.equal(vc, vc2)


def test_split_bounds_are_the_kernels(cuda):
    """The Python copies of the kernels' chunk bounds (attention_bounds,
    gemm_rows_plan, int4_gemv_plan) equal what csrc computes (att_lo,
    gr_lo, gv_splits / gv_lo), int4_gemv's at every K1-int4 shape and over
    a sweep of K, N and group counts."""
    from xtts_tpu_torch.ops import decode_step as ds
    from xtts_tpu_torch.ops import serving_step as ss
    for index in range(1000):
        assert (ds.kernel_attention_bounds(index)
                == ds.attention_bounds(index, 1000).tolist()), index
    for k in list(range(16, 4200, 37)) + [100, 1024, 4096]:
        for n in (32, 512, 1024, 3072, 4096, 9216):
            splits, bounds = ss.gemm_rows_plan(k, n)
            assert ss.kernel_gemm_rows_bounds(k, splits) == bounds, (k, n)
    cases = [(1024, 3072, 1), (1024, 1024, 1), (1024, 4096, 1),
             (4096, 1024, 4), (1024, 9216, 1)]
    cases += [(k * g, n, g) for k in list(range(16, 3000, 53)) + [100, 8192]
              for n in (32, 96, 512, 1024, 4096, 9216) for g in (1, 3, 4)]
    for k, n, g in cases:
        assert ds.kernel_int4_gemv_plan(k, n, g) == ds.int4_gemv_plan(
            k, n, g), (k, n, g)


def test_decode_attention_refuses_a_misaligned_cache(cuda):
    """The kernel reads cache rows 16 bytes a lane: a view that starts off
    a 16-byte boundary is refused before launch, not faulted on."""
    from xtts_tpu_torch.ops import decode_step as ds
    d, s_max = 128, 40
    qkv = torch.randn(3 * d, generator=cuda, device="cuda")
    flat = torch.zeros(s_max * d + 8, dtype=torch.bfloat16, device="cuda")
    bad = flat[3:3 + s_max * d].view(s_max, d)
    good = torch.zeros(s_max, d, dtype=torch.bfloat16, device="cuda")
    assert bad.data_ptr() % 16 == 6
    launches = ds.decode_attention.launches
    for kc, vc in ((bad, good), (good, bad)):
        with pytest.raises(ValueError):
            ds.decode_attention(qkv, kc, vc, 7, 2)
    assert ds.decode_attention.launches == launches
    ds.decode_attention(qkv, good, good.clone(), 7, 2)
    torch.cuda.synchronize()


def test_norm_prologue_refuses_bad_operands(cuda):
    from xtts_tpu_torch.ops import decode_step as ds
    from xtts_tpu_torch.ops import serving_step as ss
    d, n = 128, 256
    w = torch.zeros(d, n, dtype=torch.int8, device="cuda")
    w4 = torch.zeros(d, n // 2, dtype=torch.int8, device="cuda")
    sc, b = torch.ones(n, device="cuda"), torch.zeros(n, device="cuda")
    ln = (torch.ones(d, device="cuda"), torch.zeros(d, device="cuda"))
    x32 = torch.randn(d, device="cuda")
    bad = [dict(x=x32.bfloat16(), ln=ln),                  # bf16 residual
           dict(x=x32, ln=(ln[0][:-1], ln[1])),            # wrong norm shape
           dict(x=x32, ln=ln + ln[:1]),                    # three tensors
           dict(x=x32, ln=(ln[0].double(), ln[1]))]        # f64 scale
    for case in bad:
        with pytest.raises(ValueError):
            ds.int8_gemv(case["x"], w, sc, b, ln=case["ln"])
        with pytest.raises(ValueError):
            ds.int4_gemv(case["x"], w4, sc[None], b, ln=case["ln"])
        with pytest.raises(ValueError):
            ss.int8_gemm_rows(case["x"][None], w, sc, b, ln=case["ln"])
    res = torch.randn(2, d, device="cuda")
    with pytest.raises(ValueError):                        # out = residual
        ss.int8_gemm_rows(res, torch.zeros(d, d, dtype=torch.int8,
                                           device="cuda"),
                          torch.ones(d, device="cuda"),
                          torch.zeros(d, device="cuda"), out=res, ln=ln)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from xtts_tpu_torch.nn import flash_attn as fa
    from xtts_tpu_torch.ops import decode_step as ds
    q = torch.randn(1, 64, 2, 160, device="cuda").bfloat16()
    with pytest.raises(ValueError, match="up to 128"):
        fa.flash_mha(q, q, q, 0.1)                     # head dim above 128
    q64 = torch.randn(1, 64, 2, 64, device="cuda").half()
    with pytest.raises(ValueError):                    # f16
        fa.flash_mha(q64, q64, q64, 0.1)
    w = torch.zeros(64, 48, dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError):                    # N not a multiple of 32
        ds.int8_gemv(torch.zeros(64, device="cuda").bfloat16(), w,
                     torch.ones(48, device="cuda"), torch.zeros(48,
                                                                device="cuda"))
    x = torch.zeros(64, device="cuda").bfloat16()
    with pytest.raises(ValueError):                    # N not a multiple of 32
        ds.int4_gemv(x, torch.zeros(64, 24, dtype=torch.int8, device="cuda"),
                     torch.ones(1, 48, device="cuda"),
                     torch.zeros(48, device="cuda"))
    with pytest.raises(ValueError):                    # K not split in groups
        ds.int4_gemv(x, torch.zeros(64, 32, dtype=torch.int8, device="cuda"),
                     torch.ones(3, 64, device="cuda"),
                     torch.zeros(64, device="cuda"))


# ---------------------------------------------------------------------------
# K3: VQ nearest code. Codes must equal the plain twin's, except where the
# two picks' distances, recomputed in f64, lie within the fp32 error bound
# of one D-term dot product (4 D 2^-24 (2 sum|x||e| + |e|^2)): the two sum
# in another order (the kernel's products in 3xTF32 on the tensor cores),
# so an exact-looking tie may break either way.
# ---------------------------------------------------------------------------

def _vq_agree(x, e, got, want):
    x64, e64 = x.double(), e.double()
    bad = (got != want).nonzero().flatten()
    for r in bad.tolist():
        picks = torch.tensor([int(got[r]), int(want[r])], device=x.device)
        ep = e64[:, picks]
        dist = (ep * ep).sum(0) - 2 * x64[r] @ ep
        bound = 4 * x.shape[1] * 2.0 ** -24 * (
            2 * (x64[r].abs()[:, None] * ep.abs()).sum(0) + (ep * ep).sum(0))
        assert (dist[0] - dist[1]).abs() <= bound.max(), (r, dist, bound)
    return len(bad)


@pytest.mark.parametrize("n,d,e", [(3008, 512, 8192), (1001, 512, 8000),
                                   (37, 16, 50), (64, 24, 1025),
                                   (130, 512, 2048), (300, 30, 700)])
def test_vq_nearest(cuda, n, d, e):
    from xtts_tpu_torch.ops import vq
    x = torch.randn(n, d, generator=cuda, device="cuda")
    emb = torch.randn(d, e, generator=cuda, device="cuda")
    vq.vq_nearest.launches = 0
    got = vq.vq_nearest(x, emb)
    want = vq.vq_nearest_plain(x, emb)
    torch.cuda.synchronize()
    assert vq.vq_nearest.launches == 1 and got.dtype == torch.int64
    assert _vq_agree(x, emb, got, want) <= max(1, n // 1000)


def test_vq_nearest_first_index_on_ties(cuda):
    from xtts_tpu_torch.ops import vq
    emb = torch.zeros(8, 3000, device="cuda")
    emb[:, [5, 1500, 2999]] = 1.0                 # one code, three ranges
    x = torch.ones(70, 8, device="cuda")
    assert (vq.vq_nearest(x, emb) == 5).all()


@pytest.mark.parametrize("n", [400, 2400])
def test_vq_nearest_at_the_trainers_rows(cuda, n):
    """K3 at the vqvae trainer's rows (8 x 200-frame crops / 4) and the gpt
    trainer's frozen DVAE (8 x 1200 frames / 4), on a codebook whose first
    N codes lie near the rows, as EMA updates leave it."""
    from xtts_tpu_torch.ops import vq
    x = torch.randn(n, 512, generator=cuda, device="cuda")
    emb = torch.randn(512, 8192, generator=cuda, device="cuda")
    emb[:, :n] = 0.5 * emb[:, :n] + 0.5 * x.t()
    got, want = vq.vq_nearest(x, emb), vq.vq_nearest_plain(x, emb)
    assert _vq_agree(x, emb, got, want) <= max(1, n // 1000)


def _small_dvae(seed):
    from xtts_tpu_torch.core.config import DVAEConfig
    from xtts_tpu_torch.models.dvae import DVAE
    from xtts_tpu_torch.nn.blocks import init_flax_like
    g = torch.Generator().manual_seed(seed)
    m = DVAE(DVAEConfig(channels=8, num_tokens=64, hidden_dim=16,
                        num_resnet_blocks=1, codebook_dim=16, num_layers=2))
    init_flax_like(m, g)
    with torch.no_grad():
        for p in m.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    return m


def test_dvae_trainer_step_card_against_cpu(cuda):
    """One f32 vqvae Trainer step on the card (K3 once) against the CPU
    (the plain twin): loss within 1e-4 relative, the EMA codebook within
    1e-5, the straight-through gradients within rtol 1e-4 / atol 1e-6."""
    import copy
    from xtts_tpu_torch.core.config import TrainConfig
    from xtts_tpu_torch.ops import vq
    from xtts_tpu_torch.train.steps import make_dvae_loss
    from xtts_tpu_torch.train.trainer import Trainer
    base = _small_dvae(1)
    mel = torch.randn(4, 8, 64, generator=torch.Generator().manual_seed(2))
    cfg = TrainConfig(lr=1e-3, lr_schedule="constant", dtype="float32")
    out = {}
    for dev in ("cpu", "cuda"):
        m = copy.deepcopy(base).to(dev)
        loss_fn = make_dvae_loss(m)
        loss_fn({"mel": mel.to(dev)})[0].backward()
        grads = {n: p.grad.cpu() for n, p in m.named_parameters()}
        m.zero_grad(set_to_none=True)
        tr = Trainer(m, loss_fn, cfg, accum_steps=1)
        st = tr.init_state()
        vq.vq_nearest.launches = 0
        st, metrics = tr.step(st, {"mel": mel.to(dev)})
        out[dev] = (float(metrics["loss"]), grads, vq.vq_nearest.launches,
                    {k: v.cpu() for k, v in st.state_cols.items()})
    (lc, gc, kc, cc), (lk, gk, kk, ck) = out["cpu"], out["cuda"]
    assert kc == 0 and kk == 1
    assert abs(lk - lc) <= 1e-4 * abs(lc)
    for n in gc:
        torch.testing.assert_close(gk[n], gc[n], rtol=1e-4, atol=1e-6)
    for n in cc:
        torch.testing.assert_close(ck[n], cc[n], rtol=1e-5, atol=1e-5)


def test_checkpoint_restore_on_the_card_is_bit_exact(cuda, tmp_path):
    """A Trainer's state saved from the card and restored into a fresh
    model on the card equals the saved one bit for bit."""
    from xtts_tpu_torch.core.config import TrainConfig
    from xtts_tpu_torch.train.steps import make_dvae_loss
    from xtts_tpu_torch.train.trainer import Trainer
    cfg = TrainConfig(lr=1e-3, lr_schedule="constant", dtype="float32")
    mel = torch.randn(4, 8, 64, generator=cuda, device="cuda")
    m = _small_dvae(3).cuda()
    tr = Trainer(m, make_dvae_loss(m), cfg, accum_steps=1,
                 checkpoint_dir=str(tmp_path))
    st = tr.init_state()
    for _ in range(2):
        st, _ = tr.step(st, {"mel": mel})
    tr.save(st, wait=True)
    m2 = _small_dvae(4).cuda()
    tr2 = Trainer(m2, make_dvae_loss(m2), cfg, accum_steps=1,
                  checkpoint_dir=str(tmp_path))
    st2 = tr2.restore(tr2.init_state())
    assert st2.step == st.step == 2 and st2.opt_state.count == 2
    for a, b in ((st.params, st2.params), (st.state_cols, st2.state_cols),
                 (st.opt_state.mu, st2.opt_state.mu),
                 (st.opt_state.nu, st2.opt_state.nu)):
        for k in a:
            assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# K4: the B-row int8-KV serving step (tolerances as for K1)
# ---------------------------------------------------------------------------

def _serving_cache(g, layers, rows, s_max, d, p_len):
    from xtts_tpu_torch.nn.transformer import KVCache
    from xtts_tpu_torch.ops import serving_step as ss
    shape = (layers, rows, s_max, d // 64, 64)
    k = torch.zeros(shape, device="cuda")
    v = torch.zeros(shape, device="cuda")
    k[:, :, :p_len] = torch.randn(layers, rows, p_len, d // 64, 64,
                                  generator=g, device="cuda") * 0.5
    v[:, :, :p_len] = torch.randn(layers, rows, p_len, d // 64, 64,
                                  generator=g, device="cuda") * 0.5
    return ss.quantize_kv_rowwise(KVCache(k.bfloat16(), v.bfloat16()))


@pytest.mark.parametrize("rows,k,n,gelu,mode", [
    (16, 1024, 3072, False, "f32"), (16, 1024, 1024, False, "acc"),
    (16, 1024, 4096, True, "bf16"), (16, 4096, 1024, False, "acc"),
    (16, 1024, 9216, False, "f32"), (8, 1024, 3072, False, "f32"),
    (32, 1024, 1024, True, "bf16"), (3, 100, 64, False, "acc"),
    (1, 128, 32, True, "f32"), (1, 4096, 1024, False, "acc"),
    (17, 1024, 3072, False, "f32"), (31, 4096, 32, True, "bf16"),
    (32, 4096, 1024, False, "acc"), (17, 100, 32, False, "f32"),
    (1, 100, 96, True, "bf16"), (31, 1024, 9216, False, "f32")])
def test_int8_gemm_rows(cuda, rows, k, n, gelu, mode):
    from xtts_tpu_torch.infer.qdecode import quantize_dense
    from xtts_tpu_torch.ops import serving_step as ss
    q = quantize_dense(torch.randn(k, n, generator=cuda, device="cuda")
                       / math.sqrt(k))
    x = torch.randn(rows, k, generator=cuda, device="cuda").bfloat16()
    bias = torch.randn(n, generator=cuda, device="cuda") * 0.1
    if mode == "acc":
        base = torch.randn(rows, n, generator=cuda, device="cuda")
        got, want = base.clone(), base.clone()
        ss.int8_gemm_rows(x, q["w"], q["scale"], bias, out=got, gelu=gelu)
        ss.int8_gemm_rows_plain(x, q["w"], q["scale"], bias, out=want,
                                gelu=gelu)
    else:
        dt = torch.bfloat16 if mode == "bf16" else torch.float32
        got = ss.int8_gemm_rows(x, q["w"], q["scale"], bias, gelu=gelu,
                                out_dtype=dt)
        want = ss.int8_gemm_rows_plain(x, q["w"], q["scale"], bias,
                                       gelu=gelu, out_dtype=dt)
        assert got.dtype == dt
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                               atol=1e-2)


@pytest.mark.parametrize("rows,heads,s_max,idx", [
    (16, 16, 360, 354), (16, 16, 360, 0), (8, 16, 360, 200),
    (32, 16, 200, 150), (3, 2, 40, 17), (16, 16, 354, 1),
    (16, 16, 354, 353), (16, 16, 354, 127), (16, 16, 354, 128),
    (16, 16, 354, 129), (8, 16, 2048, 2047), (2, 4, 20000, 19999)])
def test_serving_attention(cuda, rows, heads, s_max, idx):
    """The kernel and its plain twin run the same explicitly rounded f32
    operations in the same order (chunks of 128 positions, a ring of 4
    chunk slots past 512): the same bits out and in the new cache rows and
    scales, at idx 0, 1, the chunk edges, S - 1 of the serving path's 354
    and of longer caches (any index < S)."""
    from xtts_tpu_torch.ops import serving_step as ss
    d = heads * 64
    kc, vc, ks, vs = (t[0].contiguous() for t in _serving_cache(
        cuda, 1, rows, s_max, d, idx))
    qkv = torch.randn(rows, 3 * d, generator=cuda, device="cuda")
    k2, v2, ks2, vs2 = kc.clone(), vc.clone(), ks.clone(), vs.clone()
    ss.serving_attention.launches = 0
    got = ss.serving_attention(qkv, kc, vc, ks, vs, idx, heads)
    want = ss.serving_attention_plain(qkv, k2, v2, ks2, vs2, idx, heads)
    torch.cuda.synchronize()
    assert ss.serving_attention.launches == 1
    assert torch.equal(got, want)
    for a, b in ((kc, k2), (vc, v2), (ks, ks2), (vs, vs2)):
        assert torch.equal(a, b)


def test_serving_attention_refuses_what_it_does_not_take(cuda):
    """index outside [0, S) and a cache that starts off a 16-byte boundary
    are refused before launch."""
    from xtts_tpu_torch.ops import serving_step as ss
    d, s_max = 128, 40
    qkv = torch.randn(2, 3 * d, device="cuda")
    kc = torch.zeros(2, s_max, d, dtype=torch.int8, device="cuda")
    ks = torch.ones(2, s_max, device="cuda")
    flat = torch.zeros(2 * s_max * d + 16, dtype=torch.int8, device="cuda")
    bad = flat[3:3 + 2 * s_max * d].view(2, s_max, d)
    launches = ss.serving_attention.launches
    for idx in (-1, s_max):
        with pytest.raises(ValueError):
            ss.serving_attention(qkv, kc, kc.clone(), ks, ks.clone(), idx, 2)
    with pytest.raises(ValueError):
        ss.serving_attention(qkv, bad, kc, ks, ks.clone(), 5, 2)
    assert ss.serving_attention.launches == launches
    ss.serving_attention(qkv, kc, kc.clone(), ks, ks.clone(), s_max - 1, 2)
    torch.cuda.synchronize()


@pytest.mark.parametrize("layers,d,heads,vocab,rows", [
    (2, 128, 2, 200, 8), (15, 1024, 16, 8194, 16)])
def test_serving_step_chain(cuda, layers, d, heads, vocab, rows):
    """16 teacher-forced steps: K4 chain vs the plain step."""
    from xtts_tpu_torch.ops import decode_step as ds
    from xtts_tpu_torch.ops import serving_step as ss
    s_max, p_len = 96, 54
    qt = _qtree(cuda, layers, d, vocab, s_max)
    st = ds.stack_qtree(qt, vocab)
    c1 = _serving_cache(cuda, layers, rows, s_max, d, p_len)
    c2 = [t.clone() for t in c1]
    ss.reset_launch_counts()
    ds.reset_launch_counts()
    agree = 0
    for step in range(16):
        tok = (torch.arange(rows, device="cuda") * 37 + step) % vocab
        x = qt["mel_embedding"][tok] + qt["mel_pos_embedding"][step][None]
        got = ss.fused_serving_logits(st, x, *c1, p_len + step, layers,
                                      heads)[0][:, :vocab]
        want = ss.fused_serving_logits_plain(st, x, *c2, p_len + step,
                                             layers, heads)[0][:, :vocab]
        scale = max(1.0, want.abs().max().item())
        assert (got - want).abs().max().item() <= 2e-2 * scale, step
        agree += int((got.argmax(-1) == want.argmax(-1)).sum())
    torch.cuda.synchronize()
    assert agree >= 16 * rows - 2, f"{16 * rows - agree} picks differ"
    assert ss.fused_serving_logits.launches == 16
    assert ss.int8_gemm_rows.launches == 16 * (4 * layers + 1)
    assert ss.int8_gemm_rows.ln_launches == 16 * (2 * layers + 1)
    assert ss.serving_attention.launches == 16 * layers
    assert ds.layer_norm_rows.launches == 0


@pytest.mark.parametrize("rows,gelu", [(1, True), (16, True), (32, True),
                                       (16, False)])
def test_int8_gemm_rows_with_exact_sums_is_its_twin(cuda, rows, gelu):
    """With small integer inputs every product and partial sum is exact in
    f32, so the tensor cores' order cannot show: the kernel's epilogue
    (product, sum, gelu_new, each rounded on its own) equals the twin's bit
    for bit, gelu or not, stored in bf16 or added into f32."""
    from xtts_tpu_torch.infer.qdecode import quantize_dense
    from xtts_tpu_torch.ops import serving_step as ss
    k, n = 1024, 4096
    q = quantize_dense(torch.randn(k, n, generator=cuda, device="cuda"))
    x = torch.randint(-4, 5, (rows, k), generator=cuda,
                      device="cuda").bfloat16()
    bias = torch.randn(n, generator=cuda, device="cuda") * 0.1
    scale = q["scale"] * 0.01
    got = ss.int8_gemm_rows(x, q["w"], scale, bias, gelu=gelu,
                            out_dtype=torch.bfloat16)
    want = ss.int8_gemm_rows_plain(x, q["w"], scale, bias, gelu=gelu,
                                   out_dtype=torch.bfloat16)
    base = torch.randn(rows, n, generator=cuda, device="cuda")
    acc, acc_p = base.clone(), base.clone()
    ss.int8_gemm_rows(x, q["w"], scale, bias, out=acc, gelu=gelu)
    ss.int8_gemm_rows_plain(x, q["w"], scale, bias, out=acc_p, gelu=gelu)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(acc, acc_p)


@pytest.mark.parametrize("idx", [0, 1, 353, 359])
@pytest.mark.parametrize("kernel", ["decode_attention", "serving_attention"])
def test_attention_reads_the_index_from_device_memory(cuda, kernel, idx):
    """A 0-d int64 index on the card gives the int-index launch's output
    and cache rows bit for bit, and the twin's with either index."""
    from xtts_tpu_torch.ops import decode_step as ds
    from xtts_tpu_torch.ops import serving_step as ss
    d, heads, s_max = 1024, 16, 360
    if kernel == "decode_attention":
        qkv = torch.randn(3 * d, generator=cuda, device="cuda")
        k = (torch.randn(s_max, d, generator=cuda, device="cuda")
             * 0.5).bfloat16()
        cache = (k, k.roll(1, 0))
        fn, twin = ds.decode_attention, ds.decode_attention_plain
    else:
        qkv = torch.randn(16, 3 * d, generator=cuda, device="cuda")
        k = torch.randn(16, s_max, d, generator=cuda, device="cuda") * 0.5
        kq, ks = ss.quantize_rows(k)
        vq, vs = ss.quantize_rows(k.roll(1, 1))
        cache = (kq, vq, ks, vs)
        fn, twin = ss.serving_attention, ss.serving_attention_plain
    copies = [[t.clone() for t in cache] for _ in range(3)]
    at = torch.tensor(idx, dtype=torch.long, device="cuda")
    by_int = fn(qkv, *copies[0], idx, heads)
    by_dev = fn(qkv, *copies[1], at, heads)
    plain = twin(qkv, *copies[2], at, heads)
    torch.cuda.synchronize()
    assert torch.equal(by_int, by_dev) and torch.equal(by_dev, plain)
    for a, b, c in zip(*copies):
        assert torch.equal(a, b) and torch.equal(b, c)


def _loop_model(g, engine):
    """A 2 x 128 GPT with random weights on the card, its int8 tree and the
    K1 stack of `engine` (the int4 one for k1_int4)."""
    from xtts_tpu_torch.core.config import GPTConfig
    from xtts_tpu_torch.infer import qdecode as tq
    from xtts_tpu_torch.models.gpt import UnifiedVoice
    from xtts_tpu_torch.nn.blocks import init_flax_like
    from xtts_tpu_torch.ops import decode_step as ds
    cfg = GPTConfig(layers=2, model_dim=128, heads=2, max_mel_tokens=200,
                    max_text_tokens=32, number_mel_codes=200,
                    start_mel_token=198, stop_mel_token=199, mel_bins=8,
                    cond_attn_blocks=1)
    tm = UnifiedVoice(cfg).to("cuda").eval()
    init_flax_like(tm, g)
    with torch.no_grad():           # spread logits: rows stop at odd steps
        tm.mel_head.bias.normal_(0.0, 1.0, generator=g)
        tm.mel_head.bias[cfg.stop_mel_token] += 2.0
    qt = tq.quantize_gpt_decode(tm, include_fused=False)
    stack = ds.stack_qtree_int4 if engine == "k1_int4" else ds.stack_qtree
    qt["fused"] = stack(qt, cfg.number_mel_codes)
    return tm, qt


@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("engine", ["k1", "k1_int4", "k4"])
def test_graph_loop_gives_the_eager_loops_codes(cuda, engine, sampled):
    """The same requests through the device loop with CUDA graphs (a first
    run that captures, a second that only replays) and without: equal
    codes, lengths, steps and generator offsets, greedy and seeded
    sampling, across a ladder rung that the chunk does not divide. The
    launch counts of a graph run equal the eager run's."""
    from xtts_tpu_torch.infer import device_loop as dl
    from xtts_tpu_torch.infer import qdecode as tq
    from xtts_tpu_torch.ops import decode_step as ds
    from xtts_tpu_torch.ops import serving_step as ss
    tm, qt = _loop_model(cuda, engine)
    b = 8 if engine == "k4" else 1
    cond = torch.randn(b, 8, 30, generator=cuda, device="cuda")
    text = torch.randint(2, 250, (b, 12), generator=cuda, device="cuda")
    runs = []
    for graphs in (False, True, True):
        g = torch.Generator(device="cuda").manual_seed(5)
        dl.STATS.reset()
        ds.reset_launch_counts()
        ss.reset_launch_counts()
        with contextlib.nullcontext() if graphs else dl.eager():
            r = tq.generate_speech_quantized(
                tm, qt, cond, text, g, max_gen=90, do_sample=sampled,
                use_fused_serving=engine == "k4", cache_ladder=(40,))
        torch.cuda.synchronize()
        launches = [fn.launches for fn in ds.KERNELS + ss.KERNELS]
        runs.append((r, g.get_offset(), dl.STATS.replays, launches))
    (r0, off0, _, n0) = runs[0]
    assert r0.steps > 2 * dl.CHUNK
    for r, off, _, n in runs[1:]:
        assert torch.equal(r.codes, r0.codes)
        assert torch.equal(r.lengths, r0.lengths)
        assert r.steps == r0.steps and off == off0 and n == n0
    assert runs[2][2] >= r0.steps // dl.CHUNK - 2     # every full chunk


def test_compacting_wave_gives_the_monolithic_chains_codes(cuda,
                                                            monkeypatch):
    """A compacting wave of 8 rows (infer/compact.py: the int8 chain in the
    device loop's CUDA graphs, rows dropped at the rungs) gives the greedy
    codes, lengths and steps of the monolithic chain over the same rungs;
    its second run replays graphs. The stop logit is raised in steps until
    the monolithic rows leave between 1 and 4 of 8 live at a rung, so the
    compacting wave drops rows."""
    from xtts_tpu_torch.infer import compact
    from xtts_tpu_torch.infer import device_loop as dl
    from xtts_tpu_torch.infer import qdecode as tq
    tm, qt = _loop_model(cuda, "k1")
    cond = torch.randn(8, 8, 30, generator=cuda, device="cuda")
    text = torch.randint(2, 250, (8, 12), generator=cuda, device="cuda")
    ladder = (16, 32, 48, 64)        # rungs of whole graph chunks
    stop = tm.cfg.stop_mel_token
    for _ in range(12):
        want = tq.generate_speech_quantized(tm, qt, cond, text, max_gen=90,
                                            do_sample=False, use_fused=False,
                                            cache_ladder=ladder)
        lens = want.lengths.tolist()
        if any(0 < sum(n > r for n in lens) <= 4 for r in ladder):
            break
        with torch.no_grad():
            tm.mel_head.bias[stop] += 0.5
            qt["mel_head_b"][stop] = tm.mel_head.bias[stop]
    takes = []
    take = dl.LoopState.take

    def counted(self, src, idx):
        takes.append(idx.numel())
        take(self, src, idx)
    monkeypatch.setattr(dl.LoopState, "take", counted)
    for _ in range(2):
        takes.clear()
        dl.STATS.reset()
        got = compact.generate_speech_compacting(
            tm, qt, cond, text, max_gen=90, do_sample=False,
            cache_ladder=ladder, row_buckets=(1, 2, 4, 8))
        torch.cuda.synchronize()
        assert takes and takes[-1] < 8, want.lengths.tolist()
        assert torch.equal(got.codes, want.codes)
        assert torch.equal(got.lengths, want.lengths)
        assert got.steps == want.steps
    assert dl.STATS.replays > 0


def test_diffusion_tts_on_the_card_matches_the_cpu_port(cuda):
    """The legacy DiffusionTts (a 64-channel, 2-layer one, f32, TF32 off)
    on the card against the same weights on the CPU, through the latent,
    code and conditioning-free branches: within 1e-4 of the output's peak
    (f32 on both sides, sums in other orders)."""
    import numpy as np
    from xtts_tpu_torch.models.diffusion_tts import DiffusionTts
    from xtts_tpu_torch.nn.blocks import init_flax_like
    kw = dict(model_channels=64, num_layers=2, in_channels=8,
              in_latent_channels=16, in_tokens=50, out_channels=16,
              num_heads=4)
    cpu = DiffusionTts(**kw).eval()
    init_flax_like(cpu, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in cpu.parameters():
            if not p.any():
                p.normal_(0.0, 0.05)
    card = DiffusionTts(**kw).cuda().eval()
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 8, 40)).astype(np.float32))
    lat = torch.from_numpy(rng.standard_normal((2, 16, 10)).astype(
        np.float32))
    codes = torch.from_numpy(rng.integers(0, 50, (2, 10)))
    mel = torch.from_numpy(rng.standard_normal((2, 8, 30)).astype(
        np.float32))
    ts = torch.tensor([3, 400])
    for aligned, free in ((lat, False), (codes, False), (lat, True)):
        with torch.no_grad():
            want = cpu(x, ts, aligned_conditioning=aligned,
                       conditioning_latent=mel, conditioning_free=free)
            got = card(x.cuda(), ts.cuda(),
                       aligned_conditioning=aligned.cuda(),
                       conditioning_latent=mel.cuda(),
                       conditioning_free=free)
        torch.cuda.synchronize()
        err = (got.cpu() - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item(), (free, err)


def test_a_scratch_growth_does_not_leave_a_graph_writing_freed_memory(cuda):
    """A small model's loop is captured; a wider gemv then grows the split-K
    partials, whose old buffer goes back to the allocator and is handed to
    a new tensor. The small model's next run must not replay a graph that
    still writes the old address: its codes equal the eager loop's, and
    the tensor in the freed memory keeps its bits."""
    from xtts_tpu_torch.infer import device_loop as dl
    from xtts_tpu_torch.infer import qdecode as tq
    from xtts_tpu_torch.ops import decode_step as ds
    tm, qt = _loop_model(cuda, "k1")
    cond = torch.randn(1, 8, 30, generator=cuda, device="cuda")
    text = torch.randint(2, 250, (1, 12), generator=cuda, device="cuda")

    def run():
        g = torch.Generator(device="cuda").manual_seed(5)
        r = tq.generate_speech_quantized(tm, qt, cond, text, g, max_gen=90,
                                         do_sample=False)
        torch.cuda.synchronize()
        return r
    with dl.eager():
        want = run()
    run()                                   # warms up and captures
    dl.STATS.reset()
    run()
    assert dl.STATS.replays > 0
    dev = torch.device("cuda", torch.cuda.current_device())
    old = ds._gv_scratch[dev]["part"]
    n_old, p_old = old.numel(), old.data_ptr()
    del old
    splits = 1                              # a product whose partials
    while 4096 * splits <= n_old:           # outgrow the old buffer
        splits *= 2
    k, n = 1024 * splits, 4096
    assert ds.int8_gemv_plan(k, n)[0] == splits
    w = torch.randint(-127, 128, (k, n), dtype=torch.int8, device="cuda",
                      generator=cuda)
    ds.int8_gemv(torch.randn(k, device="cuda", generator=cuda).bfloat16(), w,
                 torch.ones(n, device="cuda"), torch.zeros(n, device="cuda"))
    torch.cuda.synchronize()
    assert ds._gv_scratch[dev]["part"].numel() > n_old
    del w
    junk = torch.full((n_old,), 7.0, device="cuda")
    dl.STATS.reset()
    got = run()
    assert dl.STATS.captures > 0            # captured anew
    assert torch.equal(got.codes, want.codes)
    assert torch.equal(got.lengths, want.lengths) and got.steps == want.steps
    assert torch.equal(junk, torch.full_like(junk, 7.0)), (
        junk.data_ptr() == p_old)


def test_per_row_draws_in_a_graph_equal_eager_draws(cuda):
    """sample_token_rows captured in a CUDA graph (eight draws, each row's
    counter advancing) draws what the same calls draw eagerly, draw for
    draw; a row's draws equal its draws alone."""
    from xtts_tpu_torch.infer.sampling import row_keys, sample_token_rows
    v, rows, n = 8194, 16, 8
    logits = torch.randn(rows, v, generator=cuda, device="cuda")
    seen = torch.rand(rows, v, generator=cuda, device="cuda") < 0.05
    keys = torch.tensor([row_keys(1000 + r) for r in range(rows)],
                        device="cuda")
    start = torch.arange(rows, device="cuda") * 7
    kw = dict(temperature=0.8, top_p=0.8, repetition_penalty=2.0)

    def draws(out, counter, ks=keys, lg=logits, sn=seen):
        counter.copy_(start[:lg.shape[0]])
        for i in range(n):
            out[:, i] = sample_token_rows(ks, counter, lg, seen=sn, **kw)
            counter.add_(1)
    eager = torch.zeros(rows, n, dtype=torch.long, device="cuda")
    draws(eager, start.clone())
    out = torch.zeros_like(eager)
    counter = start.clone()
    draws(out, counter)                                    # warm up
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        draws(out, counter)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    solo = torch.zeros(1, n, dtype=torch.long, device="cuda")
    c = torch.full((1,), int(start[3]), device="cuda")
    for i in range(n):
        solo[:, i] = sample_token_rows(keys[3:4], c, logits[3:4],
                                       seen=seen[3:4], **kw)
        c.add_(1)
    assert torch.equal(solo[0], eager[3])


def _slot_model(g):
    """test_slots.py's 2 x 64 GPT (34 codes) with random weights on the
    card and its int8 tree, in the attributes a SlotDecoder reads."""
    from types import SimpleNamespace

    from xtts_tpu_torch.core.config import GPTConfig, MelConfig, XTTSConfig
    from xtts_tpu_torch.infer import qdecode as tq
    from xtts_tpu_torch.models.gpt import UnifiedVoice
    from xtts_tpu_torch.nn.blocks import init_flax_like
    cfg = XTTSConfig(mel=MelConfig(n_mels=20), gpt=GPTConfig(
        layers=2, model_dim=64, heads=4, max_mel_tokens=40,
        max_text_tokens=30, number_text_tokens=16, start_text_token=15,
        number_mel_codes=34, start_mel_token=32, stop_mel_token=33,
        mel_bins=20, cond_attn_blocks=2))
    tm = UnifiedVoice(cfg.gpt).to("cuda").eval()
    init_flax_like(tm, g)
    with torch.no_grad():           # spread logits: rows stop at odd steps
        tm.mel_head.bias.normal_(0.0, 1.0, generator=g)
        tm.mel_head.bias[cfg.gpt.stop_mel_token] += 1.0
    return SimpleNamespace(gpt=tm, cfg=cfg, device=torch.device("cuda"),
                           _qtree=tq.quantize_gpt_decode(
                               tm, include_fused=False))


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("greedy", [True, False])
def test_slot_pool_graphs_give_the_eager_codes(cuda, greedy, kv_quant):
    """3 slots, 7 requests refilled into recycled slots as they finish:
    the pool's CUDA graphs (segments of 12 steps, graphs of 4) give the
    codes and lengths of the same segments run eagerly, greedy and seeded
    sampling, over the bf16 and the int8 cache."""
    from xtts_tpu_torch.infer import device_loop as dl
    from xtts_tpu_torch.infer.api import TTSSettings
    from xtts_tpu_torch.infer.slots import SlotDecoder
    tts = _slot_model(cuda)
    texts = [torch.randint(2, 15, (5,), generator=cuda,
                           device="cuda").cpu().numpy() for _ in range(7)]
    conds = [torch.randn(1, 20, 30, generator=cuda, device="cuda")
             for _ in range(7)]

    def drive():
        dec = SlotDecoder(tts, n_slots=3, max_gen=24, segment_len=12,
                          text_buckets=(5,), settings=TTSSettings(
                              max_mel_tokens=24, kv_quant=kv_quant))
        pending, slot_req, out = list(range(7)), {}, {}
        for s in range(3):
            i = pending.pop(0)
            dec.install(s, dec.pad_text(texts[i]), conds[i], seed=50 + i)
            slot_req[s] = i
        while slot_req:
            done, gen = dec.run_segment(greedy=greedy)
            codes = dec.fetch_codes()
            for s in [s for s in slot_req if done[s]]:
                i = slot_req.pop(s)
                out[i] = (codes[s].tolist(), int(gen[s]))
                if pending:
                    j = pending.pop(0)
                    dec.install(s, dec.pad_text(texts[j]), conds[j],
                                seed=50 + j)
                    slot_req[s] = j
        return out
    with dl.eager():
        want = drive()
    dl.STATS.reset()
    got = drive()
    assert dl.STATS.captures > 0 and dl.STATS.replays > 0
    assert got == want
    assert len({n for _, n in want.values()}) >= 2


def test_per_row_noise_at_one_row_is_the_single_generators(cuda):
    """At one row, a generator a row draws x_T and each ancestral step's
    noise as the single generator does from the same seed: a wave's
    draws and a slot request's are the same derivation at B=1."""
    from xtts_tpu_torch.diffusion.gaussian import GaussianDiffusion
    gd = GaussianDiffusion.spaced(1000, 10)

    def model_fn(x, t):
        return torch.cat([0.1 * x, torch.tanh(x)], dim=1)
    shape = (1, 100, 64)
    one = gd.p_sample_loop(model_fn, shape, torch.Generator(
        device="cuda").manual_seed(9), device="cuda")
    rows = gd.p_sample_loop(model_fn, shape, [torch.Generator(
        device="cuda").manual_seed(9)], device="cuda")
    assert torch.equal(one, rows)


@pytest.mark.parametrize("b,n,win,hop", [(1, 1280, 1024, 256),
                                         (16, 1280, 1024, 256),
                                         (1, 2416, 1024, 512)])
def test_overlap_add_is_deterministic_and_equals_the_cpu(cuda, b, n, win, hop):
    """The iSTFT / IMDCT overlap-add on the card sums the frames in frame
    order with elementwise adds: ten calls give the same bits, equal to the
    CPU's (and so to a sequential scatter-add), where index_add_'s atomics
    would add in arrival order."""
    from xtts_tpu_torch.dsp.spectral import overlap_add
    frames = torch.randn(b, n, win, generator=cuda, device="cuda")
    size = (n - 1) * hop + win
    first = overlap_add(frames, hop, size)
    for _ in range(9):
        assert torch.equal(overlap_add(frames, hop, size), first)
    assert torch.equal(first.cpu(), overlap_add(frames.cpu(), hop, size))
