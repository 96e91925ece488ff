"""The split plans of the cluster kernels, on the CPU.

decode_attention (ops/decode_step.py) runs each head as a cluster of blocks
over contiguous chunks of positions 0..index and merges their partial
softmaxes in rank order; its plain twin follows the same plan. The plain
twin's split-and-merge must equal one softmax pass over all positions
within 1e-6 (f32: only the order of summation differs; values O(1)), with
no NaN from empty chunks. int8_gemm_rows (ops/serving_step.py) splits K
over the blocks of a cluster; its plan must cover K exactly. The kernels
themselves run only on the card (tests/test_torch_port_kernels.py); the
step built on the new twin is held against the Pallas K1 in interpret mode
by tests/test_torch_port_decode_step.py."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xtts_tpu_torch.ops import decode_step as tds  # noqa: E402
from xtts_tpu_torch.ops import serving_step as tss  # noqa: E402


@pytest.mark.parametrize("s_max", [1, 7, 8, 9, 40, 360])
def test_attention_plan_covers_every_position_once(s_max):
    for index in range(s_max):
        bounds = tds.attention_bounds(index, s_max)
        p = tds.ATT_SPLITS
        assert len(bounds) == p + 1
        assert bounds[0] == 0 and bounds[-1] == index + 1
        assert all(a <= b for a, b in zip(bounds, bounds[1:]))
        covered = [s for lo, hi in zip(bounds, bounds[1:])
                   for s in range(lo, hi)]
        assert covered == list(range(index + 1))
        # the last chunk holds index: the block that writes the new row
        assert bounds[-2] <= index < bounds[-1]
        if index + 1 < p:
            assert sum(lo == hi for lo, hi in zip(bounds, bounds[1:])) \
                == p - index - 1


def test_attention_plan_refuses_indices_outside_the_cache():
    for index, s_max in ((-1, 360), (360, 360), (16384, 16384)):
        with pytest.raises(ValueError):
            tds.attention_bounds(index, s_max)


def _one_pass(q, k, v):
    s = torch.einsum("hd,shd->hs", q, k) / math.sqrt(q.shape[-1])
    return torch.einsum("hs,shd->hd", torch.softmax(s, dim=-1), v)


@pytest.mark.parametrize("index", [0, 1, 5, 6, 7, 8, 100, 359])
def test_split_softmax_equals_one_pass(index):
    rng = np.random.default_rng(index)
    heads, hd = 4, 64
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)) for shape in ((heads, hd), (index + 1, heads, hd),
                                   (index + 1, heads, hd)))
    bounds = tds.attention_bounds(index, 360)
    got = tds.split_attention(q, k, v, bounds)
    assert not torch.isnan(got).any()
    assert (got - _one_pass(q, k, v)).abs().max().item() <= 1e-6


def test_split_softmax_ignores_far_below_max_and_empty_chunks():
    """Chunks whose scores sit ~1e3 below the maximum weigh 0, and empty
    chunks (m = -inf) merge with factor 0, not exp(-inf - -inf) = NaN."""
    heads, hd, n = 2, 64, 3
    q = torch.zeros(heads, hd)
    q[:, 0] = 1.0
    k = torch.zeros(n, heads, hd)
    k[:, :, 0] = torch.tensor([-8000.0, 0.0, 8.0])[:, None]
    v = torch.arange(n * heads * hd, dtype=torch.float32).reshape(n, heads,
                                                                 hd)
    bounds = tds.attention_bounds(n - 1, 360)
    got = tds.split_attention(q, k, v, bounds)
    assert not torch.isnan(got).any()
    assert (got - _one_pass(q, k, v)).abs().max().item() <= 1e-6 * v.max()


def test_decode_attention_plain_is_the_split_twin():
    """The plain twin (CPU tensors) writes the new row, then takes the
    split softmax of the bf16-rounded q over rows 0..index."""
    rng = np.random.default_rng(3)
    heads, d, s_max, index = 2, 128, 40, 5
    qkv = torch.from_numpy(rng.standard_normal(3 * d).astype(np.float32))
    kc = torch.from_numpy(rng.standard_normal((s_max, d)).astype(
        np.float32)).bfloat16()
    vc = torch.from_numpy(rng.standard_normal((s_max, d)).astype(
        np.float32)).bfloat16()
    got = tds.decode_attention(qkv, kc, vc, index, heads)
    assert torch.equal(kc[index], qkv[d:2 * d].bfloat16())
    assert torch.equal(vc[index], qkv[2 * d:].bfloat16())
    q = qkv[:d].bfloat16().float().reshape(heads, 64)
    k = kc[:index + 1].float().reshape(index + 1, heads, 64)
    v = vc[:index + 1].float().reshape(index + 1, heads, 64)
    want = _one_pass(q, k, v).reshape(d)
    assert got.dtype == torch.bfloat16
    assert (got.float() - want).abs().max().item() <= 1e-2


def test_decode_attention_takes_index_up_to_the_cache_end():
    """No index-sized shared buffer any more: the wrapper takes any
    0 <= index < S (beyond the old 12288 cap) and refuses S itself."""
    heads, d, s_max = 1, 64, 16384
    rng = np.random.default_rng(4)
    qkv = torch.from_numpy(rng.standard_normal(3 * d).astype(np.float32))
    kc = torch.zeros(s_max, d, dtype=torch.bfloat16)
    vc = torch.zeros(s_max, d, dtype=torch.bfloat16)
    kc[:12400] = torch.from_numpy(rng.standard_normal((12400, d)).astype(
        np.float32)).bfloat16()
    vc[:12400] = kc[:12400].roll(1, dims=1)
    for index in (12288, s_max - 1):
        out = tds.decode_attention(qkv, kc, vc, index, heads)
        assert out.shape == (d,) and torch.isfinite(out.float()).all()
    with pytest.raises(ValueError):
        tds.decode_attention(qkv, kc, vc, s_max, heads)


FLAGSHIP = {"qkv": (1024, 3072), "proj": (1024, 1024), "fc": (1024, 4096),
            "out": (4096, 1024), "head": (1024, 9216)}


@pytest.mark.parametrize("k,n", list(FLAGSHIP.values()) + [
    (100, 64), (100, 32), (128, 32), (4096, 32), (128, 512), (17, 96)])
def test_gemm_rows_plan_covers_k_exactly(k, n):
    splits, bounds = tss.gemm_rows_plan(k, n)
    assert splits in (1, 2, 4, 8) and len(bounds) == splits + 1
    assert bounds[0] == 0 and bounds[-1] == k
    covered = [i for lo, hi in zip(bounds, bounds[1:]) for i in range(lo, hi)]
    assert covered == list(range(k))
    # whole 16-deep mma steps except the ragged end; no chunk longer than
    # the 512 a block stages at once, none empty
    assert all(b % 16 == 0 for b in bounds[:-1])
    assert all(0 < hi - lo <= tss.GEMM_MAX_CHUNK
               for lo, hi in zip(bounds, bounds[1:]))


def test_gemm_rows_plan_fills_the_card_at_the_flagship_width():
    """Every product of the K4 step runs on >= 128 blocks."""
    got = {name: tss.gemm_rows_plan(k, n)[0] for name, (k, n)
           in FLAGSHIP.items()}
    assert got == {"qkv": 4, "proj": 8, "fc": 2, "out": 8, "head": 2}
    for name, (k, n) in FLAGSHIP.items():
        assert got[name] * -(-n // tss.GEMM_COLS) >= tss.GEMM_MIN_BLOCKS


@pytest.mark.parametrize("k,n,groups", [(1024, 3072, 1), (1024, 1024, 1),
                                        (1024, 4096, 1), (4096, 1024, 4),
                                        (1024, 9216, 1), (128, 384, 1),
                                        (384, 160, 3), (100, 64, 1),
                                        (4096, 32, 1), (1000, 32, 1),
                                        (12288, 32, 1)])
def test_int4_plan_covers_each_group_exactly(k, n, groups):
    """int4_gemv_plan splits each scale group into chunks of whole 16-row
    steps (the ragged end excepted) of at most 2048 rows that cover the
    group exactly; the products of the K1-int4 step run unsplit, one block
    for each 32 columns (the out matrix: one for each of its 4 groups)."""
    s, bounds = tds.int4_gemv_plan(k, n, groups)
    kg = k // groups
    assert len(bounds) == s + 1 and bounds[0] == 0 and bounds[-1] == kg
    covered = [i for lo, hi in zip(bounds, bounds[1:]) for i in range(lo, hi)]
    assert covered == list(range(kg))
    assert all(b % 16 == 0 for b in bounds[:-1])
    assert all(hi - lo <= tds.I4_MAX_CHUNK
               for lo, hi in zip(bounds, bounds[1:]))
    blocks = -(-n // tds.I4_COLS) * groups * s
    if (k, n) in FLAGSHIP.values():
        assert s == 1 and blocks >= tds.GV_MIN_BLOCKS
    elif -(-n // tds.I4_COLS) * groups < tds.GV_MIN_BLOCKS and kg >= 128:
        assert s > 1           # narrow products split K for more blocks


@pytest.mark.parametrize("k,n,groups", [(128, 384, 1), (512, 128, 4),
                                        (100, 64, 1), (1000, 32, 1),
                                        (384, 160, 3)])
def test_ordered_int4_sums_within_one_rounding_a_term(k, n, groups):
    """The int4 twin's sums in the kernel's order: each group's sum equals
    the float64 one within one f32 rounding a term (every product of a bf16
    value and a nibble is exact in f32; each of at most k adds rounds once
    relative to the running sum, bounded by sum |x w|)."""
    rng = np.random.default_rng(k + n)
    w4 = torch.from_numpy(rng.integers(-7, 8, (k, n)).astype(np.int8))
    x = torch.from_numpy(rng.standard_normal(k).astype(np.float32)).bfloat16()
    got = tds.ordered_int4_sums(x, tds.pack_int4(w4), groups).double()
    xw = (x.double()[:, None] * w4.double()).reshape(groups, k // groups, n)
    want = xw.sum(1)
    bound = (k // groups) * 2.0 ** -24 * xw.abs().sum(1)
    assert got.shape == (groups, n)
    assert ((got - want).abs() <= bound).all()


@pytest.mark.parametrize("k,n", list(FLAGSHIP.values()) + [
    (128, 384), (128, 128), (128, 512), (512, 128), (100, 64), (2048, 64),
    (3000, 32), (12288, 32)])
def test_int8_plan_covers_k_exactly(k, n):
    """int8_gemv_plan splits K into chunks of whole 16-row steps (the
    ragged end excepted) of at most 1024 rows (16 KB a block) that cover K
    in order; of the K1 products only the out matrix (K 4096) splits, in
    four; narrow products split until they make 32 blocks."""
    s, bounds = tds.int8_gemv_plan(k, n)
    assert len(bounds) == s + 1 and bounds[0] == 0 and bounds[-1] == k
    covered = [i for lo, hi in zip(bounds, bounds[1:]) for i in range(lo, hi)]
    assert covered == list(range(k))
    assert all(b % 16 == 0 for b in bounds[:-1])
    assert all(0 < hi - lo <= tds.I8_MAX_CHUNK
               for lo, hi in zip(bounds, bounds[1:]))
    if (k, n) in FLAGSHIP.values():
        assert s == (4 if k == 4096 else 1)
    elif -(-n // tds.I8_COLS) < tds.GV_MIN_BLOCKS and k >= 128:
        assert s > 1


def _kernel_order_sums(x, w, plan):
    """The gemv kernel's sum of each column written out one f32 add at a
    time (numpy float32): in chunk r, lane l adds rows lo + l, lo + l + 64,
    ... in turn; lanes 8h .. 8h + 7 add in order, then the 8 sums h; the
    chunks in order."""
    x = x.float().numpy()
    w = w.float().numpy()
    s, bounds = plan
    total = np.zeros(w.shape[1], np.float32)
    for lo, hi in zip(bounds, bounds[1:]):
        lanes = np.zeros((64, w.shape[1]), np.float32)
        for row in range(lo, hi):
            lanes[(row - lo) % 64] += np.float32(x[row]) * w[row]
        folds = np.zeros((8, w.shape[1]), np.float32)
        for h in range(8):
            for lane in range(8):
                folds[h] += lanes[8 * h + lane]
        chunk = np.zeros(w.shape[1], np.float32)
        for h in range(8):
            chunk += folds[h]
        total += chunk
    return total


@pytest.mark.parametrize("k,n", [(100, 32), (384, 48), (1024, 16),
                                 (3000, 32)])
def test_ordered_int8_sums_follow_the_kernel_order(k, n):
    """ordered_int8_sums (vectorised) equals the kernel's order written out
    add by add, bit for bit, with a ragged chunk (K 100, 3000), narrow
    products split over K (N 32, 48) and one whole chunk (K 1024)."""
    rng = np.random.default_rng(k * n)
    w = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8))
    x = torch.from_numpy(rng.standard_normal(k).astype(np.float32)).bfloat16()
    got = tds.ordered_int8_sums(x, w).numpy()
    want = _kernel_order_sums(x, w, tds.int8_gemv_plan(k, n))
    assert np.array_equal(got, want)
