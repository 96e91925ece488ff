// K1 for Hopper: the B=1 int8 GPT decode step as a short chain of kernels.
//
// Replaces the Pallas TPU kernel xtts_tpu/ops/decode_step.py
// (_make_kernel, launched by _fused_decode_logits), which ran the whole
// token step (15 layers + ln_f + final_norm + mel head) in one pallas_call
// streaming (D, D) int8 tiles through a VMEM ring. On the H100 the step is:
//
//   per layer:  int8_gemv(ln_1 prologue, qkv) -> decode_attention
//               -> int8_gemv(proj, += into the f32 residual)
//               -> int8_gemv(ln_2 prologue, fc, gelu_new, bf16 out)
//               -> int8_gemv(out, K = 4D in one launch, += residual)
//   then:       int8_gemv(ln_f then final_norm prologue, head)
//
// 5 launches a layer and one for the head: 76 a token at 15 layers. The
// LayerNorms run inside the product that consumes them, as the TPU kernel
// ran `_ln` inside `_make_kernel`: each block of a fused gemv loads the f32
// residual with its input chunk, normalises it in f32 and rounds it to
// bf16 once. layer_norm_rows stays as the standalone norm; no path
// launches it.
//
// Every piece of arithmetic of the TPU kernel runs here: f32 LayerNorm
// statistics (eps 1e-5), bf16 matvec inputs against int8 weights with f32
// accumulation, per-output-channel scale + bias, gelu_new, an f32 residual,
// f32 softmax attention over cache rows 0..idx (decode_attention: a
// flash-decode whose P blocks a head form one thread-block cluster and
// merge their partial softmaxes through distributed shared memory).
//
// Bound: weight bytes. One token streams ~190 MB of int8 weights at the
// flagship width (15 x 12 D^2 + 9 D^2 bytes, D = 1024); at 3.35 TB/s that
// is ~57 us, against ~1 MB of KV cache and activations. The gemv (below)
// spreads every product over 64-576 blocks of 16 columns, each with its
// whole chunk of weights in flight at once. At 76 launches a token the
// chain is still launch-bound; a persistent single-launch step or a CUDA
// graph is later work.
//
// Layouts: weights (K, N) int8 row-major, exactly quantize_dense's (in, out)
// matrix; KV cache (L, S, D) bf16 with the new row written in place at idx.
// The int4 mode (XTTS_DECODE_BITS=4) swaps int8_gemv for int4_gemv on a
// packed stack (ops/decode_step.stack_qtree_int4) and keeps the rest.
//
// C interface (ctypes): every entry point returns cudaGetLastError().

#include <cooperative_groups.h>
#include <stdint.h>

#include "common.cuh"

#define XT_API extern "C"

namespace {

// ---------------------------------------------------------------------------
// layer_norm_rows: one block of 256 threads per row; f32 statistics, bf16
// out. nrm.n == 2 applies a second norm (s2, b2) to the f32 result of the
// first (ln_f then final_norm), rounding to bf16 only at the end.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(256)
layer_norm_rows_kernel(const float* __restrict__ x, Norm nrm,
                       __nv_bfloat16* __restrict__ out, int d) {
  extern __shared__ float buf[];  // d floats
  __shared__ float red[8];
  const float* xr = x + (size_t)blockIdx.x * d;
  for (int i = threadIdx.x; i < d; i += 256) buf[i] = xr[i];
  __syncthreads();
  layer_norm_inplace(buf, d, nrm, red, threadIdx.x, 256);
  __nv_bfloat16* orow = out + (size_t)blockIdx.x * d;
  for (int i = threadIdx.x; i < d; i += 256)
    orow[i] = __float2bfloat16(buf[i]);
}

// ---------------------------------------------------------------------------
// int8_gemv and int4_gemv: one kernel template, gemv_kernel<BITS, LN>.
//
//   int8:  y[n] = (sum_k x[k] w[k, n]) * scale[n] + bias[n]
//   int4:  y[n] = sum_g r( (sum_{k in g} x[k] w4[k, n]) * scale[g, n]
//                          + (g == 0) bias[n] )
//
// int8: w (K, N) int8 row-major (quantize_dense's (in, out) matrix), one
// scale a column. int4 (the K1 int4 mode, the wbits == 4 branch of the TPU
// kernel, xtts_tpu/ops/decode_step.py:157-167): w4 (K, N/2) bytes, byte
// (k, j) holds column 2j in its low nibble and 2j+1 in its high nibble,
// both signed in [-7, 7]; scale (G, N) f32, one row per group of K/G input
// rows (the TPU kernel's (D, D) tiles: four groups for the MLP out matrix,
// one elsewhere). r() rounds a group's output to bf16, as the TPU kernel
// does for every tile it restores to canonical order; with gelu (the fc
// tiles, left permuted there) nothing is rounded before gelu_new. Both
// apply gelu_new on request; mode: 0 = store f32, 1 = store bf16, 2 = add
// into f32 (the residual). LN: x is the f32 residual and the block
// normalises it first (the norm prologue, below).
//
// Bound: the weight bytes (int8 ~190 MB a token at the flagship width, 57
// us at 3.35 TB/s; 4 MB for fc, 1.2 us; int4 half of that). At these sizes
// a call is a chain of latencies (a launch, a round trip for the weights,
// the products, the reduction, the stores), and the design cuts the chain:
//  - Every SM streams: a block owns GV_COLS output columns, 16 bytes of a
//    weight row (16 int8 columns, 32 int4 columns), and one chunk of the K
//    rows of one scale group, so a group's bf16 rounding still applies to
//    the group's whole sum. The grid is (G x s, N / GV_COLS): int8 qkv 192
//    blocks, proj 64, fc 256, out 4 x 64, head 576; int4 qkv 96, proj 32,
//    fc 128, out 4 groups x 32, head 288. gv_splits picks s, the chunks of
//    a group: 1 wherever the tiles x G give >= 32 blocks and the chunk fits
//    (every K1 product but int8's out, whose 4096 rows split in four
//    chunks of 1024), more for narrow products. gv_lo gives the chunk
//    bounds (multiples of 16 rows); ops/decode_step.py gemv_plan is their
//    Python copy, held against xt_int8_gemv_bounds / xt_int4_gemv_bounds
//    on the card. A block takes 18.5 KB of shared memory (the chunk, and
//    the input as bf16) and the kernels ask for the largest carveout, so
//    the head's 576 blocks fit 5 an SM. (Two column tiles a block, 288
//    blocks for the head, lost: 9.9 against 7.4 us, H100, PERF.md.)
//  - Nothing waits before everything is in flight: the input's loads and
//    the epilogue's operands (bias, scales, the residual) first, then the
//    whole chunk (<= 16 KB of int8, 32 KB of int4) as 16-byte cp.async
//    copies in GV_STAGES commit groups; the products start on the first
//    group while the later ones land. (Issued after the weights, the
//    input's loads queued behind them: 1.0 us more at int4's fc. Split
//    over K across 128-192 blocks of 128 columns, every product's partials
//    merged by the last block to arrive, the chain held more round trips:
//    5.0-5.2 us for int4's proj and fc against 4.4-4.5 without the merge's
//    fence and counter. H100, PERF.md.)
//  - Weights widen without I2F: a byte_perm puts each byte (an int8 value
//    + 128, or a nibble + 8 after one lop3) into the mantissa of 2^23, and
//    one subtraction gives the value exactly as f32.
//  - f32 FMA: thread (lane l < 64, word j < 4) holds the accumulators of
//    the columns of its 4-byte word (4 int8, 8 int4) and adds rows lo + l,
//    lo + l + 64, ... in turn. bf16 x int8 and bf16 x int4 products are
//    exact in f32, so each fmaf is one rounded add.
//  - A fixed order throughout, so the same inputs give the same bits and the
//    plain twins (int8_gemv_plain, int4_gemv_plain) repeat the sums to the
//    bit: lanes 8h .. 8h + 7 of a column add in order, then the 8 sums h in
//    order. Where a product has several chunks, each block leaves its sums
//    in global scratch and the last block of a column tile to arrive (one
//    atomic counter a tile, which it resets to 0) adds the tile's chunks in
//    split order and runs the epilogue (int4: for each group in group
//    order). Every f32 operation there is an explicitly rounded one.
//  - The norm prologue takes the row's statistics once a block, in
//    layer_norm_rows' summation order: where the chunk is the whole row,
//    from the registers of threads t < 256, which hold elements t, t +
//    256, ... (warp and block butterflies); a split chunk takes them by one
//    warp (common.cuh row_norm_stats). It normalises only its chunk and
//    rounds it to bf16 once, so fused == layer_norm_rows + product. The
//    two are separate instantiations (LN 1 and 2): in one kernel the split
//    path's registers held the whole-row one to 127 registers, 2 blocks an
//    SM (head + ln_f 13.1 us against 10.2, H100, PERF.md).
// ---------------------------------------------------------------------------
constexpr int GV_THREADS = 256;
constexpr int GV_ROWB = 16;                      // bytes of a row a block
constexpr int GV_WORDS = GV_ROWB / 4;            // 4-byte words a row
constexpr int GV_LANES = GV_THREADS / GV_WORDS;  // rows lo + l, + LANES, ...
constexpr int GV_FOLD = 8;          // lanes summed a first-level sum
constexpr int GV_STAGES = 4;        // cp.async groups a chunk is issued in
constexpr int GV_MIN_BLOCKS = 32;   // split K only below this many blocks
constexpr int GV_MIN_CHUNK = 64;    // rows: no finer split for more blocks
static_assert(GV_LANES % GV_FOLD == 0, "whole first-level sums");
static_assert(GV_THREADS == 256, "the norm statistics take 256 threads");

template <int BITS>
struct Gv {
  static constexpr int COLS = GV_ROWB * 8 / BITS;   // 16 int8, 32 int4
  static constexpr int CPW = COLS / GV_WORDS;       // columns a word
  static constexpr int MAX_CHUNK = 8192 / BITS;     // rows: 16 / 32 KB
  static constexpr int PRE = MAX_CHUNK / 256;       // residual rows a thread
};

// chunks of each scale group (kg rows of K = G kg) for N columns
__host__ __device__ __forceinline__ int gv_splits(int K, int N, int groups,
                                                  int cols, int max_chunk) {
  const int kg = K / groups, t = (kg + 15) / 16;
  const int tiles = (N + cols - 1) / cols;
  int s = 1;
  while (s < 16 && tiles * groups * s < GV_MIN_BLOCKS &&
         kg / (2 * s) >= GV_MIN_CHUNK)
    s *= 2;
  while (16 * ((t + s - 1) / s) > max_chunk) s *= 2;
  return s;
}

// the first row of chunk r of s in a group of kg rows, relative to the
// group: 16 floor(r T / s), T = ceil(kg / 16), clipped to kg
__host__ __device__ __forceinline__ int gv_lo(int r, int s, int kg) {
  const int k = r * ((kg + 15) / 16) / s * 16;
  return k < kg ? k : kg;
}

__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {  // groups still in flight allowed
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}
static_assert(GV_STAGES == 4, "cp_async_wait_upto covers 4 groups");

template <int BITS>
__host__ __device__ __forceinline__ int gv_wbytes(int cmax) {
  const int red = GV_LANES * Gv<BITS>::COLS * 4;  // the lanes' sums
  return cmax * GV_ROWB > red ? cmax * GV_ROWB : red;
}

// LN: 0 no prologue; 1 the prologue of a block whose chunk is the whole
// row (every K1 product with a norm), statistics from its registers; 2 the
// prologue of a split chunk, statistics by one warp (row_norm_stats). Two
// instantiations keep the first's registers down to 4 blocks an SM.
template <int BITS, int LN>
__global__ void __launch_bounds__(GV_THREADS)
gemv_kernel(const void* __restrict__ x, Norm nrm,
            const uint8_t* __restrict__ w, const float* __restrict__ scale,
            const float* __restrict__ bias, void* __restrict__ out,
            float* __restrict__ part, unsigned* __restrict__ count, int K,
            int N, int groups, int splits, int gelu, int mode) {
  constexpr int COLS = Gv<BITS>::COLS, CPW = Gv<BITS>::CPW;
  constexpr int PRE = Gv<BITS>::PRE;
  constexpr int FOLDS = GV_LANES / GV_FOLD;
  extern __shared__ __align__(16) unsigned char smem[];
  const int kg = K / groups;
  const int cmax = 16 * (((kg + 15) / 16 + splits - 1) / splits);
  // [row][4 words] weights; red [64 lanes][COLS] after the products
  uint32_t* ws = reinterpret_cast<uint32_t*>(smem);
  float* red = reinterpret_cast<float*>(smem);
  // the chunk of the input as bf16 (its values are bf16: half the bytes)
  __nv_bfloat16* xs =
      reinterpret_cast<__nv_bfloat16*>(smem + gv_wbytes<BITS>(cmax));
  __shared__ float fold[FOLDS][COLS];
  __shared__ float st[4], st_red[8];
  __shared__ bool last;

  const int tid = threadIdx.x, ns = gridDim.x, q = blockIdx.x;
  const int tile = blockIdx.y, n0 = tile * COLS;
  const int g = q / splits, r = q - g * splits;
  const int lo = g * kg + gv_lo(r, splits, kg);
  const int rows = g * kg + gv_lo(r + 1, splits, kg) - lo;
  const size_t rowb = (size_t)N * BITS / 8;
  // rows a commit group, a multiple of the lane count
  const int rs = (rows + GV_STAGES * GV_LANES - 1) / (GV_STAGES * GV_LANES) *
                 GV_LANES;

  // the chunk's weights, all in flight: one 16-byte copy a row in
  // GV_STAGES commit groups, issued once the input's loads are (so that
  // those do not queue behind 16-32 KB of weights)
  auto issue_weights = [&]() {
    const uint8_t* src = w + (size_t)lo * rowb + (size_t)n0 * BITS / 8;
    for (int s = 0; s < GV_STAGES; ++s) {
      const int r1 = min(rows, (s + 1) * rs);
      for (int row = s * rs + tid; row < r1; row += GV_THREADS)
        cp_async16(smem_u32(smem + row * GV_ROWB), src + row * rowb, true);
      cp_async_commit();
    }
  };

  // ---- the epilogue's operands, loaded now: thread t < COLS takes
  // column n0 + t ----
  const int n = n0 + tid;
  float pb = 0.f, ps[4] = {0.f, 0.f, 0.f, 0.f}, po = 0.f;
  if (tid < COLS && n < N) {
    pb = bias[n];
#pragma unroll
    for (int gg = 0; gg < 4; ++gg)
      if (gg < groups) ps[gg] = scale[(size_t)gg * N + n];
    if (mode == 2) po = reinterpret_cast<const float*>(out)[n];
  }

  // ---- the chunk of the input, as f32: every load issued before any is
  // used. The norm prologue: threads t < 256 hold residual elements t, t +
  // 256, ... (layer_norm_rows' per-thread order) and their norm
  // parameters ----
  if constexpr (LN != 0) {
    const float* x32 = reinterpret_cast<const float*>(x);
    float xv[PRE], s1[PRE], b1[PRE], s2[PRE], b2[PRE];
#pragma unroll
    for (int j = 0; j < PRE; ++j) {
      const int i = tid + j * 256, k = lo + i;
      if (i < rows) {
        xv[j] = x32[k];
        s1[j] = nrm.s1[k];
        b1[j] = nrm.b1[k];
        if (nrm.n == 2) {
          s2[j] = nrm.s2[k];
          b2[j] = nrm.b2[k];
        }
      }
    }
    issue_weights();

    if constexpr (LN == 1) {
      // the block's chunk is the whole row: the statistics from the
      // registers, in layer_norm_rows' order: each thread's elements in
      // turn, the warp by a butterfly, the 8 warp sums by a butterfly
      const int lane32 = tid & 31, warp = tid >> 5;
      auto block_sum = [&](auto f) {
        float a = 0.f;
#pragma unroll
        for (int j = 0; j < PRE; ++j)
          if (tid + j * 256 < rows) a += f(j);
        a = warp_sum(a);
        if (lane32 == 0) st_red[warp] = a;
        __syncthreads();
        const float t = warp_sum(lane32 < 8 ? st_red[lane32] : 0.f);
        __syncthreads();  // st_red is free again
        return t;
      };
      for (int p = 0; p < nrm.n; ++p) {
        const float mu = row_mean(block_sum([&](int j) { return xv[j]; }), K);
        const float rstd = row_rstd(row_mean(
            block_sum([&](int j) { return sq_dev(xv[j], mu); }), K));
#pragma unroll
        for (int j = 0; j < PRE; ++j)
          xv[j] = p ? ln_apply(xv[j], mu, rstd, s2[j], b2[j])
                    : ln_apply(xv[j], mu, rstd, s1[j], b1[j]);
      }
    } else {
      if (tid < 32) row_norm_stats(x32, K, nrm, tid, st);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < PRE; ++j) {
        xv[j] = ln_apply(xv[j], st[0], st[1], s1[j], b1[j]);
        if (nrm.n == 2) xv[j] = ln_apply(xv[j], st[2], st[3], s2[j], b2[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < PRE; ++j)
      if (tid + j * 256 < rows) xs[tid + j * 256] = __float2bfloat16(xv[j]);
  } else {
    const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(x);
    __nv_bfloat16 xv[PRE];
#pragma unroll
    for (int j = 0; j < PRE; ++j) {
      const int i = tid + j * GV_THREADS;
      if (i < rows) xv[j] = xb[lo + i];
    }
    issue_weights();

#pragma unroll
    for (int j = 0; j < PRE; ++j) {
      const int i = tid + j * GV_THREADS;
      if (i < rows) xs[i] = xv[j];
    }
  }

  // ---- the products: lane l, word j. int8: byte i is column 4j + i;
  // int4: the low nibble of byte i column 8j + 2i, the high one 8j + 2i + 1
  const int j = tid % GV_WORDS, lane = tid / GV_WORDS;
  float acc[CPW];
#pragma unroll
  for (int i = 0; i < CPW; ++i) acc[i] = 0.f;
  for (int s = 0; s < GV_STAGES; ++s) {
    cp_async_wait_upto(GV_STAGES - 1 - s);
    __syncthreads();  // group s of every thread, and xs, are visible
    const int r1 = min(rows, (s + 1) * rs);
#pragma unroll 4
    for (int row = s * rs + lane; row < r1; row += GV_LANES) {
      const uint32_t wd = ws[row * GV_WORDS + j];
      const float xv = __bfloat162float(xs[row]);
      if constexpr (BITS == 8) {
        const uint32_t u = wd ^ 0x80808080u;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[i] = fmaf(xv, byte_f32(u, i, 8388736.f), acc[i]);
      } else {
        const uint32_t lo4 = (wd & 0x0F0F0F0Fu) ^ 0x08080808u;
        const uint32_t hi4 = ((wd >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[2 * i] = fmaf(xv, byte_f32(lo4, i, 8388616.f), acc[2 * i]);
          acc[2 * i + 1] =
              fmaf(xv, byte_f32(hi4, i, 8388616.f), acc[2 * i + 1]);
        }
      }
    }
  }
  __syncthreads();  // every warp is done with ws, which red reuses

  // ---- the chunk's sums: lanes 8h .. 8h + 7 in order, then h in order ----
  float4* rp = reinterpret_cast<float4*>(red + lane * COLS + CPW * j);
#pragma unroll
  for (int i = 0; i < CPW / 4; ++i)
    rp[i] = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2],
                        acc[4 * i + 3]);
  __syncthreads();
  if (tid < FOLDS * COLS) {
    const int c = tid % COLS, h = tid / COLS;
    float p = 0.f;
#pragma unroll
    for (int l = 0; l < GV_FOLD; ++l)
      p = __fadd_rn(p, red[(h * GV_FOLD + l) * COLS + c]);
    fold[h][c] = p;
  }
  __syncthreads();
  float sum = 0.f;  // this chunk's sum of column n (threads < COLS)
  if (tid < COLS) {
#pragma unroll
    for (int h = 0; h < FOLDS; ++h) sum = __fadd_rn(sum, fold[h][tid]);
  }

  if (ns > 1) {
    // several chunks: the last block of the tile to arrive merges them
    float* tpart = part + (size_t)tile * ns * COLS;  // [chunk][COLS]
    if (tid < COLS) {
      tpart[q * COLS + tid] = sum;
      __threadfence();  // the sum is visible before the count moves
    }
    __syncthreads();
    if (tid == 0) last = atomicAdd(count + tile, 1u) == (unsigned)ns - 1;
    __syncthreads();
    if (!last) return;
    if (tid == 0) count[tile] = 0;  // every block of the tile has counted
  }

  // ---- the epilogue: each group's sum (its chunks in order) times its
  // scales, + bias for group 0; int4 rounds each group's output to bf16
  // unless gelu and adds the groups in order ----
  if (tid < COLS && n < N) {
    const float* tpart = part + (size_t)tile * ns * COLS;
    float total = 0.f;
    for (int gg = 0; gg < groups; ++gg) {
      float sg = 0.f;
      if (ns == 1) {
        sg = sum;
      } else {
#pragma unroll 4
        for (int rr = 0; rr < splits; ++rr)
          sg = __fadd_rn(sg, __ldcg(tpart + (gg * splits + rr) * COLS + tid));
      }
      const float sc = gg == 0   ? ps[0]
                       : gg == 1 ? ps[1]
                       : gg == 2 ? ps[2]
                       : gg == 3 ? ps[3]
                                 : scale[(size_t)gg * N + n];
      float y = __fmul_rn(sg, sc);
      if (gg == 0) y = __fadd_rn(y, pb);
      if constexpr (BITS == 8) {
        total = y;  // one group
      } else {
        if (!gelu) y = bf16_round(y);
        total = __fadd_rn(total, y);
      }
    }
    const float y = gelu ? gelu_new(total) : total;
    if (mode == 0) {
      reinterpret_cast<float*>(out)[n] = y;
    } else if (mode == 1) {
      reinterpret_cast<__nv_bfloat16*>(out)[n] = __float2bfloat16(y);
    } else {
      reinterpret_cast<float*>(out)[n] = __fadd_rn(po, y);
    }
  }
}

// ---------------------------------------------------------------------------
// decode_attention: flash-decode over a thread-block cluster.
//
// One query per head (hd = 64) over cache rows 0..idx. qkv: f32 [q | k | v]
// (3D) from the qkv gemv. The grid is (P, heads) with cluster (P, 1, 1),
// P = ATT_SPLITS: the P blocks of a head split the n = idx + 1 positions
// into contiguous chunks, rank r taking [att_lo(r, n), att_lo(r + 1, n)),
// so the last rank always holds idx and some chunks are empty when n < P.
// att_lo is the authority for the bounds; ops/decode_step.py
// attention_bounds is its Python copy, held against xt_attention_bounds
// on the card.
//
// Arithmetic of decode_attention_plain: q rounded to bf16, K and V bf16,
// scores f32 dot products times `scale`, softmax and the weighted sum in
// f32 divided by the denominator at the end, bf16 out. Every f32 operation
// is an explicitly rounded one (__fmul_rn / __fadd_rn, no fused
// multiply-add; expf, not __expf), in an order the plain twin
// (split_attention) repeats step by step with PyTorch's elementwise ops, so
// on the card kernel and twin give the same bits.
//
// Bound: bytes, the 2 x n x 128 bytes of a head's K and V rows (0.37 us
// for all 16 heads at n = 355 on 3.35 TB/s); the old one-block-a-head
// kernel walked them on 16 SMs in four dependent passes (47.8 us a call).
// Here, in each block of 128 threads, 16 groups of 8 lanes take rows
// g, g + 16, ...; a lane holds 8 dims (one 16-byte load a row of K and of
// V), and a group issues the K and V loads of 4 rows into registers before
// it computes their scores (a lane's 8 products summed in order, then a
// 3-shuffle tree) and folds them into an online softmax (m, l, o[8] a
// lane). The groups merge through shared memory in group order, then the
// P blocks through distributed shared memory: after cluster.sync() rank r
// reads every rank's (m, l, o) in rank order and finalises dims
// [64 r / P, 64 (r + 1) / P). No atomics, no scratch in device memory, no
// second launch, nothing of size idx in shared memory; the same inputs
// give the same bits. An empty partial is m = -inf, l = 0, o = 0, and its
// merge factor is 0, not exp(-inf - -inf).
//
// The new row: the last rank writes bf16(k), bf16(v) at idx and uses those
// values from registers for its own row idx, since blocks of one launch
// are not ordered; no other block reads row idx.
// ---------------------------------------------------------------------------
constexpr int ATT_THREADS = 128;
constexpr int ATT_GROUPS = ATT_THREADS / 8;   // 8 lanes a cache row
constexpr int ATT_BATCH = 4;                  // rows a group loads at once
constexpr int ATT_SPLITS = 8;                 // a portable cluster

// the first position of rank r's chunk of n
__host__ __device__ __forceinline__ int att_lo(int r, int n) {
  return (int)((long long)r * n / ATT_SPLITS);
}

__device__ __forceinline__ void bf16x8_to_f32(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// the merge factor of a partial with maximum m into the maximum M
__device__ __forceinline__ float merge_factor(float m, float M) {
  return m == -INFINITY ? 0.f : expf(__fsub_rn(m, M));
}

// acc + a b, rounded after the product and after the sum
__device__ __forceinline__ float add_mul(float acc, float a, float b) {
  return __fadd_rn(acc, __fmul_rn(a, b));
}

__global__ void __cluster_dims__(ATT_SPLITS, 1, 1)
__launch_bounds__(ATT_THREADS)
decode_attention_kernel(const float* __restrict__ qkv,
                        __nv_bfloat16* __restrict__ kc,
                        __nv_bfloat16* __restrict__ vc,
                        __nv_bfloat16* __restrict__ out,
                        const long long* __restrict__ idx_ptr, int d,
                        float scale) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ float gm[ATT_GROUPS], gl[ATT_GROUPS];
  __shared__ __align__(16) float go[ATT_GROUPS][64];
  __shared__ float bm, bl;          // this block's partial
  __shared__ float bo[64];
  constexpr int P = ATT_SPLITS;
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, grp = tid >> 3, l8 = tid & 7;
  const int c0 = blockIdx.y * 64;
  const int idx = (int)*idx_ptr;    // device memory: a graph replays it
  const int n = idx + 1;
  const int lo = att_lo(rank, n), hi = att_lo(rank + 1, n);
  const bool last = rank == P - 1;  // holds row idx

  float q[8], knew[8], vnew[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    q[i] = bf16_round(qkv[c0 + l8 * 8 + i]);
    knew[i] = last ? bf16_round(qkv[d + c0 + l8 * 8 + i]) : 0.f;
    vnew[i] = last ? bf16_round(qkv[2 * d + c0 + l8 * 8 + i]) : 0.f;
  }
  if (last && tid < 64) {
    kc[(size_t)idx * d + c0 + tid] = __float2bfloat16(qkv[d + c0 + tid]);
    vc[(size_t)idx * d + c0 + tid] = __float2bfloat16(qkv[2 * d + c0 + tid]);
  }

  // ---- this group's rows: online softmax, 4 rows of loads in flight ----
  float m = -INFINITY, l = 0.f, o[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = 0.f;
  // the trip count is the block's, not the group's: the score shuffles
  // need every lane of the warp
  for (int base = lo; base < hi; base += ATT_BATCH * ATT_GROUPS) {
    const int s0 = base + grp;
    uint4 kr[ATT_BATCH], vr[ATT_BATCH];  // rows past hi stay 0, not NaN
#pragma unroll
    for (int j = 0; j < ATT_BATCH; ++j) {
      const int s = s0 + j * ATT_GROUPS;
      kr[j] = vr[j] = make_uint4(0u, 0u, 0u, 0u);
      if (s < hi && s != idx) {
        const size_t off = (size_t)s * d + c0 + l8 * 8;
        kr[j] = __ldg(reinterpret_cast<const uint4*>(kc + off));
        vr[j] = __ldg(reinterpret_cast<const uint4*>(vc + off));
      }
    }
    float sc[ATT_BATCH], vf[ATT_BATCH][8];
    float mb = m;
#pragma unroll
    for (int j = 0; j < ATT_BATCH; ++j) {
      const int s = s0 + j * ATT_GROUPS;
      float kf[8];
      if (s == idx) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          kf[i] = knew[i];
          vf[j][i] = vnew[i];
        }
      } else {
        bf16x8_to_f32(kr[j], kf);
        bf16x8_to_f32(vr[j], vf[j]);
      }
      float p = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) p = add_mul(p, q[i], kf[i]);
      p = __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, 1));
      p = __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, 2));
      p = __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, 4));
      sc[j] = s < hi ? __fmul_rn(p, scale) : -INFINITY;
      mb = fmaxf(mb, sc[j]);
    }
    const float corr = merge_factor(m, mb);
    l = __fmul_rn(l, corr);
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = __fmul_rn(o[i], corr);
#pragma unroll
    for (int j = 0; j < ATT_BATCH; ++j) {
      const float e = merge_factor(sc[j], mb);
      l = __fadd_rn(l, e);
#pragma unroll
      for (int i = 0; i < 8; ++i) o[i] = add_mul(o[i], e, vf[j][i]);
    }
    m = mb;
  }

  // ---- the block's partial: its 16 groups in order ----
  if (l8 == 0) {
    gm[grp] = m;
    gl[grp] = l;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) go[grp][l8 * 8 + i] = o[i];
  __syncthreads();
  if (tid < 64) {
    float M = -INFINITY;
    for (int g = 0; g < ATT_GROUPS; ++g) M = fmaxf(M, gm[g]);
    float L = 0.f, O = 0.f;
    for (int g = 0; g < ATT_GROUPS; ++g) {
      const float f = merge_factor(gm[g], M);
      L = add_mul(L, gl[g], f);
      O = add_mul(O, go[g][tid], f);
    }
    bo[tid] = O;
    if (tid == 0) {
      bm = M;
      bl = L;
    }
  }
  cluster.sync();  // every rank's partial is written and visible

  // ---- the P partials, in rank order, through distributed shared memory;
  // rank r finalises dims [64 r / P, 64 (r + 1) / P) ----
  const int d0 = 64 * rank / P, d1 = 64 * (rank + 1) / P;
  if (tid < d1 - d0) {
    const int dim = d0 + tid;
    float pm[P], pl[P], po[P];
#pragma unroll
    for (int r = 0; r < P; ++r) {  // all loads in flight
      pm[r] = *cluster.map_shared_rank(&bm, r);
      pl[r] = *cluster.map_shared_rank(&bl, r);
      po[r] = cluster.map_shared_rank(bo, r)[dim];
    }
    float M = -INFINITY;
#pragma unroll
    for (int r = 0; r < P; ++r) M = fmaxf(M, pm[r]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int r = 0; r < P; ++r) {
      const float f = merge_factor(pm[r], M);
      L = add_mul(L, pl[r], f);
      O = add_mul(O, po[r], f);
    }
    out[c0 + dim] = __float2bfloat16(__fdiv_rn(O, L));
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

Norm make_norm(const void* s1, const void* b1, const void* s2, const void* b2,
               int n) {
  return Norm{(const float*)s1, (const float*)b1, (const float*)s2,
              (const float*)b2, n};
}

template <int BITS>
int launch_gemv(const void* x, Norm nrm, const void* w, const void* scale,
                const void* bias, void* out, void* part, void* count, int K,
                int N, int groups, int gelu, int mode, cudaStream_t stream) {
  constexpr int COLS = Gv<BITS>::COLS;
  const int splits = gv_splits(K, N, groups, COLS, Gv<BITS>::MAX_CHUNK);
  const int kg = K / groups;
  const int cmax = 16 * (((kg + 15) / 16 + splits - 1) / splits);
  const dim3 grid(groups * splits, (N + COLS - 1) / COLS);
  const size_t smem =
      (size_t)gv_wbytes<BITS>(cmax) + (size_t)cmax * sizeof(__nv_bfloat16);
  // a chunk is the whole row where nothing splits K
  const int ln = !nrm.n ? 0 : groups * splits == 1 ? 1 : 2;
  const uint8_t* wb = (const uint8_t*)w;
  const float *sc = (const float*)scale, *bi = (const float*)bias;
  float* pt = (float*)part;
  unsigned* ct = (unsigned*)count;
  if (ln == 0)
    gemv_kernel<BITS, 0><<<grid, GV_THREADS, smem, stream>>>(
        x, nrm, wb, sc, bi, out, pt, ct, K, N, groups, splits, gelu, mode);
  else if (ln == 1)
    gemv_kernel<BITS, 1><<<grid, GV_THREADS, smem, stream>>>(
        x, nrm, wb, sc, bi, out, pt, ct, K, N, groups, splits, gelu, mode);
  else
    gemv_kernel<BITS, 2><<<grid, GV_THREADS, smem, stream>>>(
        x, nrm, wb, sc, bi, out, pt, ct, K, N, groups, splits, gelu, mode);
  return (int)cudaGetLastError();
}

// the carveout that lets 5 blocks share an SM's memory (the head's 576
// blocks in one wave) for each instantiation of the gemv, on the current
// device
template <int BITS>
cudaError_t gemv_carveout() {
  const void* kernels[3] = {(const void*)gemv_kernel<BITS, 0>,
                            (const void*)gemv_kernel<BITS, 1>,
                            (const void*)gemv_kernel<BITS, 2>};
  for (const void* k : kernels) {
    const cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

template <int BITS>
void gemv_bounds(int K, int N, int groups, int* bounds) {
  const int s = gv_splits(K, N, groups, Gv<BITS>::COLS, Gv<BITS>::MAX_CHUNK);
  bounds[0] = s;
  for (int r = 0; r <= s; ++r) bounds[1 + r] = gv_lo(r, s, K / groups);
}

}  // namespace

XT_API int xt_layer_norm_rows(const void* x, const void* s1, const void* b1,
                              const void* s2, const void* b2, void* out,
                              int rows, int d, int nln, void* stream) {
  layer_norm_rows_kernel<<<rows, 256, d * sizeof(float),
                           (cudaStream_t)stream>>>(
      (const float*)x, make_norm(s1, b1, s2, b2, nln), (__nv_bfloat16*)out,
      d);
  return (int)cudaGetLastError();
}

// part: >= ceil(N / GV_COLS) x G x s x GV_COLS f32 of scratch; count:
// ceil(N / GV_COLS) counters, 0 before the launch and 0 after it (the last
// block of each column tile resets its own). One launch at a time may use
// them. The _ln entry points take the f32 residual (K,) as x32 and nln 1 or
// 2 norms (s1, b1[, s2, b2]) to apply first.
XT_API int xt_int8_gemv(const void* x, const void* w, const void* scale,
                        const void* bias, void* out, void* part, void* count,
                        int K, int N, int gelu, int mode, void* stream) {
  return launch_gemv<8>(x, make_norm(nullptr, nullptr, nullptr, nullptr, 0),
                        w, scale, bias, out, part, count, K, N, 1, gelu,
                        mode, (cudaStream_t)stream);
}

XT_API int xt_int8_gemv_ln(const void* x32, const void* s1, const void* b1,
                           const void* s2, const void* b2, int nln,
                           const void* w, const void* scale, const void* bias,
                           void* out, void* part, void* count, int K, int N,
                           int gelu, int mode, void* stream) {
  return launch_gemv<8>(x32, make_norm(s1, b1, s2, b2, nln), w, scale, bias,
                        out, part, count, K, N, 1, gelu, mode,
                        (cudaStream_t)stream);
}

XT_API int xt_int4_gemv(const void* x, const void* w, const void* scale,
                        const void* bias, void* out, void* part, void* count,
                        int K, int N, int groups, int gelu, int mode,
                        void* stream) {
  return launch_gemv<4>(x, make_norm(nullptr, nullptr, nullptr, nullptr, 0),
                        w, scale, bias, out, part, count, K, N, groups, gelu,
                        mode, (cudaStream_t)stream);
}

XT_API int xt_int4_gemv_ln(const void* x32, const void* s1, const void* b1,
                           const void* s2, const void* b2, int nln,
                           const void* w, const void* scale, const void* bias,
                           void* out, void* part, void* count, int K, int N,
                           int groups, int gelu, int mode, void* stream) {
  return launch_gemv<4>(x32, make_norm(s1, b1, s2, b2, nln), w, scale, bias,
                        out, part, count, K, N, groups, gelu, mode,
                        (cudaStream_t)stream);
}

// sets the gemv kernels' shared-memory carveout on the current device: the
// wrappers call it once a device and shape, before its first launch
XT_API int xt_gemv_setup() {
  const cudaError_t e = gemv_carveout<8>();
  return (int)(e != cudaSuccess ? e : gemv_carveout<4>());
}

// bounds[0] = s, the chunks of each scale group; bounds[1 + r] = gv_lo(r,
// s, K / groups) for r = 0..s: the split plans of int8_gemv and int4_gemv,
// for holding the Python copy against these
XT_API void xt_int8_gemv_bounds(int K, int N, int* bounds) {
  gemv_bounds<8>(K, N, 1, bounds);
}

XT_API void xt_int4_gemv_bounds(int K, int N, int groups, int* bounds) {
  gemv_bounds<4>(K, N, groups, bounds);
}

// idx: a device int64, the cache row of the new token (the TPU kernel's
// scalar-prefetched index), so one captured launch serves every step
XT_API int xt_decode_attention(const void* qkv, void* kc, void* vc, void* out,
                               const void* idx, int d, int heads, float scale,
                               void* stream) {
  decode_attention_kernel<<<dim3(ATT_SPLITS, heads), ATT_THREADS, 0,
                            (cudaStream_t)stream>>>(
      (const float*)qkv, (__nv_bfloat16*)kc, (__nv_bfloat16*)vc,
      (__nv_bfloat16*)out, (const long long*)idx, d, scale);
  return (int)cudaGetLastError();
}

// bounds[r] = att_lo(r, idx + 1) for r = 0..ATT_SPLITS: decode_attention's
// chunks, for holding the Python copy against this one
XT_API void xt_attention_bounds(int idx, int* bounds) {
  for (int r = 0; r <= ATT_SPLITS; ++r) bounds[r] = att_lo(r, idx + 1);
}
