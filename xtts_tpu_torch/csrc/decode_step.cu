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
// residual into the shared memory that holds the input vector anyway,
// normalises it there in f32 and rounds it to bf16 once. layer_norm_rows
// stays as the standalone norm; no path launches it.
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
// is ~57 us, against ~1 MB of KV cache and activations. The gemv keeps its
// weight reads coalesced (char4 per thread, 8 threads on 32 contiguous
// columns of a row) and holds the input vector in shared memory. At 76
// launches a token the chain is still launch-bound; a persistent
// single-launch step or a CUDA graph is later work.
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

// The product kernels' input vector, staged as f32 in xs[0..K): the bf16
// input as it is, or (the norm prologue, LN) the f32 residual normalised
// by nrm and rounded to bf16 once, bit for bit layer_norm_rows' output.
template <bool LN>
__device__ __forceinline__ void stage_input(const void* __restrict__ x,
                                            const Norm& nrm, float* xs,
                                            float* red, int K, int tid,
                                            int nthreads) {
  if constexpr (LN) {
    const float* x32 = reinterpret_cast<const float*>(x);
    for (int i = tid; i < K; i += nthreads) xs[i] = x32[i];
    __syncthreads();
    layer_norm_inplace(xs, K, nrm, red, tid, nthreads);
    for (int i = tid; i < K; i += nthreads) xs[i] = bf16_round(xs[i]);
  } else {
    const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(x);
    for (int i = tid; i < K; i += nthreads) xs[i] = __bfloat162float(xb[i]);
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// int8_gemv: y[n] = (sum_k x[k] w[k, n]) * scale[n] + bias[n]
// Block (8, 32): threadIdx.x picks 4 adjacent columns (one char4 load),
// threadIdx.y strides K; the 32 partial sums per column reduce through
// shared memory. One block per 32 columns, full K per block, so the
// epilogue (gelu_new, bf16 store, or += into the f32 residual) runs in
// place. mode: 0 = store f32, 1 = store bf16, 2 = accumulate into f32.
// The order of the sums: partial r (r < GEMV_KTHREADS) adds x[k] w[k, n]
// for k = r, r + 32, ... in turn (bf16 x int8 products are exact in f32,
// so each fmaf is one rounded add); the partials add in r order. The
// plain twin (ops/decode_step.py int8_gemv_plain) repeats both.
// LN: x is the f32 residual and the block normalises it first (above).
// ---------------------------------------------------------------------------
constexpr int GEMV_COLS = 32;
constexpr int GEMV_KTHREADS = 32;

template <bool LN>
__global__ void __launch_bounds__(256)
int8_gemv_kernel(const void* __restrict__ x, Norm nrm,
                 const int8_t* __restrict__ w,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias, void* __restrict__ out, int K,
                 int N, int gelu, int mode) {
  extern __shared__ float xs[];  // K floats
  __shared__ float red[GEMV_KTHREADS][GEMV_COLS + 1];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  stage_input<LN>(x, nrm, xs, &red[0][0], K, tid, 256);

  const int n0 = blockIdx.x * GEMV_COLS + threadIdx.x * 4;
  const char4* wp = reinterpret_cast<const char4*>(w + n0);
  const size_t row = (size_t)N / 4;  // row stride in char4
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 4
  for (int k = threadIdx.y; k < K; k += GEMV_KTHREADS) {
    const char4 c = __ldg(wp + (size_t)k * row);
    const float xv = xs[k];
    a0 = fmaf(xv, (float)c.x, a0);
    a1 = fmaf(xv, (float)c.y, a1);
    a2 = fmaf(xv, (float)c.z, a2);
    a3 = fmaf(xv, (float)c.w, a3);
  }
  red[threadIdx.y][threadIdx.x * 4 + 0] = a0;
  red[threadIdx.y][threadIdx.x * 4 + 1] = a1;
  red[threadIdx.y][threadIdx.x * 4 + 2] = a2;
  red[threadIdx.y][threadIdx.x * 4 + 3] = a3;
  __syncthreads();
  if (tid < GEMV_COLS) {
    float s = 0.f;
#pragma unroll 8
    for (int r = 0; r < GEMV_KTHREADS; ++r) s += red[r][tid];
    const int n = blockIdx.x * GEMV_COLS + tid;
    // product and sum rounded separately, never contracted into an FMA:
    // int8_gemv_plain repeats this epilogue to the bit
    float y = __fadd_rn(__fmul_rn(s, scale[n]), bias[n]);
    if (gelu) y = gelu_new(y);
    if (mode == 0) {
      reinterpret_cast<float*>(out)[n] = y;
    } else if (mode == 1) {
      reinterpret_cast<__nv_bfloat16*>(out)[n] = __float2bfloat16(y);
    } else {
      reinterpret_cast<float*>(out)[n] += y;
    }
  }
}

// ---------------------------------------------------------------------------
// int4_gemv: the K1 int4 mode (the wbits == 4 branch of the TPU kernel,
// xtts_tpu/ops/decode_step.py:157-167).
//
//   y[n] = sum_g r( (sum_{k in g} x[k] w4[k, n]) * scale[g, n] + (g == 0) bias[n] )
//
// w4 (K, N/2) bytes: byte (k, j) holds column 2j in its low nibble and
// column 2j+1 in its high nibble, both signed in [-7, 7]; scale (G, N) f32,
// one row per group of K/G input rows (the TPU kernel's (D, D) tiles: four
// groups for the MLP out matrix, one elsewhere). r() rounds a group's output
// to bf16, as the TPU kernel does for every tile it restores to canonical
// order; with gelu (the fc tiles, left permuted there) nothing is rounded
// before gelu_new. mode: 0 = store f32, 1 = store bf16, 2 = add into f32.
// LN: the norm prologue, as int8_gemv's.
//
// Bound: the packed weights, half of int8_gemv's bytes (~99 MB a token at
// the flagship width, ~30 us at 3.35 TB/s; 2 MB for fc, 0.6 us). At these
// sizes a call is a chain of latencies (a launch, a round trip for the
// weights, the products, the reduction, the stores), and the design cuts
// the chain:
//  - Every SM streams: a block owns I4_COLS = 32 output columns (16 bytes
//    of a weight row) and one chunk of the K rows of one scale group, so a
//    group's bf16 rounding still applies to the group's whole sum. The
//    grid is (G x s, N / 32): qkv 96 blocks, proj 32, fc 128, out 4 x 32,
//    head 288. i4_splits picks s, the chunks of a group: 1 wherever N / 32
//    x G gives >= 32 blocks (every K1 product), more for narrow products,
//    and no chunk over 2048 rows. i4_lo gives the chunk bounds (multiples
//    of 16 rows); ops/decode_step.py int4_gemv_plan is their Python copy,
//    held against xt_int4_gemv_bounds on the card.
//  - Nothing waits before everything is in flight: the input's loads and
//    the epilogue's operands (bias, scales, the residual) first, then the
//    whole chunk (<= 32 KB) as 16-byte cp.async copies in I4_STAGES
//    commit groups; the products start on the first group while the later
//    ones land. (Issued after the weights, the input's loads queued behind
//    them: 1.0 us more at fc. Split over K across 128-192 blocks of 128
//    columns, every product's partials merged by the last block to
//    arrive, the chain held more round trips: 5.0-5.2 us for proj and fc
//    against 4.4-4.5 without the merge's fence and counter. H100,
//    PERF.md.)
//  - Nibbles widen without I2F: one lop3 a word gives the four low
//    nibbles as bytes v + 8 (the high ones take one shift more), and a
//    byte_perm into the mantissa of 2^23 then one subtraction gives each v
//    exactly as f32.
//  - f32 FMA: thread (lane l < 64, word j < 4) holds 8 accumulators, the
//    columns of its 4-byte word, and adds rows lo + l, lo + l + 64, ... in
//    turn. bf16 x int4 products are exact in f32, so each fmaf is one
//    rounded add.
//  - A fixed order throughout, so the same inputs give the same bits and the
//    plain twin (int4_gemv_plain) repeats the sums to the bit: lanes 8h ..
//    8h + 7 of a column add in order, then the 8 sums h in order. Where a
//    product has several chunks (the four groups of out), each block leaves
//    its sums in global scratch and the last block of a column tile to
//    arrive (one atomic counter a tile, which it resets to 0) adds the
//    tile's chunks in split order and runs the epilogue for each group in
//    group order. Every f32 operation there is an explicitly rounded one.
//  - The norm prologue takes the row's statistics once a block, in
//    layer_norm_rows' summation order: where the chunk is the whole row,
//    from the registers of threads t < 256, which hold elements t, t +
//    256, ... (warp and block butterflies); a split chunk takes them by one
//    warp (common.cuh row_norm_stats). It normalises only its chunk.
// ---------------------------------------------------------------------------
constexpr int I4_COLS = 32;         // output columns a block: 16 bytes a row
constexpr int I4_THREADS = 256;
constexpr int I4_WORDS = I4_COLS / 8;            // 4-byte words a row
constexpr int I4_LANES = I4_THREADS / I4_WORDS;  // rows lo + l, + LANES, ...
constexpr int I4_FOLD = 8;          // lanes summed a first-level sum
constexpr int I4_ROWB = I4_COLS / 2;             // bytes a row
constexpr int I4_STAGES = 4;        // cp.async groups a chunk is issued in
constexpr int I4_MIN_BLOCKS = 32;   // split K only below this many blocks
constexpr int I4_MIN_CHUNK = 64;    // rows: no finer split for more blocks
constexpr int I4_MAX_CHUNK = 2048;  // rows: 32 KB of packed weights a block
constexpr int I4_PRE = I4_MAX_CHUNK / 256;  // residual rows a thread
static_assert(I4_ROWB % 16 == 0, "whole 16-byte copies a row");
static_assert(I4_LANES % I4_FOLD == 0, "whole first-level sums");
static_assert(I4_THREADS % 256 == 0, "the norm statistics take 256 threads");

// chunks of each scale group (kg rows of K = G kg) for N columns
__host__ __device__ __forceinline__ int i4_splits(int K, int N, int groups) {
  const int kg = K / groups, t = (kg + 15) / 16;
  const int tiles = (N + I4_COLS - 1) / I4_COLS;
  int s = 1;
  while (s < 16 && tiles * groups * s < I4_MIN_BLOCKS &&
         kg / (2 * s) >= I4_MIN_CHUNK)
    s *= 2;
  while (16 * ((t + s - 1) / s) > I4_MAX_CHUNK) s *= 2;
  return s;
}

// the first row of chunk r of s in a group of kg rows, relative to the
// group: 16 floor(r T / s), T = ceil(kg / 16), clipped to kg
__host__ __device__ __forceinline__ int i4_lo(int r, int s, int kg) {
  const int k = r * ((kg + 15) / 16) / s * 16;
  return k < kg ? k : kg;
}

// byte i of u (a nibble + 8) as f32 minus 8, exactly: 2^23 + b - (2^23 + 8)
__device__ __forceinline__ float nib_f32(uint32_t u, int i) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + i)) -
         8388616.f;
}

__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {  // groups still in flight allowed
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}
static_assert(I4_STAGES == 4, "cp_async_wait_upto covers 4 groups");

template <bool LN>
__global__ void __launch_bounds__(I4_THREADS)
int4_gemv_kernel(const void* __restrict__ x, Norm nrm,
                 const uint8_t* __restrict__ w,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias, void* __restrict__ out,
                 float* __restrict__ part, unsigned* __restrict__ count,
                 int K, int N, int groups, int splits, int gelu, int mode) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kg = K / groups;
  const int cmax = 16 * (((kg + 15) / 16 + splits - 1) / splits);
  // [row][4 words] weights; red [64 lanes][32] after the products
  const int wbytes = max(cmax * I4_ROWB, I4_LANES * I4_COLS * 4);
  uint32_t* ws = reinterpret_cast<uint32_t*>(smem);
  float* red = reinterpret_cast<float*>(smem);
  float* xs = reinterpret_cast<float*>(smem + wbytes);  // the chunk of x
  __shared__ float fold[I4_LANES / I4_FOLD][I4_COLS];
  __shared__ float st[4], st_red[8];
  __shared__ bool last;

  const int tid = threadIdx.x, ns = gridDim.x, q = blockIdx.x;
  const int tile = blockIdx.y, n0 = tile * I4_COLS;
  const int g = q / splits, r = q - g * splits;
  const int lo = g * kg + i4_lo(r, splits, kg);
  const int rows = g * kg + i4_lo(r + 1, splits, kg) - lo;
  const size_t rowb = (size_t)N / 2;
  // rows a commit group, a multiple of the lane count
  const int rs = (rows + I4_STAGES * I4_LANES - 1) / (I4_STAGES * I4_LANES) *
                 I4_LANES;

  // the chunk's weights, all in flight: 16-byte copies in I4_STAGES
  // commit groups, issued once the input's loads are (so that those do not
  // queue behind 16-32 KB of weights)
  auto issue_weights = [&]() {
    constexpr int CPR = I4_ROWB / 16;  // copies a row
    for (int s = 0; s < I4_STAGES; ++s) {
      const int r0 = s * rs, r1 = min(rows, r0 + rs);
      for (int c = r0 * CPR + tid; c < r1 * CPR; c += I4_THREADS) {
        const int row = c / CPR, part16 = c % CPR;
        const bool ok = n0 + 32 * part16 < N;  // N % 32 == 0
        cp_async16(smem_u32(smem + row * I4_ROWB + part16 * 16),
                   ok ? w + (size_t)(lo + row) * rowb + n0 / 2 + part16 * 16
                      : w,
                   ok);
      }
      cp_async_commit();
    }
  };

  // ---- the epilogue's operands, loaded now ----
  const int n = n0 + (tid & (I4_COLS - 1));
  float pb = 0.f, ps[4] = {0.f, 0.f, 0.f, 0.f}, po = 0.f;
  if (tid < I4_COLS && n < N) {
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
  if constexpr (LN) {
    const float* x32 = reinterpret_cast<const float*>(x);
    float xv[I4_PRE], s1[I4_PRE], b1[I4_PRE], s2[I4_PRE], b2[I4_PRE];
    const bool whole = rows == K;  // the block's chunk is the whole row
    if (tid < 256) {
#pragma unroll
      for (int j = 0; j < I4_PRE; ++j) {
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
    }
    issue_weights();

    if (whole) {
      // the statistics from the registers, in layer_norm_rows' order:
      // each thread's elements in turn, the warp by a butterfly, the 8
      // warp sums by a butterfly
      const int lane32 = tid & 31, warp = tid >> 5;
      auto block_sum = [&](auto f) {
        float a = 0.f;
        if (tid < 256) {
#pragma unroll
          for (int j = 0; j < I4_PRE; ++j)
            if (tid + j * 256 < rows) a += f(j);
          a = warp_sum(a);
          if (lane32 == 0) st_red[warp] = a;
        }
        __syncthreads();
        const float t = warp_sum(lane32 < 8 ? st_red[lane32] : 0.f);
        __syncthreads();  // st_red is free again
        return t;
      };
      for (int p = 0; p < nrm.n; ++p) {
        const float mu = block_sum([&](int j) { return xv[j]; }) / K;
        const float var = block_sum([&](int j) {
          const float c = xv[j] - mu;
          return c * c;
        }) / K;
        const float rstd = rsqrtf(var + 1e-5f);
#pragma unroll
        for (int j = 0; j < I4_PRE; ++j)
          xv[j] = p ? ln_apply(xv[j], mu, rstd, s2[j], b2[j])
                    : ln_apply(xv[j], mu, rstd, s1[j], b1[j]);
      }
    } else {
      if (tid < 32) row_norm_stats(x32, K, nrm, tid, st);
      __syncthreads();
      if (tid < 256) {
#pragma unroll
        for (int j = 0; j < I4_PRE; ++j) {
          xv[j] = ln_apply(xv[j], st[0], st[1], s1[j], b1[j]);
          if (nrm.n == 2) xv[j] = ln_apply(xv[j], st[2], st[3], s2[j], b2[j]);
        }
      }
    }
    if (tid < 256) {
#pragma unroll
      for (int j = 0; j < I4_PRE; ++j)
        if (tid + j * 256 < rows) xs[tid + j * 256] = bf16_round(xv[j]);
    }
  } else {
    const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(x);
    constexpr int XPRE = (I4_MAX_CHUNK + I4_THREADS - 1) / I4_THREADS;
    __nv_bfloat16 xv[XPRE];
#pragma unroll
    for (int j = 0; j < XPRE; ++j) {
      const int i = tid + j * I4_THREADS;
      if (i < rows) xv[j] = xb[lo + i];
    }
    issue_weights();

#pragma unroll
    for (int j = 0; j < XPRE; ++j) {
      const int i = tid + j * I4_THREADS;
      if (i < rows) xs[i] = __bfloat162float(xv[j]);
    }
  }

  // ---- the products: lane l, word j; low nibbles are the even columns ----
  const int j = tid % I4_WORDS, lane = tid / I4_WORDS;
  float alo[4], ahi[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) alo[i] = ahi[i] = 0.f;
  for (int s = 0; s < I4_STAGES; ++s) {
    cp_async_wait_upto(I4_STAGES - 1 - s);
    __syncthreads();  // group s of every thread, and xs, are visible
    const int r1 = min(rows, (s + 1) * rs);
#pragma unroll 4
    for (int row = s * rs + lane; row < r1; row += I4_LANES) {
      const uint32_t wd = ws[row * I4_WORDS + j];
      const float xv = xs[row];
      const uint32_t lo4 = (wd & 0x0F0F0F0Fu) ^ 0x08080808u;
      const uint32_t hi4 = ((wd >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        alo[i] = fmaf(xv, nib_f32(lo4, i), alo[i]);
        ahi[i] = fmaf(xv, nib_f32(hi4, i), ahi[i]);
      }
    }
  }
  __syncthreads();  // every warp is done with ws, which red reuses

  // ---- the chunk's sums: lanes 8h .. 8h + 7 in order, then h in order ----
  float4* rp = reinterpret_cast<float4*>(red + lane * I4_COLS + 8 * j);
  rp[0] = make_float4(alo[0], ahi[0], alo[1], ahi[1]);
  rp[1] = make_float4(alo[2], ahi[2], alo[3], ahi[3]);
  __syncthreads();
  {
    const int c = tid % I4_COLS, h = tid / I4_COLS;
    float p = 0.f;
#pragma unroll
    for (int l = 0; l < I4_FOLD; ++l)
      p = __fadd_rn(p, red[(h * I4_FOLD + l) * I4_COLS + c]);
    fold[h][c] = p;
  }
  __syncthreads();
  float sum = 0.f;  // this chunk's sum of column n (threads < 32)
  if (tid < I4_COLS) {
#pragma unroll
    for (int h = 0; h < I4_LANES / I4_FOLD; ++h)
      sum = __fadd_rn(sum, fold[h][tid]);
  }

  if (ns > 1) {
    // several chunks: the last block of the tile to arrive merges them
    float* tpart = part + (size_t)tile * ns * I4_COLS;  // [chunk][32]
    if (tid < I4_COLS) {
      tpart[q * I4_COLS + tid] = sum;
      __threadfence();  // the sum is visible before the count moves
    }
    __syncthreads();
    if (tid == 0) last = atomicAdd(count + tile, 1u) == (unsigned)ns - 1;
    __syncthreads();
    if (!last) return;
    if (tid == 0) count[tile] = 0;  // every block of the tile has counted
  }

  // ---- the epilogue: each group's sum (its chunks in order) times its
  // scales, + bias for group 0, rounded to bf16 unless gelu, in group
  // order ----
  if (tid < I4_COLS && n < N) {
    const float* tpart = part + (size_t)tile * ns * I4_COLS;
    float total = 0.f;
    for (int gg = 0; gg < groups; ++gg) {
      float sg = 0.f;
      if (ns == 1) {
        sg = sum;
      } else {
#pragma unroll 4
        for (int rr = 0; rr < splits; ++rr)
          sg = __fadd_rn(sg, __ldcg(tpart + (gg * splits + rr) * I4_COLS +
                                    tid));
      }
      const float sc = gg == 0   ? ps[0]
                       : gg == 1 ? ps[1]
                       : gg == 2 ? ps[2]
                       : gg == 3 ? ps[3]
                                 : scale[(size_t)gg * N + n];
      float y = __fmul_rn(sg, sc);
      if (gg == 0) y = __fadd_rn(y, pb);
      if (!gelu) y = bf16_round(y);
      total = __fadd_rn(total, y);
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
                        __nv_bfloat16* __restrict__ out, int idx, int d,
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

int launch_int8_gemv(const void* x, Norm nrm, const void* w,
                     const void* scale, const void* bias, void* out, int K,
                     int N, int gelu, int mode, cudaStream_t stream) {
  dim3 block(GEMV_COLS / 4, GEMV_KTHREADS);
  const size_t smem = (size_t)K * sizeof(float);
  if (nrm.n)
    int8_gemv_kernel<true><<<N / GEMV_COLS, block, smem, stream>>>(
        x, nrm, (const int8_t*)w, (const float*)scale, (const float*)bias,
        out, K, N, gelu, mode);
  else
    int8_gemv_kernel<false><<<N / GEMV_COLS, block, smem, stream>>>(
        x, nrm, (const int8_t*)w, (const float*)scale, (const float*)bias,
        out, K, N, gelu, mode);
  return (int)cudaGetLastError();
}

int launch_int4_gemv(const void* x, Norm nrm, const void* w,
                     const void* scale, const void* bias, void* out,
                     void* part, void* count, int K, int N, int groups,
                     int gelu, int mode, cudaStream_t stream) {
  const int splits = i4_splits(K, N, groups);
  const int kg = K / groups;
  const int cmax = 16 * (((kg + 15) / 16 + splits - 1) / splits);
  const int wbytes = cmax * I4_ROWB > I4_LANES * I4_COLS * 4
                         ? cmax * I4_ROWB
                         : I4_LANES * I4_COLS * 4;
  const size_t smem = (size_t)wbytes + (size_t)cmax * sizeof(float);
  const dim3 grid(groups * splits, (N + I4_COLS - 1) / I4_COLS);
  if (nrm.n)
    int4_gemv_kernel<true><<<grid, I4_THREADS, smem, stream>>>(
        x, nrm, (const uint8_t*)w, (const float*)scale, (const float*)bias,
        out, (float*)part, (unsigned*)count, K, N, groups, splits, gelu,
        mode);
  else
    int4_gemv_kernel<false><<<grid, I4_THREADS, smem, stream>>>(
        x, nrm, (const uint8_t*)w, (const float*)scale, (const float*)bias,
        out, (float*)part, (unsigned*)count, K, N, groups, splits, gelu,
        mode);
  return (int)cudaGetLastError();
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

XT_API int xt_int8_gemv(const void* x, const void* w, const void* scale,
                        const void* bias, void* out, int K, int N, int gelu,
                        int mode, void* stream) {
  return launch_int8_gemv(x, make_norm(nullptr, nullptr, nullptr, nullptr, 0),
                          w, scale, bias, out, K, N, gelu, mode,
                          (cudaStream_t)stream);
}

// x32: the f32 residual (K,); nln 1 or 2 norms (s1, b1[, s2, b2]) first
XT_API int xt_int8_gemv_ln(const void* x32, const void* s1, const void* b1,
                           const void* s2, const void* b2, int nln,
                           const void* w, const void* scale, const void* bias,
                           void* out, int K, int N, int gelu, int mode,
                           void* stream) {
  return launch_int8_gemv(x32, make_norm(s1, b1, s2, b2, nln), w, scale,
                          bias, out, K, N, gelu, mode, (cudaStream_t)stream);
}

// part: >= N / 32 x G x s x 32 f32 of scratch; count: N / 32 counters, 0
// before the launch and 0 after it (the last block of each column tile
// resets its own). One launch at a time may use them.
XT_API int xt_int4_gemv(const void* x, const void* w, const void* scale,
                        const void* bias, void* out, void* part, void* count,
                        int K, int N, int groups, int gelu, int mode,
                        void* stream) {
  return launch_int4_gemv(x, make_norm(nullptr, nullptr, nullptr, nullptr, 0),
                          w, scale, bias, out, part, count, K, N, groups,
                          gelu, mode, (cudaStream_t)stream);
}

XT_API int xt_int4_gemv_ln(const void* x32, const void* s1, const void* b1,
                           const void* s2, const void* b2, int nln,
                           const void* w, const void* scale, const void* bias,
                           void* out, void* part, void* count, int K, int N,
                           int groups, int gelu, int mode, void* stream) {
  return launch_int4_gemv(x32, make_norm(s1, b1, s2, b2, nln), w, scale,
                          bias, out, part, count, K, N, groups, gelu, mode,
                          (cudaStream_t)stream);
}

// bounds[0] = s, the chunks of each scale group; bounds[1 + r] = i4_lo(r,
// s, K / groups) for r = 0..s: int4_gemv's split plan, for holding the
// Python copy against this one
XT_API void xt_int4_gemv_bounds(int K, int N, int groups, int* bounds) {
  const int s = i4_splits(K, N, groups);
  bounds[0] = s;
  for (int r = 0; r <= s; ++r) bounds[1 + r] = i4_lo(r, s, K / groups);
}

XT_API int xt_decode_attention(const void* qkv, void* kc, void* vc, void* out,
                               int idx, int d, int heads, float scale,
                               void* stream) {
  decode_attention_kernel<<<dim3(ATT_SPLITS, heads), ATT_THREADS, 0,
                            (cudaStream_t)stream>>>(
      (const float*)qkv, (__nv_bfloat16*)kc, (__nv_bfloat16*)vc,
      (__nv_bfloat16*)out, idx, d, scale);
  return (int)cudaGetLastError();
}

// int8_gemv's partial sums a column (int8_gemv_plain's GEMV_KTHREADS)
XT_API int xt_gemv_kthreads() { return GEMV_KTHREADS; }

// bounds[r] = att_lo(r, idx + 1) for r = 0..ATT_SPLITS: decode_attention's
// chunks, for holding the Python copy against this one
XT_API void xt_attention_bounds(int idx, int* bounds) {
  for (int r = 0; r <= ATT_SPLITS; ++r) bounds[r] = att_lo(r, idx + 1);
}
