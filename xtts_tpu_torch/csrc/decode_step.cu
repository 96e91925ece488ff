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
    float y = s * scale[n] + bias[n];
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
// the flagship width, ~30 us at 3.35 TB/s). Block (2, 64): threadIdx.x
// picks 32 adjacent columns read as one 16-byte load of 16 bytes, so two
// threads cover a block's 64 columns with one 32-byte sector a row;
// threadIdx.y strides K. The input vector sits in shared memory as f32.
// A group's 32 partial sums a thread reduce over the warp by shuffles and
// over the block's 4 warps through shared memory; the epilogue thread of
// each column keeps the running sum over groups.
// ---------------------------------------------------------------------------
constexpr int I4_COLS = 64;
constexpr int I4_KTHREADS = 64;

// the signed nibbles of byte i of a 32-bit word: low = (b << 28) >> 28,
// high = ((int)(int8_t)b) >> 4, as the TPU kernel widens them (:159-161)
__device__ __forceinline__ int nib_lo(uint32_t w, int i) {
  return ((int)(w << (28 - 8 * i))) >> 28;
}
__device__ __forceinline__ int nib_hi(uint32_t w, int i) {
  return ((int)(w << (24 - 8 * i))) >> 28;
}

template <bool LN>
__global__ void __launch_bounds__(128)
int4_gemv_kernel(const void* __restrict__ x, Norm nrm,
                 const uint8_t* __restrict__ w,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias, void* __restrict__ out, int K,
                 int N, int groups, int gelu, int mode) {
  extern __shared__ float xs[];  // K floats
  __shared__ float red[4][I4_COLS];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  stage_input<LN>(x, nrm, xs, &red[0][0], K, tid, 128);

  const int c0 = blockIdx.x * I4_COLS + threadIdx.x * 32;
  const bool live = c0 < N;  // N % 64 == 32 leaves the last half-block idle
  const uint4* wp = reinterpret_cast<const uint4*>(w + c0 / 2);
  const size_t row = (size_t)N / 32;  // row stride in uint4 (N/2 bytes)
  const int kg = K / groups;
  const int lane = tid & 31, warp = tid >> 5;
  const int n = blockIdx.x * I4_COLS + tid;  // the epilogue's column
  float total = 0.f;
  for (int g = 0; g < groups; ++g) {
    float a[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) a[j] = 0.f;
    if (live) {
#pragma unroll 2
      for (int k = g * kg + threadIdx.y; k < (g + 1) * kg; k += I4_KTHREADS) {
        const uint4 q = __ldg(wp + (size_t)k * row);
        const float xv = xs[k];
        const uint32_t words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int v = 0; v < 4; ++v) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            a[8 * v + 2 * i] = fmaf(xv, (float)nib_lo(words[v], i),
                                    a[8 * v + 2 * i]);
            a[8 * v + 2 * i + 1] = fmaf(xv, (float)nib_hi(words[v], i),
                                        a[8 * v + 2 * i + 1]);
          }
        }
      }
    }
    // lanes differ in threadIdx.x (bit 0) and 16 threadIdx.y (bits 1-4)
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      float v = a[j];
      for (int o = 2; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      a[j] = v;
    }
    if ((lane >> 1) == 0) {
#pragma unroll
      for (int j = 0; j < 32; ++j) red[warp][threadIdx.x * 32 + j] = a[j];
    }
    __syncthreads();
    if (tid < I4_COLS && n < N) {
      const float s = red[0][tid] + red[1][tid] + red[2][tid] + red[3][tid];
      float y = s * scale[(size_t)g * N + n] + (g == 0 ? bias[n] : 0.f);
      if (!gelu) y = bf16_round(y);
      total += y;
    }
    __syncthreads();
  }
  if (tid < I4_COLS && n < N) {
    const float y = gelu ? gelu_new(total) : total;
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
                     const void* scale, const void* bias, void* out, int K,
                     int N, int groups, int gelu, int mode,
                     cudaStream_t stream) {
  dim3 block(2, I4_KTHREADS);
  const int grid = (N + I4_COLS - 1) / I4_COLS;
  const size_t smem = (size_t)K * sizeof(float);
  if (nrm.n)
    int4_gemv_kernel<true><<<grid, block, smem, stream>>>(
        x, nrm, (const uint8_t*)w, (const float*)scale, (const float*)bias,
        out, K, N, groups, gelu, mode);
  else
    int4_gemv_kernel<false><<<grid, block, smem, stream>>>(
        x, nrm, (const uint8_t*)w, (const float*)scale, (const float*)bias,
        out, K, N, groups, gelu, mode);
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

XT_API int xt_int4_gemv(const void* x, const void* w, const void* scale,
                        const void* bias, void* out, int K, int N, int groups,
                        int gelu, int mode, void* stream) {
  return launch_int4_gemv(x, make_norm(nullptr, nullptr, nullptr, nullptr, 0),
                          w, scale, bias, out, K, N, groups, gelu, mode,
                          (cudaStream_t)stream);
}

XT_API int xt_int4_gemv_ln(const void* x32, const void* s1, const void* b1,
                           const void* s2, const void* b2, int nln,
                           const void* w, const void* scale, const void* bias,
                           void* out, int K, int N, int groups, int gelu,
                           int mode, void* stream) {
  return launch_int4_gemv(x32, make_norm(s1, b1, s2, b2, nln), w, scale,
                          bias, out, K, N, groups, gelu, mode,
                          (cudaStream_t)stream);
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

// bounds[r] = att_lo(r, idx + 1) for r = 0..ATT_SPLITS: decode_attention's
// chunks, for holding the Python copy against this one
XT_API void xt_attention_bounds(int idx, int* bounds) {
  for (int r = 0; r <= ATT_SPLITS; ++r) bounds[r] = att_lo(r, idx + 1);
}
