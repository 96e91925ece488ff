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
// f32 softmax attention over cache rows 0..idx.
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
// decode_attention: one block per head (hd = 64), 128 threads.
// qkv: f32 [q | k | v] (3D) from the qkv gemv. The new k/v row is rounded
// to bf16 and written into the cache at idx, then the head attends over
// rows 0..idx: q rounded to bf16 (as the TPU kernel feeds its MXU), scores
// and softmax in f32, f32 weighted sum of the bf16 values, bf16 out.
// A warp covers one cache row per iteration (2 dims a lane, 128-byte reads).
// ---------------------------------------------------------------------------
__global__ void decode_attention_kernel(const float* __restrict__ qkv,
                                        __nv_bfloat16* __restrict__ kc,
                                        __nv_bfloat16* __restrict__ vc,
                                        __nv_bfloat16* __restrict__ out,
                                        int idx, int d, float scale) {
  extern __shared__ float sc[];  // idx + 1 scores
  __shared__ float red[33];
  __shared__ float part[4][64];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int c0 = blockIdx.x * 64;
  if (threadIdx.x < 64) {
    kc[(size_t)idx * d + c0 + threadIdx.x] =
        __float2bfloat16(qkv[d + c0 + threadIdx.x]);
    vc[(size_t)idx * d + c0 + threadIdx.x] =
        __float2bfloat16(qkv[2 * d + c0 + threadIdx.x]);
  }
  __syncthreads();

  const float q0 = bf16_round(qkv[c0 + 2 * lane]);
  const float q1 = bf16_round(qkv[c0 + 2 * lane + 1]);
  const int n = idx + 1;
  for (int s = warp; s < n; s += nwarps) {
    const float2 kf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
        kc + (size_t)s * d + c0 + 2 * lane));
    const float p = warp_sum(q0 * kf.x + q1 * kf.y);
    if (lane == 0) sc[s] = p * scale;
  }
  __syncthreads();

  float m = -INFINITY;
  for (int s = threadIdx.x; s < n; s += blockDim.x) m = fmaxf(m, sc[s]);
  m = block_reduce<true>(m, red);
  float l = 0.f;
  for (int s = threadIdx.x; s < n; s += blockDim.x) {
    const float e = __expf(sc[s] - m);
    sc[s] = e;
    l += e;
  }
  l = block_reduce<false>(l, red);  // its barriers also publish sc[]

  float o0 = 0.f, o1 = 0.f;
  for (int s = warp; s < n; s += nwarps) {
    const float p = sc[s];
    const float2 vf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
        vc + (size_t)s * d + c0 + 2 * lane));
    o0 = fmaf(p, vf.x, o0);
    o1 = fmaf(p, vf.y, o1);
  }
  part[warp][2 * lane] = o0;
  part[warp][2 * lane + 1] = o1;
  __syncthreads();
  if (threadIdx.x < 64) {
    float o = 0.f;
    for (int w = 0; w < nwarps; ++w) o += part[w][threadIdx.x];
    out[c0 + threadIdx.x] = __float2bfloat16(o / l);
  }
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
  decode_attention_kernel<<<heads, 128, (idx + 1) * sizeof(float),
                            (cudaStream_t)stream>>>(
      (const float*)qkv, (__nv_bfloat16*)kc, (__nv_bfloat16*)vc,
      (__nv_bfloat16*)out, idx, d, scale);
  return (int)cudaGetLastError();
}
