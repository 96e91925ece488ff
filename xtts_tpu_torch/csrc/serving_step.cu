// K4 for Hopper: the B-row int8 GPT serving decode step over an int8 KV
// cache, as a short chain of kernels.
//
// Replaces the Pallas TPU kernel xtts_tpu/ops/serving_step.py
// (_make_serving_kernel, launched by _fused_serving_logits), which ran the
// whole B-row token step in one pallas_call, streaming (D, D) int8 weight
// tiles and (B, Sc, D) int8 cache chunks through VMEM rings. On the H100:
//
//   per layer:  int8_gemm_rows(ln_1 prologue, qkv)
//               -> serving_attention (new rows quantized into the cache,
//                  softmax over the int8 cache, exact self term)
//               -> int8_gemm_rows(proj, += the f32 residual)
//               -> int8_gemm_rows(ln_2 prologue, fc, gelu_new, bf16)
//               -> int8_gemm_rows(out, K = 4D, += residual)
//   then:       int8_gemm_rows(ln_f then final_norm prologue, head)
//
// 76 launches a step at 15 layers: the LayerNorms run as the prologue of
// the product that consumes them (common.cuh), as in the TPU kernel.
//
// Numerics mirror the TPU kernel: an f32 residual; bf16 inputs to every
// int8 weight product with f32 accumulation; per-output-channel scale and
// bias; gelu_new; each new k/v row quantized over D (scale max|y|/127,
// floor 1e-8/127, round half to even, clip +-127) and written at `idx`;
// scores q.k over positions < idx from the int8 cache with the k scale
// folded in (each q*k product rounded to bf16, as the TPU kernel's bf16
// VPU product), the current token's own k/v taken unquantized in closed
// form; probabilities rounded to bf16 before the v sum, the v scale folded
// into it, the denominator in f32.
//
// Bound: bytes. A step streams the int8 weights once for all B rows
// (~198 MB at the flagship width) plus the int8 cache rows below idx and
// their scales (2 x L x B x idx x (D + 4) bytes, ~170 MB at B = 16,
// idx = 354): ~0.11 ms at 3.35 TB/s. int8_gemm_rows reads each weight byte
// once for up to 32 rows (char4 loads, 8 threads on 32 contiguous columns,
// the rows' inputs staged through shared memory), so the weight stream
// does not grow with B. serving_attention runs one block per (head, row),
// reads each cached k/v byte once (a half-warp per position, 4 bytes a
// lane) and keeps the scores in shared memory for an exact two-pass
// softmax. Launch cost still dominates at 76 launches a step.
//
// Layouts: weights (K, N) int8 row-major (quantize_dense's (in, out)); the
// cache one layer at a time, (B, S, D) int8 with (B, S) f32 scales.
//
// C interface (ctypes): every entry point returns cudaGetLastError().

#include <stdint.h>

#include "common.cuh"

#define XT_API extern "C"

namespace {

__device__ __forceinline__ int8_t quant(float y, float scale) {
  return (int8_t)fminf(fmaxf(rintf(y / scale), -127.f), 127.f);
}

// ---------------------------------------------------------------------------
// int8_gemm_rows: y[r, n] = (sum_k x[r, k] w[k, n]) * scale[n] + bias[n]
// for r < B <= R. Block (8, 32): threadIdx.x picks 4 adjacent columns (one
// char4 load serves all R rows), threadIdx.y strides K. The rows' inputs
// are staged as f32 in KT-deep slabs, laid out [k][R + 4] so one float4
// load gives 4 rows. The 32 K-partials of each (row, column) reduce by warp
// shuffles and shared memory; the epilogue (gelu_new; store f32 or bf16,
// or += into the f32 residual) runs once per output.
// mode: 0 = store f32, 1 = store bf16, 2 = accumulate into f32.
// LN (the norm prologue): x is the (B, K) f32 residual. Each warp first
// takes the statistics of rows warp, warp + 8, ... in layer_norm_rows'
// summation order (common.cuh row_norm_stats), into shared memory; each
// slab then stages the normalised rows, rounded to bf16 once, so the
// product's input equals layer_norm_rows' output bit for bit.
// ---------------------------------------------------------------------------
constexpr int COLS = 32;
constexpr int KT = 256;

template <int R, bool LN>
__global__ void __launch_bounds__(256)
int8_gemm_rows_kernel(const void* __restrict__ x, Norm nrm,
                      const int8_t* __restrict__ w,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias, void* __restrict__ out,
                      int B, int K, int N, int gelu, int mode) {
  constexpr int XS = R + 4;  // staged row stride (floats)
  extern __shared__ __align__(16) float sm[];  // KT * XS floats
  __shared__ float stat[LN ? R : 1][4];        // per row: mu, rstd x 2
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * 8 + tx;
  const int lane = tid & 31, warp = tid >> 5;
  const float* x32 = reinterpret_cast<const float*>(x);
  const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(x);
  if constexpr (LN) {
    for (int r = warp; r < B; r += 8)
      row_norm_stats(x32 + (size_t)r * K, K, nrm, lane, stat[r]);
    __syncthreads();
  }
  const int n0 = blockIdx.x * COLS + tx * 4;
  const char4* wp = reinterpret_cast<const char4*>(w + n0);
  const size_t row = (size_t)N / 4;  // row stride in char4
  float acc[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int k0 = 0; k0 < K; k0 += KT) {
    const int kt = min(KT, K - k0);
    for (int i = tid; i < R * KT; i += 256) {
      const int r = i / KT, kk = i % KT, k = k0 + kk;
      float v = 0.f;
      if (r < B && kk < kt) {
        if constexpr (LN) {
          const float* st = stat[r];
          float y = ln_apply(x32[(size_t)r * K + k], st[0], st[1],
                             nrm.s1[k], nrm.b1[k]);
          if (nrm.n == 2) y = ln_apply(y, st[2], st[3], nrm.s2[k], nrm.b2[k]);
          v = bf16_round(y);
        } else {
          v = __bfloat162float(xb[(size_t)r * K + k]);
        }
      }
      sm[kk * XS + r] = v;
    }
    __syncthreads();
#pragma unroll 2
    for (int kk = ty; kk < kt; kk += 32) {
      const char4 c = __ldg(wp + (size_t)(k0 + kk) * row);
      const float w0 = c.x, w1 = c.y, w2 = c.z, w3 = c.w;
      const float4* xr = reinterpret_cast<const float4*>(sm + kk * XS);
#pragma unroll
      for (int r4 = 0; r4 < R / 4; ++r4) {
        const float4 xv = xr[r4];
        const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int r = r4 * 4 + u;
          acc[r][0] = fmaf(xs[u], w0, acc[r][0]);
          acc[r][1] = fmaf(xs[u], w1, acc[r][1]);
          acc[r][2] = fmaf(xs[u], w2, acc[r][2]);
          acc[r][3] = fmaf(xs[u], w3, acc[r][3]);
        }
      }
    }
    __syncthreads();
  }

  // a warp holds ty = 4 warp .. 4 warp + 3 for all 8 tx: fold its 4 ty
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float v = acc[r][c];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[r][c] = v;
    }
  if (lane < 8) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        sm[(warp * R + r) * COLS + tx * 4 + c] = acc[r][c];
  }
  __syncthreads();
  for (int i = tid; i < B * COLS; i += 256) {
    const int r = i / COLS, col = i % COLS;
    const int n = blockIdx.x * COLS + col;
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < 8; ++wi) s += sm[(wi * R + r) * COLS + col];
    float y = s * scale[n] + bias[n];
    if (gelu) y = gelu_new(y);
    const size_t o = (size_t)r * N + n;
    if (mode == 0) {
      reinterpret_cast<float*>(out)[o] = y;
    } else if (mode == 1) {
      reinterpret_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16(y);
    } else {
      reinterpret_cast<float*>(out)[o] += y;
    }
  }
}

template <int R>
int launch_gemm_rows(const void* x, Norm nrm, const void* w,
                     const void* scale, const void* bias, void* out, int B,
                     int K, int N, int gelu, int mode, cudaStream_t stream) {
  dim3 block(COLS / 4, 32);
  const size_t smem = (size_t)KT * (R + 4) * sizeof(float);
  if (nrm.n)
    int8_gemm_rows_kernel<R, true><<<N / COLS, block, smem, stream>>>(
        x, nrm, (const int8_t*)w, (const float*)scale, (const float*)bias,
        out, B, K, N, gelu, mode);
  else
    int8_gemm_rows_kernel<R, false><<<N / COLS, block, smem, stream>>>(
        x, nrm, (const int8_t*)w, (const float*)scale, (const float*)bias,
        out, B, K, N, gelu, mode);
  return (int)cudaGetLastError();
}

int gemm_rows(const void* x, Norm nrm, const void* w, const void* scale,
              const void* bias, void* out, int B, int K, int N, int gelu,
              int mode, cudaStream_t st) {
  if (B <= 4) return launch_gemm_rows<4>(x, nrm, w, scale, bias, out, B, K, N, gelu, mode, st);
  if (B <= 8) return launch_gemm_rows<8>(x, nrm, w, scale, bias, out, B, K, N, gelu, mode, st);
  if (B <= 16) return launch_gemm_rows<16>(x, nrm, w, scale, bias, out, B, K, N, gelu, mode, st);
  return launch_gemm_rows<32>(x, nrm, w, scale, bias, out, B, K, N, gelu, mode, st);
}

// ---------------------------------------------------------------------------
// serving_attention: one block per (head, row), 128 threads, head_dim 64.
// qkv: (B, 3D) f32 [q | k | v] from the qkv product. The block first finds
// the row's k and v scales over all D (each block of the row recomputes
// them), writes its head's 64 quantized k/v values at idx (head 0 writes
// the scales), then attends over positions < idx of the int8 cache plus
// the unquantized current token.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(128)
serving_attention_kernel(const float* __restrict__ qkv,
                         int8_t* __restrict__ kc, int8_t* __restrict__ vc,
                         float* __restrict__ ks, float* __restrict__ vs,
                         __nv_bfloat16* __restrict__ out, int S, int D,
                         int idx, float att_scale) {
  extern __shared__ float sc[];  // idx scores, then probabilities
  __shared__ float red[33];
  __shared__ float part[8][64];
  __shared__ float self_s;
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int half = lane >> 4, hl = lane & 15;
  const int c0 = h * 64;
  const float* qrow = qkv + (size_t)b * 3 * D;
  const float* krow = qrow + D;
  const float* vrow = qrow + 2 * D;
  int8_t* kcb = kc + (size_t)b * S * D;
  int8_t* vcb = vc + (size_t)b * S * D;
  const float* ksb = ks + (size_t)b * S;
  const float* vsb = vs + (size_t)b * S;

  // ---- the new row, quantized over D ----
  float km = 0.f, vm = 0.f;
  for (int i = tid; i < D; i += blockDim.x) {
    km = fmaxf(km, fabsf(krow[i]));
    vm = fmaxf(vm, fabsf(vrow[i]));
  }
  km = block_reduce<true>(km, red);
  vm = block_reduce<true>(vm, red);
  const float kscale = fmaxf(km, 1e-8f) / 127.f;
  const float vscale = fmaxf(vm, 1e-8f) / 127.f;
  if (tid < 64) {
    kcb[(size_t)idx * D + c0 + tid] = quant(krow[c0 + tid], kscale);
    vcb[(size_t)idx * D + c0 + tid] = quant(vrow[c0 + tid], vscale);
  }
  if (h == 0 && tid == 0) {
    ks[(size_t)b * S + idx] = kscale;
    vs[(size_t)b * S + idx] = vscale;
  }

  // ---- scores: a half-warp per position, 4 dims a lane ----
  float q[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) q[u] = bf16_round(qrow[c0 + hl * 4 + u]);
  for (int s0 = warp * 2; s0 < idx; s0 += 8) {
    const int s = s0 + half;
    float p = 0.f;
    if (s < idx) {
      const char4 kv =
          *reinterpret_cast<const char4*>(kcb + (size_t)s * D + c0 + hl * 4);
      p = bf16_round(kv.x * q[0]) + bf16_round(kv.y * q[1]) +
          bf16_round(kv.z * q[2]) + bf16_round(kv.w * q[3]);
    }
    for (int o = 8; o > 0; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
    if (s < idx && hl == 0) sc[s] = p * (ksb[s] * att_scale);
  }
  if (warp == 0) {
    float p = 0.f;
    for (int u = 0; u < 2; ++u) {
      const int d = c0 + 2 * lane + u;
      p += bf16_round(krow[d] * qrow[d]);
    }
    p = warp_sum(p);
    if (lane == 0) self_s = p * att_scale;
  }
  __syncthreads();

  // ---- softmax over the cache positions and the current token ----
  float m = tid == 0 ? self_s : -INFINITY;
  for (int s = tid; s < idx; s += blockDim.x) m = fmaxf(m, sc[s]);
  m = block_reduce<true>(m, red);
  float l = 0.f;
  for (int s = tid; s < idx; s += blockDim.x) {
    const float e = expf(sc[s] - m);
    sc[s] = e;
    l += e;
  }
  l = block_reduce<false>(l, red);  // its barriers also publish sc[]
  const float e_self = expf(self_s - m);
  l += e_self;

  // ---- the v sum: bf16 probabilities, v scale folded in ----
  float o[4] = {0.f, 0.f, 0.f, 0.f};
  for (int s = warp * 2 + half; s < idx; s += 8) {
    const char4 vv =
        *reinterpret_cast<const char4*>(vcb + (size_t)s * D + c0 + hl * 4);
    const float p = bf16_round(sc[s]);
    const float vsc = vsb[s];
    o[0] += (vv.x * p) * vsc;
    o[1] += (vv.y * p) * vsc;
    o[2] += (vv.z * p) * vsc;
    o[3] += (vv.w * p) * vsc;
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) part[warp * 2 + half][hl * 4 + u] = o[u];
  __syncthreads();
  if (tid < 64) {
    float acc = 0.f;
#pragma unroll
    for (int p = 0; p < 8; ++p) acc += part[p][tid];
    acc += e_self * vrow[c0 + tid];
    out[(size_t)b * D + c0 + tid] = __float2bfloat16(acc / l);
  }
}

}  // namespace

XT_API int xt_int8_gemm_rows(const void* x, const void* w, const void* scale,
                             const void* bias, void* out, int B, int K, int N,
                             int gelu, int mode, void* stream) {
  return gemm_rows(x, Norm{nullptr, nullptr, nullptr, nullptr, 0}, w, scale,
                   bias, out, B, K, N, gelu, mode, (cudaStream_t)stream);
}

// x32: the (B, K) f32 residual; nln 1 or 2 norms (s1, b1[, s2, b2]) first
XT_API int xt_int8_gemm_rows_ln(const void* x32, const void* s1,
                                const void* b1, const void* s2,
                                const void* b2, int nln, const void* w,
                                const void* scale, const void* bias,
                                void* out, int B, int K, int N, int gelu,
                                int mode, void* stream) {
  const Norm nrm{(const float*)s1, (const float*)b1, (const float*)s2,
                 (const float*)b2, nln};
  return gemm_rows(x32, nrm, w, scale, bias, out, B, K, N, gelu, mode,
                   (cudaStream_t)stream);
}

XT_API int xt_serving_attention(const void* qkv, void* kc, void* vc, void* ks,
                                void* vs, void* out, int B, int S, int D,
                                int heads, int idx, float att_scale,
                                void* stream) {
  dim3 grid(heads, B);
  serving_attention_kernel<<<grid, 128, (size_t)(idx > 0 ? idx : 1) * sizeof(float),
                             (cudaStream_t)stream>>>(
      (const float*)qkv, (int8_t*)kc, (int8_t*)vc, (float*)ks, (float*)vs,
      (__nv_bfloat16*)out, S, D, idx, att_scale);
  return (int)cudaGetLastError();
}
