// Device helpers shared by the port's kernels: cp.async copies, the 3xTF32
// tensor-core product of K2's f32 kernels and K3, warp and block
// reductions, gelu_new, and the LayerNorm that layer_norm_rows (K1)
// runs standalone and the product kernels of K1 and K4 run as their
// prologue.
//
// The norm's statistics always fold in ONE order, that of a 256-thread
// block: virtual thread t sums elements t, t + 256, t + 512, ... in turn;
// each virtual warp of 32 folds its sums by a butterfly; the 8 warp sums
// fold by a butterfly. block_sum256 takes that order with any block of 32
// to 256 threads (a divisor of 256), warp_sum256 and row_norm_stats with
// one warp, so a product kernel's prologue gives layer_norm_rows' bf16
// output bit for bit. Every f32 operation of the norm rounds on its own
// (the squares and ln_apply explicitly, never contracted into a fused
// multiply-add; the divisions IEEE), so the plain twin
// (ops/decode_step.py layer_norm_rows_ordered) repeats it with PyTorch's
// elementwise ops; only rsqrtf is the card's own.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// ---------------------------------------------------------------------------
// Asynchronous copies global -> shared (cp.async), zero-filled when !valid
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes, cached in L2 only
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes (for rows that are not 16-byte aligned)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// 3xTF32 on the tensor cores (K2's f32 kernels, K3): an f32 operand v splits
// into big = tf32(v) and small = tf32(v - big), and a product sums
// big*small + small*big + big*big on mma.sync m16n8k8 with f32
// accumulators. The dropped small*small term and the tf32 roundings of the
// small parts leave each product within ~2^-21 of |a||b| relative.
// ---------------------------------------------------------------------------

// the f32 value rounded to tf32 (to nearest, ties away), as f32 bits: half
// a tf32 ulp added to the magnitude's bits, the 13 low bits cleared. The
// same bits as cvt.rna.tf32.f32 for every finite value, in two integer
// operations at the full integer rate instead of one conversion at the
// conversion rate (a quarter of it on sm_90).
__device__ __forceinline__ uint32_t to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& big,
                                           uint32_t& small) {
  big = to_tf32(v);
  small = to_tf32(v - __uint_as_float(big));
}

// The same split with the small part passed as it is: the tensor cores read
// a tf32 operand's top 19 bits, so its 13 low bits are cut there (within
// 2^-21 of |v|), in 3 operations instead of 5 (K2's f32 kernels; K3 keeps
// split_tf32, whose rounded parts its codes are held to)
__device__ __forceinline__ void split_tf32_cut(float v, uint32_t& big,
                                               uint32_t& small) {
  big = to_tf32(v);
  small = __float_as_uint(v - __uint_as_float(big));
}

// c += a b, m16n8k8, tf32 operands, f32 accumulators. Thread (g = lane / 4,
// t = lane % 4): a0 (row g, k t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8,
// t + 4); b0 (k t, column g), b1 (k t + 4, g); c0, c1 (g, 2t, 2t + 1), c2,
// c3 (g + 8, 2t, 2t + 1).
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide reduction over a 1-D block (blockDim.x a multiple of 32).
// red: >= 33 floats of shared memory. Returns the result to every thread.
template <bool MAX>
__device__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = MAX ? warp_max(v) : warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < nwarps ? red[lane] : (MAX ? -INFINITY : 0.f);
    t = MAX ? warp_max(t) : warp_sum(t);
    if (lane == 0) red[32] = t;
  }
  __syncthreads();
  const float r = red[32];
  __syncthreads();
  return r;
}

// HF gelu_new, every operation rounded on its own in the order written
// (nvcc would contract the cube and the scalings into fused multiply-adds):
// 0.5 x (1 + tanh(c (x + 0.044715 x x x))). ops/decode_step.py
// gelu_new_ordered repeats it with PyTorch's elementwise ops.
__device__ __forceinline__ float gelu_new(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  const float x3 = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, x), x), x);
  const float t = tanhf(__fmul_rn(c, __fadd_rn(x, x3)));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.f, t));
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// byte i of u as f32 minus off, exactly, without a conversion: 2^23 + b -
// off (b = an int8 value + 128, off = 2^23 + 128; or b = a nibble + 8,
// off = 2^23 + 8)
__device__ __forceinline__ float byte_f32(uint32_t u, int i, float off) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + i)) - off;
}

// ---------------------------------------------------------------------------
// LayerNorm, eps 1e-5: y = (x - mu) * rstd * s + b
// ---------------------------------------------------------------------------

// The norm operands of a product kernel's prologue: n = 1 applies (s1, b1),
// n = 2 then applies (s2, b2) to the f32 result (ln_f then final_norm).
struct Norm {
  const float* s1;
  const float* b1;
  const float* s2;
  const float* b2;
  int n;
};

__device__ __forceinline__ float ln_apply(float x, float mu, float rstd,
                                          float s, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mu), rstd), s), b);
}

// (x - mu)^2, the product rounded on its own
__device__ __forceinline__ float sq_dev(float x, float mu) {
  const float c = __fsub_rn(x, mu);
  return __fmul_rn(c, c);
}

// a statistic of a d-element row: sum / d (IEEE-rounded, as nvcc divides
// by default), and rsqrt(var + eps)
__device__ __forceinline__ float row_mean(float sum, int d) {
  return sum / (float)d;
}

__device__ __forceinline__ float row_rstd(float var) {
  return rsqrtf(__fadd_rn(var, 1e-5f));
}

// Sum of v(i), i < d, in the 256-thread order, by a block of nthreads:
// warp w folds virtual warps w, w + nthreads / 32, ...; red >= 8 floats of
// shared memory. Every thread gets the sum.
template <class F>
__device__ float block_sum256(const F& v, int d, float* red, int tid,
                              int nthreads) {
  const int lane = tid & 31, warp = tid >> 5;
  for (int w = warp; w < 8; w += nthreads >> 5) {
    float acc = 0.f;
    for (int i = w * 32 + lane; i < d; i += 256) acc += v(i);
    acc = warp_sum(acc);
    if (lane == 0) red[w] = acc;
  }
  __syncthreads();
  const float t = warp_sum(lane < 8 ? red[lane] : 0.f);
  __syncthreads();  // red is free again
  return t;
}

// The same sum by one warp, which folds all 8 virtual warps itself.
template <class F>
__device__ __forceinline__ float warp_sum256(const F& v, int d, int lane) {
  float acc[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) acc[w] = 0.f;
  for (int j = 0; j < d; j += 256) {
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      const int i = j + w * 32 + lane;
      if (i < d) acc[w] += v(i);
    }
  }
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    const float s = warp_sum(acc[w]);
    if (lane == w) t = s;
  }
  return warp_sum(t);
}

// nrm.n LayerNorms of the f32 row buf[0..d) in shared memory, in place,
// by the whole block (the row is staged and synced before the call).
__device__ void layer_norm_inplace(float* buf, int d, const Norm& nrm,
                                   float* red, int tid, int nthreads) {
  for (int p = 0; p < nrm.n; ++p) {
    const float* s = p ? nrm.s2 : nrm.s1;
    const float* b = p ? nrm.b2 : nrm.b1;
    const float mu = row_mean(
        block_sum256([&](int i) { return buf[i]; }, d, red, tid, nthreads),
        d);
    const float var = row_mean(
        block_sum256([&](int i) { return sq_dev(buf[i], mu); }, d, red, tid,
                     nthreads),
        d);
    const float rstd = row_rstd(var);
    for (int i = tid; i < d; i += nthreads)
      buf[i] = ln_apply(buf[i], mu, rstd, s[i], b[i]);
    __syncthreads();
  }
}

// (mu, rstd) of each of nrm.n norms of the f32 row x[0..d) in global
// memory, by one warp: st[2p], st[2p + 1]. Norm 2's statistics are over
// norm 1's f32 output, recomputed from x as layer_norm_inplace stores it.
// A row of d <= 1024 is loaded into registers once (element 256 j + 32 w +
// lane in xv[j][w]) and every pass folds those registers in warp_sum256's
// order, so only the first pass waits for memory; longer rows are read
// again each pass.
__device__ void row_norm_stats(const float* __restrict__ x, int d,
                               const Norm& nrm, int lane, float* st) {
  float mu1, rstd1, mu2 = 0.f, rstd2 = 0.f;
  if (d <= 1024) {
    float xv[4][8];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        const int i = j * 256 + w * 32 + lane;
        xv[j][w] = i < d ? x[i] : 0.f;
      }
    auto fold = [&](auto f) {  // warp_sum256 of f(j, w) over i < d
      float acc[8];
#pragma unroll
      for (int w = 0; w < 8; ++w) acc[w] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int w = 0; w < 8; ++w)
          // __fadd_rn, not +=: with the explicitly rounded squares, +=
          // left int8_gemm_rows' prologue kernel 96 registers and spills
          // (4 us more at fc + ln_2, H100, PERF.md); the sum is the same
          if (j * 256 + w * 32 + lane < d) acc[w] = __fadd_rn(acc[w], f(j, w));
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        const float s = warp_sum(acc[w]);
        if (lane == w) t = s;
      }
      return warp_sum(t);
    };
    mu1 = row_mean(fold([&](int j, int w) { return xv[j][w]; }), d);
    rstd1 = row_rstd(row_mean(
        fold([&](int j, int w) { return sq_dev(xv[j][w], mu1); }), d));
    if (nrm.n == 2) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int w = 0; w < 8; ++w) {
          const int i = j * 256 + w * 32 + lane;
          if (i < d)
            xv[j][w] = ln_apply(xv[j][w], mu1, rstd1, nrm.s1[i], nrm.b1[i]);
        }
      mu2 = row_mean(fold([&](int j, int w) { return xv[j][w]; }), d);
      rstd2 = row_rstd(row_mean(
          fold([&](int j, int w) { return sq_dev(xv[j][w], mu2); }), d));
    }
  } else {
    mu1 = row_mean(warp_sum256([&](int i) { return x[i]; }, d, lane), d);
    rstd1 = row_rstd(row_mean(
        warp_sum256([&](int i) { return sq_dev(x[i], mu1); }, d, lane), d));
    if (nrm.n == 2) {
      auto y1 = [&](int i) {
        return ln_apply(x[i], mu1, rstd1, nrm.s1[i], nrm.b1[i]);
      };
      mu2 = row_mean(warp_sum256(y1, d, lane), d);
      rstd2 = row_rstd(row_mean(
          warp_sum256([&](int i) { return sq_dev(y1(i), mu2); }, d, lane),
          d));
    }
  }
  if (lane == 0) {
    st[0] = mu1;
    st[1] = rstd1;
    st[2] = mu2;
    st[3] = rstd2;
  }
}
