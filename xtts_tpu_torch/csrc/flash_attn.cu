// K2 for Hopper: exact non-causal attention, forward only, FlashAttention-2
// style, for the diffusion UNet's consumer self-attention.
//
// Replaces the Pallas TPU flash kernel behind xtts_tpu/nn/flash_attn.py
// flash_mha (jax.experimental.pallas.ops.tpu.flash_attention, called at
// xtts_tpu/nn/flash_attn.py:99). On the main path: q (2, 1280, 8, 64),
// k/v (2, 1562, 8, 64) bf16 at code bucket 320 — 4 x 50 calls a request.
//
// Bound: tensor-core FLOPs. 4 * B * H * Tq * Tk * 64 = 8.2 GFLOP a call at
// the shape above, against ~5 MB of q/k/v/o; the score matrix (2 x 8 x
// 1280 x 1562) never reaches device memory. This first version runs its
// two products on the tensor cores through WMMA (mma.sync 16x16x16 bf16,
// f32 accumulate) with plain synchronous tile loads; wgmma, TMA and
// pipelined loads are later work.
//
// Design: one block (4 warps) per (64-query tile, head, batch row). The Q
// tile lives in shared memory; K/V tiles of 64 rows stream through shared
// memory. Each warp owns 16 query rows: S = Q K^T into f32 shared memory,
// online softmax in f32 (two lanes a row), P rounded to bf16, O += P V
// through WMMA into a scratch tile, and O = alpha * O + tmp in f32 shared
// memory. The (B, T, H, 64) strides are read directly; the ragged Tk edge
// is masked here (zero-filled rows, -inf scores), the ragged Tq edge is not
// stored. No host padding, no segment ids.
//
// C interface (ctypes): returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#define XT_API extern "C"

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // key rows per tile
constexpr int HD = 64;        // head dim
constexpr int NWARPS = 4;     // 16 query rows per warp
constexpr int LDH = HD + 8;   // bf16 tile row stride (144 B)
constexpr int LDF = BK + 4;   // f32 tile row stride (272 B)
constexpr int SMEM_BYTES =
    4 * BQ * LDH * (int)sizeof(bf16) + 2 * BQ * LDF * (int)sizeof(float);

__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long row_stride, int row0,
                                          int nrows) {
  // 64 rows x 64 bf16 as 16-byte vectors; rows past nrows are zero-filled
  for (int i = threadIdx.x; i < 64 * 8; i += blockDim.x) {
    const int r = i >> 3, c = (i & 7) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows)
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) *
                                                      row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * LDH + c) = val;
  }
}

__global__ void __launch_bounds__(NWARPS * 32)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int Tq,
                 int Tk, long long sqb, long long sqt, long long sqh,
                 long long skb, long long skt, long long skh, long long svb,
                 long long svt, long long svh, long long sob, long long sot,
                 long long soh, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BQ * LDH;
  bf16* sV = sK + BK * LDH;
  bf16* sP = sV + BK * LDH;
  float* sS = reinterpret_cast<float*>(sP + BQ * LDH);
  float* sO = sS + BQ * LDF;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* qb = q + b * sqb + h * sqh;
  const bf16* kb = k + b * skb + h * skh;
  const bf16* vb = v + b * svb + h * svh;

  load_tile(sQ, qb, sqt, q0, Tq);
  for (int i = threadIdx.x; i < BQ * LDF; i += blockDim.x) sO[i] = 0.f;
  __syncthreads();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa[HD / 16];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wmma::load_matrix_sync(qa[kk], sQ + warp * 16 * LDH + kk * 16, LDH);

  // softmax state: two lanes per query row, 32 key columns each
  const int row = warp * 16 + (lane >> 1);
  const int half = lane & 1;
  float m_i = -INFINITY, l_i = 0.f;
  float* srow = sS + row * LDF + half * 32;
  float* orow = sO + row * LDF + half * 32;
  bf16* prow = sP + row * LDH + half * 32;

  for (int k0 = 0; k0 < Tk; k0 += BK) {
    load_tile(sK, kb, skt, k0, Tk);
    load_tile(sV, vb, svt, k0, Tk);
    __syncthreads();

    // S = Q K^T (this warp's 16 rows x 64 keys)
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, sK + j * 16 * LDH + kk * 16, LDH);
        wmma::mma_sync(acc, qa[kk], kf, acc);
      }
      wmma::store_matrix_sync(sS + warp * 16 * LDF + j * 16, acc, LDF,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax (f32)
    const int valid = Tk - k0 - half * 32;
    float mx = -INFINITY;
#pragma unroll 8
    for (int c = 0; c < 32; ++c)
      if (c < valid) mx = fmaxf(mx, srow[c] * scale);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_i, mx);
    const float alpha = __expf(m_i - m_new);
    float sum = 0.f;
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const float p = c < valid ? __expf(srow[c] * scale - m_new) : 0.f;
      prow[c] = __float2bfloat16(p);
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_i = l_i * alpha + sum;
    m_i = m_new;
    __syncwarp();

    // tmp = P V into the (now free) score tile, then O = alpha O + tmp
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(pf, sP + warp * 16 * LDH + kk * 16, LDH);
        wmma::load_matrix_sync(vf, sV + kk * 16 * LDH + j * 16, LDH);
        wmma::mma_sync(acc, pf, vf, acc);
      }
      wmma::store_matrix_sync(sS + warp * 16 * LDF + j * 16, acc, LDF,
                              wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll 8
    for (int c = 0; c < 32; ++c) orow[c] = orow[c] * alpha + srow[c];
    __syncthreads();  // every warp is done with sK / sV
  }

  if (q0 + row < Tq) {
    const float inv = 1.f / l_i;
    bf16* op = o + b * sob + (long long)(q0 + row) * sot + h * soh + half * 32;
#pragma unroll 8
    for (int c = 0; c < 32; ++c) op[c] = __float2bfloat16(orow[c] * inv);
  }
}

}  // namespace

XT_API int xt_flash_attn_fwd(const void* q, const void* k, const void* v,
                             void* o, int B, int Tq, int Tk, int H,
                             long long sqb, long long sqt, long long sqh,
                             long long skb, long long skt, long long skh,
                             long long svb, long long svt, long long svh,
                             long long sob, long long sot, long long soh,
                             float scale, void* stream) {
  // > 48 KB of dynamic shared memory needs an opt-in, per device
  if (cudaFuncSetAttribute(flash_fwd_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM_BYTES) != cudaSuccess)
    return (int)cudaGetLastError();
  dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<<<grid, NWARPS * 32, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, Tq, Tk, sqb,
      sqt, sqh, skb, skt, skh, svb, svt, svh, sob, sot, soh, scale);
  return (int)cudaGetLastError();
}
