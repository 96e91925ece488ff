// K3 for Hopper: VQ nearest-code search (DVAE.get_codebook_indices).
//
// Replaces the Pallas TPU kernel xtts_tpu/ops/vq.py (_vq_kernel, launched
// by vq_nearest_pallas), which tiled rows x codebook columns on the MXU and
// carried a running (min, argmin) across the sequential code-tile axis.
//
// For each row x (N, D) f32 it returns the index j minimizing
//     dist_j = |e_j|^2 - 2 x.e_j        over the (D, E) codebook,
// the first index on ties (the TPU kernel's strict `<`). |e|^2 comes in
// precomputed (E,), as in the TPU wrapper.
//
// Precision: plain fp32 FMA. No TF32 and no bf16: the codes must be exact,
// and every dot product sums over d = 0..D-1 in order.
//
// Bound: operations. 2 N D E flops (25.2 GFLOP at the DVAE round trip's
// N = 3008, D = 512, E = 8192) at 67 TFLOP/s fp32 is ~0.38 ms, against
// ~25 MB of operands (~7.5 us). Design: a 64-row x 64-code register-blocked
// tile product (4 x 4 a thread, operands staged through shared memory in
// 16-deep slabs); each block owns one 64-row tile and a 1024-code range of
// the codebook, so N/64 x E/1024 blocks fill the card. Blocks run in no
// order, so the sequential code axis of the TPU grid becomes a split: each
// block writes its range's (min, argmin) per row, and a second launch
// merges the ranges in code order. Every merge of two (value, index) pairs
// keeps the smaller index on equal values.
//
// C interface (ctypes): every entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define XT_API extern "C"

namespace {

constexpr int BM = 64;      // rows a tile
constexpr int BN = 64;      // codes a tile
constexpr int BK = 16;      // depth of a staged slab
constexpr int RANGE = 1024; // codes a block

__device__ __forceinline__ void better(float& v, int& i, float v2, int i2) {
  if (v2 < v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// grid (ceil(N / BM), ceil(E / RANGE)), 256 threads: ty = tid / 16 owns
// rows ty*4..+3 of the tile, tx = tid % 16 owns codes tx*4..+3.
__global__ void __launch_bounds__(256)
vq_partial_kernel(const float* __restrict__ x, const float* __restrict__ embed,
                  const float* __restrict__ esq, float* __restrict__ part_v,
                  int* __restrict__ part_i, int N, int D, int E) {
  __shared__ __align__(16) float As[BK][BM + 4];  // +4: fewer bank conflicts
  __shared__ __align__(16) float Bs[BK][BN];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.x * BM;
  const int e_lo = blockIdx.y * RANGE;
  const int e_hi = min(E, e_lo + RANGE);

  float best_v[4];
  int best_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    best_v[i] = INFINITY;
    best_i[i] = 0x7fffffff;
  }

  for (int n0 = e_lo; n0 < e_hi; n0 += BN) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < D; k0 += BK) {
      // x tile (BM x BK), stored transposed; codebook slab (BK x BN)
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const int idx = tid + l * 256;
        const int r = idx / BK, k = idx % BK;
        const int gr = m0 + r, gk = k0 + k;
        As[k][r] = (gr < N && gk < D) ? x[(size_t)gr * D + gk] : 0.f;
        const int kb = idx / BN, c = idx % BN;
        const int gkb = k0 + kb, gc = n0 + c;
        Bs[kb][c] = (gkb < D && gc < e_hi) ? embed[(size_t)gkb * E + gc] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
    // codes in increasing order, strict < : the first index stays
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx * 4 + j;
      if (c < e_hi) {
        const float s = esq[c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float dist = s - 2.f * acc[i][j];
          if (dist < best_v[i]) {
            best_v[i] = dist;
            best_i[i] = c;
          }
        }
      }
    }
  }

  // merge the 16 code lanes of each row (lanes tx of one half-warp)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
      const float v2 = __shfl_xor_sync(0xffffffffu, best_v[i], o);
      const int i2 = __shfl_xor_sync(0xffffffffu, best_i[i], o);
      better(best_v[i], best_i[i], v2, i2);
    }
    const int r = m0 + ty * 4 + i;
    if (tx == 0 && r < N) {
      part_v[(size_t)r * gridDim.y + blockIdx.y] = best_v[i];
      part_i[(size_t)r * gridDim.y + blockIdx.y] = best_i[i];
    }
  }
}

// one thread per row: the ranges in code order, strict < (first index)
__global__ void vq_merge_kernel(const float* __restrict__ part_v,
                                const int* __restrict__ part_i,
                                int64_t* __restrict__ codes, int N,
                                int ranges) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= N) return;
  float v = part_v[(size_t)r * ranges];
  int i = part_i[(size_t)r * ranges];
  for (int s = 1; s < ranges; ++s)
    better(v, i, part_v[(size_t)r * ranges + s], part_i[(size_t)r * ranges + s]);
  codes[r] = i;
}

}  // namespace

XT_API int xt_vq_ranges(int E) { return (E + RANGE - 1) / RANGE; }

// part_v / part_i: (N, xt_vq_ranges(E)) scratch from the caller.
XT_API int xt_vq_nearest(const void* x, const void* embed, const void* esq,
                         void* part_v, void* part_i, void* codes, int N, int D,
                         int E, void* stream) {
  const int ranges = xt_vq_ranges(E);
  dim3 grid((N + BM - 1) / BM, ranges);
  vq_partial_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)embed, (const float*)esq, (float*)part_v,
      (int*)part_i, N, D, E);
  int err = (int)cudaGetLastError();
  if (err) return err;
  vq_merge_kernel<<<(N + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const float*)part_v, (const int*)part_i, (int64_t*)codes, N, ranges);
  return (int)cudaGetLastError();
}
