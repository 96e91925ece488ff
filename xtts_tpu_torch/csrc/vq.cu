// K3 for Hopper: VQ nearest-code search (DVAE.get_codebook_indices).
//
// Replaces the Pallas TPU kernel xtts_tpu/ops/vq.py (_vq_kernel, launched
// by vq_nearest_pallas), which tiled rows x codebook columns on the MXU and
// carried a running (min, argmin) across the sequential code-tile axis.
//
// For each row x (N, D) f32 it returns the index j minimizing
//     dist_j = |e_j|^2 - 2 x.e_j        over the (D, E) codebook,
// the first index on ties (the TPU kernel's strict `<`). |e|^2 is
// computed by a small first launch (the TPU wrapper took it from XLA;
// built by two PyTorch ops it cost ~30 us a call on an H100).
//
// Bound: operations. 2 N D E products (25.2 GFLOP at the DVAE round
// trip's N = 3008, D = 512, E = 8192) against ~25 MB of operands (~7.5
// us). On the fp32 pipes that is 0.38 ms at 67 TFLOP/s; an fp32 FMA
// design (128 x 128 tiles of 8 x 8 microtiles, 32-deep cp.async slabs)
// reached 33.7-35.5 TFLOP/s on an H100 (709-749 us, PERF.md), so the
// products run on the tensor cores instead, in 3xTF32: each f32 operand v
// splits into big = tf32(v) and small = tf32(v - big), and x.e sums
// big*small + small*big + big*big on mma.sync m16n8k8 with f32
// accumulators (common.cuh's split_tf32 and mma_tf32, shared with K2's f32
// kernels; 3 x 2 N D E = 75.6 GFLOP at 495 TFLOP/s dense tf32: 0.15
// ms). The dropped small*small term and the tf32 roundings of the small
// parts leave each product within ~2^-21 of |x||e| relative, against the
// codes' tie bound of 4 D 2^-24 (2 sum |x||e| + |e|^2) (card tests,
// _vq_agree); at the DVAE's shape and the card tests' shapes the codes
// measured equal to the fp32 plain twin's on an H100 (PERF.md).
//
// Design:
//  - A block of 8 warps computes a 128-row x 128-code tile; a warp a 64 x
//    32 part as 4 x 4 tiles of m16n8, its fragments read from shared
//    memory without bank conflicts (rows of x staged 36 floats apart,
//    codebook rows 136) and split into tf32 pairs as they are read.
//  - x (128 rows x 32 k) and the codebook (32 k x 128 codes) stream in
//    32-deep slabs through a double buffer of cp.async copies (16 bytes
//    each where rows are 16-byte aligned, else 4; 72 KB of shared memory),
//    the next slab in flight while the block computes on this one.
//  - Each block owns one 128-row tile and a range of 512 codes (4 code
//    tiles; N = 3008, E = 8192 give 24 x 16 = 384 blocks). The argmin runs
//    in the epilogue of each code tile: a thread's codes in increasing
//    order with strict `<`, then the 4 lanes of a row by shuffles and the
//    4 warps along the codes through shared memory. Blocks run in no
//    order, so the sequential code axis of the TPU grid becomes a split:
//    each block writes its range's (min, argmin) per row, and a second
//    launch merges the ranges in code order. Every merge of two (value,
//    index) pairs keeps the smaller index on equal values.
//
// C interface (ctypes): every entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

#define XT_API extern "C"

namespace {

constexpr int BM = 128;      // rows a tile
constexpr int BN = 128;      // codes a tile
constexpr int BK = 32;       // depth of a staged slab
constexpr int AS = BK + 4;   // floats a staged x row
constexpr int RANGE = 512;   // codes a block
constexpr int THREADS = 256;
constexpr int STAGES = 2;    // slabs in the cp.async ring
constexpr int BNP = BN + 8;  // floats a staged codebook row
constexpr int STAGE = BM * AS + BK * BNP;  // floats a stage
constexpr size_t SMEM = (size_t)STAGES * STAGE * sizeof(float);

__device__ __forceinline__ void better(float& v, int& i, float v2, int i2) {
  if (v2 < v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// grid (ceil(N / BM), ceil(E / RANGE)), 256 threads: 8 warps as 2 (rows)
// x 4 (codes), a warp 64 rows x 32 codes as 4 x 4 tiles of m16n8; thread
// (g = lane / 4, t4 = lane % 4) holds rows g, g + 8 and codes 2 t4, 2 t4 +
// 1 of each tile. VEC: D % 4 == 0, E % 4 == 0 and 16-byte aligned x and
// codebook.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
vq_partial_kernel(const float* __restrict__ x,
                     const float* __restrict__ embed,
                     const float* __restrict__ esq, float* __restrict__ part_v,
                     int* __restrict__ part_i, int N, int D, int E) {
  extern __shared__ __align__(16) float ring[];
  __shared__ float mv[4][BM];
  __shared__ int mi_[4][BM];
  auto As = [&](int st, int r, int k) -> float* {
    return ring + st * STAGE + r * AS + k;
  };
  auto Bs = [&](int st, int k, int c) -> float* {
    return ring + st * STAGE + BM * AS + k * BNP + c;
  };
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.x * BM;
  const int e_lo = blockIdx.y * RANGE;
  const int e_hi = min(E, e_lo + RANGE);
  const int nslabs = (D + BK - 1) / BK;
  const int total = (e_hi - e_lo + BN - 1) / BN * nslabs;

  auto load = [&](int it) {
    const int t = it / nslabs, k0 = (it - t * nslabs) * BK;
    const int n0 = e_lo + t * BN, st = it % STAGES;
    if constexpr (VEC) {
      for (int c = tid; c < BM * BK / 4; c += THREADS) {
        const int r = c / (BK / 4), kq = c % (BK / 4) * 4;
        const bool ok = m0 + r < N && k0 + kq < D;
        cp_async16(smem_u32(As(st, r, kq)),
                   ok ? x + (size_t)(m0 + r) * D + k0 + kq : x, ok);
      }
      for (int c = tid; c < BK * BN / 4; c += THREADS) {
        const int kr = c / (BN / 4), cq = c % (BN / 4) * 4;
        const bool ok = k0 + kr < D && n0 + cq < e_hi;
        cp_async16(smem_u32(Bs(st, kr, cq)),
                   ok ? embed + (size_t)(k0 + kr) * E + n0 + cq : embed, ok);
      }
    } else {
      for (int c = tid; c < BM * BK; c += THREADS) {
        const int r = c / BK, kk = c % BK;
        const bool ok = m0 + r < N && k0 + kk < D;
        cp_async4(smem_u32(As(st, r, kk)),
                  ok ? x + (size_t)(m0 + r) * D + k0 + kk : x, ok);
      }
      for (int c = tid; c < BK * BN; c += THREADS) {
        const int kr = c / BN, cc = c % BN;
        const bool ok = k0 + kr < D && n0 + cc < e_hi;
        cp_async4(smem_u32(Bs(st, kr, cc)),
                  ok ? embed + (size_t)(k0 + kr) * E + n0 + cc : embed, ok);
      }
    }
  };

  float best_v[8];
  int best_i[8];
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    best_v[i] = INFINITY;
    best_i[i] = 0x7fffffff;
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.f;

  for (int it = 0; it < STAGES - 1; ++it) {
    if (it < total) load(it);
    cp_async_commit();
  }
  for (int it = 0; it < total; ++it) {
    if (it + STAGES - 1 < total) load(it + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    const int st = it % STAGES;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t ab[4][4], as_[4][4], bb[4][2], bs[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int r = wm * 64 + mt * 16 + g;
        split_tf32(*As(st, r, kk + t4), ab[mt][0], as_[mt][0]);
        split_tf32(*As(st, r + 8, kk + t4), ab[mt][1], as_[mt][1]);
        split_tf32(*As(st, r, kk + t4 + 4), ab[mt][2], as_[mt][2]);
        split_tf32(*As(st, r + 8, kk + t4 + 4), ab[mt][3], as_[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = wn * 32 + nt * 8 + g;
        split_tf32(*Bs(st, kk + t4, c), bb[nt][0], bs[nt][0]);
        split_tf32(*Bs(st, kk + t4 + 4, c), bb[nt][1], bs[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          mma_tf32(acc[mt][nt], ab[mt], bs[nt]);
          mma_tf32(acc[mt][nt], as_[mt], bb[nt]);
          mma_tf32(acc[mt][nt], ab[mt], bb[nt]);
        }
    }
    __syncthreads();
    if ((it + 1) % nslabs == 0) {
      // rows wm 64 + 16 mt + g (+ 8), codes n0 + wn 32 + 8 nt + 2 t4 (+ 1),
      // the thread's codes in increasing order, strict <
      const int n0 = e_lo + it / nslabs * BN;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = n0 + wn * 32 + nt * 8 + 2 * t4 + j;
          const float s = c < e_hi ? esq[c] : 0.f;
#pragma unroll
          for (int mt = 0; mt < 4; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float dist = s - 2.f * acc[mt][nt][2 * h + j];
              const int i = mt * 2 + h;
              if (c < e_hi && dist < best_v[i]) {
                best_v[i] = dist;
                best_i[i] = c;
              }
              acc[mt][nt][2 * h + j] = 0.f;
            }
        }
    }
  }
  cp_async_wait<0>();

  // the 4 t4 lanes of a row, then the 4 warps along the codes
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      const float v2 = __shfl_xor_sync(0xffffffffu, best_v[i], o);
      const int i2 = __shfl_xor_sync(0xffffffffu, best_i[i], o);
      better(best_v[i], best_i[i], v2, i2);
    }
    if (t4 == 0) {
      const int r = wm * 64 + (i >> 1) * 16 + g + (i & 1) * 8;
      mv[wn][r] = best_v[i];
      mi_[wn][r] = best_i[i];
    }
  }
  __syncthreads();
  if (tid < BM && m0 + tid < N) {
    float v = mv[0][tid];
    int i = mi_[0][tid];
    for (int w = 1; w < 4; ++w) better(v, i, mv[w][tid], mi_[w][tid]);
    part_v[(size_t)(m0 + tid) * gridDim.y + blockIdx.y] = v;
    part_i[(size_t)(m0 + tid) * gridDim.y + blockIdx.y] = i;
  }
}

// |e_c|^2 for every code, one thread a code: the squares over d in turn
__global__ void vq_esq_kernel(const float* __restrict__ embed,
                              float* __restrict__ esq, int D, int E) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= E) return;
  float s = 0.f;
  for (int d = 0; d < D; ++d) {
    const float v = embed[(size_t)d * E + c];
    s = fmaf(v, v, s);
  }
  esq[c] = s;
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

// esq: (E,) f32 scratch, part_v / part_i: (N, xt_vq_ranges(E)) scratch
// from the caller. Three launches: |e|^2, the ranges, their merge.
XT_API int xt_vq_nearest(const void* x, const void* embed, void* esq,
                         void* part_v, void* part_i, void* codes, int N, int D,
                         int E, void* stream) {
  const int ranges = xt_vq_ranges(E);
  vq_esq_kernel<<<(E + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const float*)embed, (float*)esq, D, E);
  dim3 grid((N + BM - 1) / BM, ranges);
  const bool vec = D % 4 == 0 && E % 4 == 0 &&
                   ((uintptr_t)x | (uintptr_t)embed) % 16 == 0;
  // the ring is over 48 KB: opt in once per device and process
  static unsigned opted = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (!(opted >> dev & 1u)) {
    for (auto fn : {vq_partial_kernel<true>, vq_partial_kernel<false>}) {
      const cudaError_t e = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
      if (e != cudaSuccess) return (int)e;
    }
    opted |= 1u << dev;
  }
  if (vec)
    vq_partial_kernel<true><<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)embed, (const float*)esq,
        (float*)part_v, (int*)part_i, N, D, E);
  else
    vq_partial_kernel<false><<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)embed, (const float*)esq,
        (float*)part_v, (int*)part_i, N, D, E);
  int err = (int)cudaGetLastError();
  if (err) return err;
  vq_merge_kernel<<<(N + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const float*)part_v, (const int*)part_i, (int64_t*)codes, N, ranges);
  return (int)cudaGetLastError();
}
