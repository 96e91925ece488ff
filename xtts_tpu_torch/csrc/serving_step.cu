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
// once for up to 32 rows on the tensor cores, split over K across a
// thread-block cluster so that every matrix of the step streams from
// 128-288 blocks, and merges the K partials through distributed shared
// memory (below), so the weight stream does not grow with B.
// serving_attention runs one block per (head, row),
// reads each cached k/v byte once (a half-warp per position, 4 bytes a
// lane) and keeps the scores in shared memory for an exact two-pass
// softmax. Launch cost still dominates at 76 launches a step.
//
// Layouts: weights (K, N) int8 row-major (quantize_dense's (in, out)); the
// cache one layer at a time, (B, S, D) int8 with (B, S) f32 scales.
//
// C interface (ctypes): every entry point returns cudaGetLastError().

#include <cooperative_groups.h>
#include <stdint.h>

#include "common.cuh"

#define XT_API extern "C"

namespace {

__device__ __forceinline__ int8_t quant(float y, float scale) {
  return (int8_t)fminf(fmaxf(rintf(y / scale), -127.f), 127.f);
}

// ---------------------------------------------------------------------------
// int8_gemm_rows: y[r, n] = (sum_k x[r, k] w[k, n]) * scale[n] + bias[n]
// for r < B <= 32, split over K across a thread-block cluster, on the
// tensor cores.
//
// Bound: bytes, each weight byte read once for all rows (4 MB for fc at 16
// rows: 1.25 us at 3.35 TB/s). The grid is (S, ceil(N / 64)) with cluster
// (S, 1, 1): a cluster owns 64 output columns and its S blocks split K
// into chunks of whole 16-deep steps, rank r taking [gr_lo(r), gr_lo(r +
// 1)). ops/serving_step.py gemm_rows_plan picks S (1-8) so that a matrix
// runs on >= 128 blocks where K allows, with a chunk of at most 512:
// qkv 4 x 48, proj 8 x 16, fc 2 x 64, out 8 x 16, head 2 x 144. gr_lo is
// the authority for the bounds; gemm_rows_plan's are its Python copy, held
// against xt_gemm_rows_bounds on the card.
//
// A block (4 warps) streams its (chunk x 64) int8 weights through an
// 8-stage cp.async ring of 64 x 64 tiles (16 bytes a thread, zero-filled
// past the chunk and past N; rows padded to 80 bytes so the fragment reads
// below hit distinct banks): a whole 512-deep chunk is in flight before
// the norm prologue starts. cp.async and not TMA: no tensor
// map to build on the host per call, and src-size 0 fills the edges.
//
// The product: mma.sync m16n8k16 bf16 with f32 accumulators, swap-AB —
// 16 weight columns are M, the rows (padded to R = 8, 16 or 32, zeros) are
// N, so one instruction serves 8 rows and B = 1 wastes 7/8 of an
// instruction, not 15/16. int8 -> bf16 is exact for |q| <= 127, so every
// term equals the plain twin's; only the order of summation differs.
// mma.sync and not wgmma: the bound is bytes, and a warp's m16 tile needs
// no warpgroup-wide shared-memory descriptors for an operand that has to
// be converted from int8 in registers anyway. Warp w takes columns
// [16 w, 16 w + 16); M slots g and g + 8 of its A fragment are columns
// 2g and 2g + 1, so one 16-bit shared load gives both bytes of a k row.
// x is staged once per block as bf16 [row][k] for its chunk, the B
// fragment's layout: a bf16 input by cp.async in tile 0's group, ahead of
// the weights (issued behind them, its loads would wait for their
// stream); the normalised rows by the block's threads.
//
// Split-K reduction: each block leaves its (R x 64) f32 partial in shared
// memory; after cluster.sync() rank r reads the S partials of columns
// [64 r / S, 64 (r + 1) / S) through distributed shared memory in rank
// order and runs the epilogue once per output (scale, bias, gelu_new;
// store f32 or bf16, or += into the f32 residual). No atomics: the same
// inputs give the same bits.
//
// LN (the norm prologue): x is the (B, K) f32 residual. The cluster's 4S
// warps take each row's statistics once, one warp a row held in registers,
// in layer_norm_rows' summation order (common.cuh row_norm_stats), and
// share them through distributed shared memory; each block then stages its
// chunk of the normalised rows, rounded to bf16 once, so the product's
// input equals layer_norm_rows' output bit for bit. (Writing the
// normalised rows from their owners into every rank's staging buffer
// through DSMEM reads x once a cluster, but measured slower on the H100.)
// mode: 0 = store f32, 1 = store bf16, 2 = accumulate into f32.
// ---------------------------------------------------------------------------
constexpr int GR_COLS = 64;            // output columns a cluster
constexpr int GR_THREADS = 128;        // 4 warps x 16 columns
constexpr int GR_KT = 64;              // k rows a weight tile
constexpr int GR_STAGES = 8;           // cp.async ring depth: a 512 chunk
constexpr int GR_TROW = 80;            // bytes a tile row: 64 + 16 padding
constexpr int GR_SLAB = 512;           // k of x staged at once
constexpr int GR_XS = GR_SLAB + 8;     // bf16 a staged x row
constexpr int GR_PS = GR_COLS + 4;     // floats a partial row

// the first k of rank r's chunk when S blocks split K: 16 floor(r T / S),
// T = ceil(K / 16), clipped to K
__host__ __device__ __forceinline__ int gr_lo(int r, int S, int K) {
  const int k = r * ((K + 15) / 16) / S * 16;
  return k < K ? k : K;
}

template <int R>
constexpr size_t gemm_rows_smem() {
  return (size_t)R * GR_XS * 2 + (size_t)GR_STAGES * GR_KT * GR_TROW;
}
static_assert(32 * GR_PS * 4 <= GR_STAGES * GR_KT * GR_TROW,
              "the partials reuse the ring");

// the four int8 bytes of w as f32 bit patterns, exactly and without a
// conversion instruction: byte ^ 0x80 = q + 128 goes into the low mantissa
// of 2^23, and subtracting 2^23 + 128 leaves q. An integer |q| <= 128 has
// no mantissa bits in the low half, so the top 16 bits are its bf16.
__device__ __forceinline__ void i8x4_f32(uint32_t w, uint32_t* f) {
  w ^= 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __float_as_uint(
        __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7650 + i)) -
        8388736.f);
}

// a bf16x2 of the bf16 tops of two such f32: lo in the low half
__device__ __forceinline__ uint32_t bf16x2_of(uint32_t lo, uint32_t hi) {
  return __byte_perm(lo, hi, 0x7632);
}

// c += a b: m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int R, bool LN>
__global__ void __launch_bounds__(GR_THREADS)
int8_gemm_rows_kernel(const void* __restrict__ x, Norm nrm,
                      const int8_t* __restrict__ w,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias, void* __restrict__ out,
                      int B, int K, int N, int gelu, int mode) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);  // [R][GR_XS]
  unsigned char* ring = smem + (size_t)R * GR_XS * 2;  // [stage][KT][TROW]
  float* part = reinterpret_cast<float*>(ring);  // [R][GR_PS], after the loop
  __shared__ float stat[LN ? R : 1][4];          // per row: mu, rstd x 2
  const int S = gridDim.x, rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int n0 = blockIdx.y * GR_COLS;
  const int lo = gr_lo(rank, S, K), hi = gr_lo(rank + 1, S, K);
  const int ntiles = (hi - lo + GR_KT - 1) / GR_KT;
  // the epilogue's column: rank r finalises columns [64 r / S, 64 (r + 1)
  // / S), a thread one of them for rows tid / per, + 128 / per, ...
  const int per = GR_COLS / S, n = n0 + rank * per + tid % per;
  const float sc_n = n < N ? scale[n] : 0.f, bi_n = n < N ? bias[n] : 0.f;
  const float* x32 = reinterpret_cast<const float*>(x);
  const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(x);

  // tile t: k rows lo + 64 t .. of this chunk, columns n0 .. n0 + 63
  auto load_tile = [&](int t) {
    const uint32_t dst = smem_u32(ring + (t % GR_STAGES) * GR_KT * GR_TROW);
#pragma unroll
    for (int j = 0; j < GR_KT * GR_COLS / 16 / GR_THREADS; ++j) {
      const int c = tid + j * GR_THREADS;
      const int r = c >> 2, col = (c & 3) * 16;
      const int k = lo + t * GR_KT + r;
      const bool ok = k < hi && n0 + col < N;
      cp_async16(dst + r * GR_TROW + col,
                 ok ? w + (size_t)k * N + n0 + col : w, ok);
    }
  };
  // a bf16 input reaches xs by cp.async in tile 0's group, ahead of the
  // weights, where K % 8 == 0, x is 16-byte aligned and the chunk is one
  // slab; otherwise (and with the norm prologue) stage_x loads it at the
  // top of each slab. (stage_x for every input measured 2.2-2.7 us slower
  // a call on an H100 at 16 rows: PERF.md.)
  const bool x_async = !LN && hi - lo <= GR_SLAB && K % 8 == 0 &&
                       (uintptr_t)x % 16 == 0;
  if (x_async) {
    const int cpr = (hi - lo + GR_KT - 1) / GR_KT * GR_KT / 8;  // 16 B a row
    for (int i = tid; i < R * cpr; i += GR_THREADS) {
      const int r = i / cpr, c = i - r * cpr, k = lo + 8 * c;
      const bool ok = r < B && k < hi;
      cp_async16(smem_u32(xs + r * GR_XS + 8 * c),
                 ok ? xb + (size_t)r * K + k : xb, ok);
    }
  }
  for (int t = 0; t < GR_STAGES - 1; ++t) {
    if (t < ntiles) load_tile(t);
    cp_async_commit();
  }

  if constexpr (LN) {
    // each row's statistics once in the cluster: warp gw of the 4S takes
    // rows gw, gw + 4S, ...; the other blocks read them from its rank
    const int nw = 4 * S, gw = rank * 4 + warp;
    for (int r = gw; r < B; r += nw)
      row_norm_stats(x32 + (size_t)r * K, K, nrm, lane, stat[r]);
    cluster.sync();
    if (tid < B * 4) {
      const int r = tid >> 2, owner = (r % nw) >> 2;
      if (owner != rank)
        stat[r][tid & 3] =
            cluster.map_shared_rank(&stat[0][0], owner)[r * 4 + (tid & 3)];
    }
    __syncthreads();
  }

  // x for k in [k0, k0 + 512) of the chunk as bf16 [row][k]; zeros past
  // hi (to the tile's end) and in the padding rows. A thread takes 4
  // consecutive k of 8 rows at once, so 8 rows' loads are in flight
  // together: 16-byte f32 or 8-byte bf16 loads where K % 4 == 0 and the
  // operands are aligned, else element by element.
  const bool vec =
      K % 4 == 0 &&
      (LN ? ((uintptr_t)x | (uintptr_t)nrm.s1 | (uintptr_t)nrm.b1 |
             (uintptr_t)nrm.s2 | (uintptr_t)nrm.b2) % 16 == 0
          : (uintptr_t)x % 8 == 0);
  auto load4 = [&](const float* p, int k, bool ok, float* v) {
    if (vec) {
      const float4 t = ok ? __ldg(reinterpret_cast<const float4*>(p + k))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = ok && k + i < hi ? p[k + i] : 0.f;
    }
  };
  auto stage_x = [&](int k0) {
    const int slen = min(GR_SLAB, hi - k0);
    const int slen_pad = (slen + GR_KT - 1) / GR_KT * GR_KT;
    for (int c = tid * 4; c < slen_pad; c += GR_THREADS * 4) {
      const int k = k0 + c;
      const bool kin = c < slen;
      float s1[4], b1[4], s2[4], b2[4];
      if constexpr (LN) {
        load4(nrm.s1, k, kin, s1);
        load4(nrm.b1, k, kin, b1);
        if (nrm.n == 2) {
          load4(nrm.s2, k, kin, s2);
          load4(nrm.b2, k, kin, b2);
        }
      }
#pragma unroll
      for (int r0 = 0; r0 < R; r0 += 8) {
        float v[8][4];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int r = r0 + u;
          const bool ok = kin && r < B;
          if constexpr (LN) {
            load4(x32 + (size_t)r * K, k, ok, v[u]);
          } else if (vec) {
            const uint2 t =
                ok ? __ldg(reinterpret_cast<const uint2*>(xb + (size_t)r * K +
                                                          k))
                   : make_uint2(0u, 0u);
            const float2 a = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&t.x));
            const float2 b = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&t.y));
            v[u][0] = a.x, v[u][1] = a.y, v[u][2] = b.x, v[u][3] = b.y;
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i)
              v[u][i] = ok && k + i < hi
                            ? __bfloat162float(xb[(size_t)r * K + k + i])
                            : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int r = r0 + u;
          if constexpr (LN) {
            if (kin && r < B) {
              const float* st = stat[r];
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                float y = ln_apply(v[u][i], st[0], st[1], s1[i], b1[i]);
                if (nrm.n == 2) y = ln_apply(y, st[2], st[3], s2[i], b2[i]);
                v[u][i] = k + i < hi ? y : 0.f;
              }
            }
          }
          const __nv_bfloat162 lo2 = __floats2bfloat162_rn(v[u][0], v[u][1]);
          const __nv_bfloat162 hi2 = __floats2bfloat162_rn(v[u][2], v[u][3]);
          uint2 packed;
          packed.x = *reinterpret_cast<const uint32_t*>(&lo2);
          packed.y = *reinterpret_cast<const uint32_t*>(&hi2);
          *reinterpret_cast<uint2*>(xs + r * GR_XS + c) = packed;
        }
      }
    }
  };

  // two accumulator sets, even and odd k-steps: two independent mma
  // chains, each half as long
  float acc[2][R / 8][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < R / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[h][j][c] = 0.f;

  constexpr int SLAB_TILES = GR_SLAB / GR_KT;
  for (int t = 0; t < ntiles; ++t) {
    // the last iteration's closing barrier has freed xs and the stage
    if (!x_async && t % SLAB_TILES == 0) stage_x(lo + t * GR_KT);
    if (t + GR_STAGES - 1 < ntiles) load_tile(t + GR_STAGES - 1);
    cp_async_commit();
    cp_async_wait<GR_STAGES - 1>();
    __syncthreads();  // tile t (every thread's copies) and xs are visible
    const unsigned char* tile = ring + (t % GR_STAGES) * GR_KT * GR_TROW;
    const __nv_bfloat16* xt = xs + (t % SLAB_TILES) * GR_KT;
#pragma unroll
    for (int ks = 0; ks < GR_KT; ks += 16) {
      // A: columns 2g, 2g + 1 of the warp's 16 (M slots g, g + 8) at k
      // rows ks + 2 t4 + {0, 1} and + 8
      const unsigned char* wt =
          tile + (ks + 2 * t4) * GR_TROW + warp * 16 + 2 * g;
      const uint32_t h0 = *reinterpret_cast<const uint16_t*>(wt);
      const uint32_t h1 = *reinterpret_cast<const uint16_t*>(wt + GR_TROW);
      const uint32_t h2 =
          *reinterpret_cast<const uint16_t*>(wt + 8 * GR_TROW);
      const uint32_t h3 =
          *reinterpret_cast<const uint16_t*>(wt + 9 * GR_TROW);
      // f: column 2g at k, 2g + 1 at k, 2g at k + 1, 2g + 1 at k + 1
      uint32_t f[4], e[4];
      i8x4_f32(__byte_perm(h0, h1, 0x5410), f);
      i8x4_f32(__byte_perm(h2, h3, 0x5410), e);
      const uint32_t a[4] = {bf16x2_of(f[0], f[2]), bf16x2_of(f[1], f[3]),
                             bf16x2_of(e[0], e[2]), bf16x2_of(e[1], e[3])};
#pragma unroll
      for (int j = 0; j < R / 8; ++j) {
        // B: row 8 j + g of x, k rows ks + 2 t4 + {0, 1} and + 8
        const __nv_bfloat16* xr = xt + (j * 8 + g) * GR_XS + ks + 2 * t4;
        mma_bf16(acc[(ks / 16) & 1][j], a,
                 *reinterpret_cast<const uint32_t*>(xr),
                 *reinterpret_cast<const uint32_t*>(xr + 8));
      }
    }
    // a barrier only where the next iteration refills this stage or
    // restages xs: a chunk of <= 512 fits the ring whole
    if (t + GR_STAGES < ntiles ||
        (!x_async && (t + 1) % SLAB_TILES == 0 && t + 1 < ntiles))
      __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring, which part reuses

  // the block's partial: C row g is column 2g, row g + 8 column 2g + 1;
  // C columns 2 t4, 2 t4 + 1 are rows 8 j + 2 t4, + 1
#pragma unroll
  for (int j = 0; j < R / 8; ++j) {
    const int r0 = j * 8 + 2 * t4, col = warp * 16 + 2 * g;
    part[r0 * GR_PS + col] = acc[0][j][0] + acc[1][j][0];
    part[(r0 + 1) * GR_PS + col] = acc[0][j][1] + acc[1][j][1];
    part[r0 * GR_PS + col + 1] = acc[0][j][2] + acc[1][j][2];
    part[(r0 + 1) * GR_PS + col + 1] = acc[0][j][3] + acc[1][j][3];
  }
  cluster.sync();  // every rank's partial is written and visible

  // the S partials of each output in rank order, then the epilogue; all
  // loads are issued before the stores (out may be read, for +=)
  const int rstep = GR_THREADS / per;  // >= 2
  float y[R / 2];
#pragma unroll
  for (int j = 0; j < R / 2; ++j) {
    const int r = tid / per + j * rstep;
    y[j] = 0.f;
    if (r < B && n < N) {
      const int off = r * GR_PS + (n - n0);
      float p[8];  // every rank's partial in flight at once
#pragma unroll
      for (int q = 0; q < 8; ++q)
        p[q] = q < S ? cluster.map_shared_rank(part, q)[off] : 0.f;
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (q < S) s += p[q];
      y[j] = s * sc_n + bi_n;
      if (gelu) y[j] = gelu_new(y[j]);
    }
  }
  if (mode == 2) {
    float* o32 = reinterpret_cast<float*>(out);
#pragma unroll
    for (int j = 0; j < R / 2; ++j) {
      const int r = tid / per + j * rstep;
      if (r < B && n < N) y[j] += o32[(size_t)r * N + n];
    }
  }
#pragma unroll
  for (int j = 0; j < R / 2; ++j) {
    const int r = tid / per + j * rstep;
    if (r < B && n < N) {
      const size_t o = (size_t)r * N + n;
      if (mode == 1)
        reinterpret_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16(y[j]);
      else
        reinterpret_cast<float*>(out)[o] = y[j];
    }
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

template <int R, bool LN>
int launch_gemm_rows(const void* x, Norm nrm, const void* w,
                     const void* scale, const void* bias, void* out, int B,
                     int K, int N, int splits, int gelu, int mode,
                     cudaStream_t stream) {
  if (splits < 1 || splits > 8 || GR_COLS % splits)
    return (int)cudaErrorInvalidValue;
  constexpr size_t smem = gemm_rows_smem<R>();
  if constexpr (smem > 48 * 1024) {
    // the opt-in costs microseconds: once per device and process
    static unsigned opted = 0;
    int dev = 0;
    cudaGetDevice(&dev);
    if (!(opted >> dev & 1u)) {
      const cudaError_t e = cudaFuncSetAttribute(
          int8_gemm_rows_kernel<R, LN>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
      opted |= 1u << dev;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (N + GR_COLS - 1) / GR_COLS);
  cfg.blockDim = dim3(GR_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, int8_gemm_rows_kernel<R, LN>, x, nrm, (const int8_t*)w,
      (const float*)scale, (const float*)bias, out, B, K, N, gelu, mode);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <int R>
int gemm_rows_r(const void* x, Norm nrm, const void* w, const void* scale,
                const void* bias, void* out, int B, int K, int N, int splits,
                int gelu, int mode, cudaStream_t st) {
  if (nrm.n)
    return launch_gemm_rows<R, true>(x, nrm, w, scale, bias, out, B, K, N,
                                     splits, gelu, mode, st);
  return launch_gemm_rows<R, false>(x, nrm, w, scale, bias, out, B, K, N,
                                    splits, gelu, mode, st);
}

int gemm_rows(const void* x, Norm nrm, const void* w, const void* scale,
              const void* bias, void* out, int B, int K, int N, int splits,
              int gelu, int mode, cudaStream_t st) {
  if (B <= 8)
    return gemm_rows_r<8>(x, nrm, w, scale, bias, out, B, K, N, splits, gelu,
                          mode, st);
  if (B <= 16)
    return gemm_rows_r<16>(x, nrm, w, scale, bias, out, B, K, N, splits,
                           gelu, mode, st);
  return gemm_rows_r<32>(x, nrm, w, scale, bias, out, B, K, N, splits, gelu,
                         mode, st);
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
                             int splits, int gelu, int mode, void* stream) {
  return gemm_rows(x, Norm{nullptr, nullptr, nullptr, nullptr, 0}, w, scale,
                   bias, out, B, K, N, splits, gelu, mode,
                   (cudaStream_t)stream);
}

// bounds[r] = gr_lo(r, S, K) for r = 0..S: int8_gemm_rows' chunks of K,
// for holding the Python copy against this one
XT_API void xt_gemm_rows_bounds(int K, int S, int* bounds) {
  for (int r = 0; r <= S; ++r) bounds[r] = gr_lo(r, S, K);
}

// x32: the (B, K) f32 residual; nln 1 or 2 norms (s1, b1[, s2, b2]) first
XT_API int xt_int8_gemm_rows_ln(const void* x32, const void* s1,
                                const void* b1, const void* s2,
                                const void* b2, int nln, const void* w,
                                const void* scale, const void* bias,
                                void* out, int B, int K, int N, int splits,
                                int gelu, int mode, void* stream) {
  const Norm nrm{(const float*)s1, (const float*)b1, (const float*)s2,
                 (const float*)b2, nln};
  return gemm_rows(x32, nrm, w, scale, bias, out, B, K, N, splits, gelu,
                   mode, (cudaStream_t)stream);
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
