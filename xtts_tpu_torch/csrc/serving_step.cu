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
// serving_attention runs one block per (head, row) with all of its cache
// rows in flight at once (cp.async chunks of 128 positions) and an online
// softmax over the chunks, as the TPU kernel's. Launch cost still
// dominates at 76 launches a step.
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
      // rounded after the product and after the sum, as the plain twin
      y[j] = __fadd_rn(__fmul_rn(s, sc_n), bi_n);
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
// serving_attention: one query per (row, head) over the int8 cache
// positions < idx plus the current token, an online softmax over chunks of
// SA_CHUNK = 128 positions as the TPU kernel's (xtts_tpu/ops/
// serving_step.py:206-270; its chunk is 128 at 8-16 rows of D 1024).
//
// qkv: (B, 3D) f32 [q | k | v] from the qkv product. The grid is (heads,
// B), 256 threads a block, head_dim 64. A block:
//  1. loads its q slice, the row's k and v (for their scales over all D)
//     and issues the cp.async copies of its first SA_STAGES chunks (64
//     bytes of k and of v a position, and the two f32 scales; zero-filled
//     past idx) before it uses any of them: a (row, head)'s 353 positions
//     are 45 KB, all in flight at once from 256 blocks;
//  2. walks the chunks SA_STEP at a time (the next step's copies in flight
//     meanwhile), each step's chunks side by side:
//     - scores, 4 threads a position of 16 dims each: the bf16(k q)
//       products summed in dim order, then a 2-level butterfly; times the
//       k scale x att_scale;
//     - each chunk c in order: m' = max(m, chunk max), alpha_c = exp(m -
//       m'); e = exp(s - m'); E_c = the butterfly sums of its 4 warps' e,
//       in warp order;
//     - each chunk's v sum P_c: group g of 16 adds v (bf16(e) vscale) of
//       positions g, g + 16, ... in turn, then the 16 groups add in order
//       (the v scale folded into each position's weight once, not into
//       each of its 64 terms);
//     - den = den alpha_c + E_c and o = o alpha_c + P_c, chunk by chunk, as
//       the TPU kernel's acc * alpha + contrib;
//  3. quantizes the new row over D (scale max(|y|, 1e-8) / 127, round half
//     to even, clip +-127) and writes its head's 64 values at idx (head 0
//     writes the scales); no block reads position idx (after the chunks,
//     so that they start as soon as the first lands: 1 us earlier, H100);
//  4. takes the current token's score in closed form: bf16(k q) of its 64
//     dims, lane l summing dims 2l and 2l + 1, then a butterfly, times the
//     attention scale;
//  5. adds the current token as the TPU kernel does (m' = max(m, self), den
//     alpha + e_self, o alpha + e_self v), then out = o / den in bf16.
// Every f32 operation rounds on its own (explicitly where nvcc could
// contract it into a fused multiply-add; IEEE divisions; expf), in an order
// the plain twin (ops/serving_step.py
// serving_attention_plain) repeats with PyTorch's elementwise ops, so on
// the card the two give the same bits. The running max starts at -inf,
// and its factor is 0 then (not exp(-inf - -inf)). The int8 values widen
// by a byte_perm, not by a conversion, and the products round to bf16 two
// at a time (the conversion unit runs at a quarter of the FP32 rate; with
// one conversion a value, the scores and the v sum took 5.4 of 12.4 us,
// H100, PERF.md).
//
// Bound: bytes, the cache rows and scales below idx (16 rows x 16 heads x
// 353 positions x 128 bytes, 11.6 MB, 3.5 us at 3.35 TB/s). The earlier
// kernel walked the positions twice, 8 a warp step, each step a dependent
// round trip (34.4 us); here a block's loads are all issued before its
// first product, any idx < S runs through the ring of SA_STAGES chunk
// slots, and nothing of size idx lives in shared memory.
// ---------------------------------------------------------------------------
constexpr int SA_THREADS = 256;
constexpr int SA_CHUNK = 128;          // positions a chunk
constexpr int SA_STEP = 2;             // chunks a step: one a thread's e
constexpr int SA_STAGES = 4;           // chunk slots: two steps in flight
constexpr int SA_GROUPS = SA_THREADS / 16;   // v-sum groups of 16 threads
constexpr size_t SA_SLOT = (size_t)SA_CHUNK * (64 + 64 + 4 + 4);
constexpr size_t SA_SMEM = SA_SLOT * SA_STAGES;
static_assert(SA_CHUNK * SA_STEP == SA_THREADS,
              "one position's e a thread, 4 threads a position's score");
static_assert(SA_STAGES == 2 * SA_STEP, "the ring holds two steps");

__device__ __forceinline__ float sa_factor(float m, float big_m) {
  return m == -INFINITY ? 0.f : expf(__fsub_rn(m, big_m));
}

__global__ void __launch_bounds__(SA_THREADS)
serving_attention_kernel(const float* __restrict__ qkv,
                         int8_t* __restrict__ kc, int8_t* __restrict__ vc,
                         float* __restrict__ ks, float* __restrict__ vs,
                         __nv_bfloat16* __restrict__ out, int S, int D,
                         const long long* __restrict__ idx_ptr,
                         float att_scale) {
  extern __shared__ __align__(16) unsigned char smem[];  // SA_STAGES slots
  __shared__ float red[33];
  __shared__ float sc[SA_THREADS], pv[SA_THREADS];
  __shared__ float wmax[SA_STEP][4], wsum[SA_STEP][4];
  __shared__ __align__(16) float part[SA_STEP][SA_GROUPS][64];
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = h * 64;
  const float* qrow = qkv + (size_t)b * 3 * D;
  const float* krow = qrow + D;
  const float* vrow = qrow + 2 * D;
  const int8_t* kcb = kc + (size_t)b * S * D + c0;
  const int8_t* vcb = vc + (size_t)b * S * D + c0;
  const float* ksb = ks + (size_t)b * S;
  const float* vsb = vs + (size_t)b * S;
  const int idx = (int)*idx_ptr;    // device memory: a graph replays it
  const int nchunks = (idx + SA_CHUNK - 1) / SA_CHUNK;

  // a slot: k [128][64] int8, v [128][64] int8, kscale [128], vscale [128]
  auto slot_k = [&](int c) { return smem + (c % SA_STAGES) * SA_SLOT; };
  auto slot_v = [&](int c) { return slot_k(c) + SA_CHUNK * 64; };
  auto slot_ks = [&](int c) {
    return reinterpret_cast<float*>(slot_k(c) + SA_CHUNK * 128);
  };
  auto slot_vs = [&](int c) { return slot_ks(c) + SA_CHUNK; };
  // chunk c's copies as one commit group (an empty group past the last)
  auto issue = [&](int c) {
    if (c < nchunks) {
      const int p0 = c * SA_CHUNK;
      const uint32_t dk = smem_u32(slot_k(c)), dv = smem_u32(slot_v(c));
      for (int i = tid; i < SA_CHUNK * 4; i += SA_THREADS) {
        const int p = i >> 2, part16 = (i & 3) * 16, s = p0 + p;
        const bool ok = s < idx;
        const size_t off = (size_t)(ok ? s : 0) * D + part16;
        cp_async16(dk + p * 64 + part16, kcb + off, ok);
        cp_async16(dv + p * 64 + part16, vcb + off, ok);
      }
      if (tid < SA_CHUNK) {
        const int s = p0 + tid;
        const bool ok = s < idx;
        cp_async4(smem_u32(slot_ks(c) + tid), ksb + (ok ? s : 0), ok);
        cp_async4(smem_u32(slot_vs(c) + tid), vsb + (ok ? s : 0), ok);
      }
    }
    cp_async_commit();
  };

  // ---- 1. the inputs' loads, then every chunk slot's copies ----
  const int qq = tid & 3;  // the score's dims 16 qq .. 16 qq + 15
  float qv[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) qv[i] = qrow[c0 + 16 * qq + i];
  float kr[4], vr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int d = tid + i * SA_THREADS;
    kr[i] = d < D ? krow[d] : 0.f;
    vr[i] = d < D ? vrow[d] : 0.f;
  }
  float self_k[2], self_q[2];
  if (warp == 0) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      self_k[u] = krow[c0 + 2 * lane + u];
      self_q[u] = qrow[c0 + 2 * lane + u];
    }
  }
  for (int c = 0; c < SA_STAGES; ++c) issue(c);

#pragma unroll
  for (int i = 0; i < 16; ++i) qv[i] = bf16_round(qv[i]);

  // ---- 2. the chunks, SA_STEP a step ----
  const int vq = tid & 15, vg = tid >> 4;  // v sum: dims 4 vq.., group vg
  const int cb = tid >> 7;                 // the chunk of this thread's e
  float m = -INFINITY, den = 0.f, o = 0.f;  // den, o: threads < 64 (dim)
  for (int c1 = 0; c1 < nchunks; c1 += SA_STEP) {
    const int nb = min(SA_STEP, nchunks - c1);  // chunks this step
    cp_async_wait<SA_STAGES - SA_STEP>();
    __syncthreads();  // the step's chunks (every thread's copies) landed
    // scores: position p = tid / 4 + 64 i of the step, quarter qq
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = (tid >> 2) + 64 * i, c = c1 + (p >> 7), pc = p & 127;
      if (c - c1 >= nb) break;  // uniform: no chunk there
      const uint4 raw = *reinterpret_cast<const uint4*>(
          slot_k(c) + pc * 64 + 16 * qq);
      const uint32_t wd[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u,
                              raw.z ^ 0x80808080u, raw.w ^ 0x80808080u};
      float a = 0.f;
#pragma unroll
      for (int j = 0; j < 16; j += 2) {
        // two products rounded to bf16 by one packed conversion
        const float2 pr = __bfloat1622float2(__floats2bfloat162_rn(
            __fmul_rn(byte_f32(wd[j >> 2], j & 3, 8388736.f), qv[j]),
            __fmul_rn(byte_f32(wd[j >> 2], (j & 3) + 1, 8388736.f),
                      qv[j + 1])));
        a = __fadd_rn(__fadd_rn(a, pr.x), pr.y);
      }
      a = __fadd_rn(a, __shfl_xor_sync(0xffffffffu, a, 1));
      a = __fadd_rn(a, __shfl_xor_sync(0xffffffffu, a, 2));
      if (qq == 0)
        sc[p] = c * SA_CHUNK + pc < idx
                    ? __fmul_rn(a, __fmul_rn(slot_ks(c)[pc], att_scale))
                    : -INFINITY;
    }
    __syncthreads();
    // each chunk's max: warps 4 cb .. 4 cb + 3 hold its 128 scores
    const float s = sc[tid];
    if (cb < nb) {
      const float wm = warp_max(s);
      if (lane == 0) wmax[cb][warp & 3] = wm;
    }
    __syncthreads();
    float mc[SA_STEP], al[SA_STEP];  // each chunk's running max and factor
#pragma unroll
    for (int cc = 0; cc < SA_STEP; ++cc) {
      const float prev = cc ? mc[cc - 1] : m;
      mc[cc] = cc < nb ? fmaxf(prev, fmaxf(fmaxf(wmax[cc][0], wmax[cc][1]),
                                           fmaxf(wmax[cc][2], wmax[cc][3])))
                       : prev;
      al[cc] = sa_factor(prev, mc[cc]);
    }
    if (cb < nb) {
      const float e = expf(__fsub_rn(s, mc[cb]));
      pv[tid] = __fmul_rn(bf16_round(e),
                          slot_vs(c1 + cb)[tid & (SA_CHUNK - 1)]);
      float t = e;
      for (int off = 16; off > 0; off >>= 1)
        t = __fadd_rn(t, __shfl_xor_sync(0xffffffffu, t, off));
      if (lane == 0) wsum[cb][warp & 3] = t;
    }
    __syncthreads();
    // each chunk's v sum: group vg's positions in turn
    for (int cc = 0; cc < nb; ++cc) {
      const int8_t* vt = reinterpret_cast<const int8_t*>(slot_v(c1 + cc));
      float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int p = vg; p < SA_CHUNK; p += SA_GROUPS) {
        const uint32_t wd =
            *reinterpret_cast<const uint32_t*>(vt + p * 64 + 4 * vq) ^
            0x80808080u;
        const float w = pv[cc * SA_CHUNK + p];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = __fadd_rn(a[i], __fmul_rn(byte_f32(wd, i, 8388736.f), w));
      }
      *reinterpret_cast<float4*>(&part[cc][vg][4 * vq]) =
          make_float4(a[0], a[1], a[2], a[3]);
    }
    __syncthreads();  // the slots are free; part, wsum are written
    for (int cc = 0; cc < SA_STEP; ++cc) issue(c1 + SA_STAGES + cc);
    if (tid < 64) {
      for (int cc = 0; cc < nb; ++cc) {
        float pc = 0.f;
#pragma unroll
        for (int g = 0; g < SA_GROUPS; ++g) pc = __fadd_rn(pc, part[cc][g][tid]);
        const float ec = __fadd_rn(
            __fadd_rn(__fadd_rn(wsum[cc][0], wsum[cc][1]), wsum[cc][2]),
            wsum[cc][3]);
        den = __fadd_rn(__fmul_rn(den, al[cc]), ec);
        o = __fadd_rn(__fmul_rn(o, al[cc]), pc);
      }
    }
    m = mc[SA_STEP - 1];
  }
  cp_async_wait<0>();

  // ---- 3. the new row, quantized over D: both maxima in one reduction
  // (the warps' in red[0..15]) ----
  float km = 0.f, vm = 0.f;
  for (int i = 0; i < 4; ++i) {
    km = fmaxf(km, fabsf(kr[i]));
    vm = fmaxf(vm, fabsf(vr[i]));
  }
  for (int d = tid + 4 * SA_THREADS; d < D; d += SA_THREADS) {
    km = fmaxf(km, fabsf(krow[d]));
    vm = fmaxf(vm, fabsf(vrow[d]));
  }
  km = warp_max(km);
  vm = warp_max(vm);
  if (lane == 0) {
    red[warp] = km;
    red[8 + warp] = vm;
  }
  // ---- 4. the current token's score ----
  if (warp == 0) {
    float p = __fadd_rn(bf16_round(__fmul_rn(self_k[0], self_q[0])),
                        bf16_round(__fmul_rn(self_k[1], self_q[1])));
    for (int off = 16; off > 0; off >>= 1)
      p = __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, off));
    if (lane == 0) red[32] = __fmul_rn(p, att_scale);
  }
  __syncthreads();
  for (int w = 0; w < SA_THREADS / 32; ++w) {
    km = fmaxf(km, red[w]);
    vm = fmaxf(vm, red[8 + w]);
  }
  const float kscale = fmaxf(km, 1e-8f) / 127.f;
  const float vscale = fmaxf(vm, 1e-8f) / 127.f;
  if (tid < 64) {
    kc[((size_t)b * S + idx) * D + c0 + tid] = quant(krow[c0 + tid], kscale);
    vc[((size_t)b * S + idx) * D + c0 + tid] = quant(vrow[c0 + tid], vscale);
  }
  if (h == 0 && tid == 0) {
    ks[(size_t)b * S + idx] = kscale;
    vs[(size_t)b * S + idx] = vscale;
  }

  // ---- 5. the current token ----
  if (tid < 64) {
    const float self_s = red[32];
    const float m_new = fmaxf(m, self_s);
    const float alpha = sa_factor(m, m_new);
    const float e_self = expf(__fsub_rn(self_s, m_new));
    const float l = __fadd_rn(__fmul_rn(den, alpha), e_self);
    o = __fadd_rn(__fmul_rn(o, alpha), __fmul_rn(e_self, vrow[c0 + tid]));
    out[(size_t)b * D + c0 + tid] = __float2bfloat16(o / l);
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

// idx: a device int64, the position of the current token (the TPU
// kernel's scalar-prefetched index), so one captured launch serves every step
XT_API int xt_serving_attention(const void* qkv, void* kc, void* vc, void* ks,
                                void* vs, void* out, int B, int S, int D,
                                int heads, const void* idx, float att_scale,
                                void* stream) {
  // the opt-in above 48 KB costs microseconds: once per device and process
  static unsigned opted = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (!(opted >> dev & 1u)) {
    const cudaError_t e = cudaFuncSetAttribute(
        serving_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SA_SMEM);
    if (e != cudaSuccess) return (int)e;
    opted |= 1u << dev;
  }
  serving_attention_kernel<<<dim3(heads, B), SA_THREADS, SA_SMEM,
                             (cudaStream_t)stream>>>(
      (const float*)qkv, (int8_t*)kc, (int8_t*)vc, (float*)ks, (float*)vs,
      (__nv_bfloat16*)out, S, D, (const long long*)idx, att_scale);
  return (int)cudaGetLastError();
}
