// K2 for Hopper: exact non-causal attention, forward and backward, for the
// diffusion UNet's consumer self-attention.
//
// Replaces the Pallas TPU flash kernels behind xtts_tpu/nn/flash_attn.py
// flash_mha (jax.experimental.pallas.ops.tpu.flash_attention, called at
// xtts_tpu/nn/flash_attn.py:99): the forward, and under jax.grad the
// library's _flash_attention_bwd_dkv and _flash_attention_bwd_dq. On the
// serving path: q (2, 1280, 8, 64), k/v (2, 1562, 8, 64) at code bucket 320
// — 4 x 50 forward calls a request, bf16 or f32 (TextToSpeech's default).
//
// Four kernels, each generic in where the (B, T, H, 64) views' strides put
// their rows (the projections' head-split views arrive as they are):
//
// flash_fwd_kernel (bf16). Bound: tensor-core FLOPs. 4 * B * H * Tq * Tk *
// 64 = 8.2 GFLOP a call at the shape above (8.3 us at 989 TFLOP/s),
// against ~5 MB of q/k/v/o; the score matrix (2 x 8 x 1280 x 1562) never
// leaves the registers.
//
// Design (one warpgroup of 128 threads per 64-query tile of one (batch
// row, head); 20 x 8 x 2 = 320 blocks at the main shape, 41 KB of shared
// memory each, so every block of the grid is resident on the 132 SMs; 41
// KB is under the 48 KB a launch may take without an opt-in, so no call
// pays for cudaFuncSetAttribute):
// - Q (64 x 64) is copied into shared memory once.
// - K and V tiles of 64 rows stream through a two-stage ring in shared
//   memory with cp.async commit groups: tile t + 1 is in flight while tile
//   t computes, and one __syncthreads a tile both publishes tile t and
//   frees the stage that tile t + 1 lands in. cp.async and not TMA: the
//   (B, T, H, 64) views arrive with any strides, cp.async's src-size 0
//   zero-fills the rows past Tq / Tk, and the ring needs no tensor map
//   built on the host (nor -lcuda) per call.
// - Every tile is stored in the 128-byte-swizzle layout wgmma reads (16-B
//   chunk c of row r at r * 128 + ((c ^ (r % 8)) * 16), 1024-B aligned).
// - S = Q K^T: wgmma.mma_async m64n64k16 bf16, both operands from shared
//   memory descriptors (K-major), f32 accumulator in registers.
// - Online softmax on those registers: a thread holds rows g and g + 8 of
//   its warp's 16 (g = lane / 4), 16 columns each, so the row max takes two
//   xor-shuffles within the quad; columns >= Tk are -inf before the max;
//   exp2 with the scale folded in; the row sum stays per thread until the
//   end (one quad fold).
// - O += P V: P rounded to bf16 in registers is wgmma's register-A operand
//   (the m64n16 accumulator layout of two n8 blocks is the A fragment of
//   one k16 step); V is the shared-memory B operand read MN-major (trans-b,
//   which bf16 allows), so no transpose of V is stored.
// - O stays in registers, is rescaled by alpha there, and is normalised and
//   stored as bf16 once; the ragged Tq edge is not stored.
// - With an lse buffer (training) the row's log-sum-exp of the scaled
//   scores is stored too, in natural log as the plain version gives it
//   ((m * scale * log2 e + log2 l) * ln 2; the backward multiplies by
//   log2 e again to rebuild P with exp2); without one (serving) nothing
//   else changes.
//
// flash_fwd_tile_kernel<float> (f32 inputs, as the Pallas kernel takes
// them). The same grid and online softmax on the same accumulator layout;
// S and P V are f32 FMA tiles (tile_mma<float>), no TF32: every product and
// sum is an f32 operation, so the output differs from f32 attention only
// in the order of the sums. Bound: 4 B H Tq Tk 64 operations at the 67
// TFLOP/s of f32 outside the tensor cores (0.12 ms at the main shape).
//
// flash_bwd_dkv_kernel<T> (counterpart of _flash_attention_bwd_dkv) and
// flash_bwd_dq_kernel<T> (of _flash_attention_bwd_dq), T bf16 or float
// from one source. Bound: the backward's five products, 10 B H Tq Tk 64 =
// 20.5 GFLOP at the main shape (20.7 us at 989 TFLOP/s bf16; f32 at 67
// TFLOP/s), against ~10 MB of q/k/v/o/dO/dq/dk/dv. D = rowsum(dO * O) in
// f32 comes in from the caller (torch ops, as JAX computes it in XLA
// outside its kernels); lse (natural log) from the forward.
// - dkv: one 128-thread block for each (64-key tile, head, batch row). K
//   and V stay in shared memory; the block loops over the 64-query tiles:
//   S^T = K Q^T and dP^T = V dO^T (keys are the accumulator rows), then
//   P^T = exp2(S^T scale log2 e - lse) (0 past Tk; the rows past Tq load
//   lse = +inf and D = 0, so their P and dS are exactly 0: no 0 * NaN),
//   dS^T = P^T (dP^T - D) scale, P^T and dS^T rounded to T into shared
//   memory, dV += P^T dO and dK += dS^T Q in f32 registers; stored once.
// - dq: one block for each (64-query tile, head, batch row), looping over
//   the key tiles: S, dP, P and dS as above with queries as rows, dS
//   rounded to T, dQ += dS K.
// - No atomics: each block owns its output rows, so the gradients are the
//   same from run to run, as the Pallas kernels' are.
// - Products on tile_mma<T>: for bf16 mma.sync m16n8k16 (f32 accumulate)
//   on fragments read from padded row-major tiles (72-element rows: the
//   quads' reads fall in distinct banks); for f32, FMA on the same
//   accumulator layout. The simple design first: synchronous 16-byte tile
//   loads, no ring, the P / dS tiles through shared memory.
//
// C interface (ctypes): returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define XT_API extern "C"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;                  // query rows per block (wgmma M)
constexpr int BK = 64;                  // key rows per tile
constexpr int THREADS = 128;            // one warpgroup
constexpr int TILE_BYTES = 64 * 128;    // 64 rows x 64 bf16
constexpr int STAGES = 2;               // K/V ring depth
constexpr int SMEM_BYTES = (1 + 2 * STAGES) * TILE_BYTES + 1024;  // + align
static_assert(SMEM_BYTES <= 48 * 1024, "more would need an opt-in per device");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A 64 x 64 bf16 tile (rows row0.. of a view with row stride `stride`
// elements) into the swizzled layout at shared address dst; rows at or
// past nrows are zero-filled. 512 16-byte chunks, 4 a thread; 8
// neighbouring threads read one 128-byte row.
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          long long stride, int row0,
                                          int nrows) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int id = threadIdx.x + j * THREADS;
    const int r = id >> 3, c = id & 7;
    const bool valid = row0 + r < nrows;
    const bf16* g = valid ? src + (long long)(row0 + r) * stride + c * 8 : src;
    cp_async16(dst + r * 128 + ((c ^ (r & 7)) << 4), g, valid);
  }
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address
// >> 4 (bits 0-13), leading byte offset >> 4 (16-29), stride byte offset
// >> 4 (32-45), layout 1 = 128B swizzle (62-63). One 8-row group of a tile
// is 1024 bytes. K-major operands (Q, K) read only the stride byte offset
// (8-row groups along M / N); the MN-major V tile, one swizzle atom wide in
// N (64 bf16), steps its 8-row groups along K by the same 1024 bytes —
// both offsets carry it, so either reading of the two fields holds.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving register reads and writes across the
// asynchronous wgmma (it cannot see that the asm is still running)
__device__ __forceinline__ void fence_regs(float (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define XT_ACC32(d)                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])

#define XT_D32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d (+)= A B, m64n64k16, A and B K-major from shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " XT_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : XT_ACC32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, m64n64k16, A from registers (4 x bf16x2), B MN-major in shared
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " XT_D32
      ", {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : XT_ACC32(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// lse (B, H, Tq) f32, contiguous: rows r0 and r0 + 8 where they are < Tq;
// v0, v1 in log2 units, stored in natural log
__device__ __forceinline__ void store_lse(float* lse, int b, int h, int Tq,
                                          int r0, float v0, float v1) {
  constexpr float LN2 = 0.6931471805599453f;
  float* row = lse + ((long long)b * gridDim.y + h) * Tq;
  if (r0 < Tq) row[r0] = v0 * LN2;
  if (r0 + 8 < Tq) row[r0 + 8] = v1 * LN2;
}

// Accumulator layout of m64n64 (f32, 32 a thread): warp w, lane l,
// g = l / 4, q = l % 4. Register 4j + c holds (row 16w + g, column 8j +
// 2q + c); 4j + 2 + c holds row 16w + g + 8, same column (c = 0, 1).
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int Tq, int Tk, long long sqb,
                 long long sqt, long long sqh, long long skb, long long skt,
                 long long skh, long long svb, long long svt, long long svh,
                 long long sob, long long sot, long long soh,
                 float scale_log2) {
  extern __shared__ unsigned char smem[];
  const uint32_t raw = smem_u32(smem);
  const uint32_t sQ = (raw + 1023u) & ~1023u;  // swizzle atoms: 1024-B aligned
  auto sK = [&](int s) { return sQ + (1 + 2 * s) * TILE_BYTES; };
  auto sV = [&](int s) { return sQ + (2 + 2 * s) * TILE_BYTES; };

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, cq = (lane & 3) * 2;
  const bf16* qb = q + b * sqb + h * sqh;
  const bf16* kb = k + b * skb + h * skh;
  const bf16* vb = v + b * svb + h * svh;
  const int ntiles = (Tk + BK - 1) / BK;

  load_tile(sQ, qb, sqt, q0, Tq);
  load_tile(sK(0), kb, skt, 0, Tk);
  load_tile(sV(0), vb, svt, 0, Tk);
  cp_async_commit();

  float acc_o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows g, g + 8
  float l0 = 0.f, l1 = 0.f;              // this thread's part of the sums

  for (int t = 0; t < ntiles; ++t) {
    const int st = t % STAGES;
    cp_async_wait_all();                    // tile t (and Q) landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();                        // ... for every thread; tile t-1
                                            // is done, its stage is free
    if (t + 1 < ntiles) {
      load_tile(sK((t + 1) % STAGES), kb, skt, (t + 1) * BK, Tk);
      load_tile(sV((t + 1) % STAGES), vb, svt, (t + 1) * BK, Tk);
    }
    cp_async_commit();

    // ---- S = Q K^T ----
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(s, desc(sQ + 32 * kk), desc(sK(st) + 32 * kk), kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // ---- online softmax on the accumulator registers ----
    const int k0 = t * BK;
    if (k0 + BK > Tk) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (k0 + 8 * j + cq + c >= Tk)
            s[4 * j + c] = s[4 * j + 2 + c] = -INFINITY;
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
    // every tile holds at least one valid column, so mx0 / mx1 are finite
    const float alpha0 = exp2f((m0 - mx0) * scale_log2);
    const float alpha1 = exp2f((m1 - mx1) * scale_log2);
    m0 = mx0;
    m1 = mx1;
    const float mb0 = mx0 * scale_log2, mb1 = mx1 * scale_log2;
    uint32_t p[16];
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float e0 = exp2f(fmaf(s[4 * j], scale_log2, -mb0));
      const float e1 = exp2f(fmaf(s[4 * j + 1], scale_log2, -mb0));
      const float e2 = exp2f(fmaf(s[4 * j + 2], scale_log2, -mb1));
      const float e3 = exp2f(fmaf(s[4 * j + 3], scale_log2, -mb1));
      rs0 += e0 + e1;
      rs1 += e2 + e3;
      p[2 * j] = pack_bf16(e0, e1);
      p[2 * j + 1] = pack_bf16(e2, e3);
    }
    l0 = l0 * alpha0 + rs0;
    l1 = l1 * alpha1 + rs1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc_o[4 * j] *= alpha0;
      acc_o[4 * j + 1] *= alpha0;
      acc_o[4 * j + 2] *= alpha1;
      acc_o[4 * j + 3] *= alpha1;
    }

    // ---- O += P V: k16 step kk takes keys 16 kk .. 16 kk + 15, whose
    // accumulator blocks 2 kk, 2 kk + 1 are its A fragment ----
    fence_regs(acc_o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc_o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
               desc(sV(st) + 2048 * kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc_o);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  if (lse != nullptr && cq == 0)
    store_lse(lse, b, h, Tq, r0, m0 * scale_log2 + log2f(l0),
              m1 * scale_log2 + log2f(l1));
  bf16* ob = o + b * sob + h * soh;
  if (r0 < Tq) {
    bf16* op = ob + (long long)r0 * sot + cq;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(op + 8 * j) = __floats2bfloat162_rn(
          acc_o[4 * j] * inv0, acc_o[4 * j + 1] * inv0);
  }
  if (r1 < Tq) {
    bf16* op = ob + (long long)r1 * sot + cq;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(op + 8 * j) = __floats2bfloat162_rn(
          acc_o[4 * j + 2] * inv1, acc_o[4 * j + 3] * inv1);
  }
}

// ---------------------------------------------------------------------------
// The tile kernels: the f32 forward and both backward kernels, generic in T
// (bf16 or float). A tile is 64 rows x 64 elements of T in shared memory,
// row-major with a padded row of LD<T> elements (a multiple of 16 bytes).

template <typename T>
struct Tile;
template <>
struct Tile<bf16> {
  static constexpr int LD = 72;
};
template <>
struct Tile<float> {
  static constexpr int LD = 68;
};
template <typename T>
__host__ __device__ constexpr int tile_elems() {
  return 64 * Tile<T>::LD;
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}

// rows row0.. of a (T, 64) view with row stride `stride` elements into a
// tile; rows at or past nrows are zero. 16-byte loads: the caller checks
// that strides and bases allow them.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* src,
                                          long long stride, int row0,
                                          int nrows) {
  constexpr int EPC = 16 / sizeof(T);  // elements a 16-byte chunk
  constexpr int CPR = 64 / EPC;        // chunks a row
  for (int id = threadIdx.x; id < 64 * CPR; id += THREADS) {
    const int r = id / CPR, c = id % CPR;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows)
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) *
                                                      stride + c * EPC);
    *reinterpret_cast<uint4*>(dst + r * Tile<T>::LD + c * EPC) = val;
  }
}

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_pair(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// d[0..3] += a (16 x 16, row) b (16 x 8, col): bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// acc += A B over k = 0..63 for the warp's 16 rows of a 64 x 64 product, in
// the accumulator layout of the bf16 forward (register 4j + c: row 16 warp
// + g, column 8j + 2q + c; 4j + 2 + c: row + 8). A is a tile, row-major
// (rows x k). NT: B(k, n) = tile Bt[n][k]; else B(k, n) = tile B[k][n].
template <bool NT>
__device__ __forceinline__ void tile_mma(float (&acc)[32], const bf16* A,
                                         const bf16* B) {
  constexpr int LD = Tile<bf16>::LD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const bf16* alo = A + (16 * warp + g) * LD + t2;
  const bf16* ahi = alo + 8 * LD;
#pragma unroll
  for (int k0 = 0; k0 < 64; k0 += 16) {
    const uint32_t a0 = ld_pair(alo + k0), a1 = ld_pair(ahi + k0);
    const uint32_t a2 = ld_pair(alo + k0 + 8), a3 = ld_pair(ahi + k0 + 8);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = 8 * j + g;
      uint32_t b0, b1;
      if (NT) {
        b0 = ld_pair(B + n * LD + k0 + t2);
        b1 = ld_pair(B + n * LD + k0 + 8 + t2);
      } else {
        const bf16* col = B + (k0 + t2) * LD + n;
        b0 = pack_pair(col[0], col[LD]);
        b1 = pack_pair(col[8 * LD], col[9 * LD]);
      }
      mma_bf16(acc + 4 * j, a0, a1, a2, a3, b0, b1);
    }
  }
}

template <bool NT>
__device__ __forceinline__ void tile_mma(float (&acc)[32], const float* A,
                                         const float* B) {
  constexpr int LD = Tile<float>::LD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const float* alo = A + (16 * warp + g) * LD;
  const float* ahi = alo + 8 * LD;
#pragma unroll 4
  for (int k = 0; k < 64; ++k) {
    const float a_lo = alo[k], a_hi = ahi[k];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int n = 8 * j + t2 + c;
        const float bv = NT ? B[n * LD + k] : B[k * LD + n];
        acc[4 * j + c] = fmaf(a_lo, bv, acc[4 * j + c]);
        acc[4 * j + 2 + c] = fmaf(a_hi, bv, acc[4 * j + 2 + c]);
      }
    }
  }
}

// a thread's accumulator values into tile rows (16 warp + g, + 8), as T
template <typename T>
__device__ __forceinline__ void store_acc(T* tile, const float (&v)[32]) {
  constexpr int LD = Tile<T>::LD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  T* lo = tile + (16 * warp + g) * LD + t2;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      lo[8 * j + c] = from_f<T>(v[4 * j + c]);
      lo[8 * LD + 8 * j + c] = from_f<T>(v[4 * j + 2 + c]);
    }
}

// a thread's accumulator rows (row0 + 16 warp + g, + 8) of a (T, 64) view,
// rows at or past nrows left out
template <typename T>
__device__ __forceinline__ void store_rows(T* dst, long long stride,
                                           int row0, int nrows,
                                           const float (&v)[32]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const int r0 = row0 + 16 * warp + g, r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (r0 < nrows)
        dst[(long long)r0 * stride + 8 * j + t2 + c] = from_f<T>(v[4 * j + c]);
      if (r1 < nrows)
        dst[(long long)r1 * stride + 8 * j + t2 + c] =
            from_f<T>(v[4 * j + 2 + c]);
    }
}

// Forward on tiles (the f32 variant): flash_fwd_kernel's online softmax,
// S = Q K^T and O += P V as tile products, P through shared memory.
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_tile_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
                      float* __restrict__ lse, int Tq, int Tk, long long sqb,
                      long long sqt, long long sqh, long long skb,
                      long long skt, long long skh, long long svb,
                      long long svt, long long svh, long long sob,
                      long long sot, long long soh, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_t[];
  T* sQ = reinterpret_cast<T*>(smem_t);
  T* sK = sQ + tile_elems<T>();
  T* sV = sK + tile_elems<T>();
  T* sP = sV + tile_elems<T>();
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, cq = (lane & 3) * 2;
  const T* kb = k + b * skb + h * skh;
  const T* vb = v + b * svb + h * svh;
  load_rows(sQ, q + b * sqb + h * sqh, sqt, q0, Tq);

  float acc_o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  for (int k0 = 0; k0 < Tk; k0 += BK) {
    __syncthreads();  // the last tile's products are done with sK, sV
    load_rows(sK, kb, skt, k0, Tk);
    load_rows(sV, vb, svt, k0, Tk);
    __syncthreads();
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    tile_mma<true>(s, sQ, sK);
    if (k0 + BK > Tk) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (k0 + 8 * j + cq + c >= Tk)
            s[4 * j + c] = s[4 * j + 2 + c] = -INFINITY;
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int sh = 1; sh <= 2; sh <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, sh));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, sh));
    }
    const float alpha0 = exp2f((m0 - mx0) * scale_log2);
    const float alpha1 = exp2f((m1 - mx1) * scale_log2);
    m0 = mx0;
    m1 = mx1;
    const float mb0 = mx0 * scale_log2, mb1 = mx1 * scale_log2;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[4 * j] = exp2f(fmaf(s[4 * j], scale_log2, -mb0));
      s[4 * j + 1] = exp2f(fmaf(s[4 * j + 1], scale_log2, -mb0));
      s[4 * j + 2] = exp2f(fmaf(s[4 * j + 2], scale_log2, -mb1));
      s[4 * j + 3] = exp2f(fmaf(s[4 * j + 3], scale_log2, -mb1));
      rs0 += s[4 * j] + s[4 * j + 1];
      rs1 += s[4 * j + 2] + s[4 * j + 3];
    }
    l0 = l0 * alpha0 + rs0;
    l1 = l1 * alpha1 + rs1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc_o[4 * j] *= alpha0;
      acc_o[4 * j + 1] *= alpha0;
      acc_o[4 * j + 2] *= alpha1;
      acc_o[4 * j + 3] *= alpha1;
    }
    store_acc(sP, s);  // the warp's own rows: it alone reads them back
    __syncwarp();
    tile_mma<false>(acc_o, sP, sV);
    __syncwarp();      // done reading sP before the next tile writes it
  }
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int r0 = q0 + (threadIdx.x >> 5) * 16 + (lane >> 2);
  if (lse != nullptr && cq == 0)
    store_lse(lse, b, h, Tq, r0, m0 * scale_log2 + log2f(l0),
              m1 * scale_log2 + log2f(l1));
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    acc_o[4 * j] *= inv0;
    acc_o[4 * j + 1] *= inv0;
    acc_o[4 * j + 2] *= inv1;
    acc_o[4 * j + 3] *= inv1;
  }
  store_rows(o + b * sob + h * soh, sot, q0, Tq, acc_o);
}

// P and dS of one 64 x 64 tile from S and dP in the accumulator layout:
// p = exp2(s scale log2 e - lse), 0 where `keep` is false; ds = (dp - D) p
// scale (the Pallas kernels' order), in place of s and dp. lse and D are
// the query's: the accumulator row's where rows are queries (dq), else the
// column's (dkv, where rows are keys).
template <bool ROWS_ARE_QUERIES>
__device__ __forceinline__ void p_and_ds(float (&s)[32], float (&dp)[32],
                                         const float* sL, const float* sD,
                                         int key0, int Tk, float scale_log2,
                                         float scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const int r0 = 16 * warp + g, r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = 8 * j + t2 + c;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = half ? r1 : r0, i = 4 * j + 2 * half + c;
        const int qi = ROWS_ARE_QUERIES ? row : col;
        const int key = key0 + (ROWS_ARE_QUERIES ? col : row);
        const float p = key < Tk ? exp2f(fmaf(s[i], scale_log2, -sL[qi]))
                                 : 0.f;
        s[i] = p;
        dp[i] = (dp[i] - sD[qi]) * p * scale;
      }
    }
}

// lse (back in log2 units) and D of the query rows q0.. (rows past Tq:
// lse +inf, D 0)
__device__ __forceinline__ void load_stats(float* sL, float* sD,
                                           const float* lse,
                                           const float* delta, int q0,
                                           int Tq) {
  if (threadIdx.x < 64) {
    const int r = q0 + threadIdx.x;
    sL[threadIdx.x] = r < Tq ? lse[r] * 1.4426950408889634f : INFINITY;
    sD[threadIdx.x] = r < Tq ? delta[r] : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int Tq, int Tk, long long sqb,
                     long long sqt, long long sqh, long long skb,
                     long long skt, long long skh, long long svb,
                     long long svt, long long svh, long long sdb,
                     long long sdt, long long sdh, long long skgb,
                     long long skgt, long long skgh, long long svgb,
                     long long svgt, long long svgh, float scale_log2,
                     float scale) {
  extern __shared__ __align__(16) unsigned char smem_t[];
  T* sK = reinterpret_cast<T*>(smem_t);
  T* sV = sK + tile_elems<T>();
  T* sQ = sV + tile_elems<T>();
  T* sdO = sQ + tile_elems<T>();
  T* sPt = sdO + tile_elems<T>();
  T* sdSt = sPt + tile_elems<T>();
  float* sL = reinterpret_cast<float*>(sdSt + tile_elems<T>());
  float* sD = sL + 64;
  const int k0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  const T* qb = q + b * sqb + h * sqh;
  const T* db = dout + b * sdb + h * sdh;
  const long long st = ((long long)b * gridDim.y + h) * Tq;
  load_rows(sK, k + b * skb + h * skh, skt, k0, Tk);
  load_rows(sV, v + b * svb + h * svh, svt, k0, Tk);

  float acc_dk[32], acc_dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_dk[i] = acc_dv[i] = 0.f;
  for (int q0 = 0; q0 < Tq; q0 += BQ) {
    __syncthreads();  // the last query tile's products are done
    load_rows(sQ, qb, sqt, q0, Tq);
    load_rows(sdO, db, sdt, q0, Tq);
    load_stats(sL, sD, lse + st, delta + st, q0, Tq);
    __syncthreads();
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    tile_mma<true>(s, sK, sQ);    // S^T: keys x queries
    tile_mma<true>(dp, sV, sdO);  // dP^T
    p_and_ds<false>(s, dp, sL, sD, k0, Tk, scale_log2, scale);
    store_acc(sPt, s);            // P^T and dS^T rounded to T, the warp's
    store_acc(sdSt, dp);          // own rows
    __syncwarp();
    tile_mma<false>(acc_dv, sPt, sdO);   // dV += P^T dO
    tile_mma<false>(acc_dk, sdSt, sQ);   // dK += dS^T Q
  }
  store_rows(dk + b * skgb + h * skgh, skgt, k0, Tk, acc_dk);
  store_rows(dv + b * svgb + h * svgh, svgt, k0, Tk, acc_dv);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int Tq, int Tk, long long sqb, long long sqt,
                    long long sqh, long long skb, long long skt,
                    long long skh, long long svb, long long svt,
                    long long svh, long long sdb, long long sdt,
                    long long sdh, long long sqgb, long long sqgt,
                    long long sqgh, float scale_log2, float scale) {
  extern __shared__ __align__(16) unsigned char smem_t[];
  T* sQ = reinterpret_cast<T*>(smem_t);
  T* sdO = sQ + tile_elems<T>();
  T* sK = sdO + tile_elems<T>();
  T* sV = sK + tile_elems<T>();
  T* sdS = sV + tile_elems<T>();
  float* sL = reinterpret_cast<float*>(sdS + tile_elems<T>());
  float* sD = sL + 64;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const T* kb = k + b * skb + h * skh;
  const T* vb = v + b * svb + h * svh;
  const long long st = ((long long)b * gridDim.y + h) * Tq;
  load_rows(sQ, q + b * sqb + h * sqh, sqt, q0, Tq);
  load_rows(sdO, dout + b * sdb + h * sdh, sdt, q0, Tq);
  load_stats(sL, sD, lse + st, delta + st, q0, Tq);

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < Tk; k0 += BK) {
    __syncthreads();  // the last key tile's products are done
    load_rows(sK, kb, skt, k0, Tk);
    load_rows(sV, vb, svt, k0, Tk);
    __syncthreads();
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    tile_mma<true>(s, sQ, sK);    // S: queries x keys
    tile_mma<true>(dp, sdO, sV);  // dP
    p_and_ds<true>(s, dp, sL, sD, k0, Tk, scale_log2, scale);
    store_acc(sdS, dp);           // dS rounded to T, the warp's own rows
    __syncwarp();
    tile_mma<false>(acc, sdS, sK);  // dQ += dS K
    __syncwarp();
  }
  store_rows(dq + b * sqgb + h * sqgh, sqgt, q0, Tq, acc);
}

// Dynamic shared memory of the tile kernels: `tiles` tiles (+ the lse and
// D rows); over 48 KB needs an opt-in, made once per device and process.
template <typename T>
constexpr int tile_smem(int tiles) {
  return tiles * tile_elems<T>() * (int)sizeof(T) +
         2 * 64 * (int)sizeof(float);
}

template <typename K>
int opt_in(K kernel, int bytes, unsigned& opted) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (!(opted >> dev & 1u)) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    opted |= 1u << dev;
  }
  return 0;
}

template <typename T>
int launch_fwd_tile(const void* q, const void* k, const void* v, void* o,
                    float* lse, int B, int Tq, int Tk, int H, long long sqb,
                    long long sqt, long long sqh, long long skb, long long skt,
                    long long skh, long long svb, long long svt,
                    long long svh, long long sob, long long sot,
                    long long soh, float scale, cudaStream_t stream) {
  static unsigned opted = 0;
  constexpr int smem = tile_smem<T>(4);
  if (int e = opt_in(flash_fwd_tile_kernel<T>, smem, opted)) return e;
  dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_fwd_tile_kernel<T><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, Tq, Tk, sqb, sqt,
      sqh, skb, skt, skh, svb, svt, svh, sob, sot, soh,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd_dkv(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dk, void* dv, int B, int Tq, int Tk, int H,
                   const long long* st, float scale, cudaStream_t stream) {
  static unsigned opted = 0;
  constexpr int smem = tile_smem<T>(6);
  if (int e = opt_in(flash_bwd_dkv_kernel<T>, smem, opted)) return e;
  dim3 grid((Tk + BK - 1) / BK, H, B);
  flash_bwd_dkv_kernel<T><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dk, (T*)dv, Tq, Tk, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], st[12], st[13], st[14],
      st[15], st[16], st[17], scale * 1.4426950408889634f, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd_dq(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  void* dq, int B, int Tq, int Tk, int H, const long long* st,
                  float scale, cudaStream_t stream) {
  static unsigned opted = 0;
  constexpr int smem = tile_smem<T>(5);
  if (int e = opt_in(flash_bwd_dq_kernel<T>, smem, opted)) return e;
  dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_bwd_dq_kernel<T><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dq, Tq, Tk, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], st[12], st[13], st[14],
      scale * 1.4426950408889634f, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// f32 != 0: float inputs and output (the tile kernel), else bf16 (the
// wgmma kernel). lse: null, or (B, H, Tq) f32 for the backward.
XT_API int xt_flash_attn_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int Tq, int Tk, int H,
                             long long sqb, long long sqt, long long sqh,
                             long long skb, long long skt, long long skh,
                             long long svb, long long svt, long long svh,
                             long long sob, long long sot, long long soh,
                             float scale, int f32, void* stream) {
  if (f32)
    return launch_fwd_tile<float>(q, k, v, o, (float*)lse, B, Tq, Tk, H, sqb,
                                  sqt, sqh, skb, skt, skh, svb, svt, svh, sob,
                                  sot, soh, scale, (cudaStream_t)stream);
  dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse,
      Tq, Tk, sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sob, sot, soh,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// strides: (b, t, h) of q, k, v, dout, dk, dv (18 values)
XT_API int xt_flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv, int B,
                                 int Tq, int Tk, int H,
                                 const long long* strides, float scale,
                                 int f32, void* stream) {
  if (f32)
    return launch_bwd_dkv<float>(q, k, v, dout, (const float*)lse,
                                 (const float*)delta, dk, dv, B, Tq, Tk, H,
                                 strides, scale, (cudaStream_t)stream);
  return launch_bwd_dkv<bf16>(q, k, v, dout, (const float*)lse,
                              (const float*)delta, dk, dv, B, Tq, Tk, H,
                              strides, scale, (cudaStream_t)stream);
}

// strides: (b, t, h) of q, k, v, dout, dq (15 values)
XT_API int xt_flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int B, int Tq,
                                int Tk, int H, const long long* strides,
                                float scale, int f32, void* stream) {
  if (f32)
    return launch_bwd_dq<float>(q, k, v, dout, (const float*)lse,
                                (const float*)delta, dq, B, Tq, Tk, H,
                                strides, scale, (cudaStream_t)stream);
  return launch_bwd_dq<bf16>(q, k, v, dout, (const float*)lse,
                             (const float*)delta, dq, B, Tq, Tk, H, strides,
                             scale, (cudaStream_t)stream);
}
