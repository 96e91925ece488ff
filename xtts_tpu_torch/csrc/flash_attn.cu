// K2 for Hopper: exact non-causal attention, forward only, for the
// diffusion UNet's consumer self-attention.
//
// Replaces the Pallas TPU flash kernel behind xtts_tpu/nn/flash_attn.py
// flash_mha (jax.experimental.pallas.ops.tpu.flash_attention, called at
// xtts_tpu/nn/flash_attn.py:99). On the main path: q (2, 1280, 8, 64),
// k/v (2, 1562, 8, 64) bf16 at code bucket 320 — 4 x 50 calls a request.
//
// Bound: tensor-core FLOPs. 4 * B * H * Tq * Tk * 64 = 8.2 GFLOP a call at
// the shape above (8.3 us at 989 TFLOP/s), against ~5 MB of q/k/v/o; the
// score matrix (2 x 8 x 1280 x 1562) never leaves the registers.
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

// Accumulator layout of m64n64 (f32, 32 a thread): warp w, lane l,
// g = l / 4, q = l % 4. Register 4j + c holds (row 16w + g, column 8j +
// 2q + c); 4j + 2 + c holds row 16w + g + 8, same column (c = 0, 1).
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int Tq,
                 int Tk, long long sqb, long long sqt, long long sqh,
                 long long skb, long long skt, long long skh, long long svb,
                 long long svt, long long svh, long long sob, long long sot,
                 long long soh, float scale_log2) {
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

}  // namespace

XT_API int xt_flash_attn_fwd(const void* q, const void* k, const void* v,
                             void* o, int B, int Tq, int Tk, int H,
                             long long sqb, long long sqt, long long sqh,
                             long long skb, long long skt, long long skh,
                             long long svb, long long svt, long long svh,
                             long long sob, long long sot, long long soh,
                             float scale, void* stream) {
  dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, Tq, Tk, sqb,
      sqt, sqh, skb, skt, skh, svb, svt, svh, sob, sot, soh,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}
