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
// Every kernel reads the (B, T, H, D) views' strides as they come (the
// projections' head-split views arrive as they are) and takes head widths
// D = 32, 64 and 128, or any multiple of 128 above 128; the wrapper
// zero-pads any other width up to 128 to the next of these. The kernels:
//
// - bf16 at D = 64, the flagship path: flash_fwd_kernel,
//   flash_bwd_dkv_kernel and flash_bwd_dq_kernel on wgmma (below).
// - The bf16 backward at D = 128 NC for every NC >= 1 (128 and each
//   multiple above): flash_bwd_dkv_wgmma_wide and flash_bwd_dq_wgmma_wide
//   on wgmma, the blocks of a tile's 128-column chunks one thread-block
//   cluster that forms each score tile once and shares it through
//   distributed shared memory (after the wide kernels). wgmma's 128-byte
//   swizzle holds exactly 64 bf16 a row; a 128-column chunk is two such
//   atoms side by side, one descriptor each, so the width-64 kernels'
//   tiles, swizzle and descriptors serve it unchanged.
// - The f32 backward at D = 128 NC for every NC >= 1:
//   flash_bwd_dkv_f32_wide and flash_bwd_dq_f32_wide, the same clusters
//   and exchange on the tile family's 3xTF32 mma.sync, two warpgroups a
//   block, P and dS shared as f32 (after the wgmma pair).
// - The bf16 forward at D = 128 NC for every NC >= 1:
//   flash_fwd_wgmma_wide<CPS, MQ> on wgmma (after the f32 pair), a block
//   one or two 64-query tiles across the whole width up to 512 (above,
//   slices of up to 512 columns), so each score tile is formed once; the
//   keys split over a thread-block cluster of R <= 8 blocks, whose ranks
//   combine (m, l, O) once through distributed shared memory in rank
//   order. What holds it back: the block's two warpgroups run in
//   lockstep, a block barrier a 128-column step, so the tensor cores wait
//   out each softmax and barrier (at 128 a key tile takes ~3100 cycles:
//   S ~600, the softmax ~930, the steps' barriers and copies ~1400;
//   PERF.md), and at 384 and above one warpgroup idles while S and the
//   softmax run.
// - The f32 forward at D = 128 NC for every NC >= 1:
//   flash_fwd_f32_wide<CPS, MQ> (after the bf16 one), its grid, key split,
//   steps and combine, on the tile family's 3xTF32 mma.sync: up to 128
//   columns a block two query tiles, above that the two warpgroups split
//   one query tile's keys in S and its columns in O.
// - The tile family on mma.sync (flash_*_tc_kernel<T, D>): the f32 forward
//   at D = 32, 64 and backward at 32, 64, the bf16 forward and backward at
//   D = 32. It takes any D that is a multiple of its mma depth, and keeps
//   the flagship kernels' source and times as they are.
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
// The backward: flash_bwd_dkv_kernel (bf16) and flash_bwd_dkv_tc_kernel
// are the counterparts of _flash_attention_bwd_dkv, flash_bwd_dq_kernel
// and flash_bwd_dq_tc_kernel of _flash_attention_bwd_dq. Bound: the
// backward's five products, 10 B H Tq Tk D = 20.5 GFLOP at the main shape
// (20.7 us at 989 TFLOP/s bf16), against ~10 MB of q/k/v/o/dO/dq/dk/dv.
// D = rowsum(dO * O) in f32 comes in from the caller (torch ops, as JAX
// computes it in XLA outside its kernels); lse (natural log) from the
// forward.
// - dkv: one 128-thread block for each (64-key tile, head, batch row). K
//   and V stay in shared memory; the block loops over the 64-query tiles:
//   S^T = K Q^T and dP^T = V dO^T (keys are the accumulator rows), then
//   P^T = exp2(S^T scale log2 e - lse) (the columns past Tq take lse =
//   +inf and D = 0, so their P and dS are exactly 0: no 0 * NaN),
//   dS^T = P^T (dP^T - D) scale, P^T and dS^T rounded to the inputs'
//   dtype, dV += P^T dO and dK += dS^T Q in f32 registers; stored once.
// - dq: one block for each (64-query tile, head, batch row), looping over
//   the key tiles: S, dP, P (0 past Tk) and dS as above with queries as
//   rows, dS rounded, dQ += dS K.
// - No atomics: each block owns its output rows, so the gradients are the
//   same from run to run, as the Pallas kernels' are.
// - Where Tk <= 64, the tile family and the wide kernels take D from the
//   one key tile (ds_one_tile): dS is then exactly 0 at one key, as it is
//   in exact arithmetic.
// - bf16 at D = 64 (the forward's parts): the block's fixed pair of tiles
//   (K, V for dkv; Q, dO for dq) is copied once into swizzled shared
//   memory; the streamed pair (Q, dO; K, V) runs through a BWD_STAGES-deep
//   cp.async ring, zero-filled past the ragged edge, one __syncthreads a
//   tile. dkv streams each query tile's 64 lse and D values beside it (its
//   columns are queries: a thread reads its 16 columns' values as 8
//   float2 pairs); dq keeps its two rows' in registers. Every product is
//   wgmma m64n64k16 with an f32 accumulator in registers: S (S^T) and dP
//   (dP^T) wgmma_ss with both tiles K-major, as S in the forward, each its
//   own commit group, so P is computed while dP runs; dV += P^T dO, dK +=
//   dS^T Q and dQ += dS K wgmma_rs, P^T / dS^T / dS rounded to bf16 in
//   registers as the A operand (as P in the forward) and dO / Q / K read
//   MN-major (as V). In dkv the dV product runs while dS^T is computed.
//   No tile of P or dS touches shared memory.
//
// The tile family (flash_fwd_tc_kernel, flash_bwd_dkv_tc_kernel,
// flash_bwd_dq_tc_kernel <T, D>): the same grids (a 64-query tile a block
// in the forward and dq, a 64-key tile in dkv), online softmax, lse
// contract, zero-filled ragged edges and no atomics, with
// - every product on the tensor cores by mma.sync m16n8: f32 in 3xTF32
//   (m16n8k8; each operand split into a big and a small tf32 part as its
//   fragment is read from shared memory or the registers, three products
//   a step, as K3 does: common.cuh), bf16 on m16n8k16;
// - P, P^T, dS and dS^T kept in registers: an m16n8 accumulator block is
//   the A operand of the next product as it stands (f32: its columns 2t,
//   2t + 1 taken as k = t, t + 4, with B's rows read in that order; bf16:
//   two blocks rounded to bf16 pairs, as wgmma's P);
// - the long f32 sums (O, dV, dK, dQ over every key or query) taken in
//   partials of four k-steps joined by IEEE adds: the tensor cores'
//   accumulation truncates, and in place it drifted by 1.3-1.9e-5 of the
//   largest gradient over the main bucket's ~500 k-steps;
// - the streamed tiles (K, V in the forward and dq; Q, dO and their lse
//   and D in dkv) through a two-stage cp.async ring, the next tile's copy
//   in flight during this tile's products; tile rows padded (f32 D + 4,
//   bf16 D + 8 elements) so that every fragment read is free of bank
//   conflicts;
// - bf16's Q read once into registers (unsplit) through the ring's second
//   K slot, so its shared memory is the ring's four tiles; f32's Q in a
//   fifth tile (87 KB at D = 64, two blocks an SM: in registers it
//   spilled); the backward keeps its fixed pair in shared memory (104 KB
//   at f32 D = 64: two blocks an SM); dkv forms dV right after P^T,
//   before dP^T takes its registers.
// Bounds of the f32 kernels at the main shape, the forward (2 B H Tq Tk D
// x 2 = 8.19 GFLOP), dkv (4 products, 16.4 GFLOP) and dq (3, 12.3 GFLOP):
// in f32 FMA at 67 TFLOP/s 122, 244 and 183 us; in 3xTF32 (3 x the
// operations at 495 TFLOP/s dense) 49.6, 99.3 and 74.4 us. The FMA tiles
// these replace reached 18, 16.3 and 13.2 TFLOP/s, held by their
// shared-memory loads (2 A and 16 B values for 32 FMA a k). What holds
// the tile family back (scripts/bench_flash_f32.py, PERF.md): the splits
// (each warp splits the whole B tile: one B value feeds 3 mma of 16 rows),
// the two extra mma of 3xTF32, and mma.sync's rate on sm_90.
//
// C interface (ctypes): returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

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
constexpr float LOG2E = 1.4426950408889634f;

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
// until at most N commit groups are in flight (groups end in order)
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving register reads and writes across the
// asynchronous wgmma (it cannot see that the asm is still running)
__device__ __forceinline__ void fence_regs(float (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// the same for a register A operand, which an asynchronous wgmma reads
// until its group ends
__device__ __forceinline__ void fence_regs(uint32_t (&r)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(r[i])::"memory");
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
    cp_async_wait<0>();                     // tile t (and Q) landed
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
    wgmma_wait<0>();
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
    wgmma_wait<0>();
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
// The bf16 backward on wgmma (the forward's ring, tiles and products).

constexpr int BWD_STAGES = 2;  // depth of the streamed ring (3: no better,
                               // scripts/bench_flash_bwd.py)
static_assert(BWD_STAGES >= 2, "one __syncthreads a tile needs two stages");
constexpr int STAT_BYTES = 2 * 64 * 4;     // a query tile's lse and D (dkv)
// 2 fixed tiles + BWD_STAGES stages of 2 streamed tiles (+ the statistics);
// over 48 KB: an opt-in, made once per device and process
constexpr int BWD_DKV_SMEM =
    (2 + 2 * BWD_STAGES) * TILE_BYTES + BWD_STAGES * STAT_BYTES + 1024;
constexpr int BWD_DQ_SMEM = (2 + 2 * BWD_STAGES) * TILE_BYTES + 1024;

__device__ __forceinline__ void zero(float (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) r[i] = 0.f;
}

// a thread's accumulator rows (row0 + 16 warp + g, + 8) of a (rows, 64)
// bf16 view as bf16 pairs, rows at or past nrows left out
__device__ __forceinline__ void store_bf16_rows(bf16* dst, long long stride,
                                                int row0, int nrows,
                                                const float (&v)[32]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = row0 + 16 * warp + (lane >> 2), cq = (lane & 3) * 2;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    if (r >= nrows) continue;
    bf16* p = dst + (long long)r * stride + cq;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(p + 8 * j) = __floats2bfloat162_rn(
          v[4 * j + 2 * half], v[4 * j + 2 * half + 1]);
  }
}

// dK and dV of one 64-key tile: keys are the accumulator rows, so a
// thread's columns 8j + 2q + c are queries and take the stage's lse and D.
// The key rows past Tk compute from zero-filled K and V and are not stored.
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int Tq, int Tk, long long sqb,
                     long long sqt, long long sqh, long long skb,
                     long long skt, long long skh, long long svb,
                     long long svt, long long svh, long long sdb,
                     long long sdt, long long sdh, long long skgb,
                     long long skgt, long long skgh, long long svgb,
                     long long svgt, long long svgh, float scale_log2,
                     float scale) {
  extern __shared__ unsigned char smem[];
  const uint32_t raw = smem_u32(smem);
  const uint32_t sK = (raw + 1023u) & ~1023u, sV = sK + TILE_BYTES;
  auto sQ = [&](int s) { return sK + (2 + 2 * s) * TILE_BYTES; };
  auto sdO = [&](int s) { return sK + (3 + 2 * s) * TILE_BYTES; };
  const uint32_t sStat = sK + (2 + 2 * BWD_STAGES) * TILE_BYTES;
  const float* stats = reinterpret_cast<const float*>(smem + (sStat - raw));

  const int k0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  const int cq = (threadIdx.x & 3) * 2;
  const bf16* qb = q + b * sqb + h * sqh;
  const bf16* db = dout + b * sdb + h * sdh;
  const long long st = ((long long)b * gridDim.y + h) * Tq;
  // threads 0-63 copy a tile's lse, 64-127 its D
  const float* stat_src = (threadIdx.x < 64 ? lse : delta) + st;
  const int ntiles = (Tq + BQ - 1) / BQ;
  auto load_stage = [&](int t) {
    const int s = t % BWD_STAGES, r = t * BQ + (threadIdx.x & 63);
    load_tile(sQ(s), qb, sqt, t * BQ, Tq);
    load_tile(sdO(s), db, sdt, t * BQ, Tq);
    cp_async4(sStat + s * STAT_BYTES + threadIdx.x * 4,
              stat_src + (r < Tq ? r : 0), r < Tq);
  };

  load_tile(sK, k + b * skb + h * skh, skt, k0, Tk);
  load_tile(sV, v + b * svb + h * svh, svt, k0, Tk);
#pragma unroll
  for (int t = 0; t < BWD_STAGES - 1; ++t) {
    if (t < ntiles) load_stage(t);
    cp_async_commit();
  }

  float acc_dk[32], acc_dv[32];
  zero(acc_dk);
  zero(acc_dv);
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % BWD_STAGES;
    cp_async_wait<BWD_STAGES - 2>();        // tile t (and K, V) landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();                        // ... for every thread; tile
                                            // t - 1 is done, its stage free
    if (t + BWD_STAGES - 1 < ntiles) load_stage(t + BWD_STAGES - 1);
    cp_async_commit();

    // ---- S^T = K Q^T and dP^T = V dO^T, one commit group each ----
    float sp[32], dp[32];
    zero(sp);
    zero(dp);
    fence_regs(sp);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(sp, desc(sK + 32 * kk), desc(sQ(s) + 32 * kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(dp, desc(sV + 32 * kk), desc(sdO(s) + 32 * kk), kk);
    wgmma_commit();

    // ---- P^T = exp2(S^T scale log2 e - lse) while dP^T runs ----
    wgmma_wait<1>();
    fence_regs(sp);
    const float* sL = stats + s * (STAT_BYTES / 4);
    const int qc = t * BQ + cq;             // this thread's first column
    uint32_t pa[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 L = *reinterpret_cast<const float2*>(sL + 8 * j + cq);
      const float l0 = qc + 8 * j < Tq ? L.x * LOG2E : INFINITY;
      const float l1 = qc + 8 * j + 1 < Tq ? L.y * LOG2E : INFINITY;
      sp[4 * j] = exp2f(fmaf(sp[4 * j], scale_log2, -l0));
      sp[4 * j + 1] = exp2f(fmaf(sp[4 * j + 1], scale_log2, -l1));
      sp[4 * j + 2] = exp2f(fmaf(sp[4 * j + 2], scale_log2, -l0));
      sp[4 * j + 3] = exp2f(fmaf(sp[4 * j + 3], scale_log2, -l1));
      pa[2 * j] = pack_bf16(sp[4 * j], sp[4 * j + 1]);
      pa[2 * j + 1] = pack_bf16(sp[4 * j + 2], sp[4 * j + 3]);
    }

    // ---- dV += P^T dO (queries 16 kk.. are k16 step kk) ----
    fence_regs(acc_dv);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc_dv, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
               pa[4 * kk + 3], desc(sdO(s) + 2048 * kk));
    wgmma_commit();

    // ---- dS^T = P^T (dP^T - D) scale while dV runs; dK += dS^T Q ----
    wgmma_wait<1>();
    fence_regs(dp);
    const float* sD = sL + 64;
    uint32_t da[16];          // not pa's registers: dV still reads those
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 D = *reinterpret_cast<const float2*>(sD + 8 * j + cq);
      da[2 * j] = pack_bf16((dp[4 * j] - D.x) * sp[4 * j] * scale,
                            (dp[4 * j + 1] - D.y) * sp[4 * j + 1] * scale);
      da[2 * j + 1] =
          pack_bf16((dp[4 * j + 2] - D.x) * sp[4 * j + 2] * scale,
                    (dp[4 * j + 3] - D.y) * sp[4 * j + 3] * scale);
    }
    fence_regs(acc_dk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc_dk, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2],
               da[4 * kk + 3], desc(sQ(s) + 2048 * kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(pa);
    fence_regs(da);
    fence_regs(acc_dv);
    fence_regs(acc_dk);
  }
  store_bf16_rows(dk + b * skgb + h * skgh, skgt, k0, Tk, acc_dk);
  store_bf16_rows(dv + b * svgb + h * svgh, svgt, k0, Tk, acc_dv);
}

// dQ of one 64-query tile: queries are the accumulator rows, so a thread's
// two rows' lse and D stay in registers; the key columns past Tk get P = 0.
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int Tq, int Tk, long long sqb, long long sqt,
                    long long sqh, long long skb, long long skt,
                    long long skh, long long svb, long long svt,
                    long long svh, long long sdb, long long sdt,
                    long long sdh, long long sqgb, long long sqgt,
                    long long sqgh, float scale_log2, float scale) {
  extern __shared__ unsigned char smem[];
  const uint32_t sQ = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t sdO = sQ + TILE_BYTES;
  auto sK = [&](int s) { return sQ + (2 + 2 * s) * TILE_BYTES; };
  auto sV = [&](int s) { return sQ + (3 + 2 * s) * TILE_BYTES; };

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cq = (lane & 3) * 2;
  const bf16* kb = k + b * skb + h * skh;
  const bf16* vb = v + b * svb + h * svh;
  const int ntiles = (Tk + BK - 1) / BK;
  auto load_stage = [&](int t) {
    const int s = t % BWD_STAGES;
    load_tile(sK(s), kb, skt, t * BK, Tk);
    load_tile(sV(s), vb, svt, t * BK, Tk);
  };

  load_tile(sQ, q + b * sqb + h * sqh, sqt, q0, Tq);
  load_tile(sdO, dout + b * sdb + h * sdh, sdt, q0, Tq);
#pragma unroll
  for (int t = 0; t < BWD_STAGES - 1; ++t) {
    if (t < ntiles) load_stage(t);
    cp_async_commit();
  }
  // rows r0 and r0 + 8: lse in log2 units and D (past Tq: +inf and 0)
  const long long st = ((long long)b * gridDim.y + h) * Tq;
  const int r0 = q0 + 16 * warp + (lane >> 2), r1 = r0 + 8;
  const float l0 = r0 < Tq ? lse[st + r0] * LOG2E : INFINITY;
  const float l1 = r1 < Tq ? lse[st + r1] * LOG2E : INFINITY;
  const float d0 = r0 < Tq ? delta[st + r0] : 0.f;
  const float d1 = r1 < Tq ? delta[st + r1] : 0.f;

  float acc[32];
  zero(acc);
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % BWD_STAGES;
    cp_async_wait<BWD_STAGES - 2>();        // tile t (and Q, dO) landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (t + BWD_STAGES - 1 < ntiles) load_stage(t + BWD_STAGES - 1);
    cp_async_commit();

    // ---- S = Q K^T and dP = dO V^T, one commit group each ----
    float sp[32], dp[32];
    zero(sp);
    zero(dp);
    fence_regs(sp);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(sp, desc(sQ + 32 * kk), desc(sK(s) + 32 * kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(dp, desc(sdO + 32 * kk), desc(sV(s) + 32 * kk), kk);
    wgmma_commit();

    // ---- P = exp2(S scale log2 e - lse), 0 past Tk, while dP runs ----
    wgmma_wait<1>();
    fence_regs(sp);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sp[4 * j] = exp2f(fmaf(sp[4 * j], scale_log2, -l0));
      sp[4 * j + 1] = exp2f(fmaf(sp[4 * j + 1], scale_log2, -l0));
      sp[4 * j + 2] = exp2f(fmaf(sp[4 * j + 2], scale_log2, -l1));
      sp[4 * j + 3] = exp2f(fmaf(sp[4 * j + 3], scale_log2, -l1));
    }
    const int key0 = t * BK;
    if (key0 + BK > Tk) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (key0 + 8 * j + cq + c >= Tk)
            sp[4 * j + c] = sp[4 * j + 2 + c] = 0.f;
    }

    // ---- dS = P (dP - D) scale; dQ += dS K (keys 16 kk.. step kk) ----
    wgmma_wait<0>();
    fence_regs(dp);
    uint32_t pa[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      pa[2 * j] = pack_bf16((dp[4 * j] - d0) * sp[4 * j] * scale,
                            (dp[4 * j + 1] - d0) * sp[4 * j + 1] * scale);
      pa[2 * j + 1] = pack_bf16((dp[4 * j + 2] - d1) * sp[4 * j + 2] * scale,
                                (dp[4 * j + 3] - d1) * sp[4 * j + 3] * scale);
    }
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
               pa[4 * kk + 3], desc(sK(s) + 2048 * kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }
  store_bf16_rows(dq + b * sqgb + h * sqgh, sqgt, q0, Tq, acc);
}

// ---------------------------------------------------------------------------
// The tile family (mma.sync): the f32 kernels at widths 32 and 64, the
// bf16 forward and backward at 32 (the f32 wide kernels' fragment code is
// this family's too). Generic in the element type T and the head width D. A
// tile is 64 rows x D elements of T in shared memory, rows TC<T, D>::LD
// elements apart. A warp owns 16 accumulator rows as m16n8 blocks: block
// j's c[j][0], c[j][1] are (row g, columns 8j + 2t, + 1) and c[j][2],
// c[j][3] row g + 8 (g = lane / 4, t = lane % 4) — the wgmma kernels'
// register 4j + c, so the softmax and the P / dS code read the same.
//
// Two B reads: b_nt (B(k, n) = tile[n][k]; S, dP and their transposes) and
// b_nn (B(k, n) = tile[k][n]; the products whose A operand is P, P^T, dS or
// dS^T, taken from the accumulators as they are).

template <typename T, int D>
struct TC;

// f32: 3xTF32 on m16n8k8 (common.cuh's split_tf32_cut and mma_tf32). An
// accumulator block's columns 2t, 2t + 1 feed the A operand as k = t and
// k = t + 4, so b_nn reads B's rows in that same order: rows 2t and 2t + 1.
// LD = D + 4 puts the 32 lanes of b_nt (tile[g][t]) and of b_nn
// (tile[2t][g]) on 32 banks.
template <int D>
struct TC<float, D> {
  static constexpr int LD = D + 4;
  static constexpr int KS = 8;        // depth of one mma
  static constexpr int PARTIAL = 4;   // k-steps a partial of a long sum
  struct A {
    uint32_t big[4], small[4];
  };
  struct B {
    uint32_t big[2], small[2];
  };

  // the A operand of rows g, g + 8 of `rows` (the warp's first row), k0..,
  // unsplit
  __device__ static void a_raw(uint32_t (&r)[4], const float* rows, int k0) {
    const int lane = threadIdx.x & 31;
    const float* p = rows + (lane >> 2) * LD + k0 + (lane & 3);
    r[0] = __float_as_uint(p[0]);
    r[1] = __float_as_uint(p[8 * LD]);
    r[2] = __float_as_uint(p[4]);
    r[3] = __float_as_uint(p[8 * LD + 4]);
  }
  __device__ static A a_split(const uint32_t (&r)[4]) {
    A a;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split_tf32_cut(__uint_as_float(r[i]), a.big[i], a.small[i]);
    return a;
  }
  __device__ static A a_tile(const float* rows, int k0) {
    uint32_t r[4];
    a_raw(r, rows, k0);
    return a_split(r);
  }
  // accumulator block kk as the A operand of k-step kk
  __device__ static A a_acc(const float (&c)[8][4], int kk) {
    const uint32_t r[4] = {__float_as_uint(c[kk][0]), __float_as_uint(c[kk][2]),
                           __float_as_uint(c[kk][1]), __float_as_uint(c[kk][3])};
    return a_split(r);
  }
  __device__ static B b_nt(const float* tile, int n0, int k0) {
    const int lane = threadIdx.x & 31;
    const float* p = tile + (n0 + (lane >> 2)) * LD + k0 + (lane & 3);
    B b;
    split_tf32_cut(p[0], b.big[0], b.small[0]);
    split_tf32_cut(p[4], b.big[1], b.small[1]);
    return b;
  }
  __device__ static B b_nn(const float* tile, int k0, int n0) {
    const int lane = threadIdx.x & 31;
    const float* p = tile + (k0 + 2 * (lane & 3)) * LD + n0 + (lane >> 2);
    B b;
    split_tf32_cut(p[0], b.big[0], b.small[0]);
    split_tf32_cut(p[LD], b.big[1], b.small[1]);
    return b;
  }
  // c += a b: the two small terms, then big * big
  __device__ static void mma(float (&c)[4], const A& a, const B& b) {
    mma_tf32(c, a.big, b.small);
    mma_tf32(c, a.small, b.big);
    mma_tf32(c, a.big, b.big);
  }
};

// bf16: m16n8k16. A: (row g, k 2t, 2t + 1), (g + 8, ...), (g, 2t + 8, 2t +
// 9), (g + 8, ...) as bf16 pairs; B: (k 2t, 2t + 1; column g), (k 2t + 8,
// 2t + 9; g). Accumulator blocks 2kk and 2kk + 1, rounded to bf16, are the
// A operand of k-step kk as they stand. LD = D + 8 puts b_nt's and a_raw's
// 32-bit words on 32 banks, and b_nn's 16-bit reads on 16 distinct words a
// row (lanes g and g + 1 share one).
template <int D>
struct TC<bf16, D> {
  static constexpr int LD = D + 8;
  static constexpr int KS = 16;
  // bf16 rounds P and dS to 2^-9 before the product: the accumulation's
  // truncation is far below that, so long sums accumulate in place
  static constexpr int PARTIAL = 0;
  struct A {
    uint32_t r[4];
  };
  struct B {
    uint32_t r[2];
  };

  __device__ static uint32_t word(const bf16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  }
  __device__ static uint32_t pair(bf16 lo, bf16 hi) {
    return (uint32_t)__bfloat16_as_ushort(lo) |
           ((uint32_t)__bfloat16_as_ushort(hi) << 16);
  }
  __device__ static void a_raw(uint32_t (&r)[4], const bf16* rows, int k0) {
    const int lane = threadIdx.x & 31;
    const bf16* p = rows + (lane >> 2) * LD + k0 + 2 * (lane & 3);
    r[0] = word(p);
    r[1] = word(p + 8 * LD);
    r[2] = word(p + 8);
    r[3] = word(p + 8 * LD + 8);
  }
  __device__ static A a_split(const uint32_t (&r)[4]) {
    return A{{r[0], r[1], r[2], r[3]}};
  }
  __device__ static A a_tile(const bf16* rows, int k0) {
    A a;
    a_raw(a.r, rows, k0);
    return a;
  }
  __device__ static A a_acc(const float (&c)[8][4], int kk) {
    return A{{pack_bf16(c[2 * kk][0], c[2 * kk][1]),
              pack_bf16(c[2 * kk][2], c[2 * kk][3]),
              pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]),
              pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3])}};
  }
  __device__ static B b_nt(const bf16* tile, int n0, int k0) {
    const int lane = threadIdx.x & 31;
    const bf16* p = tile + (n0 + (lane >> 2)) * LD + k0 + 2 * (lane & 3);
    return B{{word(p), word(p + 8)}};
  }
  __device__ static B b_nn(const bf16* tile, int k0, int n0) {
    const int lane = threadIdx.x & 31;
    const bf16* p = tile + (k0 + 2 * (lane & 3)) * LD + n0 + (lane >> 2);
    return B{{pair(p[0], p[LD]), pair(p[8 * LD], p[9 * LD])}};
  }
  __device__ static void mma(float (&c)[4], const A& a, const B& b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "r"(b.r[0]),
          "r"(b.r[1]));
  }
};

template <typename T, int D>
__host__ __device__ constexpr int tc_tile_bytes() {
  return 64 * TC<T, D>::LD * (int)sizeof(T);
}

// a tile kernel dkv's statistics: two stages of a query tile's 64 lse and
// 64 D values, and dkv_ds's sums over the keys (2 x 4 warps x 64 columns)
constexpr int DKV_STAT_BYTES = 2 * 128 * 4 + 2 * 4 * 64 * 4;

// Blocks an SM the f32 kernels are built for: their shared memory holds
// two (87-104 KB at D = 64). Built for one, ptxas kept dq and the forward
// to 168 registers and spilled; for two it holds them in 216-240 without
// a spill, and dq took 305 us against 433 at the main bucket on an H100
// (scripts/bench_flash_f32.py dqlb2).
template <typename T>
__host__ __device__ constexpr int tc_min_blocks() {
  return sizeof(T) == 4 ? 2 : 1;
}

// rows row0.. of a (rows, D) view with row stride `stride` elements into a
// tile, asynchronously (16-byte cp.async, the caller commits); rows at or
// past nrows zero-filled
template <typename T, int D>
__device__ __forceinline__ void stage_tile(T* dst, const T* src,
                                           long long stride, int row0,
                                           int nrows) {
  constexpr int EPC = 16 / (int)sizeof(T);  // elements a chunk
  constexpr int CPR = D / EPC;              // chunks a row
  static_assert(64 * CPR % THREADS == 0, "whole chunks a thread");
  const uint32_t base = smem_u32(dst);
#pragma unroll
  for (int i = 0; i < 64 * CPR / THREADS; ++i) {
    const int id = threadIdx.x + i * THREADS, r = id / CPR, c = id % CPR;
    const bool valid = row0 + r < nrows;
    const T* g = valid ? src + (long long)(row0 + r) * stride + c * EPC : src;
    cp_async16(base + (r * TC<T, D>::LD + c * EPC) * (int)sizeof(T), g,
               valid);
  }
}

// acc[j] += A B over k = 0..D-1: A the warp's 16 rows of a tile (`rows`
// its first), B(k, n) = b_tile[8j + n][k] (S = Q K^T and its kin). The
// k-steps unrolled by 2: unrolled whole, f32 dkv at D = 64 spilled at 255
// registers and took 458 us at the main bucket on an H100, by 2 it holds
// its registers and took 396 (scripts/bench_flash_f32.py nt2).
template <typename T, int D>
__device__ __forceinline__ void mma_nt(float (&acc)[8][4], const T* rows,
                                       const T* b_tile) {
  using C = TC<T, D>;
#pragma unroll 2
  for (int kk = 0; kk < D / C::KS; ++kk) {
    const typename C::A a = C::a_tile(rows, kk * C::KS);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      C::mma(acc[j], a, C::b_nt(b_tile, 8 * j, kk * C::KS));
  }
}

// acc[j] += P B over the 64 columns of P (registers, the accumulator
// layout), B(k, n) = b_tile[k][8j + n] (O += P V and its kin: sums over
// every key or query). The tensor cores' f32 accumulation truncates, so
// in place over hundreds of k-steps it biases such a sum (1.3-1.9e-5 of
// the largest f32 gradient at the main bucket on an H100, against 1e-5):
// with C::PARTIAL, every PARTIAL k-steps' products form in a zeroed
// partial that joins the sum by an IEEE add.
template <typename T, int D>
__device__ __forceinline__ void mma_pn(float (&acc)[D / 8][4],
                                       const float (&p)[8][4],
                                       const T* b_tile) {
  using C = TC<T, D>;
  constexpr int G = C::PARTIAL > 0 ? C::PARTIAL : 1;
#pragma unroll
  for (int k0 = 0; k0 < 64 / C::KS; k0 += G) {
    typename C::A a[G];
#pragma unroll
    for (int g = 0; g < G; ++g) a[g] = C::a_acc(p, k0 + g);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if constexpr (C::PARTIAL > 0) {
        float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int g = 0; g < G; ++g)
          C::mma(t, a[g], C::b_nn(b_tile, (k0 + g) * C::KS, 8 * j));
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] += t[i];
      } else {
        C::mma(acc[j], a[0], C::b_nn(b_tile, k0 * C::KS, 8 * j));
      }
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) r[j][c] = 0.f;
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// a thread's accumulator rows (row0 + 16 warp + g, + 8; warp the warp in
// its warpgroup) of a (rows, D) view, rows at or past nrows left out
template <typename T, int D>
__device__ __forceinline__ void store_tile_rows(T* dst, long long stride,
                                                int row0, int nrows,
                                                const float (&v)[D / 8][4]) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int r0 = row0 + 16 * warp + (lane >> 2), cq = (lane & 3) * 2;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    if (r >= nrows) continue;
    T* p = dst + (long long)r * stride + cq;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store_pair(p + 8 * j, v[j][2 * half], v[j][2 * half + 1]);
  }
}

// The forward's online softmax over one key tile of scores s (a thread's
// rows g, g + 8; the columns from k0 at or past Tk masked to -inf first):
// the running maxima m, this thread's part of the row sums l and the
// output acc (N accumulator blocks) rescaled; s leaves as P, unnormalised.
template <int N>
__device__ __forceinline__ void online_softmax(float (&s)[8][4],
                                               float (&acc)[N][4], float& m0,
                                               float& m1, float& l0,
                                               float& l1, int k0, int Tk,
                                               float scale_log2) {
  const int cq = (threadIdx.x & 3) * 2;
  if (k0 + BK > Tk) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        if (k0 + 8 * j + cq + c >= Tk) s[j][c] = s[j][2 + c] = -INFINITY;
  }
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
    mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
  }
#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, sh));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, sh));
  }
  // every tile holds at least one valid column, so mx0 / mx1 are finite
  const float alpha0 = exp2f((m0 - mx0) * scale_log2);
  const float alpha1 = exp2f((m1 - mx1) * scale_log2);
  m0 = mx0;
  m1 = mx1;
  const float mb0 = mx0 * scale_log2, mb1 = mx1 * scale_log2;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[j][0] = exp2f(fmaf(s[j][0], scale_log2, -mb0));
    s[j][1] = exp2f(fmaf(s[j][1], scale_log2, -mb0));
    s[j][2] = exp2f(fmaf(s[j][2], scale_log2, -mb1));
    s[j][3] = exp2f(fmaf(s[j][3], scale_log2, -mb1));
    rs0 += s[j][0] + s[j][1];
    rs1 += s[j][2] + s[j][3];
  }
  l0 = l0 * alpha0 + rs0;
  l1 = l1 * alpha1 + rs1;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    acc[j][0] *= alpha0;
    acc[j][1] *= alpha0;
    acc[j][2] *= alpha1;
    acc[j][3] *= alpha1;
  }
}

// The forward's end: the row sums folded over the quad; the row's
// log-sum-exp stored in natural log where lse_row (the (b, h) row of the
// (B, H, Tq) lse) is given; acc normalised and stored into the (Tq, D)
// view o with row stride `stride`.
template <typename T, int D>
__device__ __forceinline__ void fwd_store(float (&acc)[D / 8][4], float m0,
                                          float m1, float l0, float l1,
                                          float* lse_row, T* o,
                                          long long stride, int q0, int Tq,
                                          float scale_log2) {
  constexpr float LN2 = 0.6931471805599453f;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int r0 = q0 + 16 * warp + (lane >> 2);
  if (lse_row != nullptr && (lane & 3) == 0) {
    if (r0 < Tq) lse_row[r0] = (m0 * scale_log2 + log2f(l0)) * LN2;
    if (r0 + 8 < Tq) lse_row[r0 + 8] = (m1 * scale_log2 + log2f(l1)) * LN2;
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    acc[j][0] *= inv0;
    acc[j][1] *= inv0;
    acc[j][2] *= inv1;
    acc[j][3] *= inv1;
  }
  store_tile_rows<T, D>(o, stride, q0, Tq, acc);
}

// The forward keeps Q in registers (unsplit) in bf16; in f32 in a fifth
// tile. In registers at f32 D = 64 the kernel spilled at the 168
// registers of three blocks an SM (239 us at the main bucket on an H100)
// and at 255 (2 blocks); from shared memory, two blocks an SM, it holds
// everything in 240 registers and took 203 us (scripts/bench_flash_f32.py
// qsmem).
template <typename T, int D>
__host__ __device__ constexpr bool fwd_q_in_regs() {
  return sizeof(T) == 2;
}
template <typename T, int D>
__host__ __device__ constexpr int fwd_smem() {
  return (fwd_q_in_regs<T, D>() ? 4 : 5) * tc_tile_bytes<T, D>();
}

// The forward: flash_fwd_kernel's grid, ring and online softmax. Q in
// registers is staged through stage 1's K slot before the ring first
// fills that stage, so the ring's four tiles are all the shared memory
// the block holds.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, tc_min_blocks<T>())
flash_fwd_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o,
                    float* __restrict__ lse, int Tq, int Tk, long long sqb,
                    long long sqt, long long sqh, long long skb,
                    long long skt, long long skh, long long svb,
                    long long svt, long long svh, long long sob,
                    long long sot, long long soh, float scale_log2) {
  using C = TC<T, D>;
  constexpr int TE = 64 * C::LD;  // elements a tile
  constexpr bool QREG = fwd_q_in_regs<T, D>();
  extern __shared__ __align__(16) unsigned char smem_t[];
  T* const ring = reinterpret_cast<T*>(smem_t);
  auto sK = [&](int s) { return ring + 2 * s * TE; };
  auto sV = [&](int s) { return ring + (2 * s + 1) * TE; };
  T* const sQ = QREG ? sK(1) : ring + 4 * TE;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const T* kb = k + b * skb + h * skh;
  const T* vb = v + b * svb + h * svh;
  const int ntiles = (Tk + BK - 1) / BK;

  stage_tile<T, D>(sQ, q + b * sqb + h * sqh, sqt, q0, Tq);
  stage_tile<T, D>(sK(0), kb, skt, 0, Tk);
  stage_tile<T, D>(sV(0), vb, svt, 0, Tk);
  cp_async_commit();
  const T* const qrows = sQ + 16 * warp * C::LD;  // this warp's Q rows
  uint32_t qf[QREG ? D / C::KS : 1][4];           // ... as A operands
  if constexpr (QREG) {
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < D / C::KS; ++kk)
      C::a_raw(qf[kk], qrows, kk * C::KS);
  }

  float acc[D / 8][4];
  zero(acc);
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows g, g + 8
  float l0 = 0.f, l1 = 0.f;              // this thread's part of the sums
  for (int t = 0; t < ntiles; ++t) {
    const int st = t & 1;
    cp_async_wait<0>();  // tile t (at t = 0 with Q) landed
    __syncthreads();     // ... for every thread; tile t - 1 (at t = 0 Q
                         // in registers) is read, its stage free
    if (t + 1 < ntiles) {
      stage_tile<T, D>(sK(st ^ 1), kb, skt, (t + 1) * BK, Tk);
      stage_tile<T, D>(sV(st ^ 1), vb, svt, (t + 1) * BK, Tk);
    }
    cp_async_commit();

    // ---- S = Q K^T ----
    float s[8][4];
    zero(s);
#pragma unroll
    for (int kk = 0; kk < D / C::KS; ++kk) {
      typename C::A a;
      if constexpr (QREG)
        a = C::a_split(qf[kk]);
      else
        a = C::a_tile(qrows, kk * C::KS);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        C::mma(s[j], a, C::b_nt(sK(st), 8 * j, kk * C::KS));
    }

    // ---- online softmax on the accumulators ----
    online_softmax<D / 8>(s, acc, m0, m1, l0, l1, t * BK, Tk, scale_log2);

    // ---- O += P V, P from the registers ----
    mma_pn<T, D>(acc, s, sV(st));
  }

  fwd_store<T, D>(acc, m0, m1, l0, l1,
                  lse == nullptr ? nullptr
                                 : lse + ((long long)b * gridDim.y + h) * Tq,
                  o + b * sob + h * soh, sot, q0, Tq, scale_log2);
}

// The backward's dS = P (dP - D) scale. Where every key lies in the
// block's one key tile (Tk <= BK), the tile kernels take D from that tile:
// dS = P (dP L - E) scale with L = rowsum(P) and E = rowsum(P dP) of the
// values in registers. In exact arithmetic L = 1 and E = rowsum(dO O) = D,
// so nothing changes; at one key dP L and E are then one product, P dP
// rounded once, and dS is exactly 0 as it is in exact arithmetic, whatever
// the rounding of P or of dP's 3xTF32 sum (the caller's D = rowsum(dO O)
// in f32 differs from dP there by the rounding of two sums in other
// orders). The twin takes the same rule (nn/flash_attn.py _bwd_plain).
__device__ __forceinline__ float ds_one_tile(float dp, float p, float L,
                                             float E, float scale) {
  return __fsub_rn(__fmul_rn(dp, L), E) * p * scale;
}

// dkv's P^T from its S^T accumulators (keys the rows; the columns the
// query tile from q0, whose lse (natural log) sL holds): exp2(S^T scale
// log2 e - lse); the columns past Tq take lse = +inf, so P^T = 0 there
__device__ __forceinline__ void dkv_p(float (&sp)[8][4], const float* sL,
                                      int q0, int Tq, float scale_log2) {
  const int cq = (threadIdx.x & 3) * 2;
  const int qc = q0 + cq;  // this thread's first column
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 L = *reinterpret_cast<const float2*>(sL + 8 * j + cq);
    const float la = qc + 8 * j < Tq ? L.x * LOG2E : INFINITY;
    const float lb = qc + 8 * j + 1 < Tq ? L.y * LOG2E : INFINITY;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      sp[j][2 * half] = exp2f(fmaf(sp[j][2 * half], scale_log2, -la));
      sp[j][2 * half + 1] = exp2f(fmaf(sp[j][2 * half + 1], scale_log2, -lb));
    }
  }
}

// dkv's dS^T = P^T (dP^T - D) scale in place of dP^T, D of the tile's
// queries at sD (0 past Tq). With Tk <= BK (the keys of the block at k0 are
// all the keys) ds_one_tile's rule: the sums over the keys run down the
// accumulator rows, over the quads' lanes and then the four warps through
// red (2 x 4 x 64 floats of shared memory), the rows past Tk left out.
__device__ __forceinline__ void dkv_ds(float (&dp)[8][4],
                                       const float (&sp)[8][4],
                                       const float* sD, int k0, int Tk,
                                       float* red, float scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cq = (lane & 3) * 2;
  if (Tk > BK) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 D = *reinterpret_cast<const float2*>(sD + 8 * j + cq);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        dp[j][2 * half] = (dp[j][2 * half] - D.x) * sp[j][2 * half] * scale;
        dp[j][2 * half + 1] =
            (dp[j][2 * half + 1] - D.y) * sp[j][2 * half + 1] * scale;
      }
    }
    return;
  }
  const int row = k0 + 16 * warp + (lane >> 2);
  const bool in0 = row < Tk, in1 = row + 8 < Tk;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float l = (in0 ? sp[j][c] : 0.f) + (in1 ? sp[j][2 + c] : 0.f);
      float e = (in0 ? __fmul_rn(sp[j][c], dp[j][c]) : 0.f) +
                (in1 ? __fmul_rn(sp[j][2 + c], dp[j][2 + c]) : 0.f);
#pragma unroll
      for (int sh = 4; sh <= 16; sh <<= 1) {
        l += __shfl_xor_sync(0xffffffffu, l, sh);
        e += __shfl_xor_sync(0xffffffffu, e, sh);
      }
      if (lane < 4) {
        red[64 * warp + 8 * j + cq + c] = l;
        red[256 + 64 * warp + 8 * j + cq + c] = e;
      }
    }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = 8 * j + cq + c;
      const float L = red[col] + red[64 + col] + red[128 + col] + red[192 + col];
      const float E = red[256 + col] + red[320 + col] + red[384 + col] +
                      red[448 + col];
      dp[j][c] = ds_one_tile(dp[j][c], sp[j][c], L, E, scale);
      dp[j][2 + c] = ds_one_tile(dp[j][2 + c], sp[j][2 + c], L, E, scale);
    }
}

// dq's P = exp2(S scale log2 e - lse) from its S accumulators (queries the
// rows, lse l0, l1 in log2 units; the key tile from key0 the columns, P = 0
// past Tk) and dS = P (dP - D) scale in place of dP (D of the rows d0, d1);
// with Tk <= BK ds_one_tile's rule, the sums over the quads' lanes. sp
// leaves as P on that path.
__device__ __forceinline__ void dq_ds(float (&sp)[8][4], float (&dp)[8][4],
                                      int key0, int Tk, float l0, float l1,
                                      float d0, float d1, float scale_log2,
                                      float scale) {
  const int cq = (threadIdx.x & 3) * 2;
  if (Tk > BK) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const bool in = key0 + 8 * j + cq + c < Tk;
        const float pa = in ? exp2f(fmaf(sp[j][c], scale_log2, -l0)) : 0.f;
        const float pb =
            in ? exp2f(fmaf(sp[j][2 + c], scale_log2, -l1)) : 0.f;
        dp[j][c] = (dp[j][c] - d0) * pa * scale;
        dp[j][2 + c] = (dp[j][2 + c] - d1) * pb * scale;
      }
    return;
  }
  float L0 = 0.f, L1 = 0.f, E0 = 0.f, E1 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const bool in = key0 + 8 * j + cq + c < Tk;
      sp[j][c] = in ? exp2f(fmaf(sp[j][c], scale_log2, -l0)) : 0.f;
      sp[j][2 + c] = in ? exp2f(fmaf(sp[j][2 + c], scale_log2, -l1)) : 0.f;
      L0 += sp[j][c];
      L1 += sp[j][2 + c];
      E0 += __fmul_rn(sp[j][c], dp[j][c]);
      E1 += __fmul_rn(sp[j][2 + c], dp[j][2 + c]);
    }
#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    L0 += __shfl_xor_sync(0xffffffffu, L0, sh);
    L1 += __shfl_xor_sync(0xffffffffu, L1, sh);
    E0 += __shfl_xor_sync(0xffffffffu, E0, sh);
    E1 += __shfl_xor_sync(0xffffffffu, E1, sh);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      dp[j][c] = ds_one_tile(dp[j][c], sp[j][c], L0, E0, scale);
      dp[j][2 + c] = ds_one_tile(dp[j][2 + c], sp[j][2 + c], L1, E1, scale);
    }
}

// dK and dV of one 64-key tile (flash_bwd_dkv_kernel's recurrences): K and
// V fixed, the query tiles (Q, dO and their 64 lse and D) through the
// ring; keys are the accumulator rows, queries the columns.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, tc_min_blocks<T>())
flash_bwd_dkv_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
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
  using C = TC<T, D>;
  constexpr int TE = 64 * C::LD;
  extern __shared__ __align__(16) unsigned char smem_t[];
  T* const sK = reinterpret_cast<T*>(smem_t);
  T* const sV = sK + TE;
  auto sQ = [&](int s) { return sK + (2 + 2 * s) * TE; };
  auto sdO = [&](int s) { return sK + (3 + 2 * s) * TE; };
  float* const stats = reinterpret_cast<float*>(sK + 6 * TE);  // 2 x 128
  float* const red = stats + 256;  // dkv_ds's 2 x 4 x 64

  const int k0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const T* qb = q + b * sqb + h * sqh;
  const T* db = dout + b * sdb + h * sdh;
  // threads 0-63 copy a tile's lse, 64-127 its D
  const float* stat_src =
      (threadIdx.x < 64 ? lse : delta) + ((long long)b * gridDim.y + h) * Tq;
  const int ntiles = (Tq + BQ - 1) / BQ;
  auto load_stage = [&](int t) {
    const int s = t & 1, r = t * BQ + (threadIdx.x & 63);
    stage_tile<T, D>(sQ(s), qb, sqt, t * BQ, Tq);
    stage_tile<T, D>(sdO(s), db, sdt, t * BQ, Tq);
    cp_async4(smem_u32(stats + 128 * s + threadIdx.x),
              stat_src + (r < Tq ? r : 0), r < Tq);
  };

  stage_tile<T, D>(sK, k + b * skb + h * skh, skt, k0, Tk);
  stage_tile<T, D>(sV, v + b * svb + h * svh, svt, k0, Tk);
  load_stage(0);
  cp_async_commit();

  float acc_dk[D / 8][4], acc_dv[D / 8][4];
  zero(acc_dk);
  zero(acc_dv);
  for (int t = 0; t < ntiles; ++t) {
    const int st = t & 1;
    cp_async_wait<0>();  // tile t (and K, V) landed
    __syncthreads();     // ... for every thread; tile t - 1's stage free
    if (t + 1 < ntiles) load_stage(t + 1);
    cp_async_commit();

    // ---- S^T = K Q^T, P^T = exp2(S^T scale log2 e - lse) ----
    float sp[8][4], dp[8][4];
    zero(sp);
    mma_nt<T, D>(sp, sK + 16 * warp * C::LD, sQ(st));
    const float* sL = stats + 128 * st;
    dkv_p(sp, sL, t * BQ, Tq, scale_log2);

    // ---- dV += P^T dO first: dP^T's registers are not live yet ----
    mma_pn<T, D>(acc_dv, sp, sdO(st));

    // ---- dP^T = V dO^T, dS^T = P^T (dP^T - D) scale, dK += dS^T Q ----
    zero(dp);
    mma_nt<T, D>(dp, sV + 16 * warp * C::LD, sdO(st));
    dkv_ds(dp, sp, sL + 64, k0, Tk, red, scale);
    mma_pn<T, D>(acc_dk, dp, sQ(st));
  }
  store_tile_rows<T, D>(dk + b * skgb + h * skgh, skgt, k0, Tk, acc_dk);
  store_tile_rows<T, D>(dv + b * svgb + h * svgh, svgt, k0, Tk, acc_dv);
}

// dQ of one 64-query tile (flash_bwd_dq_kernel's recurrences): Q and dO
// fixed, the key tiles through the ring; the rows' lse and D in registers,
// P = 0 past Tk.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, tc_min_blocks<T>())
flash_bwd_dq_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, T* __restrict__ dq,
                       int Tq, int Tk, long long sqb, long long sqt,
                       long long sqh, long long skb, long long skt,
                       long long skh, long long svb, long long svt,
                       long long svh, long long sdb, long long sdt,
                       long long sdh, long long sqgb, long long sqgt,
                       long long sqgh, float scale_log2, float scale) {
  using C = TC<T, D>;
  constexpr int TE = 64 * C::LD;
  extern __shared__ __align__(16) unsigned char smem_t[];
  T* const sQ = reinterpret_cast<T*>(smem_t);
  T* const sdO = sQ + TE;
  auto sK = [&](int s) { return sQ + (2 + 2 * s) * TE; };
  auto sV = [&](int s) { return sQ + (3 + 2 * s) * TE; };

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* kb = k + b * skb + h * skh;
  const T* vb = v + b * svb + h * svh;
  const int ntiles = (Tk + BK - 1) / BK;

  stage_tile<T, D>(sQ, q + b * sqb + h * sqh, sqt, q0, Tq);
  stage_tile<T, D>(sdO, dout + b * sdb + h * sdh, sdt, q0, Tq);
  stage_tile<T, D>(sK(0), kb, skt, 0, Tk);
  stage_tile<T, D>(sV(0), vb, svt, 0, Tk);
  cp_async_commit();
  // rows r0 and r0 + 8: lse in log2 units and D (past Tq: +inf and 0)
  const long long sr = ((long long)b * gridDim.y + h) * Tq;
  const int r0 = q0 + 16 * warp + (lane >> 2), r1 = r0 + 8;
  const float l0 = r0 < Tq ? lse[sr + r0] * LOG2E : INFINITY;
  const float l1 = r1 < Tq ? lse[sr + r1] * LOG2E : INFINITY;
  const float d0 = r0 < Tq ? delta[sr + r0] : 0.f;
  const float d1 = r1 < Tq ? delta[sr + r1] : 0.f;

  float acc[D / 8][4];
  zero(acc);
  for (int t = 0; t < ntiles; ++t) {
    const int st = t & 1;
    cp_async_wait<0>();  // tile t (and Q, dO) landed
    __syncthreads();
    if (t + 1 < ntiles) {
      stage_tile<T, D>(sK(st ^ 1), kb, skt, (t + 1) * BK, Tk);
      stage_tile<T, D>(sV(st ^ 1), vb, svt, (t + 1) * BK, Tk);
    }
    cp_async_commit();

    // ---- S = Q K^T and dP = dO V^T ----
    float sp[8][4], dp[8][4];
    zero(sp);
    zero(dp);
    mma_nt<T, D>(sp, sQ + 16 * warp * C::LD, sK(st));
    mma_nt<T, D>(dp, sdO + 16 * warp * C::LD, sV(st));

    // ---- P = exp2(S scale log2 e - lse), 0 past Tk; dS = P (dP - D)
    // scale ----
    dq_ds(sp, dp, t * BK, Tk, l0, l1, d0, d1, scale_log2, scale);

    // ---- dQ += dS K ----
    mma_pn<T, D>(acc, dp, sK(st));
  }
  store_tile_rows<T, D>(dq + b * sqgb + h * sqgh, sqgt, q0, Tq, acc);
}

// ---------------------------------------------------------------------------
// The wide kernels' 128-column chunks of the head width (D = 128 NC).

constexpr int WCH = 128;  // a wide kernel's chunk of the head width

// acc (+)= A B^T over chunk `i` of the head width (mma_nt at width 128; A
// the warp's rows, acc zeroed first at i = 0). f32 takes each later
// chunk's product in a zeroed partial joined by IEEE adds, as mma_pn does
// its long sums: in place, the tensor cores' truncating accumulation over
// the 48 k-steps of width 384 moved dQ by 1.5e-5 of its largest against
// the f32 twin (bound 1e-5) on an H100.
template <typename T>
__device__ __forceinline__ void mma_nt_chunk(float (&acc)[8][4], const T* a,
                                             const T* b_tile, int i) {
  if (i == 0) zero(acc);
  if (i == 0 || TC<T, WCH>::PARTIAL == 0) {
    mma_nt<T, WCH>(acc, a, b_tile);
    return;
  }
  float t[8][4];
  zero(t);
  mma_nt<T, WCH>(t, a, b_tile);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] += t[j][c];
}

// ---------------------------------------------------------------------------
// The bf16 wide backward on wgmma: flash_bwd_dkv_wgmma_wide and
// flash_bwd_dq_wgmma_wide, bf16 at every head width D = 128 NC (NC >= 1:
// width 128 too), under the backward's contract above.
//
// A cluster of CS blocks (cudaLaunchKernelEx, cluster dimension CS along
// the grid's y axis of (head, rank)) shares one (key tile, head, batch
// row) in dkv or one (query tile, ...) in dq. Rank c owns the 128-column
// chunks c, c + CS, ... of D: one chunk up to NC = 8 (CS = NC, a portable
// cluster), ceil(NC / 8) above (PER chunks a block, CS = ceil(NC / PER)).
// A block is two warpgroups (256 threads). A step (a query tile in dkv, a
// key tile in dq):
// 1. partial products on the block's own chunk only: warpgroup 0 forms
//    S^T_c = K_c Q_c^T (dq: S_c = Q_c K_c^T), warpgroup 1 dP^T_c = V_c
//    dO_c^T (dq: dP_c = dO_c V_c^T), 64 x 64 f32 over the chunk's 128
//    columns (eight m64n64k16 wgmma from shared memory: a 128-column chunk
//    is two 64-column 128-byte-swizzle atoms side by side, one descriptor
//    each), published in shared memory (16 KB each);
// 2. once every rank's partials are published, the tile's 512 units of 2
//    rows x 4 columns are split among the ranks: a thread sums a unit's
//    partials of every rank through distributed shared memory in rank
//    order 0..CS-1, forms P and dS, rounds them to bf16 and stores them
//    into every rank's P / dS tiles (swizzled, wgmma's A operand from
//    shared memory). Each element of S and dP is summed, and each P and
//    dS formed, once in the cluster: no chunk forms a score tile again,
//    and every rank multiplies by the same bits. Where every key lies in
//    one tile (Tk <= 64) the one-key rule's sums run over keys, so there
//    every rank forms all 512 units itself, storing only into its own
//    tiles, with a warp's lanes on one column quad (dkv) or row pair (dq);
// 3. once every rank's lines are stored, the output products with A the
//    P / dS tile and B the streamed chunk read MN-major: in dkv warpgroup 0
//    takes dV_c += P^T dO_c and 1 dK_c += dS^T Q_c, each m64n128k16 over
//    both atoms (A read once for 128 columns); in dq each warpgroup takes
//    64 of dQ_c += dS K_c's 128 columns, m64n64k16 on one atom.
// The waits of steps 2 and 3 are mbarriers in each block, on which one
// thread of every rank arrives (release at cluster scope) after a block
// barrier; a barrier.cluster cost ~1000 cycles more than a block barrier
// a step even at one block (scripts/bench_flash_wgw.py, PERF.md). With
// one chunk a block, the fixed pair of the chunk (K_c, V_c in dkv; Q_c,
// dO_c in dq) stays in shared memory and the step is pipelined: the
// streamed pair (dkv: with the query tile's lse and D) runs through a
// three-stage cp.async ring two tiles ahead; step t + 1's partial product
// is issued before step t's exchange and published, and signalled, while
// step t's output products run; the P / dS tiles alternate by step
// parity, so that the ranks may write step t + 1's while step t's are
// still read. Buffer reuse follows from the two waits: a block writes its
// partials again only after every rank has stored its lines of the last
// step (so read the partials), and the ranks write a parity's tiles only
// after every rank has published the next partials (so ended the
// products two steps back). With PER > 1 (D > 1024) a step copies each
// owned chunk's tiles in turn into the same buffers, without the ring,
// and each chunk's f32 accumulators live between steps in a device
// scratch the caller provides (xt_flash_attn_bwd_scratch floats), a
// block's own slots: no atomics. One block an SM (shared memory 194.5 KB
// in dkv, 177.5 KB in dq); registers: accumulators 64 (dkv) / 32 (dq) a
// thread beside the partial's 32. What bounds it (PERF.md): the
// distributed shared memory the exchange moves, (CS - 1) / CS x (32 KB of
// partials in + 16 KB of P / dS out) a block a step, at roughly 6-10
// bytes a cycle an SM.

constexpr int WGW_THREADS = 256;          // two warpgroups
constexpr int WGW_CHUNK = 2 * TILE_BYTES; // 64 rows x 128 bf16: two atoms
constexpr int WGW_PART = 64 * 64 * 4;     // an f32 64 x 64 partial
constexpr int WGW_MAX_CLUSTER = 8;        // portable cluster size
// dkv: K_c, V_c; the stages of Q_c, dO_c and their lse and D; P^T and
// dS^T twice (by step parity); the two partials; the exchange's barriers
constexpr int WGW_STAGES = 3;             // the streamed ring's depth
constexpr int WGW_DKV_SMEM = 1024 + (2 + 2 * WGW_STAGES) * WGW_CHUNK +
                             4 * TILE_BYTES + 2 * WGW_PART +
                             WGW_STAGES * STAT_BYTES + 16;
// dq: Q_c, dO_c; the stages of K_c, V_c; dS twice; the two partials; the
// query tile's lse and D; the exchange's barriers
constexpr int WGW_DQ_SMEM = 1024 + (2 + 2 * WGW_STAGES) * WGW_CHUNK +
                            2 * TILE_BYTES + 2 * WGW_PART + STAT_BYTES + 16;
// a block's scratch slot for one chunk: dK and dV (dkv) or dQ (dq)
constexpr int WGW_DKV_SLOT = 2 * 64 * WCH;
constexpr int WGW_DQ_SLOT = 64 * WCH;

// chunks a block (PER) and the cluster size (CS) at NC chunks
__host__ __device__ __forceinline__ int wgw_per(int nc) {
  return (nc + WGW_MAX_CLUSTER - 1) / WGW_MAX_CLUSTER;
}
__host__ __device__ __forceinline__ int wgw_cs(int nc) {
  return (nc + wgw_per(nc) - 1) / wgw_per(nc);
}

// d += A B, m64n64k16, A K-major and B MN-major from shared memory
__device__ __forceinline__ void wgmma_ss_tb(float (&d)[32], uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " XT_D32
      ", %32, %33, 1, 1, 1, 0, 1;\n"
      : XT_ACC32(d)
      : "l"(da), "l"(db));
}

// the m64n128 forms: d (+)= A B with 64 f32 accumulators a thread (register
// 4j + c: row 16 w + g (+ 8 for 4j + 2 + c), column 8 j + 2 q + c)
#define XT_ACC64(d)                                                          \
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),            \
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),            \
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),       \
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),       \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),       \
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),       \
      "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),       \
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),       \
      "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),       \
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),       \
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),       \
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

#define XT_D64                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63}"

// d += A B, m64n128k16, A K-major and B MN-major from shared memory
__device__ __forceinline__ void wgmma_ss_tb128(float (&d)[64], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " XT_D64
      ", %64, %65, 1, 1, 1, 0, 1;\n"
      : XT_ACC64(d)
      : "l"(da), "l"(db));
}

// an MN-major B operand two 64-column atoms wide in N: the atoms 8 KB apart
// (leading byte offset), 8-row groups along K 1024 bytes apart (stride)
__device__ __forceinline__ uint64_t desc_mn2(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)(TILE_BYTES >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void fence_regs(float (&r)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ void zero(float (&r)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) r[i] = 0.f;
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// arrive (release) and wait (acquire) for every thread of the cluster;
// returns 0, read after the wait
__device__ __forceinline__ uint32_t cluster_sync() {
  uint32_t after;
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  asm volatile(
      "barrier.cluster.wait.aligned;\n"
      "mov.u32 %0, 0;\n"
      : "=r"(after)::"memory");
  return after;
}

// the shared::cluster address of shared address `a` in rank r's block
__device__ __forceinline__ uint32_t mapa(uint32_t a, uint32_t r) {
  uint32_t out;
  asm("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(a), "r"(r));
  return out;
}

// a float4 of a partial: not volatile, so that the compiler issues a
// warp's loads together; `after` (a value computed after the barrier that
// published the partials) keeps them behind it
__device__ __forceinline__ float4 ld_cluster4(uint32_t a, uint32_t after) {
  float4 v;
  asm("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "r"(a), "r"(after));
  return v;
}

// a float4 of this block's shared memory (the own rank's partial)
__device__ __forceinline__ float4 ld_shared4(uint32_t a, uint32_t after) {
  float4 v;
  asm("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "r"(a), "r"(after));
  return v;
}

// shared address a in rank r's block (this block's plainly where r == c)
__device__ __forceinline__ float4 ld_rank4(uint32_t a, int r, int c,
                                           uint32_t after) {
  return r == c ? ld_shared4(a, after) : ld_cluster4(mapa(a, r), after);
}
__device__ __forceinline__ void st_rank2(uint32_t a, int r, int c,
                                         uint32_t v0, uint32_t v1) {
  if (r == c)
    asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(a), "r"(v0),
                 "r"(v1)
                 : "memory");
  else
    asm volatile("st.shared::cluster.v2.b32 [%0], {%1, %2};\n" ::"r"(
                     mapa(a, r)),
                 "r"(v0), "r"(v1)
                 : "memory");
}

// mbarriers of the exchange: a block's barrier completes a phase when
// every rank of the cluster has arrived on it once
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// this block's threads' shared-memory writes so far made visible to every
// rank (release at cluster scope) and counted on each rank's barrier
// `bar`: after a block barrier, thread r < CS arrives on rank r's
__device__ __forceinline__ void mbar_signal(uint32_t bar, int CS) {
  __syncthreads();
  if ((int)threadIdx.x < CS)
    asm volatile(
        "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::
            "r"(mapa(bar, threadIdx.x))
        : "memory");
}

// until this block's barrier `bar` completes the phase of parity `parity`
// (acquire at cluster scope); returns 0, read after the wait
__device__ __forceinline__ uint32_t mbar_wait(uint32_t bar,
                                              uint32_t parity) {
  uint32_t after;
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
      "%2;\n"
      "@!p bra WAIT;\n"
      "mov.u32 %0, 0;\n}\n"
      : "=r"(after)
      : "r"(bar), "r"(parity)
      : "memory");
  return after;
}

// a 64 x 128 bf16 chunk (rows row0.. of a view with row stride `stride`)
// into two swizzled 64-column atoms at dst, dst + TILE_BYTES; rows at or
// past nrows zero-filled. 1024 16-byte pieces, 1024 / NT a thread of the
// NT copying; 16 neighbouring threads read one 256-byte row.
template <int NT = WGW_THREADS>
__device__ __forceinline__ void load_chunk(uint32_t dst, const bf16* src,
                                           long long stride, int row0,
                                           int nrows) {
#pragma unroll
  for (int j = 0; j < 1024 / NT; ++j) {
    const int id = threadIdx.x + j * NT;
    const int r = id >> 4, cc = id & 15, c = cc & 7;
    const bool valid = row0 + r < nrows;
    const bf16* g = valid ? src + (long long)(row0 + r) * stride + cc * 8
                          : src;
    cp_async16(dst + (cc >> 3) * TILE_BYTES + r * 128 + ((c ^ (r & 7)) << 4),
               g, valid);
  }
}

// acc (+)= A B^T over one 128-column chunk, A and B chunks in shared
// memory (K-major, two atoms each), issued as one commit group (the caller
// waits); acc zeroed first where `first`
__device__ __forceinline__ void wgw_partial(float (&acc)[32], uint32_t a,
                                            uint32_t b, bool first) {
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint32_t o = (kk >> 2) * TILE_BYTES + 32 * (kk & 3);
    wgmma_ss(acc, desc(a + o), desc(b + o), first ? kk > 0 : 1);
  }
  wgmma_commit();
}

// acc += A B over 64: A a 64 x 64 tile (K-major), B one atom read MN-major
__device__ __forceinline__ void wgw_product(float (&acc)[32], uint32_t a,
                                            uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss_tb(acc, desc(a + 32 * kk), desc(b + 2048 * kk));
}

// the same with B a whole chunk (both atoms): acc 64 x 128
__device__ __forceinline__ void wgw_product(float (&acc)[64], uint32_t a,
                                            uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss_tb128(acc, desc(a + 32 * kk), desc_mn2(b + 2048 * kk));
}

// A partial's shared-memory layout. The exchange works in 512 units of 2
// rows x 4 columns: rows r = 16 w + g and r + 8 of task tau = 8 (8 w + g)
// + j (w, g: the warp in the warpgroup and lane / 4 of the threads that
// hold those rows), columns 8 j + 4 h .. + 3 (unit u = 2 tau + h). The
// accumulator float4 4j..4j+3 of thread t (rows r, r + 8, columns 8 j +
// 2 q, + 1; q = t % 4) is float4 k = q of task tau (t / 4 = 8 w + g), so a
// unit is the task's float4 2h and 2h + 1. Task tau's four float4 lie at
// block tau ^ bit 3 of tau, float4 k ^ bit 1 of tau in it: a quarter warp
// of publishing threads (two tasks, k = 0..3) and of exchange lanes (four
// tasks, h = 0, 1) touches eight distinct 16-byte bank groups.
__device__ __forceinline__ uint32_t part_slot(int tau, int k) {
  return ((tau ^ ((tau >> 3) & 1)) * 4 + (k ^ ((tau >> 1) & 1))) * 16;
}

__device__ __forceinline__ void wgw_publish(unsigned char* buf,
                                            const float (&p)[32]) {
  const int t = threadIdx.x & 127;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    *reinterpret_cast<float4*>(buf + part_slot(8 * (t >> 2) + j, t & 3)) =
        make_float4(p[4 * j], p[4 * j + 1], p[4 * j + 2], p[4 * j + 3]);
}

__device__ __forceinline__ float warp_sum(float v, int lanes) {
  for (int sh = 1; sh < lanes; sh <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, sh);
  return v;
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
}

// A unit of the exchange: its rows and columns, and the two float4 of S
// and of dP summed over every rank in rank order 0..CS-1. Row r holds
// (s0.x, s0.y, s1.x, s1.y), row r + 8 (s0.z, s0.w, s1.z, s1.w).
struct WgwUnit {
  int r, j, h, c0;
  float4 s0, s1, d0, d1;
};

__device__ __forceinline__ WgwUnit wgw_unit(int tau, int h, uint32_t sS,
                                            uint32_t sdP, int c, int CS,
                                            uint32_t after) {
  WgwUnit u;
  const int rg = tau >> 3;
  u.j = tau & 7;
  u.h = h;
  u.r = 16 * (rg >> 3) + (rg & 7);
  u.c0 = 8 * u.j + 4 * h;
  const uint32_t oa = part_slot(tau, 2 * h), ob = part_slot(tau, 2 * h + 1);
  u.s0 = ld_rank4(sS + oa, 0, c, after);
  u.s1 = ld_rank4(sS + ob, 0, c, after);
  u.d0 = ld_rank4(sdP + oa, 0, c, after);
  u.d1 = ld_rank4(sdP + ob, 0, c, after);
#pragma unroll
  for (int rk = 1; rk < WGW_MAX_CLUSTER; ++rk) {
    if (rk >= CS) break;
    add4(u.s0, ld_rank4(sS + oa, rk, c, after));
    add4(u.s1, ld_rank4(sS + ob, rk, c, after));
    add4(u.d0, ld_rank4(sdP + oa, rk, c, after));
    add4(u.d1, ld_rank4(sdP + ob, rk, c, after));
  }
  return u;
}

// a unit's row pair of P or dS as bf16 into rank rk's 64 x 64 swizzled
// tile at `tile` (row r at the unit's 8 bytes of chunk j, row r + 8)
__device__ __forceinline__ void wgw_store(uint32_t tile, const WgwUnit& u,
                                          int rk, int c, const float (&v)[8]) {
  const uint32_t a = tile + u.r * 128 + ((u.j ^ (u.r & 7)) << 4) + 8 * u.h;
  st_rank2(a, rk, c, pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
  st_rank2(a + 8 * 128, rk, c, pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

// shared address a in rank r's block (this block's plainly where r == c)
__device__ __forceinline__ void st_rank4(uint32_t a, int r, int c, float x,
                                         float y, float z, float w) {
  if (r == c)
    asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(a),
                 "f"(x), "f"(y), "f"(z), "f"(w)
                 : "memory");
  else
    asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                     mapa(a, r)),
                 "f"(x), "f"(y), "f"(z), "f"(w)
                 : "memory");
}

// The f32 pair's P / dS tiles: 64 x 64 f32, rows FW_LDP floats apart (72:
// a quarter warp's float2 reads of the A operand, rows g and columns 2t,
// land on 32 distinct banks, 8 g + 2 t)
constexpr int FW_LDP = 72;

// a unit's row pair of P or dS in f32 into rank rk's tile (row r's 4
// columns from c0, then row r + 8's)
__device__ __forceinline__ void fw_store(uint32_t tile, const WgwUnit& u,
                                         int rk, int c, const float (&v)[8]) {
  const uint32_t a = tile + (u.r * FW_LDP + u.c0) * 4;
  st_rank4(a, rk, c, v[0], v[1], v[2], v[3]);
  st_rank4(a + 8 * FW_LDP * 4, rk, c, v[4], v[5], v[6], v[7]);
}

template <bool F32>
__device__ __forceinline__ void unit_store(uint32_t tile, const WgwUnit& u,
                                           int rk, int c,
                                           const float (&v)[8]) {
  if constexpr (F32)
    fw_store(tile, u, rk, c, v);
  else
    wgw_store(tile, u, rk, c, v);
}

// The units a thread takes in a step: this rank's share of the 512
// (units lo + threadIdx.x + 256 i), or where every key lies in one tile
// (Tk <= 64, the one-key rule, whose sums run over keys) all 512 in every
// rank, each rank storing only into its own tiles.
constexpr int WGW_UNITS = 2;

// Step 2 of a dkv step (keys the rows, queries the columns): P^T and dS^T
// of this thread's units into every rank's sP / sdS (bf16 swizzled, or
// with F32 the f32 pair's tiles). sL: the query tile's 64 lse (natural
// log), then its 64 D; q0 its first query. The one-key rule's sums over
// keys run down a column: there a warp takes one 4-column quad of all 32
// row pairs.
template <bool F32 = false>
__device__ __forceinline__ void dkv_exchange(
    uint32_t sS, uint32_t sdP, uint32_t sP, uint32_t sdS, const float* sL,
    int q0, int Tq, int Tk, int c, int CS, float scale_log2, float scale,
    uint32_t after) {
  const bool one = Tk <= BK;
  const int lo = one ? 0 : 512 * c / CS, hi = one ? 512 : 512 * (c + 1) / CS;
  WgwUnit us[WGW_UNITS];
#pragma unroll
  for (int i = 0; i < WGW_UNITS; ++i) {
    const int u = lo + threadIdx.x + 256 * i;
    if (u >= hi) break;
    // one-key: u = 32 quad + row pair, quad = 2 j + h
    const int tau = one ? 8 * (u & 31) + (u >> 6) : u >> 1;
    us[i] = wgw_unit(tau, one ? (u >> 5) & 1 : u & 1, sS, sdP, c, CS, after);
  }
#pragma unroll
  for (int i = 0; i < WGW_UNITS; ++i) {
    if (lo + (int)threadIdx.x + 256 * i >= hi) break;
    const WgwUnit& u = us[i];
    const float4 L4 = *reinterpret_cast<const float4*>(sL + u.c0);
    const float4 D4 = *reinterpret_cast<const float4*>(sL + 64 + u.c0);
    const float Lc[4] = {L4.x, L4.y, L4.z, L4.w};
    const float Dc[4] = {D4.x, D4.y, D4.z, D4.w};
    const float S[8] = {u.s0.x, u.s0.y, u.s1.x, u.s1.y,
                        u.s0.z, u.s0.w, u.s1.z, u.s1.w};
    const float dP[8] = {u.d0.x, u.d0.y, u.d1.x, u.d1.y,
                         u.d0.z, u.d0.w, u.d1.z, u.d1.w};
    float P[8], dS[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const bool in = q0 + u.c0 + (e & 3) < Tq;
      P[e] = exp2f(fmaf(S[e], scale_log2, in ? -Lc[e & 3] * LOG2E
                                              : -INFINITY));
      dS[e] = (dP[e] - (in ? Dc[e & 3] : 0.f)) * P[e] * scale;
    }
    if (one) {
      const bool k0 = u.r < Tk, k1 = u.r + 8 < Tk;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float L = warp_sum((k0 ? P[e] : 0.f) + (k1 ? P[e + 4] : 0.f),
                                 32);
        const float E =
            warp_sum((k0 ? __fmul_rn(P[e], dP[e]) : 0.f) +
                         (k1 ? __fmul_rn(P[e + 4], dP[e + 4]) : 0.f),
                     32);
        dS[e] = ds_one_tile(dP[e], P[e], L, E, scale);
        dS[e + 4] = ds_one_tile(dP[e + 4], P[e + 4], L, E, scale);
      }
      unit_store<F32>(sP, u, c, c, P);
      unit_store<F32>(sdS, u, c, c, dS);
      continue;
    }
    for (int rk = 0; rk < CS; ++rk) {
      unit_store<F32>(sP, u, rk, c, P);
      unit_store<F32>(sdS, u, rk, c, dS);
    }
  }
}

// Step 2 of a dq step (queries the rows, keys the columns from key0): dS
// of this thread's units into every rank's sdS (as dkv_exchange's), P = 0
// past Tk. sL: the query tile's lse and D. The one-key rule's sums over
// keys run along a row pair: 16 neighbouring lanes.
template <bool F32 = false>
__device__ __forceinline__ void dq_exchange(
    uint32_t sS, uint32_t sdP, uint32_t sdS, const float* sL, int q0,
    int key0, int Tq, int Tk, int c, int CS, float scale_log2, float scale,
    uint32_t after) {
  const bool one = Tk <= BK;
  const int lo = one ? 0 : 512 * c / CS, hi = one ? 512 : 512 * (c + 1) / CS;
  WgwUnit us[WGW_UNITS];
#pragma unroll
  for (int i = 0; i < WGW_UNITS; ++i) {
    const int u = lo + threadIdx.x + 256 * i;
    if (u >= hi) break;
    us[i] = wgw_unit(u >> 1, u & 1, sS, sdP, c, CS, after);
  }
#pragma unroll
  for (int i = 0; i < WGW_UNITS; ++i) {
    if (lo + (int)threadIdx.x + 256 * i >= hi) break;
    const WgwUnit& u = us[i];
    const bool r0 = q0 + u.r < Tq, r1 = q0 + u.r + 8 < Tq;
    const float l[2] = {r0 ? sL[u.r] * LOG2E : INFINITY,
                        r1 ? sL[u.r + 8] * LOG2E : INFINITY};
    const float d[2] = {r0 ? sL[64 + u.r] : 0.f, r1 ? sL[64 + u.r + 8] : 0.f};
    const float S[8] = {u.s0.x, u.s0.y, u.s1.x, u.s1.y,
                        u.s0.z, u.s0.w, u.s1.z, u.s1.w};
    const float dP[8] = {u.d0.x, u.d0.y, u.d1.x, u.d1.y,
                         u.d0.z, u.d0.w, u.d1.z, u.d1.w};
    float P[8], dS[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      P[e] = key0 + u.c0 + (e & 3) < Tk
                 ? exp2f(fmaf(S[e], scale_log2, -l[e >> 2]))
                 : 0.f;
      dS[e] = (dP[e] - d[e >> 2]) * P[e] * scale;
    }
    if (one) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int e0 = 4 * half;
        const float L = warp_sum(P[e0] + P[e0 + 1] + P[e0 + 2] + P[e0 + 3],
                                 16);
        const float E = warp_sum(
            __fmul_rn(P[e0], dP[e0]) + __fmul_rn(P[e0 + 1], dP[e0 + 1]) +
                __fmul_rn(P[e0 + 2], dP[e0 + 2]) +
                __fmul_rn(P[e0 + 3], dP[e0 + 3]),
            16);
#pragma unroll
        for (int e = e0; e < e0 + 4; ++e)
          dS[e] = ds_one_tile(dP[e], P[e], L, E, scale);
      }
      unit_store<F32>(sdS, u, c, c, dS);
      continue;
    }
    for (int rk = 0; rk < CS; ++rk) unit_store<F32>(sdS, u, rk, c, dS);
  }
}

// Step t's two waits: every rank's partials published (bar[0]), every
// rank's P / dS lines stored into this block (bar[1]); each barrier
// completes once a step. One block a cluster: a block barrier.
__device__ __forceinline__ uint32_t wgw_partials_ready(uint32_t bars, int CS,
                                                       int t) {
  if (CS == 1) {
    uint32_t after;
    __syncthreads();
    asm volatile("mov.u32 %0, 0;\n" : "=r"(after)::"memory");
    return after;
  }
  mbar_signal(bars, CS);
  return mbar_wait(bars, t & 1);
}

// The pipelined steps' split of it: this block's partials published
// (signalled as soon as they are), and at the top of step t a block
// barrier, then every rank's partials of t ready.
__device__ __forceinline__ void wgw_signal_partials(uint32_t bars, int CS) {
  if (CS > 1) mbar_signal(bars, CS);
}
__device__ __forceinline__ uint32_t wgw_wait_partials(uint32_t bars, int CS,
                                                      int t) {
  uint32_t after;
  __syncthreads();
  if (CS > 1) return mbar_wait(bars, t & 1);
  asm volatile("mov.u32 %0, 0;\n" : "=r"(after)::"memory");
  return after;
}

// the generic stores of P / dS made visible to wgmma (the async proxy) in
// every rank, and every rank's lines stored
__device__ __forceinline__ void wgw_tiles_ready(uint32_t bars, int CS,
                                                int t) {
  if (CS == 1) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    return;
  }
  asm volatile("fence.proxy.async.shared::cluster;\n" ::: "memory");
  mbar_signal(bars + 8, CS);
  mbar_wait(bars + 8, t & 1);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the exchange's barriers initialised, and seen initialised by every rank
// before any rank arrives on them
__device__ __forceinline__ void wgw_init(uint32_t bars, int CS) {
  if (threadIdx.x == 0) {
    mbar_init(bars, CS);
    mbar_init(bars + 8, CS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();
}

// a warpgroup's accumulator rows (row0 + 16 w + g, + 8; w the warp in the
// warpgroup) of a (rows, 2 N) bf16 view as bf16 pairs, rows at or past
// nrows left out
template <int N>
__device__ __forceinline__ void store_wg_rows(bf16* dst, long long stride,
                                              int row0, int nrows,
                                              const float (&v)[N]) {
  const int t = threadIdx.x & 127;
  const int r0 = row0 + 16 * (t >> 5) + ((t & 31) >> 2), cq = (t & 3) * 2;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    if (r >= nrows) continue;
    bf16* p = dst + (long long)r * stride + cq;
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
      *reinterpret_cast<__nv_bfloat162*>(p + 8 * j) = __floats2bfloat162_rn(
          v[4 * j + 2 * half], v[4 * j + 2 * half + 1]);
  }
}

// a thread's N accumulators in / out of its block's scratch slot part
// (float4 i of thread x at (i * 256 + x) * 4)
template <int N>
__device__ __forceinline__ void slot_load(float (&v)[N], const float* s) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 a = reinterpret_cast<const float4*>(s)[i * WGW_THREADS +
                                                        threadIdx.x];
    v[4 * i] = a.x; v[4 * i + 1] = a.y; v[4 * i + 2] = a.z; v[4 * i + 3] = a.w;
  }
}
template <int N>
__device__ __forceinline__ void slot_store(float* s, const float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i)
    reinterpret_cast<float4*>(s)[i * WGW_THREADS + threadIdx.x] =
        make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}

__device__ __forceinline__ void cp_async_land() {
  cp_async_wait<0>();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// dK and dV of one 64-key tile's chunks (keys the accumulator rows).
__global__ void __launch_bounds__(WGW_THREADS, 1)
flash_bwd_dkv_wgmma_wide(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, float* __restrict__ scratch,
    int Tq, int Tk, int NC, long long sqb, long long sqt, long long sqh,
    long long skb, long long skt, long long skh, long long svb,
    long long svt, long long svh, long long sdb, long long sdt,
    long long sdh, long long skgb, long long skgt, long long skgh,
    long long svgb, long long svgt, long long svgh, float scale_log2,
    float scale) {
  extern __shared__ unsigned char smem[];
  const uint32_t raw = smem_u32(smem);
  const uint32_t sK = (raw + 1023u) & ~1023u, sV = sK + WGW_CHUNK;
  auto sQ = [&](int s) { return sK + (2 + 2 * s) * WGW_CHUNK; };
  auto sdO = [&](int s) { return sK + (3 + 2 * s) * WGW_CHUNK; };
  // P^T and dS^T of even steps, then of odd ones
  const uint32_t sP = sK + (2 + 2 * WGW_STAGES) * WGW_CHUNK;
  const uint32_t sdS = sP + TILE_BYTES, sPS = sP + 4 * TILE_BYTES;
  const uint32_t sPdP = sPS + WGW_PART, sStat = sPdP + WGW_PART;
  const uint32_t bars = sStat + WGW_STAGES * STAT_BYTES;
  auto stats = [&](int s) {
    return reinterpret_cast<const float*>(smem + (sStat - raw) +
                                          s * STAT_BYTES);
  };

  const int CS = wgw_cs(NC), PER = wgw_per(NC);
  const int c = (int)cluster_rank(), hd = blockIdx.y / CS, b = blockIdx.z;
  const int H = gridDim.y / CS, k0 = blockIdx.x * BK;
  const int wg = threadIdx.x >> 7;
  const bf16* qb = q + b * sqb + hd * sqh;
  const bf16* db = dout + b * sdb + hd * sdh;
  const bf16* kb = k + b * skb + hd * skh;
  const bf16* vb = v + b * svb + hd * svh;
  // threads 0-63 copy a query tile's lse, 64-127 its D
  const float* stat_src =
      (threadIdx.x < 64 ? lse : delta) + ((long long)b * H + hd) * Tq;
  const int nt = (Tq + BQ - 1) / BQ;
  auto load_stats = [&](int s, int t) {
    if (threadIdx.x < 128) {
      const int r = t * BQ + (threadIdx.x & 63);
      cp_async4(sStat + s * STAT_BYTES + threadIdx.x * 4,
                stat_src + (r < Tq ? r : 0), r < Tq);
    }
  };
  // this warpgroup's partial (0: S^T = K Q^T, 1: dP^T = V dO^T) and
  // output columns (64 wg.. of the chunk)
  unsigned char* const mine = smem + (sPS - raw) + wg * WGW_PART;
  // warpgroup 0 accumulates dV_c, 1 dK_c (64 x 128 each)
  float part[32], acc[64];
  // dV += P^T dO (warpgroup 0) or dK += dS^T Q (1), the P^T / dS^T tiles of
  // step parity `odd`, the stage's Q and dO
  auto products = [&](int odd, uint32_t tq, uint32_t tdo) {
    fence_regs(acc);
    wgmma_fence();
    wgw_product(acc, (wg ? sdS : sP) + odd * 2 * TILE_BYTES, wg ? tq : tdo);
    wgmma_commit();
  };
  bf16* const out =
      wg ? dk + b * skgb + hd * skgh : dv + b * svgb + hd * svgh;
  const long long out_t = wg ? skgt : svgt;
  auto exchange = [&](int t, const float* sL, int q0) {
    const uint32_t after = wgw_partials_ready(bars, CS, t);
    dkv_exchange(sPS, sPdP, sP, sdS, sL, q0, Tq, Tk, c, CS, scale_log2,
                 scale, after);
    wgw_tiles_ready(bars, CS, t);
  };
  wgw_init(bars, CS);
  zero(acc);

  if (PER == 1) {
    // Step t: (the partials of t published) every rank's partials of t
    // ready; tile t + 2 copied into its stage and step t + 1's partial
    // product issued; the exchange of t; the products of t issued, the
    // partial of t + 1 published while they run. A stage is refilled
    // only after the barrier of the next step, when both warpgroups'
    // products from it have ended.
    auto load_stage = [&](int t) {
      const int s = t % WGW_STAGES;
      load_chunk(sQ(s), qb + c * WCH, sqt, t * BQ, Tq);
      load_chunk(sdO(s), db + c * WCH, sdt, t * BQ, Tq);
      load_stats(s, t);
    };
    load_chunk(sK, kb + c * WCH, skt, k0, Tk);
    load_chunk(sV, vb + c * WCH, svt, k0, Tk);
    load_stage(0);
    cp_async_commit();
    if (nt > 1) load_stage(1);
    cp_async_commit();
    cp_async_wait<1>();  // K, V and tile 0
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    wgw_partial(part, wg ? sV : sK, wg ? sdO(0) : sQ(0), true);
    wgmma_wait<0>();
    fence_regs(part);
    wgw_publish(mine, part);
    cp_async_wait<0>();  // tile 1
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    wgw_signal_partials(bars, CS);
    for (int t = 0; t < nt; ++t) {
      const int s = t % WGW_STAGES;
      const int n = t + 1 < nt ? (t + 1) % WGW_STAGES : s;
      const uint32_t pds = (t & 1) * 2 * TILE_BYTES;  // this step's tiles
      const uint32_t after = wgw_wait_partials(bars, CS, t);
      if (t + 2 < nt) load_stage(t + 2);
      cp_async_commit();
      wgw_partial(part, wg ? sV : sK, wg ? sdO(n) : sQ(n), true);
      dkv_exchange(sPS, sPdP, sP + pds, sdS + pds, stats(s), t * BQ, Tq, Tk,
                   c, CS, scale_log2, scale, after);
      wgw_tiles_ready(bars, CS, t);
      products(t & 1, sQ(s), sdO(s));
      wgmma_wait<1>();  // the partial of t + 1 (the products may run)
      fence_regs(part);
      wgw_publish(mine, part);
      // the ranks may write the other parity's tiles from here on
      if (t + 1 < nt) wgw_signal_partials(bars, CS);
      wgmma_wait<0>();
      fence_regs(acc);
      cp_async_wait<0>();  // tile t + 2
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    store_wg_rows(out + c * WCH, out_t, k0, Tk, acc);
    return;
  }

  // PER > 1: chunks c + CS i, i < n, each step copying their tiles in turn
  const int n = (NC - c + CS - 1) / CS;
  float* const slots =
      scratch + ((((long long)b * H + hd) * gridDim.x + blockIdx.x) * CS +
                 c) * PER * WGW_DKV_SLOT;
  for (int t = 0; t < nt; ++t) {
    const int q0 = t * BQ;
    for (int i = 0; i < n; ++i) {
      const int col = (c + CS * i) * WCH;
      __syncthreads();  // the last readers of these buffers are done
      load_chunk(sK, kb + col, skt, k0, Tk);
      load_chunk(sV, vb + col, svt, k0, Tk);
      load_chunk(sQ(0), qb + col, sqt, q0, Tq);
      load_chunk(sdO(0), db + col, sdt, q0, Tq);
      if (i == 0) load_stats(0, t);
      cp_async_commit();
      cp_async_land();
      wgw_partial(part, wg ? sV : sK, wg ? sdO(0) : sQ(0), i == 0);
      wgmma_wait<0>();
      fence_regs(part);
    }
    wgw_publish(mine, part);
    exchange(t, stats(0), q0);
    for (int i = 0; i < n; ++i) {
      const int col = (c + CS * i) * WCH;
      __syncthreads();
      load_chunk(sQ(0), qb + col, sqt, q0, Tq);
      load_chunk(sdO(0), db + col, sdt, q0, Tq);
      cp_async_commit();
      cp_async_land();
      float* slot = slots + i * WGW_DKV_SLOT;
      if (t == 0)
        zero(acc);
      else
        slot_load(acc, slot);
      products(0, sQ(0), sdO(0));
      wgmma_wait<0>();
      fence_regs(acc);
      if (t + 1 < nt)
        slot_store(slot, acc);
      else
        store_wg_rows(out + col, out_t, k0, Tk, acc);
    }
  }
}

// dQ of one 64-query tile's chunks (queries the accumulator rows): the
// dkv kernel's steps over the key tiles, Q_c and dO_c fixed, K_c and V_c
// streamed.
__global__ void __launch_bounds__(WGW_THREADS, 1)
flash_bwd_dq_wgmma_wide(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, float* __restrict__ scratch, int Tq, int Tk,
    int NC, long long sqb, long long sqt, long long sqh, long long skb,
    long long skt, long long skh, long long svb, long long svt,
    long long svh, long long sdb, long long sdt, long long sdh,
    long long sqgb, long long sqgt, long long sqgh, float scale_log2,
    float scale) {
  extern __shared__ unsigned char smem[];
  const uint32_t raw = smem_u32(smem);
  const uint32_t sQ = (raw + 1023u) & ~1023u, sdO = sQ + WGW_CHUNK;
  auto sK = [&](int s) { return sQ + (2 + 2 * s) * WGW_CHUNK; };
  auto sV = [&](int s) { return sQ + (3 + 2 * s) * WGW_CHUNK; };
  // dS of even steps, then of odd ones
  const uint32_t sdS = sQ + (2 + 2 * WGW_STAGES) * WGW_CHUNK;
  const uint32_t sPS = sdS + 2 * TILE_BYTES, sPdP = sPS + WGW_PART;
  const uint32_t sStat = sPdP + WGW_PART, bars = sStat + STAT_BYTES;
  const float* sL = reinterpret_cast<const float*>(smem + (sStat - raw));

  const int CS = wgw_cs(NC), PER = wgw_per(NC);
  const int c = (int)cluster_rank(), hd = blockIdx.y / CS, b = blockIdx.z;
  const int H = gridDim.y / CS, q0 = blockIdx.x * BQ;
  const int wg = threadIdx.x >> 7;
  const bf16* qb = q + b * sqb + hd * sqh;
  const bf16* db = dout + b * sdb + hd * sdh;
  const bf16* kb = k + b * skb + hd * skh;
  const bf16* vb = v + b * svb + hd * svh;
  const int nt = (Tk + BK - 1) / BK;
  if (threadIdx.x < 128) {  // the query tile's lse (0-63) and D (64-127)
    const int r = q0 + (threadIdx.x & 63);
    cp_async4(sStat + threadIdx.x * 4,
              (threadIdx.x < 64 ? lse : delta) +
                  ((long long)b * H + hd) * Tq + (r < Tq ? r : 0),
              r < Tq);
  }
  unsigned char* const mine = smem + (sPS - raw) + wg * WGW_PART;
  float part[32], acc[32];
  auto products = [&](int odd, uint32_t tk) {  // dQ += dS K
    fence_regs(acc);
    wgmma_fence();
    wgw_product(acc, sdS + odd * TILE_BYTES, tk + wg * TILE_BYTES);
    wgmma_commit();
  };
  auto exchange = [&](int t, int key0) {
    const uint32_t after = wgw_partials_ready(bars, CS, t);
    dq_exchange(sPS, sPdP, sdS, sL, q0, key0, Tq, Tk, c, CS, scale_log2,
                scale, after);
    wgw_tiles_ready(bars, CS, t);
  };
  wgw_init(bars, CS);
  zero(acc);

  if (PER == 1) {  // the dkv kernel's pipeline
    auto load_stage = [&](int t) {
      const int s = t % WGW_STAGES;
      load_chunk(sK(s), kb + c * WCH, skt, t * BK, Tk);
      load_chunk(sV(s), vb + c * WCH, svt, t * BK, Tk);
    };
    load_chunk(sQ, qb + c * WCH, sqt, q0, Tq);
    load_chunk(sdO, db + c * WCH, sdt, q0, Tq);
    load_stage(0);
    cp_async_commit();
    if (nt > 1) load_stage(1);
    cp_async_commit();
    cp_async_wait<1>();  // Q, dO, the statistics and tile 0
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    wgw_partial(part, wg ? sdO : sQ, wg ? sV(0) : sK(0), true);
    wgmma_wait<0>();
    fence_regs(part);
    wgw_publish(mine, part);
    cp_async_wait<0>();  // tile 1
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    wgw_signal_partials(bars, CS);
    for (int t = 0; t < nt; ++t) {
      const int s = t % WGW_STAGES;
      const int n = t + 1 < nt ? (t + 1) % WGW_STAGES : s;
      const uint32_t after = wgw_wait_partials(bars, CS, t);
      if (t + 2 < nt) load_stage(t + 2);
      cp_async_commit();
      wgw_partial(part, wg ? sdO : sQ, wg ? sV(n) : sK(n), true);
      dq_exchange(sPS, sPdP, sdS + (t & 1) * TILE_BYTES, sL, q0, t * BK, Tq,
                  Tk, c, CS, scale_log2, scale, after);
      wgw_tiles_ready(bars, CS, t);
      products(t & 1, sK(s));
      wgmma_wait<1>();
      fence_regs(part);
      wgw_publish(mine, part);
      if (t + 1 < nt) wgw_signal_partials(bars, CS);
      wgmma_wait<0>();
      fence_regs(acc);
      cp_async_wait<0>();  // tile t + 2
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    store_wg_rows(dq + b * sqgb + hd * sqgh + c * WCH + 64 * wg, sqgt, q0,
                  Tq, acc);
    return;
  }

  const int n = (NC - c + CS - 1) / CS;
  float* const slots =
      scratch + ((((long long)b * H + hd) * gridDim.x + blockIdx.x) * CS +
                 c) * PER * WGW_DQ_SLOT;
  for (int t = 0; t < nt; ++t) {
    const int key0 = t * BK;
    for (int i = 0; i < n; ++i) {
      const int col = (c + CS * i) * WCH;
      __syncthreads();  // the last readers of these buffers are done
      load_chunk(sQ, qb + col, sqt, q0, Tq);
      load_chunk(sdO, db + col, sdt, q0, Tq);
      load_chunk(sK(0), kb + col, skt, key0, Tk);
      load_chunk(sV(0), vb + col, svt, key0, Tk);
      cp_async_commit();
      cp_async_land();
      wgw_partial(part, wg ? sdO : sQ, wg ? sV(0) : sK(0), i == 0);
      wgmma_wait<0>();
      fence_regs(part);
    }
    wgw_publish(mine, part);
    exchange(t, key0);
    for (int i = 0; i < n; ++i) {
      const int col = (c + CS * i) * WCH;
      __syncthreads();
      load_chunk(sK(0), kb + col, skt, key0, Tk);
      cp_async_commit();
      cp_async_land();
      float* slot = slots + i * WGW_DQ_SLOT;
      if (t == 0)
        zero(acc);
      else
        slot_load(acc, slot);
      products(0, sK(0));
      wgmma_wait<0>();
      fence_regs(acc);
      if (t + 1 < nt)
        slot_store(slot, acc);
      else
        store_wg_rows(dq + b * sqgb + hd * sqgh + col + 64 * wg, sqgt, q0,
                      Tq, acc);
    }
  }
}

// ---------------------------------------------------------------------------
// The f32 wide backward: flash_bwd_dkv_f32_wide and flash_bwd_dq_f32_wide,
// f32 at every head width D = 128 NC (NC >= 1, width 128 too; routing:
// fw_width), under the backward's contract above. Above 128 they replace
// a block a 128-column chunk that formed S and dP again over the whole
// width ((2 NC + 2) / 4 of dkv's work and (2 NC + 1) / 3 of dq's) and
// spilled; at 128 the tile pair <float, 128>, which spilled 312 / 80
// bytes, in half its time (PERF.md, the same A/B run).
//
// The wgmma pair's cluster and exchange, on the tile family's 3xTF32
// mma.sync: a cluster of CS blocks (cudaLaunchKernelEx, cluster dimension
// CS along y) shares one (key tile, head, batch row) in dkv or one (query
// tile, ...) in dq; rank c owns the 128-column chunks c, c + CS, ... (one
// chunk up to NC = 8, PER = ceil(NC / 8) above, CS = ceil(NC / PER): wgw_cs
// and wgw_per). A block is two warpgroups (256 threads, one block an SM:
// 8 warps on the products), each warp 16 accumulator rows. A step (a
// query tile in dkv, a key tile in dq):
// 1. partial products on the block's own chunk only (64 x 64 f32 over its
//    128 columns, 16 k-steps of m16n8k8): in dkv warpgroup 0 forms S^T_c =
//    K_c Q_c^T and 1 dP^T_c = V_c dO_c^T, in dq 0 S_c = Q_c K_c^T and 1
//    dP_c = dO_c V_c^T; published into shared memory (16 KB each);
// 2. the exchange (dkv_exchange / dq_exchange, the wgmma pair's): each of
//    the tile's 512 units of 2 rows x 4 columns is summed once in the
//    cluster, over the ranks' partials in rank order through distributed
//    shared memory, P and dS formed from it once and stored as f32 into
//    every rank's P / dS tiles (at Tk <= 64, the one-key rule, every rank
//    forms all units, storing into its own). Each element of S and dP is
//    thus formed once per (query tile, key tile, head), and every rank
//    splits the same f32 bits into tf32 parts;
// 3. the output products, A the P / dS tile from shared memory (its
//    columns 2t, 2t + 1 of each 8 read as one float2 and taken as k = t,
//    t + 4, b_nn's order), B the streamed tile, partials of four k-steps
//    joined by IEEE adds (mma_pn's rule): in dkv warpgroup 0 dK_c += dS^T
//    Q_c and 1 dV_c += P^T dO_c (64 x 128 each, 64 registers a thread); in
//    dq each warpgroup 64 of dQ_c += dS K_c's 128 columns (32).
// The waits of steps 2 and 3 are the wgmma pair's mbarriers (no proxy
// fence: mma.sync reads shared memory through the generic proxy); one
// buffer each for the partials and the P / dS tiles suffices, as the
// steps do not overlap: a block publishes the next partials only after
// every rank has stored its units (so read the partials), and the ranks
// store the next P / dS only after every rank has published the next
// partials (so ended its output products).
//
// Shared memory (f32 tiles of 64 x 128, rows TC<float, 128>::LD = 132
// floats apart: 33 KB each; P / dS 18 KB each; partials 16 KB each):
// - dkv: K_c, V_c fixed; one Q_c and one dO_c tile; P^T, dS^T; the two
//   partials; two query tiles' lse and D; 201 KB. A second stage of the
//   streamed pair (66 KB more) does not fit, so each warpgroup owns one
//   streamed tile (0 Q_c, 1 dO_c: the two products that read it) and
//   refills it by column halves: after its output product's first 64
//   columns the next tile's first half is copied, after the second the
//   second half, and the next partial's first 8 k-steps run while that
//   second half lands (named barriers a warpgroup, no block barrier);
// - dq: Q_c, dO_c fixed; K_c in two stages (read by the partial and the
//   output product), V_c in one (read by the partial only: refilled during
//   the exchange); dS; the partials; the tile's lse and D; 215.5 KB.
// The tf32 split of the streamed tiles into shared memory once (goal of a
// split per value instead of one per warp) would double them: 66 KB more
// in dkv and 99 KB in dq, which neither has, so each warp splits its B
// fragments as the tile family does.
// Registers: dkv holds 64 accumulators and the 32 of a partial a thread,
// dq 32 and 32; __launch_bounds__(256, 1) leaves 255 a thread, and ptxas
// gives dkv 245 and dq 237 without a spill. With PER > 1 (D > 1024) a
// step copies each owned chunk's tiles in turn into the same buffers,
// without the halves, the partial summed over them in zeroed partials
// joined by IEEE adds (mma_nt_chunk), and each chunk's accumulators live
// between steps in the caller's f32 scratch (xt_flash_attn_bwd_scratch,
// the wgmma pair's slots): no atomics.
// Grids: dkv (ceil(Tk / 64), H CS, B), dq (ceil(Tq / 64), H CS, B)
// blocks, one an SM; xt_flash_attn_bwd_clusters gives the clusters
// resident at once (on an H100 66 of 2, 39 of 3). At the main bucket's 2
// heads of 256 that is 200 and 160 blocks, two waves each, so the wrapper
// launches dq on a second stream beside dkv (nn/flash_attn.py
// flash_mha_bwd_pair): together 360 blocks, three waves.
// What bounds it (PERF.md): the 3xTF32 mma.sync products, ~75% of a step
// (about 10 cycles an m16n8k8 a sub-partition), then the exchange and its
// two waits.

constexpr int FW_LD = TC<float, WCH>::LD;  // a 64 x 128 tile's row
constexpr int FW_TILE = 64 * FW_LD;         // floats of a 64 x 128 tile
constexpr int FW_PTILE = 64 * FW_LDP;       // floats of a P / dS tile
constexpr int FW_DKV_SMEM =
    (4 * FW_TILE + 2 * FW_PTILE) * 4 + 2 * STAT_BYTES + 2 * WGW_PART + 16;
constexpr int FW_DQ_SMEM =
    (5 * FW_TILE + FW_PTILE) * 4 + STAT_BYTES + 2 * WGW_PART + 16;
static_assert(FW_DKV_SMEM <= 232448 && FW_DQ_SMEM <= 232448,
              "227 KB of shared memory a block");

// rows row0.. of a 64 x 128 f32 chunk (row stride `stride` floats) into a
// tile, the 16-byte pieces p0 .. p0 + P - 1 of each row (32 a row), by NT
// threads from `tid`; rows at or past nrows zero-filled
template <int NT, int P>
__device__ __forceinline__ void fw_stage(float* dst, const float* src,
                                         long long stride, int row0,
                                         int nrows, int p0, int tid) {
  static_assert(64 * P % NT == 0, "whole pieces a thread");
  const uint32_t base = smem_u32(dst);
#pragma unroll
  for (int i = 0; i < 64 * P / NT; ++i) {
    const int id = tid + i * NT, r = id / P, c = p0 + id % P;
    const bool valid = row0 + r < nrows;
    const float* g = valid ? src + (long long)(row0 + r) * stride + 4 * c
                           : src;
    cp_async16(base + (r * FW_LD + 4 * c) * 4, g, valid);
  }
}

// acc += A B^T over the k-steps K0 .. K1 - 1 of a 128-column chunk: A the
// warp's 16 rows `rows` of a tile, B(k, n) = b_tile[8 j + n][k] (mma_nt's
// products, in two halves where the second's columns are still landing)
template <int K0, int K1>
__device__ __forceinline__ void fw_partial(float (&acc)[8][4],
                                           const float* rows,
                                           const float* b_tile) {
  using C = TC<float, WCH>;
#pragma unroll 2
  for (int kk = K0; kk < K1; ++kk) {
    const C::A a = C::a_tile(rows, kk * C::KS);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      C::mma(acc[j], a, C::b_nt(b_tile, 8 * j, kk * C::KS));
  }
}

// acc[j] += A B over the 64 columns of A: A the warp's 16 rows `rows` of a
// P / dS tile, B(k, n) = b_tile[k][n0 + 8 j + n]; A's columns 2t, 2t + 1
// of each 8 are k = t, t + 4 (a_acc's and b_nn's order), one float2 a row;
// partials of PARTIAL k-steps joined by IEEE adds, as mma_pn. Each k-step
// feeds the N blocks' partials t[j] in turn, so a warp has N independent
// accumulator chains in flight (mma_pn's order, a chain of 3 PARTIAL
// products on one partial, took dkv's product 1.35 times the partial's
// cycles for the same products; scripts/bench_flash_wgw.py prof). The
// two partials in turn, not unrolled: unrolled, ptxas hoisted the
// second's operands and spilled at 255 registers.
template <int N>
__device__ __forceinline__ void fw_product(float (&acc)[N][4],
                                           const float* rows,
                                           const float* b_tile, int n0) {
  using C = TC<float, WCH>;
  const int lane = threadIdx.x & 31;
  const float* p = rows + (lane >> 2) * FW_LDP + 2 * (lane & 3);
#pragma unroll 1
  for (int k0 = 0; k0 < 64 / C::KS; k0 += C::PARTIAL) {
    float t[N][4];
    zero(t);
#pragma unroll
    for (int g = 0; g < C::PARTIAL; ++g) {
      const int kk = k0 + g;
      const float2 r0 = *reinterpret_cast<const float2*>(p + C::KS * kk);
      const float2 r1 =
          *reinterpret_cast<const float2*>(p + 8 * FW_LDP + C::KS * kk);
      const uint32_t r[4] = {__float_as_uint(r0.x), __float_as_uint(r1.x),
                             __float_as_uint(r0.y), __float_as_uint(r1.y)};
      const C::A a = C::a_split(r);
#pragma unroll
      for (int j = 0; j < N; ++j)
        C::mma(t[j], a, C::b_nn(b_tile, kk * C::KS, n0 + 8 * j));
    }
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] += t[j][i];
  }
}

__device__ __forceinline__ void fw_publish(unsigned char* buf,
                                           const float (&p)[8][4]) {
  const int t = threadIdx.x & 127;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    *reinterpret_cast<float4*>(buf + part_slot(8 * (t >> 2) + j, t & 3)) =
        make_float4(p[j][0], p[j][1], p[j][2], p[j][3]);
}

// every rank's P / dS stored into this block's tiles (the f32 pair's
// wgw_tiles_ready, without the async proxy)
__device__ __forceinline__ void fw_tiles_ready(uint32_t bars, int CS,
                                               int t) {
  if (CS > 1) {
    mbar_signal(bars + 8, CS);
    mbar_wait(bars + 8, t & 1);
  } else {
    __syncthreads();
  }
}

// the 128 threads of warpgroup wg (named barrier 1 + wg)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// a thread's accumulators in / out of its block's scratch slot part
// (slot_load's layout)
__device__ __forceinline__ void fw_slot_load(float (&v)[8][4],
                                             const float* s) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float4 a =
        reinterpret_cast<const float4*>(s)[i * WGW_THREADS + threadIdx.x];
    v[i][0] = a.x; v[i][1] = a.y; v[i][2] = a.z; v[i][3] = a.w;
  }
}
__device__ __forceinline__ void fw_slot_store(float* s,
                                              const float (&v)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
    reinterpret_cast<float4*>(s)[i * WGW_THREADS + threadIdx.x] =
        make_float4(v[i][0], v[i][1], v[i][2], v[i][3]);
}

// dK and dV of one 64-key tile's chunks in f32 (keys the accumulator
// rows).
__global__ void __launch_bounds__(WGW_THREADS, 1)
flash_bwd_dkv_f32_wide(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv,
    float* __restrict__ scratch, int Tq, int Tk, int NC, long long sqb,
    long long sqt, long long sqh, long long skb, long long skt,
    long long skh, long long svb, long long svt, long long svh,
    long long sdb, long long sdt, long long sdh, long long skgb,
    long long skgt, long long skgh, long long svgb, long long svgt,
    long long svgh, float scale_log2, float scale) {
  extern __shared__ __align__(16) unsigned char smem_t[];
  float* const sK = reinterpret_cast<float*>(smem_t);
  float* const sV = sK + FW_TILE;
  float* const sQ = sK + 2 * FW_TILE;
  float* const sdO = sK + 3 * FW_TILE;
  float* const sP = sK + 4 * FW_TILE;  // P^T, then dS^T
  float* const sdS = sP + FW_PTILE;
  float* const stats = sdS + FW_PTILE;  // lse, D of tiles t & 1 = 0, 1
  unsigned char* const parts = reinterpret_cast<unsigned char*>(stats + 256);
  const uint32_t sPS = smem_u32(parts), sPdP = sPS + WGW_PART;
  const uint32_t bars = sPdP + WGW_PART;

  const int CS = wgw_cs(NC), PER = wgw_per(NC);
  const int c = (int)cluster_rank(), hd = blockIdx.y / CS, b = blockIdx.z;
  const int H = gridDim.y / CS, k0 = blockIdx.x * BK;
  const int wg = threadIdx.x >> 7, w = (threadIdx.x >> 5) & 3;
  const int tid = threadIdx.x & 127;  // the thread in its warpgroup
  const float* qb = q + b * sqb + hd * sqh;
  const float* db = dout + b * sdb + hd * sdh;
  const float* kb = k + b * skb + hd * skh;
  const float* vb = v + b * svb + hd * svh;
  // threads 0-63 copy a query tile's lse, 64-127 its D
  const float* stat_src =
      (threadIdx.x < 64 ? lse : delta) + ((long long)b * H + hd) * Tq;
  auto load_stats = [&](int t) {
    const int r = t * BQ + (threadIdx.x & 63);
    cp_async4(smem_u32(stats + 128 * (t & 1) + threadIdx.x),
              stat_src + (r < Tq ? r : 0), r < Tq);
  };
  const int nt = (Tq + BQ - 1) / BQ;
  // warpgroup 0: S^T = K Q^T, then dK += dS^T Q; 1: dP^T = V dO^T, then
  // dV += P^T dO. The warp's rows of its fixed tile, its streamed tile
  // (and the view that fills it), the warp's rows of its A tile
  const float* const own = (wg ? sV : sK) + 16 * w * FW_LD;
  float* const tile = wg ? sdO : sQ;
  const float* const src = wg ? db : qb;
  const long long src_t = wg ? sdt : sqt;
  const float* const arows = (wg ? sP : sdS) + 16 * w * FW_LDP;
  unsigned char* const mine = parts + wg * WGW_PART;
  float* const out = wg ? dv + b * svgb + hd * svgh : dk + b * skgb + hd * skgh;
  const long long out_t = wg ? svgt : skgt;
  float part[8][4], lo[8][4], hi[8][4];  // a partial; columns 0-63, 64-127
  auto exchange = [&](int t) {
    fw_publish(mine, part);
    const uint32_t after = wgw_partials_ready(bars, CS, t);
    dkv_exchange<true>(sPS, sPdP, smem_u32(sP), smem_u32(sdS),
                       stats + 128 * (t & 1), t * BQ, Tq, Tk, c, CS,
                       scale_log2, scale, after);
    fw_tiles_ready(bars, CS, t);
  };
  wgw_init(bars, CS);
  zero(lo);
  zero(hi);

  if (PER == 1) {
    // Step t: (partial of t formed) exchange of t; the output product on
    // the streamed tile's columns 0-63, then the first half of tile t + 1
    // copied into them; columns 64-127, then the second half; the partial
    // of t + 1 on the first half while the second lands.
    const int col = c * WCH;
    fw_stage<WGW_THREADS, 32>(sK, kb + col, skt, k0, Tk, 0, threadIdx.x);
    fw_stage<WGW_THREADS, 32>(sV, vb + col, svt, k0, Tk, 0, threadIdx.x);
    fw_stage<128, 32>(tile, src + col, src_t, 0, Tq, 0, tid);
    if (wg == 0) load_stats(0);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    zero(part);
    fw_partial<0, 16>(part, own, tile);
    for (int t = 0; t < nt; ++t) {
      const bool next = t + 1 < nt;
      exchange(t);
      fw_product(lo, arows, tile, 0);
      wg_sync(wg);  // the warpgroup's reads of columns 0-63 ended
      if (next) {
        fw_stage<128, 16>(tile, src + col, src_t, (t + 1) * BQ, Tq, 0, tid);
        if (wg == 0) load_stats(t + 1);
      }
      cp_async_commit();
      fw_product(hi, arows, tile, 64);
      wg_sync(wg);
      if (next)
        fw_stage<128, 16>(tile, src + col, src_t, (t + 1) * BQ, Tq, 16, tid);
      cp_async_commit();
      if (!next) break;
      cp_async_wait<1>();  // the first half of tile t + 1
      wg_sync(wg);
      zero(part);
      fw_partial<0, 8>(part, own, tile);
      cp_async_wait<0>();  // the second
      wg_sync(wg);
      fw_partial<8, 16>(part, own, tile);
    }
    store_tile_rows<float, 64>(out + col, out_t, k0, Tk, lo);
    store_tile_rows<float, 64>(out + col + 64, out_t, k0, Tk, hi);
    return;
  }

  // PER > 1: chunks c + CS i, i < n, each step copying their tiles in turn
  const int n = (NC - c + CS - 1) / CS;
  float* const slots =
      scratch + ((((long long)b * H + hd) * gridDim.x + blockIdx.x) * CS +
                 c) * PER * WGW_DKV_SLOT;
  for (int t = 0; t < nt; ++t) {
    const int q0 = t * BQ;
    for (int i = 0; i < n; ++i) {
      const int col = (c + CS * i) * WCH;
      __syncthreads();  // the last readers of these buffers are done
      fw_stage<WGW_THREADS, 32>(sK, kb + col, skt, k0, Tk, 0, threadIdx.x);
      fw_stage<WGW_THREADS, 32>(sV, vb + col, svt, k0, Tk, 0, threadIdx.x);
      fw_stage<128, 32>(tile, src + col, src_t, q0, Tq, 0, tid);
      if (i == 0 && wg == 0) load_stats(t);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      mma_nt_chunk<float>(part, own, tile, i);
    }
    exchange(t);
    for (int i = 0; i < n; ++i) {
      const int col = (c + CS * i) * WCH;
      __syncthreads();
      fw_stage<128, 32>(tile, src + col, src_t, q0, Tq, 0, tid);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      float* slot = slots + i * WGW_DKV_SLOT;
      if (t > 0) {
        fw_slot_load(lo, slot);
        fw_slot_load(hi, slot + WGW_DKV_SLOT / 2);
      } else {
        zero(lo);
        zero(hi);
      }
      fw_product(lo, arows, tile, 0);
      fw_product(hi, arows, tile, 64);
      if (t + 1 < nt) {
        fw_slot_store(slot, lo);
        fw_slot_store(slot + WGW_DKV_SLOT / 2, hi);
      } else {
        store_tile_rows<float, 64>(out + col, out_t, k0, Tk, lo);
        store_tile_rows<float, 64>(out + col + 64, out_t, k0, Tk, hi);
      }
    }
  }
}

// dQ of one 64-query tile's chunks (queries the accumulator rows): Q_c and
// dO_c fixed, K_c and V_c streamed over the key tiles.
__global__ void __launch_bounds__(WGW_THREADS, 1)
flash_bwd_dq_f32_wide(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, float* __restrict__ scratch, int Tq, int Tk,
    int NC, long long sqb, long long sqt, long long sqh, long long skb,
    long long skt, long long skh, long long svb, long long svt,
    long long svh, long long sdb, long long sdt, long long sdh,
    long long sqgb, long long sqgt, long long sqgh, float scale_log2,
    float scale) {
  extern __shared__ __align__(16) unsigned char smem_t[];
  float* const sQ = reinterpret_cast<float*>(smem_t);
  float* const sdO = sQ + FW_TILE;
  auto sK = [&](int s) { return sQ + (2 + s) * FW_TILE; };
  float* const sV = sQ + 4 * FW_TILE;
  float* const sdS = sQ + 5 * FW_TILE;
  float* const sL = sdS + FW_PTILE;  // the query tile's lse, then its D
  unsigned char* const parts = reinterpret_cast<unsigned char*>(sL + 128);
  const uint32_t sPS = smem_u32(parts), sPdP = sPS + WGW_PART;
  const uint32_t bars = sPdP + WGW_PART;

  const int CS = wgw_cs(NC), PER = wgw_per(NC);
  const int c = (int)cluster_rank(), hd = blockIdx.y / CS, b = blockIdx.z;
  const int H = gridDim.y / CS, q0 = blockIdx.x * BQ;
  const int wg = threadIdx.x >> 7, w = (threadIdx.x >> 5) & 3;
  const float* qb = q + b * sqb + hd * sqh;
  const float* db = dout + b * sdb + hd * sdh;
  const float* kb = k + b * skb + hd * skh;
  const float* vb = v + b * svb + hd * svh;
  const int nt = (Tk + BK - 1) / BK;
  if (threadIdx.x < 128) {  // the query tile's lse (0-63) and D (64-127)
    const int r = q0 + (threadIdx.x & 63);
    cp_async4(smem_u32(sL + threadIdx.x),
              (threadIdx.x < 64 ? lse : delta) +
                  ((long long)b * H + hd) * Tq + (r < Tq ? r : 0),
              r < Tq);
  }
  // warpgroup 0: S = Q K^T, 1: dP = dO V^T; then each 64 of dQ's 128
  // columns += dS K
  const float* const own = (wg ? sdO : sQ) + 16 * w * FW_LD;
  const float* const arows = sdS + 16 * w * FW_LDP;
  unsigned char* const mine = parts + wg * WGW_PART;
  float* const out = dq + b * sqgb + hd * sqgh + 64 * wg;
  float part[8][4], acc[8][4];
  auto exchange = [&](int t) {
    fw_publish(mine, part);
    const uint32_t after = wgw_partials_ready(bars, CS, t);
    // every warp's reads of V_c ended: tile t + 1's may land (PER == 1)
    if (PER == 1 && t + 1 < nt)
      fw_stage<WGW_THREADS, 32>(sV, vb + c * WCH, svt, (t + 1) * BK, Tk, 0,
                                threadIdx.x);
    cp_async_commit();
    dq_exchange<true>(sPS, sPdP, smem_u32(sdS), sL, q0, t * BK, Tq, Tk, c,
                      CS, scale_log2, scale, after);
    fw_tiles_ready(bars, CS, t);
  };
  wgw_init(bars, CS);
  zero(acc);

  if (PER == 1) {
    // Step t: tiles t landed; K of t + 1 copied into the other stage; the
    // partial; the exchange, V of t + 1 copied meanwhile; dQ += dS K_t.
    const int col = c * WCH;
    fw_stage<WGW_THREADS, 32>(sQ, qb + col, sqt, q0, Tq, 0, threadIdx.x);
    fw_stage<WGW_THREADS, 32>(sdO, db + col, sdt, q0, Tq, 0, threadIdx.x);
    fw_stage<WGW_THREADS, 32>(sK(0), kb + col, skt, 0, Tk, 0, threadIdx.x);
    fw_stage<WGW_THREADS, 32>(sV, vb + col, svt, 0, Tk, 0, threadIdx.x);
    cp_async_commit();
    for (int t = 0; t < nt; ++t) {
      const float* kt = sK(t & 1);
      cp_async_wait<0>();  // K and V of t (at t = 0 Q, dO, lse, D) landed
      __syncthreads();     // ... for every thread; the products of t - 1
                           // ended, the other stage is free
      if (t + 1 < nt)
        fw_stage<WGW_THREADS, 32>(sK((t + 1) & 1), kb + col, skt,
                                  (t + 1) * BK, Tk, 0, threadIdx.x);
      cp_async_commit();
      zero(part);
      fw_partial<0, 16>(part, own, wg ? sV : kt);
      exchange(t);
      fw_product(acc, arows, kt, 64 * wg);
    }
    store_tile_rows<float, 64>(out + col, sqgt, q0, Tq, acc);
    return;
  }

  const int n = (NC - c + CS - 1) / CS;
  float* const slots =
      scratch + ((((long long)b * H + hd) * gridDim.x + blockIdx.x) * CS +
                 c) * PER * WGW_DQ_SLOT;
  for (int t = 0; t < nt; ++t) {
    const int key0 = t * BK;
    for (int i = 0; i < n; ++i) {
      const int col = (c + CS * i) * WCH;
      __syncthreads();  // the last readers of these buffers are done
      fw_stage<WGW_THREADS, 32>(sQ, qb + col, sqt, q0, Tq, 0, threadIdx.x);
      fw_stage<WGW_THREADS, 32>(sdO, db + col, sdt, q0, Tq, 0, threadIdx.x);
      fw_stage<WGW_THREADS, 32>(sK(0), kb + col, skt, key0, Tk, 0,
                                threadIdx.x);
      fw_stage<WGW_THREADS, 32>(sV, vb + col, svt, key0, Tk, 0, threadIdx.x);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      mma_nt_chunk<float>(part, own, wg ? sV : sK(0), i);
    }
    exchange(t);
    for (int i = 0; i < n; ++i) {
      const int col = (c + CS * i) * WCH;
      __syncthreads();
      fw_stage<WGW_THREADS, 32>(sK(0), kb + col, skt, key0, Tk, 0,
                                threadIdx.x);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      float* slot = slots + i * WGW_DQ_SLOT;
      if (t > 0)
        fw_slot_load(acc, slot);
      else
        zero(acc);
      fw_product(acc, arows, sK(0), 64 * wg);
      if (t + 1 < nt)
        fw_slot_store(slot, acc);
      else
        store_tile_rows<float, 64>(out + col, sqgt, q0, Tq, acc);
    }
  }
}

// ---------------------------------------------------------------------------
// The bf16 forward at head width D = 128 NC for every NC >= 1 (128 and each
// multiple above): flash_fwd_wgmma_wide<CPS, MQ>, under the forward's
// contract (the views' strides as they come, the ragged Tq / Tk edges
// zero-filled, the lse in natural log where asked, one launch, the same
// bits from run to run).
//
// Each score tile is formed once. A block of two warpgroups owns MQ
// 64-query tiles of one (head, batch row) and W = 128 CPS columns of their
// output, W up to W_MAX = 512: at D = 128, 256, 384 and 512 the whole
// width, so each score tile S = Q K^T is formed once for all of O. S is
// wgmma m64n64k16 over the D / 16 k-steps from 128-byte-swizzle
// descriptors, a 128-column chunk (two atoms, WGW_CHUNK) a ring step
// (wgw_partial); the online softmax stays in registers as in
// flash_fwd_kernel; O += P V is wgmma too, V read MN-major.
//
// What bounds it on an H100 (scripts/bench_flash_fwd_wide.py, PERF.md):
// not the tensor cores' rate (at 128 the forward takes 88% of its time
// without its S products, 95% without its P V) but each warpgroup's
// serial chain of a key tile: its S, then its softmax (exp2 at the SM's
// 16 a cycle), then its P V, with a block barrier at each 128-column step
// where the ring's copies are waited for (66% of the time without them).
// Ways out tried and not kept: the next tile's S issued before this
// tile's P V (ptxas then serializes the wgmma, their registers in flight
// across the barrier and the softmax), and the two warpgroups in turns on
// an mbarrier ring filled by cp.async or by TMA (right, but 10-40%
// slower than the lockstep).
//
// Up to W = 256 (CPS 1-2) a block takes two query tiles (MQ = 2), a
// warpgroup each over the whole width (64 / 128 f32 accumulators a thread
// at 128 / 256 beside S's 32 and P's 16; P stays in registers as wgmma's A
// operand, m64n128k16 a chunk), and both read the one K / V ring: every
// query tile streams its head's whole K and V, so two a block halve the
// copies a query row. At W = 384 and 512 O does not fit one warpgroup, so
// the two split the columns of one query tile (MQ = 1; warpgroup w the
// 64-column atom w of every chunk, 96 / 128 accumulators a thread):
// warpgroup 0 forms S and the softmax and stores P (bf16, swizzled, 8 KB)
// and each row's rescale factor into shared memory before the V-steps'
// barrier; both take P from there (wgw_product). The warpgroups reach the
// block's barriers from their own code (named barrier 1), so that neither
// issues wgmma under a branch. One block an SM (~200-255 registers).
//
// The card is filled by splitting the keys, not O's columns: a
// thread-block cluster of R <= 8 blocks shares one (query tiles, head,
// batch row, column slice) and rank r takes key tiles T r / R .. T (r + 1)
// / R - 1 of the T. R comes from the grid (fww_plan): of R = 1..8 the one
// with the least reckoned time, rounds of the card's SMs (resident
// clusters of R read with cudaOccupancyMaxActiveClusters) times a block's
// key tiles plus FWW_RANK_COST tiles for its Q and the combine. At the end
// the ranks combine (m, l, O) once through distributed shared memory: each
// rank writes its unnormalised f32 O (64 MQ x W, 8-float groups of a row
// swizzled by row % 4, over its ring and Q) and its rows' (m, l); after a
// cluster barrier every rank reads all ranks' (m, l), weights each rank's
// O by 2^(m_r - m) / l in rank order 0..R-1 and stores its own 1 / R of
// O's rows x columns, four float4 of every rank in flight a thread; rank 0
// stores the lse. A rank with no key tile (Tk < 64 R: R does not look at
// Tk's whole tiles) keeps m = -inf, l = 0 and O = 0 and weighs 0. That is
// one exchange a block, not one a step. With R = 1 no cluster barrier
// runs: O is normalised and stored from the registers.
//
// Steps: K and V stream through a ring of FWW_SLOTS stages, a 128-column
// chunk a step, FWW_AHEAD steps copied ahead by cp.async (zero-filled past
// Tk), one block barrier a step; a key tile is D / 128 S-steps (K_i; S +=
// Q_i K_i^T), the softmax, then CPS V-steps (V_c; O_c += P V_c). A step's
// products are waited for a step later, so that the next step's issue
// while they run; the stage refilled at step n is step n - 2's. Q is copied once
// and held whole where D <= 512; above, each S-step copies Q_i beside K_i
// (a stage is two chunks) and Q is read again a key tile.
//
// Above W_MAX (D > 512; only the card test at 1152 runs such heads) the
// grid's y axis runs over (head, slice): ceil(NC / 4) slices of O's
// columns, CPS = ceil(NC / slices) chunks each (a chunk past D
// zero-filled and not stored), and each slice forms S itself: D / W times
// in all. Slice 0 stores the lse.

constexpr int FWW_WMAX = 4;                // chunks of O a block: W_MAX 512
constexpr int FWW_THREADS = 256;           // two warpgroups
constexpr int FWW_AHEAD = 3;               // ring steps copied ahead
// the stages: the step computing, the one before (its products may still
// run) and the FWW_AHEAD in flight
constexpr int FWW_SLOTS = FWW_AHEAD + 2;
// (m, l) of up to 128 rows; 64 rows' rescale factors (MQ = 1); the
// combine's weights of every rank
constexpr int FWW_STAT_BYTES = 128 * 8 + 64 * 4 + WGW_MAX_CLUSTER * 128 * 4;
// a rank's fixed work in key tiles (its Q and the combine) in fww_plan
constexpr double FWW_RANK_COST = 6.0;

// query tiles a block at CPS chunks of O
__host__ __device__ constexpr int fww_mq(int cps) { return cps <= 2 ? 2 : 1; }

// shared memory of an instance (CPS chunks of O) with Q held (qres) or
// streamed: Q, the ring and P, aliased by the f32 O of the exchange, then
// the statistics; 1024 bytes to align the swizzle atoms
__host__ __device__ constexpr int fww_main(int cps, bool qres) {
  return (qres ? (fww_mq(cps) * cps + FWW_SLOTS) * WGW_CHUNK
               : FWW_SLOTS * 2 * WGW_CHUNK) +
         (fww_mq(cps) == 1 ? TILE_BYTES : 0);
}
__host__ __device__ constexpr int fww_region(int cps, bool qres) {
  return fww_main(cps, qres) > 64 * fww_mq(cps) * WCH * cps * 4
             ? fww_main(cps, qres)
             : 64 * fww_mq(cps) * WCH * cps * 4;
}
__host__ __device__ constexpr int fww_smem(int cps, bool qres) {
  return 1024 + fww_region(cps, qres) + FWW_STAT_BYTES;
}

// the block's threads (named barrier 1: the two warpgroups reach it from
// their own code)
__device__ __forceinline__ void fww_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(FWW_THREADS) : "memory");
}

__device__ __forceinline__ void st_shared32(uint32_t a, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(a), "r"(v) : "memory");
}

// a float2 of rank r's shared memory at a (this block's plainly where r ==
// c), behind `after`
__device__ __forceinline__ float2 ld_rank2(uint32_t a, int r, int c,
                                           uint32_t after) {
  float2 v;
  if (r == c)
    asm("ld.shared.v2.f32 {%0, %1}, [%2];\n"
        : "=f"(v.x), "=f"(v.y)
        : "r"(a), "r"(after));
  else
    asm("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
        : "=f"(v.x), "=f"(v.y)
        : "r"(mapa(a, r)), "r"(after));
  return v;
}

// d += A B, m64n128k16, A from registers (4 x bf16x2), B MN-major in shared
// memory two atoms wide (desc_mn2)
__device__ __forceinline__ void wgmma_rs128(float (&d)[64], uint32_t a0,
                                            uint32_t a1, uint32_t a2,
                                            uint32_t a3, uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " XT_D64
      ", {%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
      : XT_ACC64(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db));
}

// The online softmax over one key tile's scores s (m64n64 accumulators:
// rows g, g + 8; the columns from k0 at or past Tk masked to -inf first),
// as flash_fwd_kernel's: the running maxima m, this thread's part of the
// row sums l, the rows' rescale factors a0, a1; s leaves as P,
// unnormalised.
__device__ __forceinline__ void fww_softmax(float (&s)[32], float& m0,
                                            float& m1, float& l0, float& l1,
                                            float& a0, float& a1, int k0,
                                            int Tk, float scale_log2) {
  const int cq = (threadIdx.x & 3) * 2;
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
  a0 = exp2f((m0 - mx0) * scale_log2);
  a1 = exp2f((m1 - mx1) * scale_log2);
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
  l0 = l0 * a0 + rs0;
  l1 = l1 * a1 + rs1;
}

// What a block of a wide forward (flash_fwd_wgmma_wide, T = bf16;
// flash_fwd_f32_wide, T = float) works on.
template <typename T>
struct FwwArgs {
  const T* qb;     // q, k, v at the block's (batch row, head)
  const T* kb;
  const T* vb;
  T* ob;           // o there
  float* lse_row;  // the (b, h) row of the lse where this block stores it
  long long sqt, skt, svt, sot;
  int Tq, Tk, D, q0, col0, t0, t1, R, rank;
  bool qres;           // Q held whole
  uint32_t base;       // the region (Q, ring, P; the exchange)
  uint32_t sstat;      // the statistics (shared address) ...
  unsigned char* stat; // ... and generic
  float scale_log2;
};

// A wide forward block's arguments at grid (R x query blocks of `rows`,
// H x slices of up to `wmax` chunks, B); block x's query block x / R, rank
// x % R; the region at shared address base (generic smem + off), `region`
// bytes, the statistics after it.
template <typename T>
__device__ __forceinline__ FwwArgs<T> fww_args(
    const T* q, const T* k, const T* v, T* o, float* lse, int Tq, int Tk,
    int D, int R, long long sqb, long long sqt, long long sqh, long long skb,
    long long skt, long long skh, long long svb, long long svt,
    long long svh, long long sob, long long sot, long long soh,
    float scale_log2, int rows, int cps, int wmax, unsigned char* smem,
    uint32_t base, uint32_t off, int region) {
  const int nsl = (D / WCH + wmax - 1) / wmax;
  const int h = blockIdx.y / nsl, sl = blockIdx.y % nsl, b = blockIdx.z;
  const int H = gridDim.y / nsl, T_ = (Tk + BK - 1) / BK;
  FwwArgs<T> a;
  a.rank = blockIdx.x % R;
  a.R = R;
  a.q0 = blockIdx.x / R * rows;
  a.qb = q + b * sqb + h * sqh;
  a.kb = k + b * skb + h * skh;
  a.vb = v + b * svb + h * svh;
  a.ob = o + b * sob + h * soh;
  a.lse_row = lse != nullptr && sl == 0
                  ? lse + ((long long)b * H + h) * Tq
                  : nullptr;
  a.sqt = sqt;
  a.skt = skt;
  a.svt = svt;
  a.sot = sot;
  a.Tq = Tq;
  a.Tk = Tk;
  a.D = D;
  a.col0 = sl * WCH * cps;
  a.t0 = (int)((long long)T_ * a.rank / R);
  a.t1 = (int)((long long)T_ * (a.rank + 1) / R);
  a.qres = nsl == 1;
  a.base = base;
  a.sstat = base + region;
  a.stat = smem + off + region;
  a.scale_log2 = scale_log2;
  return a;
}

__device__ __forceinline__ void store4(bf16* p, const float4& o) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(pack_bf16(o.x, o.y), pack_bf16(o.z, o.w));
}
__device__ __forceinline__ void store4(float* p, const float4& o) {
  *reinterpret_cast<float4*>(p) = o;
}

// The ranks' combine, once each rank has written its unnormalised f32 O
// (RB rows x W, row r's float column x at r W + (x ^ 8 (r % 4))) at shared
// address sex and its rows' (m scale log2 e, l) into the statistics: after
// a cluster barrier every rank reads all ranks' (m, l), weighs each rank's
// O by 2^(m_r - m) / l in rank order 0..R-1 and stores its own 1 / R of
// O's rows x columns; rank 0 stores the lse.
template <int RB, int W, typename T>
__device__ __forceinline__ void fww_combine(const FwwArgs<T>& a,
                                            uint32_t sex) {
  constexpr int NT = FWW_THREADS;
  constexpr float LN2 = 0.6931471805599453f;
  float* const wts = reinterpret_cast<float*>(a.stat + 128 * 8 + 64 * 4);
  const uint32_t after = cluster_sync();
  // every rank's weight of each row, in rank order: 2^(m_r - m) / l with m
  // the rows' largest m_r and l = sum of 2^(m_r - m) l_r (0 for a rank
  // without a key tile); rank 0 stores the lse
  if ((int)threadIdx.x < RB) {
    const int row = threadIdx.x;
    float mr[WGW_MAX_CLUSTER], lr[WGW_MAX_CLUSTER];
    float M = -INFINITY;
#pragma unroll
    for (int rk = 0; rk < WGW_MAX_CLUSTER; ++rk) {
      if (rk >= a.R) break;
      const float2 x = ld_rank2(a.sstat + row * 8, rk, a.rank, after);
      mr[rk] = x.x;
      lr[rk] = x.y;
      M = fmaxf(M, x.x);
    }
    float L = 0.f;
#pragma unroll
    for (int rk = 0; rk < WGW_MAX_CLUSTER; ++rk) {
      if (rk >= a.R) break;
      mr[rk] = exp2f(mr[rk] - M);
      L += mr[rk] * lr[rk];
    }
#pragma unroll
    for (int rk = 0; rk < WGW_MAX_CLUSTER; ++rk) {
      if (rk >= a.R) break;
      wts[rk * RB + row] = mr[rk] / L;
    }
    if (a.rank == 0 && a.lse_row != nullptr && a.q0 + row < a.Tq)
      a.lse_row[a.q0 + row] = (M + log2f(L)) * LN2;
  }
  fww_sync();
  // this rank's share of O's RB W / 4 float4 (row-major: row u / (W / 4),
  // columns 4 (u % (W / 4)) ..), summed over the ranks in rank order, UB
  // units a thread at once: their loads of a rank in flight together
  constexpr int UB = 4;
  const int lo = RB * W / 4 * a.rank / a.R;
  const int hi = RB * W / 4 * (a.rank + 1) / a.R;
  for (int u0 = lo + threadIdx.x; u0 < hi; u0 += UB * NT) {
    int row[UB], col[UB];
    uint32_t at[UB];
    float4 o[UB];
#pragma unroll
    for (int e = 0; e < UB; ++e) {
      const int u = u0 + e * NT < hi ? u0 + e * NT : u0;
      row[e] = u / (W / 4);
      col[e] = 4 * (u % (W / 4));
      at[e] = sex + (row[e] * W + (col[e] ^ ((row[e] & 3) << 3))) * 4;
      o[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int rk = 0; rk < WGW_MAX_CLUSTER; ++rk) {
      if (rk >= a.R) break;
      float4 x[UB];
#pragma unroll
      for (int e = 0; e < UB; ++e) x[e] = ld_rank4(at[e], rk, a.rank, after);
#pragma unroll
      for (int e = 0; e < UB; ++e) {
        const float w = wts[rk * RB + row[e]];
        o[e].x += x[e].x * w;
        o[e].y += x[e].y * w;
        o[e].z += x[e].z * w;
        o[e].w += x[e].w * w;
      }
    }
#pragma unroll
    for (int e = 0; e < UB; ++e)
      if (u0 + e * NT < hi && a.q0 + row[e] < a.Tq && a.col0 + col[e] < a.D)
        store4(a.ob + (long long)(a.q0 + row[e]) * a.sot + a.col0 + col[e],
               o[e]);
  }
  cluster_sync();  // no rank leaves while another reads its exchange
}

// Warpgroup ROLE of a block: with MQ = 2 each warpgroup (ROLE 0) forms S,
// the softmax and P of its own query tile (rows 64 wg of the block's) and
// takes its O; with MQ = 1 warpgroup 0 forms S, the softmax and P and
// takes its atoms of O, warpgroup 1 (ROLE 1) its atoms.
template <int CPS, int MQ, int ROLE>
__device__ __forceinline__ void fww_body(const FwwArgs<bf16>& a) {
  constexpr int NT = FWW_THREADS;
  constexpr int ACC = MQ == 2 ? 64 : 32;  // accumulators of a chunk
  constexpr int W = WCH * CPS;
  constexpr int RB = 64 * MQ;             // query rows a block
  constexpr float LN2 = 0.6931471805599453f;
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
  const int rw = MQ == 2 ? 64 * wg : 0;   // this warpgroup's first row
  const int r0 = rw + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  const int cq = (lane & 3) * 2;
  const int cw = MQ == 2 ? 0 : 64 * ROLE; // its first column of a chunk
  const int ncd = a.D / WCH, per = ncd + CPS;
  const int nsteps = (a.t1 - a.t0) * per;
  const uint32_t sb = a.qres ? WGW_CHUNK : 2 * WGW_CHUNK;
  const uint32_t sQ = a.base;
  const uint32_t ring = a.base + (a.qres ? MQ * ncd * WGW_CHUNK : 0);
  const uint32_t sP = ring + FWW_SLOTS * sb;  // MQ = 1
  float2* const stat = reinterpret_cast<float2*>(a.stat);
  float* const alpha = reinterpret_cast<float*>(a.stat + 128 * 8);
  auto stage = [&](int n) { return ring + (uint32_t)(n % FWW_SLOTS) * sb; };
  // step n's copies: K_i (and Q_i where Q is not held: MQ = 1) or V_c
  auto load = [&](int n) {
    const int tile = a.t0 + n / per, i = n % per;
    const uint32_t st = stage(n);
    if (i < ncd) {
      if (!a.qres)
        load_chunk<NT>(st + WGW_CHUNK, a.qb + i * WCH, a.sqt, a.q0, a.Tq);
      load_chunk<NT>(st, a.kb + i * WCH, a.skt, tile * BK, a.Tk);
    } else {
      const int col = a.col0 + (i - ncd) * WCH;
      const bool in = col < a.D;
      load_chunk<NT>(st, in ? a.vb + col : a.vb, a.svt, tile * BK,
                     in ? a.Tk : 0);
    }
  };
  // the top of step n: this thread's products of step n - 2 (drain: of
  // every step) done, step n's copies landed for every thread, step n +
  // FWW_AHEAD's issued into step n - 2's stage
  auto begin = [&](int n, bool drain) {
    if (drain)
      wgmma_wait<0>();
    else
      wgmma_wait<1>();
    cp_async_wait<FWW_AHEAD - 1>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    fww_sync();
    if (n + FWW_AHEAD < nsteps) load(n + FWW_AHEAD);
    cp_async_commit();
  };

  if (a.qres && nsteps > 0)
    for (int i = 0; i < MQ * ncd; ++i)
      load_chunk<NT>(sQ + i * WGW_CHUNK, a.qb + (i % ncd) * WCH, a.sqt,
                     a.q0 + 64 * (i / ncd), a.Tq);
#pragma unroll
  for (int n = 0; n < FWW_AHEAD; ++n) {
    if (n < nsteps) load(n);
    cp_async_commit();
  }
  const uint32_t myQ = sQ + (rw / 64) * ncd * WGW_CHUNK;

  float acc[CPS][ACC];
#pragma unroll
  for (int c = 0; c < CPS; ++c)
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[c][i] = 0.f;
  float s[32];
  uint32_t p[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) p[i] = 0u;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows r0, r0 + 8
  float l0 = 0.f, l1 = 0.f;              // this thread's part of the sums

  int n = 0;
  for (int tile = a.t0; tile < a.t1; ++tile) {
    // ---- S = sum over the chunks of Q_i K_i^T ----
    for (int i = 0; i < ncd; ++i, ++n) {
      begin(n, ROLE == 1);
      if constexpr (ROLE == 0) {
        const uint32_t st = stage(n);
        wgw_partial(s, a.qres ? myQ + i * WGW_CHUNK : st + WGW_CHUNK, st,
                    i == 0);
      }
    }
    // ---- softmax; P in registers (MQ = 2) or shared memory ----
    if constexpr (ROLE == 0) {
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(p);
      float al0, al1;
      fww_softmax(s, m0, m1, l0, l1, al0, al1, tile * BK, a.Tk,
                  a.scale_log2);
#pragma unroll
      for (int c = 0; c < CPS; ++c)
#pragma unroll
        for (int j = 0; j < ACC / 4; ++j) {
          acc[c][4 * j] *= al0;
          acc[c][4 * j + 1] *= al0;
          acc[c][4 * j + 2] *= al1;
          acc[c][4 * j + 3] *= al1;
        }
      if constexpr (MQ == 2) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          p[2 * j] = pack_bf16(s[4 * j], s[4 * j + 1]);
          p[2 * j + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
        }
      } else {
        // P (64 x 64 bf16, wgmma's K-major swizzled tile): row r's 16-byte
        // chunk j at r * 128 + ((j ^ (r % 8)) << 4)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint32_t at =
              sP + r0 * 128 + ((j ^ (r0 & 7)) << 4) + 2 * cq;
          st_shared32(at, pack_bf16(s[4 * j], s[4 * j + 1]));
          st_shared32(at + 8 * 128, pack_bf16(s[4 * j + 2], s[4 * j + 3]));
        }
        if (cq == 0) {
          alpha[r0] = al0;
          alpha[r0 + 8] = al1;
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      }
    }
    // ---- O_c += P V_c (warpgroup 1 rescales O first, its products of
    // the last tile drained) ----
#pragma unroll
    for (int c = 0; c < CPS; ++c, ++n) {
      begin(n, ROLE == 1 && c == 0);
      const uint32_t st = stage(n);
      if constexpr (ROLE == 1) {
        if (c == 0) {
          const float al0 = alpha[r0], al1 = alpha[r0 + 8];
#pragma unroll
          for (int cc = 0; cc < CPS; ++cc)
#pragma unroll
            for (int j = 0; j < ACC / 4; ++j) {
              acc[cc][4 * j] *= al0;
              acc[cc][4 * j + 1] *= al0;
              acc[cc][4 * j + 2] *= al1;
              acc[cc][4 * j + 3] *= al1;
            }
        }
      }
      fence_regs(acc[c]);
      wgmma_fence();
      if constexpr (MQ == 2) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs128(acc[c], p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                      p[4 * kk + 3], desc_mn2(st + 2048 * kk));
      } else {
        wgw_product(acc[c], sP, st + ROLE * TILE_BYTES);
      }
      wgmma_commit();
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int c = 0; c < CPS; ++c) fence_regs(acc[c]);
  fence_regs(p);
  cp_async_wait<0>();

  // ---- the rows' (m scale log2 e, l), of the warpgroups that form S ----
  if constexpr (ROLE == 0) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    if (cq == 0) {
      stat[r0] = make_float2(m0 * a.scale_log2, l0);
      stat[r0 + 8] = make_float2(m1 * a.scale_log2, l1);
    }
  }
  fww_sync();  // ... stored; Q, the ring and P read by every thread

  if (a.R == 1) {  // ---- O normalised and stored from the registers ----
    const float2 x0 = stat[r0], x1 = stat[r0 + 8];
    const float inv0 = 1.f / x0.y, inv1 = 1.f / x1.y;
    if (ROLE == 0 && a.lse_row != nullptr && cq == 0) {
      if (a.q0 + r0 < a.Tq)
        a.lse_row[a.q0 + r0] = (x0.x + log2f(x0.y)) * LN2;
      if (a.q0 + r0 + 8 < a.Tq)
        a.lse_row[a.q0 + r0 + 8] = (x1.x + log2f(x1.y)) * LN2;
    }
#pragma unroll
    for (int c = 0; c < CPS; ++c) {
#pragma unroll
      for (int j = 0; j < ACC / 4; ++j) {
        acc[c][4 * j] *= inv0;
        acc[c][4 * j + 1] *= inv0;
        acc[c][4 * j + 2] *= inv1;
        acc[c][4 * j + 3] *= inv1;
      }
      const int col = a.col0 + c * WCH + cw;
      if (col < a.D)
        store_wg_rows<ACC>(a.ob + col, a.sot, a.q0 + rw, a.Tq, acc[c]);
    }
    return;
  }

  // ---- the combine: O unnormalised into the exchange (row r's float
  // column x at r W + (x ^ 8 (r % 4)): a warp's float2 stores take two
  // wavefronts), every rank's published ----
  float* const ex =
      reinterpret_cast<float*>(a.stat - fww_region(CPS, a.qres));
#pragma unroll
  for (int c = 0; c < CPS; ++c)
#pragma unroll
    for (int j = 0; j < ACC / 4; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + 8 * half, col = c * WCH + cw + 8 * j + cq;
        *reinterpret_cast<float2*>(ex + r * W + (col ^ ((r & 3) << 3))) =
            make_float2(acc[c][4 * j + 2 * half],
                        acc[c][4 * j + 2 * half + 1]);
      }
  fww_combine<RB, W>(a, a.sstat - fww_region(CPS, a.qres));
}

// Grid (R x query blocks of 64 MQ rows, H x slices, B), clusters of R
// along x: block x's query block x / R, rank x % R.
template <int CPS, int MQ>
__global__ void __launch_bounds__(FWW_THREADS, 1)
flash_fwd_wgmma_wide(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int Tq, int Tk, int D, int R,
                     long long sqb, long long sqt, long long sqh,
                     long long skb, long long skt, long long skh,
                     long long svb, long long svt, long long svh,
                     long long sob, long long sot, long long soh,
                     float scale_log2) {
  extern __shared__ unsigned char smem[];
  const uint32_t raw = smem_u32(smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const FwwArgs<bf16> a = fww_args(
      q, k, v, o, lse, Tq, Tk, D, R, sqb, sqt, sqh, skb, skt, skh, svb, svt,
      svh, sob, sot, soh, scale_log2, 64 * MQ, CPS, FWW_WMAX, smem, base,
      base - raw, fww_region(CPS, (D / WCH + FWW_WMAX - 1) / FWW_WMAX == 1));
  if constexpr (MQ == 2)
    fww_body<CPS, 2, 0>(a);
  else if (threadIdx.x < 128)
    fww_body<CPS, 1, 0>(a);
  else
    fww_body<CPS, 1, 1>(a);
}

// ---------------------------------------------------------------------------
// The f32 forward at head width D = 128 NC for every NC >= 1 (128 and each
// multiple above): flash_fwd_f32_wide<CPS, MQ>, under the forward's
// contract. It replaces a block a 128-column chunk of O that formed each
// score tile again ((NC + 1) / 2 times the forward's products, 88 local
// bytes a thread) and, at 128, the tile family's <float, 128> forward (one
// warpgroup, O in registers: 128 local bytes a thread).
//
// flash_fwd_wgmma_wide's structure: a block of two warpgroups owns MQ
// 64-query tiles and W = 128 CPS columns of their output, the whole width
// up to W_MAX = 384, so each score tile is formed once for all of O; the
// keys split over a cluster of R <= 8 ranks (fww_plan with this kernel's
// rank cost), combined once through distributed shared memory in rank
// order (fww_combine; a rank without a key tile weighs 0; rank 0 stores
// the lse); above W_MAX slices of O's columns, each forming S itself, Q
// streamed beside K. The arithmetic is the f32 pair's: every product in
// 3xTF32 on mma.sync m16n8k8 (TC<float, 128>; each warp splits its B
// fragments), long sums in partials of four k-steps joined by IEEE adds
// (S over the chunks as mma_nt_chunk, O += P V as fw_product), one block
// an SM. Steps: K and V run through a ring of FWF_SLOTS 64 x 128 f32
// chunks (rows FW_LD floats apart), FWF_AHEAD steps copied ahead by
// cp.async, one block barrier a step; mma.sync ends within its step, so
// the stage refilled at step n is step n - 1's. A key tile is D / 128
// S-steps (K_i), the softmax, then CPS V-steps (V_c).
// - W = 128 (CPS 1, MQ 2): each warpgroup a query tile of its own, as the
//   tile family's forward: a warp 16 rows, S over the tile's 64 keys (32
//   accumulators), O over 128 columns (64). Both read the one ring, so a
//   K / V copy serves two query tiles.
// - W = 256, 384 (CPS 2-3, MQ 1): O over W does not fit one warpgroup's
//   registers, so the two split one query tile: warp w of warpgroup g
//   forms S of rows 16 w.. over keys 32 g.. (16 accumulators), the two
//   warps of rows 16 w.. trade their rows' maxima through shared memory
//   (a named barrier of the pair), and each takes columns 64 g.. of every
//   chunk of O (32 accumulators a chunk). Both hold the same maxima, so
//   each rescales its own O; each keeps the row sums of its keys, added
//   once at the end.
// P, the A operand of O += P V, goes through shared memory, a float4 of
// an accumulator block a lane, published by the V-step's block barrier:
// MQ = 1 needs the pair's halves, and at MQ = 2, P held in registers
// across its fully unrolled product took ptxas to 255 registers and 60
// bytes of spill on an H100 (PERF.md). O += P V runs in 64-column passes
// of eight n-blocks, a k-loop not unrolled.

constexpr int FWF_WMAX = 3;            // chunks of O a block: W_MAX 384
constexpr int FWF_AHEAD = 2;           // ring steps copied ahead
constexpr int FWF_SLOTS = FWF_AHEAD + 1;
constexpr int FWF_CHUNK = FW_TILE * 4;  // bytes of a 64 x 128 f32 chunk
// P of each 16 query rows (8 k-steps x 32 lanes x float4) and, MQ = 1,
// both warpgroups' row maxima of their keys
constexpr int FWF_PBYTES = 8 * 32 * 16;
constexpr int FWF_MBYTES = 2 * 64 * 4;
// a rank's fixed work in key tiles (its Q and the combine) in fww_plan: an
// f32 key tile's products take ~5 times a bf16 one's (PERF.md)
constexpr double FWF_RANK_COST = 1.5;

// query tiles a block at CPS chunks of O
__host__ __device__ constexpr int fwf_mq(int cps) { return cps == 1 ? 2 : 1; }

// shared memory of an instance with Q held (qres) or streamed: Q, the ring,
// P and the maxima, aliased by the f32 O of the exchange, then the
// statistics
__host__ __device__ constexpr int fwf_main(int cps, bool qres) {
  return (qres ? fwf_mq(cps) * cps + FWF_SLOTS : 2 * FWF_SLOTS) * FWF_CHUNK +
         4 * fwf_mq(cps) * FWF_PBYTES + (fwf_mq(cps) == 1 ? FWF_MBYTES : 0);
}
__host__ __device__ constexpr int fwf_region(int cps, bool qres) {
  return fwf_main(cps, qres) > 64 * fwf_mq(cps) * WCH * cps * 4
             ? fwf_main(cps, qres)
             : 64 * fwf_mq(cps) * WCH * cps * 4;
}
__host__ __device__ constexpr int fwf_smem(int cps, bool qres) {
  return fwf_region(cps, qres) + FWW_STAT_BYTES;
}
// the instance's largest shared memory over the cases that occur (CPS 1
// only at D = 128, with Q held)
__host__ __device__ constexpr int fwf_most(int cps) {
  return cps == 1 ? fwf_smem(1, true)
         : fwf_smem(cps, true) > fwf_smem(cps, false) ? fwf_smem(cps, true)
                                                      : fwf_smem(cps, false);
}
static_assert(fwf_most(1) <= 232448 && fwf_most(2) <= 232448 &&
                  fwf_most(3) <= 232448,
              "227 KB of shared memory a block");

// the two warps of rows 16 w.. of a query tile, one of each warpgroup
// (named barrier 2 + w)
__device__ __forceinline__ void pair_sync(int w) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(2 + w) : "memory");
}

// acc (+)= A B^T over chunk i of the head width (16 k-steps): A the warp's
// 16 rows `rows` of a tile, B(k, n) = b_tile[8 j + n][k], j < N; acc takes
// the product at i = 0, a later chunk's formed in a zeroed partial and
// joined by IEEE adds (mma_nt_chunk's rule)
template <int N>
__device__ __forceinline__ void fwf_scores(float (&acc)[N][4],
                                           const float* rows,
                                           const float* b_tile, int i) {
  using C = TC<float, WCH>;
  float t[N][4];
  zero(t);
#pragma unroll 2
  for (int kk = 0; kk < WCH / C::KS; ++kk) {
    const C::A a = C::a_tile(rows, kk * C::KS);
#pragma unroll
    for (int j = 0; j < N; ++j)
      C::mma(t[j], a, C::b_nt(b_tile, 8 * j, kk * C::KS));
  }
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      acc[j][c] = i == 0 ? t[j][c] : acc[j][c] + t[j][c];
}

// acc[j] += P B over the 64 keys of P, B(k, n) = b_tile[k][8 j + n], J0 <=
// j < J1: k-step kk's A operand the float4 pw[32 kk + lane] of shared
// memory, an accumulator block as a_acc takes it; partials of PARTIAL
// k-steps joined by IEEE adds (fw_product's order)
template <int J0, int J1>
__device__ __forceinline__ void fwf_pv(float (&acc)[8][4], const float4* pw,
                                       const float* b_tile) {
  using C = TC<float, WCH>;
  const int lane = threadIdx.x & 31;
#pragma unroll 1
  for (int k0 = 0; k0 < 64 / C::KS; k0 += C::PARTIAL) {
    float t[J1 - J0][4];
    zero(t);
#pragma unroll
    for (int g = 0; g < C::PARTIAL; ++g) {
      const float4 x = pw[32 * (k0 + g) + lane];
      const uint32_t r[4] = {__float_as_uint(x.x), __float_as_uint(x.z),
                             __float_as_uint(x.y), __float_as_uint(x.w)};
      const C::A a = C::a_split(r);
#pragma unroll
      for (int j = J0; j < J1; ++j)
        C::mma(t[j - J0], a, C::b_nn(b_tile, (k0 + g) * C::KS, 8 * j));
    }
#pragma unroll
    for (int j = J0; j < J1; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] += t[j - J0][i];
  }
}

template <int CPS, int MQ>
__device__ __forceinline__ void fwf_body(const FwwArgs<float>& a,
                                         float* region) {
  constexpr int NT = FWW_THREADS;
  constexpr int W = WCH * CPS;
  constexpr int RB = 64 * MQ;             // query rows a block
  constexpr int NS = MQ == 2 ? 8 : 4;     // S's n-blocks a warp: 64 / 32 keys
  constexpr int NP = CPS * MQ;            // O's 64-column passes a warp
  constexpr float LN2 = 0.6931471805599453f;
  const int wg = threadIdx.x >> 7, w = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, cq = (lane & 3) * 2;
  const int rw = MQ == 2 ? 64 * wg : 0;   // this warpgroup's first row
  const int r0 = rw + 16 * w + (lane >> 2);
  const int kw = MQ == 2 ? 0 : 32 * wg;   // its first key of a tile
  const int cw = MQ == 2 ? 0 : 64 * wg;   // its first column of a chunk
  const int ncd = MQ == 2 ? 1 : a.D / WCH, per = ncd + CPS;
  const int nsteps = (a.t1 - a.t0) * per;
  const int sb = a.qres ? FW_TILE : 2 * FW_TILE;  // floats a stage
  float* const sQ = region;
  float* const ring = region + (a.qres ? MQ * ncd * FW_TILE : 0);
  float4* const sP = reinterpret_cast<float4*>(ring + FWF_SLOTS * sb);
  float* const sM = reinterpret_cast<float*>(sP + 4 * MQ * 8 * 32);
  // P of this warp's 16 rows: k-step kk's float4 of lane x at pw[32 kk + x]
  float4* const pw = sP + 8 * 32 * (r0 >> 4);
  float2* const stat = reinterpret_cast<float2*>(a.stat);
  float* const lpart = reinterpret_cast<float*>(a.stat + 128 * 8);
  auto stage = [&](int n) { return ring + (n % FWF_SLOTS) * sb; };
  // step n's copies: K_i (and Q_i where Q is not held) or V_c
  auto load = [&](int n) {
    const int tile = a.t0 + n / per, i = n % per;
    float* const st = stage(n);
    if (i < ncd) {
      if (!a.qres)
        fw_stage<NT, 32>(st + FW_TILE, a.qb + i * WCH, a.sqt, a.q0, a.Tq, 0,
                         threadIdx.x);
      fw_stage<NT, 32>(st, a.kb + i * WCH, a.skt, tile * BK, a.Tk, 0,
                       threadIdx.x);
    } else {
      const int col = a.col0 + (i - ncd) * WCH;
      const bool in = col < a.D;
      fw_stage<NT, 32>(st, in ? a.vb + col : a.vb, a.svt, tile * BK,
                       in ? a.Tk : 0, 0, threadIdx.x);
    }
  };
  // the top of step n: its copies landed for every thread, every thread
  // done with step n - 1, step n + FWF_AHEAD's copies issued into its stage
  auto begin = [&](int n) {
    cp_async_wait<FWF_AHEAD - 1>();
    fww_sync();
    if (n + FWF_AHEAD < nsteps) load(n + FWF_AHEAD);
    cp_async_commit();
  };
  // O's pass p: columns 128 (p / MQ) + cw + 64 (p % MQ) .. of the block's
  auto pass_col = [&](int p) { return WCH * (p / MQ) + cw + 64 * (p % MQ); };

  if (a.qres && nsteps > 0)
    for (int i = 0; i < MQ * ncd; ++i)
      fw_stage<NT, 32>(sQ + i * FW_TILE, a.qb + (i % ncd) * WCH, a.sqt,
                       a.q0 + 64 * (i / ncd), a.Tq, 0, threadIdx.x);
#pragma unroll
  for (int n = 0; n < FWF_AHEAD; ++n) {
    if (n < nsteps) load(n);
    cp_async_commit();
  }
  const float* const myQ = sQ + (rw / 64) * ncd * FW_TILE + 16 * w * FW_LD;

  float acc[NP][8][4];
#pragma unroll
  for (int p = 0; p < NP; ++p) zero(acc[p]);
  float s[NS][4];
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows r0, r0 + 8
  float l0 = 0.f, l1 = 0.f;              // this thread's part of the sums

  int n = 0;
  for (int tile = a.t0; tile < a.t1; ++tile) {
    // ---- S = sum over the chunks of Q_i K_i^T (MQ = 1: this warpgroup's
    // 32 keys) ----
    for (int i = 0; i < ncd; ++i, ++n) {
      begin(n);
      const float* const st = stage(n);
      fwf_scores(s, a.qres ? myQ + i * FW_TILE : st + FW_TILE + 16 * w * FW_LD,
                 st + kw * FW_LD, i);
    }
    // ---- the online softmax (MQ = 1: the pair's row maxima traded); P
    // into shared memory ----
    const int k0 = tile * BK;
    if (k0 + BK > a.Tk) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (k0 + kw + 8 * j + cq + c >= a.Tk)
            s[j][c] = s[j][2 + c] = -INFINITY;
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int sh = 1; sh <= 2; sh <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, sh));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, sh));
    }
    if constexpr (MQ == 1) {
      if (cq == 0) {
        sM[64 * wg + r0] = mx0;
        sM[64 * wg + r0 + 8] = mx1;
      }
      pair_sync(w);
      mx0 = fmaxf(mx0, sM[64 * (wg ^ 1) + r0]);
      mx1 = fmaxf(mx1, sM[64 * (wg ^ 1) + r0 + 8]);
    }
    // the tile holds a valid key, so mx0 / mx1 are finite
    const float al0 = exp2f((m0 - mx0) * a.scale_log2);
    const float al1 = exp2f((m1 - mx1) * a.scale_log2);
    m0 = mx0;
    m1 = mx1;
    const float mb0 = mx0 * a.scale_log2, mb1 = mx1 * a.scale_log2;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      s[j][0] = exp2f(fmaf(s[j][0], a.scale_log2, -mb0));
      s[j][1] = exp2f(fmaf(s[j][1], a.scale_log2, -mb0));
      s[j][2] = exp2f(fmaf(s[j][2], a.scale_log2, -mb1));
      s[j][3] = exp2f(fmaf(s[j][3], a.scale_log2, -mb1));
      rs0 += s[j][0] + s[j][1];
      rs1 += s[j][2] + s[j][3];
      pw[32 * (kw / 8 + j) + lane] =
          make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
    }
    l0 = l0 * al0 + rs0;
    l1 = l1 * al1 + rs1;
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[p][j][0] *= al0;
        acc[p][j][1] *= al0;
        acc[p][j][2] *= al1;
        acc[p][j][3] *= al1;
      }
    // ---- O_c += P V_c, P published by the step's barrier ----
#pragma unroll
    for (int c = 0; c < CPS; ++c, ++n) {
      begin(n);
      const float* const vt = stage(n);
#pragma unroll
      for (int h = 0; h < MQ; ++h) {
        const float* const b = vt + pass_col(c * MQ + h) - WCH * c;
        if constexpr (CPS == 3) {  // 32-column partials: with 64, ptxas
          fwf_pv<0, 4>(acc[c], pw, b);  // spilled 8 bytes at 255 registers
          fwf_pv<4, 8>(acc[c], pw, b);
        } else {
          fwf_pv<0, 8>(acc[c * MQ + h], pw, b);
        }
      }
    }
  }
  cp_async_wait<0>();

  // ---- the rows' (m scale log2 e, l); MQ = 1: warpgroup 1's sums over
  // its keys added to warpgroup 0's ----
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  if constexpr (MQ == 1) {
    if (wg == 1 && cq == 0) {
      lpart[r0] = l0;
      lpart[r0 + 8] = l1;
    }
    fww_sync();
  }
  if ((MQ == 2 || wg == 0) && cq == 0) {
    stat[r0] = make_float2(m0 * a.scale_log2, MQ == 2 ? l0 : l0 + lpart[r0]);
    stat[r0 + 8] =
        make_float2(m1 * a.scale_log2, MQ == 2 ? l1 : l1 + lpart[r0 + 8]);
  }
  fww_sync();  // ... stored; Q, the ring and P read by every thread

  if (a.R == 1) {  // ---- O normalised and stored from the registers ----
    const float2 x0 = stat[r0], x1 = stat[r0 + 8];
    const float inv0 = 1.f / x0.y, inv1 = 1.f / x1.y;
    if ((MQ == 2 || wg == 0) && a.lse_row != nullptr && cq == 0) {
      if (a.q0 + r0 < a.Tq)
        a.lse_row[a.q0 + r0] = (x0.x + log2f(x0.y)) * LN2;
      if (a.q0 + r0 + 8 < a.Tq)
        a.lse_row[a.q0 + r0 + 8] = (x1.x + log2f(x1.y)) * LN2;
    }
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int col = a.col0 + pass_col(p);
      if (col >= a.D) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = a.q0 + r0 + 8 * half;
        const float inv = half ? inv1 : inv0;
        if (r >= a.Tq) continue;
        float* const o = a.ob + (long long)r * a.sot + col + cq;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          store_pair(o + 8 * j, acc[p][j][2 * half] * inv,
                     acc[p][j][2 * half + 1] * inv);
      }
    }
    return;
  }

  // ---- the combine: O unnormalised into the exchange (fww_combine's
  // layout) over Q, the ring and P ----
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + 8 * half, col = pass_col(p) + 8 * j + cq;
        *reinterpret_cast<float2*>(region + r * W + (col ^ ((r & 3) << 3))) =
            make_float2(acc[p][j][2 * half], acc[p][j][2 * half + 1]);
      }
  fww_combine<RB, W>(a, a.base);
}

// Grid (R x query blocks of 64 MQ rows, H x slices, B), clusters of R
// along x, as flash_fwd_wgmma_wide's.
template <int CPS, int MQ>
__global__ void __launch_bounds__(FWW_THREADS, 1)
flash_fwd_f32_wide(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o,
                   float* __restrict__ lse, int Tq, int Tk, int D, int R,
                   long long sqb, long long sqt, long long sqh,
                   long long skb, long long skt, long long skh,
                   long long svb, long long svt, long long svh,
                   long long sob, long long sot, long long soh,
                   float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_t[];
  const FwwArgs<float> a = fww_args(
      q, k, v, o, lse, Tq, Tk, D, R, sqb, sqt, sqh, skb, skt, skh, svb, svt,
      svh, sob, sot, soh, scale_log2, 64 * MQ, CPS, FWF_WMAX, smem_t,
      smem_u32(smem_t), 0,
      fwf_region(CPS, (D / WCH + FWF_WMAX - 1) / FWF_WMAX == 1));
  fwf_body<CPS, MQ>(a, reinterpret_cast<float*>(smem_t));
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

// a backward kernel (the bf16 wgmma one or a tile one) of element type T,
// with `smem` bytes of dynamic shared memory (opted in once per device);
// st: (b, t, h) strides of q, k, v, dout, then dk, dv (dkv) or dq
template <typename T, typename Kernel>
int launch_bwd_dkv(Kernel kernel, int smem, unsigned& opted, const void* q,
                   const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dk, void* dv,
                   int B, int Tq, int Tk, int H, const long long* st,
                   float scale, cudaStream_t stream) {
  if (int e = opt_in(kernel, smem, opted)) return e;
  dim3 grid((Tk + BK - 1) / BK, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dk, (T*)dv, Tq, Tk, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], st[12], st[13], st[14],
      st[15], st[16], st[17], scale * LOG2E, scale);
  return (int)cudaGetLastError();
}

template <typename T, typename Kernel>
int launch_bwd_dq(Kernel kernel, int smem, unsigned& opted, const void* q,
                  const void* k, const void* v, const void* dout,
                  const float* lse, const float* delta, void* dq, int B,
                  int Tq, int Tk, int H, const long long* st, float scale,
                  cudaStream_t stream) {
  if (int e = opt_in(kernel, smem, opted)) return e;
  dim3 grid((Tq + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dq, Tq, Tk, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], st[12], st[13], st[14], scale * LOG2E,
      scale);
  return (int)cudaGetLastError();
}

// The tile kernels' launches, one instantiation of (T, D) each: the ring's
// four tiles (forward), two fixed tiles and the ring's four (backward;
// dkv's 2 x 128 statistics beside them).
template <typename T, int D>
struct FwdTC {
  static int run(const void* q, const void* k, const void* v, void* o,
                 float* lse, int B, int Tq, int Tk, int H,
                 const long long* s, float scale, cudaStream_t stream) {
    static unsigned opted = 0;
    constexpr int smem = fwd_smem<T, D>();
    if (int e = opt_in(flash_fwd_tc_kernel<T, D>, smem, opted)) return e;
    dim3 grid((Tq + BQ - 1) / BQ, H, B);
    flash_fwd_tc_kernel<T, D><<<grid, THREADS, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, Tq, Tk, s[0], s[1],
        s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11],
        scale * LOG2E);
    return (int)cudaGetLastError();
  }
};

template <typename T, int D>
struct DkvTC {
  static int run(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 void* dk, void* dv, int B, int Tq, int Tk, int H,
                 const long long* st, float scale, cudaStream_t stream) {
    static unsigned opted = 0;
    constexpr int smem = 6 * tc_tile_bytes<T, D>() + DKV_STAT_BYTES;
    return launch_bwd_dkv<T>(flash_bwd_dkv_tc_kernel<T, D>, smem, opted, q,
                             k, v, dout, lse, delta, dk, dv, B, Tq, Tk, H,
                             st, scale, stream);
  }
};

template <typename T, int D>
struct DqTC {
  static int run(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 void* dq, int B, int Tq, int Tk, int H, const long long* st,
                 float scale, cudaStream_t stream) {
    static unsigned opted = 0;
    constexpr int smem = 6 * tc_tile_bytes<T, D>();
    return launch_bwd_dq<T>(flash_bwd_dq_tc_kernel<T, D>, smem, opted, q, k,
                            v, dout, lse, delta, dq, B, Tq, Tk, H, st, scale,
                            stream);
  }
};

// a tile kernel's launch at (f32 or bf16, d): f32 at 32 and 64, bf16 at
// 32 (bf16 at 64 is the wgmma kernels', every multiple of 128 the wide
// kernels'); another width is refused
template <template <typename, int> class L, typename... Args>
int by_width(int f32, int d, Args... args) {
  if (f32 && d == 32) return L<float, 32>::run(args...);
  if (f32 && d == 64) return L<float, 64>::run(args...);
  if (!f32 && d == 32) return L<bf16, 32>::run(args...);
  return (int)cudaErrorInvalidValue;
}

// The wgmma pair takes bf16 at every multiple of 128; at width 128 too,
// where it is faster than the tile pair (PERF.md, the same A/B run). The
// f32 pair takes f32 at every multiple of 128, at 128 too for the same
// reason.
bool wgw_width(int f32, int d) { return !f32 && d % WCH == 0; }
bool fw_width(int f32, int d) { return f32 && d % WCH == 0; }

// a wgmma pair kernel's launch: grid (tiles, H CS, B), clusters of CS
// blocks along y, `smem` bytes of dynamic shared memory (opted in once per
// device)
template <typename Kernel, typename... Args>
int launch_wgw(Kernel kernel, int smem, unsigned& opted, int tiles, int H,
               int B, int NC, cudaStream_t stream, Args... args) {
  if (int e = opt_in(kernel, smem, opted)) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles, H * wgw_cs(NC), B);
  cfg.blockDim = dim3(WGW_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = wgw_cs(NC);
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}


// A wide forward's plan at (B, Tq, Tk, H, d = 128 NC): the slices of O's
// columns, the chunks of O a block (the instance), its query tiles and
// shared memory, the split R of the keys over a cluster and the clusters
// of R that can be resident at once.
struct FwwPlan {
  int nsl, cps, mq, smem, R, resident;
};

template <typename T>
using FwwKernel = void (*)(const T*, const T*, const T*, T*, float*, int, int,
                           int, int, long long, long long, long long,
                           long long, long long, long long, long long,
                           long long, long long, long long, long long,
                           long long, float);

// Each element type's wide forward: the most chunks of O a block (W_MAX /
// 128), the query tiles, shared memory (with Q held or not, and the most
// a launch of the instance takes) and kernel of the instance of CPS
// chunks, and a rank's fixed work in key tiles
template <typename T>
struct FwwOf;
template <>
struct FwwOf<bf16> {
  static constexpr int WMAX = FWW_WMAX;
  static constexpr double RANK_COST = FWW_RANK_COST;
  static int mq(int cps) { return fww_mq(cps); }
  static int smem(int cps, bool qres) { return fww_smem(cps, qres); }
  static int most(int cps) {
    return fww_smem(cps, false) > fww_smem(cps, true) ? fww_smem(cps, false)
                                                      : fww_smem(cps, true);
  }
  static FwwKernel<bf16> kernel(int cps) {
    switch (cps) {
      case 1: return flash_fwd_wgmma_wide<1, 2>;
      case 2: return flash_fwd_wgmma_wide<2, 2>;
      case 3: return flash_fwd_wgmma_wide<3, 1>;
      default: return flash_fwd_wgmma_wide<4, 1>;
    }
  }
};
template <>
struct FwwOf<float> {
  static constexpr int WMAX = FWF_WMAX;
  static constexpr double RANK_COST = FWF_RANK_COST;
  static int mq(int cps) { return fwf_mq(cps); }
  static int smem(int cps, bool qres) { return fwf_smem(cps, qres); }
  static int most(int cps) { return fwf_most(cps); }
  static FwwKernel<float> kernel(int cps) {
    switch (cps) {
      case 1: return flash_fwd_f32_wide<1, 2>;
      case 2: return flash_fwd_f32_wide<2, 1>;
      default: return flash_fwd_f32_wide<3, 1>;
    }
  }
};

// clusters of r blocks of instance cps (Q held or not) that can be
// resident at once, read once per device (the instance's shared memory
// opted in with the first)
template <typename T>
int fww_resident(int cps, bool qres, int r, int smem, int* out) {
  using F = FwwOf<T>;
  static unsigned opted[F::WMAX] = {};
  static int seen[32][F::WMAX][2][WGW_MAX_CLUSTER + 1] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  int& n = seen[dev & 31][cps - 1][qres][r];
  if (n == 0) {
    if (int e = opt_in(F::kernel(cps), F::most(cps), opted[cps - 1]))
      return e;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(64 * r, 1, 1);
    cfg.blockDim = dim3(FWW_THREADS);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = r;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int got = 0;
    const cudaError_t e =
        cudaOccupancyMaxActiveClusters(&got, F::kernel(cps), &cfg);
    if (e != cudaSuccess) return (int)e;
    n = got > 0 ? got : -1;  // -1: no such cluster fits
  }
  *out = n;
  return 0;
}

// R: of 1..8 the split with the least reckoned time, in rounds of the
// card's SMs (a wave of resident clusters, or what is left of the grid,
// as blocks an SM) times a block's share of the key tiles plus the rank
// cost; ties go to the smaller R
template <typename T>
int fww_plan(int B, int Tq, int Tk, int H, int d, FwwPlan& p) {
  using F = FwwOf<T>;
  static int sms[32] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (sms[dev & 31] == 0) {
    const cudaError_t e = cudaDeviceGetAttribute(
        &sms[dev & 31], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  const long long nsm = sms[dev & 31];
  const int nc = d / WCH;
  p.nsl = (nc + F::WMAX - 1) / F::WMAX;
  p.cps = (nc + p.nsl - 1) / p.nsl;
  p.mq = F::mq(p.cps);
  const bool qres = p.nsl == 1;
  p.smem = F::smem(p.cps, qres);
  const long long units =
      (long long)((Tq + 64 * p.mq - 1) / (64 * p.mq)) * H * p.nsl * B;
  const double tiles = (double)Tk / BK;
  double best = 0.0;
  p.R = 0;
  for (int r = 1; r <= WGW_MAX_CLUSTER; ++r) {
    int act = 0;
    if (int e = fww_resident<T>(p.cps, qres, r, p.smem, &act)) return e;
    if (act < 1) continue;
    const long long full = units / act, rest = units % act;
    const long long rounds = full * ((act * r + nsm - 1) / nsm) +
                             (rest * r + nsm - 1) / nsm;
    const double cost = rounds * (tiles / r + F::RANK_COST);
    if (p.R == 0 || cost < best) {
      best = cost;
      p.R = r;
      p.resident = act;
    }
  }
  return p.R ? 0 : (int)cudaErrorInvalidConfiguration;
}

template <typename T>
int launch_fww(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int Tq, int Tk, int H, int d,
               const long long* s, float scale, cudaStream_t stream) {
  FwwPlan p;
  if (int e = fww_plan<T>(B, Tq, Tk, H, d, p)) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.R * ((Tq + 64 * p.mq - 1) / (64 * p.mq)), H * p.nsl,
                     B);
  cfg.blockDim = dim3(FWW_THREADS);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.R;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, FwwOf<T>::kernel(p.cps), (const T*)q, (const T*)k, (const T*)v,
      (T*)o, lse, Tq, Tk, d, p.R, s[0], s[1], s[2], s[3], s[4], s[5], s[6],
      s[7], s[8], s[9], s[10], s[11], scale * LOG2E);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
}  // namespace

// f32 != 0: float inputs and output, else bf16; d: the head width (bf16 at
// 64: the wgmma kernel; every multiple of 128: the wide forward of the
// dtype, flash_fwd_wgmma_wide or flash_fwd_f32_wide; f32 at 32 and 64 and
// bf16 at 32 a tile kernel). lse: null, or (B, H, Tq) f32 for the
// backward.
XT_API int xt_flash_attn_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int Tq, int Tk, int H,
                             long long sqb, long long sqt, long long sqh,
                             long long skb, long long skt, long long skh,
                             long long svb, long long svt, long long svh,
                             long long sob, long long sot, long long soh,
                             float scale, int f32, int d, void* stream) {
  const long long s[12] = {sqb, sqt, sqh, skb, skt, skh,
                           svb, svt, svh, sob, sot, soh};
  if (d % WCH == 0)
    return f32 ? launch_fww<float>(q, k, v, o, (float*)lse, B, Tq, Tk, H, d,
                                   s, scale, (cudaStream_t)stream)
               : launch_fww<bf16>(q, k, v, o, (float*)lse, B, Tq, Tk, H, d,
                                  s, scale, (cudaStream_t)stream);
  if (f32 || d != 64)
    return by_width<FwdTC>(f32, d, q, k, v, o, (float*)lse, B, Tq, Tk, H, s,
                           scale, (cudaStream_t)stream);
  dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse,
      Tq, Tk, sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sob, sot, soh,
      scale * LOG2E);
  return (int)cudaGetLastError();
}

// strides: (b, t, h) of q, k, v, dout, dk, dv (18 values); scratch:
// xt_flash_attn_bwd_scratch(..., 0) floats of f32 device memory, or null
// where that is 0
XT_API int xt_flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 void* scratch, int B, int Tq, int Tk, int H,
                                 const long long* st, float scale, int f32,
                                 int d, void* stream) {
  static unsigned opted_bf16 = 0, opted_wgw = 0, opted_fw = 0;
  const cudaStream_t cs = (cudaStream_t)stream;
  if (wgw_width(f32, d) || fw_width(f32, d)) {
    if (wgw_per(d / WCH) > 1 && scratch == nullptr)
      return (int)cudaErrorInvalidValue;
    if (f32)
      return launch_wgw(
          flash_bwd_dkv_f32_wide, FW_DKV_SMEM, opted_fw, (Tk + BK - 1) / BK,
          H, B, d / WCH, cs, (const float*)q, (const float*)k,
          (const float*)v, (const float*)dout, (const float*)lse,
          (const float*)delta, (float*)dk, (float*)dv, (float*)scratch, Tq,
          Tk, d / WCH, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
          st[7], st[8], st[9], st[10], st[11], st[12], st[13], st[14],
          st[15], st[16], st[17], scale * LOG2E, scale);
    return launch_wgw(
        flash_bwd_dkv_wgmma_wide, WGW_DKV_SMEM, opted_wgw, (Tk + BK - 1) / BK,
        H, B, d / WCH, cs, (const bf16*)q, (const bf16*)k, (const bf16*)v,
        (const bf16*)dout, (const float*)lse, (const float*)delta, (bf16*)dk,
        (bf16*)dv, (float*)scratch, Tq, Tk, d / WCH, st[0], st[1], st[2],
        st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
        st[12], st[13], st[14], st[15], st[16], st[17], scale * LOG2E, scale);
  }
  if (d > WCH) return (int)cudaErrorInvalidValue;
  if (f32 || d != 64)
    return by_width<DkvTC>(f32, d, q, k, v, dout, (const float*)lse,
                                  (const float*)delta, dk, dv, B, Tq, Tk, H,
                                  st, scale, cs);
  return launch_bwd_dkv<bf16>(flash_bwd_dkv_kernel, BWD_DKV_SMEM, opted_bf16,
                              q, k, v, dout, (const float*)lse,
                              (const float*)delta, dk, dv, B, Tq, Tk, H, st,
                              scale, cs);
}

// strides: (b, t, h) of q, k, v, dout, dq (15 values); scratch:
// xt_flash_attn_bwd_scratch(..., 1) floats, or null where that is 0
XT_API int xt_flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, void* scratch,
                                int B, int Tq, int Tk, int H,
                                const long long* st, float scale, int f32,
                                int d, void* stream) {
  static unsigned opted_bf16 = 0, opted_wgw = 0, opted_fw = 0;
  const cudaStream_t cs = (cudaStream_t)stream;
  if (wgw_width(f32, d) || fw_width(f32, d)) {
    if (wgw_per(d / WCH) > 1 && scratch == nullptr)
      return (int)cudaErrorInvalidValue;
    if (f32)
      return launch_wgw(
          flash_bwd_dq_f32_wide, FW_DQ_SMEM, opted_fw, (Tq + BQ - 1) / BQ, H,
          B, d / WCH, cs, (const float*)q, (const float*)k, (const float*)v,
          (const float*)dout, (const float*)lse, (const float*)delta,
          (float*)dq, (float*)scratch, Tq, Tk, d / WCH, st[0], st[1], st[2],
          st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
          st[12], st[13], st[14], scale * LOG2E, scale);
    return launch_wgw(
        flash_bwd_dq_wgmma_wide, WGW_DQ_SMEM, opted_wgw, (Tq + BQ - 1) / BQ,
        H, B, d / WCH, cs, (const bf16*)q, (const bf16*)k, (const bf16*)v,
        (const bf16*)dout, (const float*)lse, (const float*)delta, (bf16*)dq,
        (float*)scratch, Tq, Tk, d / WCH, st[0], st[1], st[2], st[3], st[4],
        st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[12], st[13],
        st[14], scale * LOG2E, scale);
  }
  if (d > WCH) return (int)cudaErrorInvalidValue;
  if (f32 || d != 64)
    return by_width<DqTC>(f32, d, q, k, v, dout, (const float*)lse,
                                 (const float*)delta, dq, B, Tq, Tk, H, st,
                                 scale, cs);
  return launch_bwd_dq<bf16>(flash_bwd_dq_kernel, BWD_DQ_SMEM, opted_bf16, q,
                             k, v, dout, (const float*)lse,
                             (const float*)delta, dq, B, Tq, Tk, H, st,
                             scale, cs);
}

// Floats of f32 scratch xt_flash_attn_bwd_dkv (dq = 0) or _dq (dq = 1)
// needs at these shapes: the wgmma or the f32 pair's accumulator slots
// where a block owns more than one chunk (above width 1024), else 0
XT_API long long xt_flash_attn_bwd_scratch(int B, int Tq, int Tk, int H,
                                           int f32, int d, int dq) {
  if (!(wgw_width(f32, d) || fw_width(f32, d)) || wgw_per(d / WCH) == 1)
    return 0;
  const int nc = d / WCH;
  const long long tiles = dq ? (Tq + BQ - 1) / BQ : (Tk + BK - 1) / BK;
  return tiles * B * H * wgw_cs(nc) * wgw_per(nc) *
         (dq ? WGW_DQ_SLOT : WGW_DKV_SLOT);
}

// Clusters of a backward pair's kernel (the bf16 wgmma pair, or with f32
// the f32 pair; dq = 0 dkv, 1 dq) at head width d, a multiple of 128 the
// pair takes, that can be resident on the card at once, into *out
// (cudaOccupancyMaxActiveClusters with the kernel's cluster size and
// shared memory)
XT_API int xt_flash_attn_bwd_clusters(int f32, int d, int dq, int* out) {
  if (!(wgw_width(f32, d) || fw_width(f32, d)))
    return (int)cudaErrorInvalidValue;
  const void* fns[4] = {(const void*)flash_bwd_dkv_wgmma_wide,
                        (const void*)flash_bwd_dq_wgmma_wide,
                        (const void*)flash_bwd_dkv_f32_wide,
                        (const void*)flash_bwd_dq_f32_wide};
  const int smems[4] = {WGW_DKV_SMEM, WGW_DQ_SMEM, FW_DKV_SMEM, FW_DQ_SMEM};
  const int i = 2 * (f32 != 0) + (dq != 0);
  const cudaError_t e = cudaFuncSetAttribute(
      fns[i], cudaFuncAttributeMaxDynamicSharedMemorySize, smems[i]);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, 64 * wgw_cs(d / WCH), 1);
  cfg.blockDim = dim3(WGW_THREADS);
  cfg.dynamicSmemBytes = smems[i];
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = wgw_cs(d / WCH);
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(out, fns[i], &cfg);
}

// The wide forward's plan (f32 != 0: flash_fwd_f32_wide's, else
// flash_fwd_wgmma_wide's) at these shapes and d, a multiple of 128 (csrc
// fww_plan): out[0] the split R of the keys over a cluster, out[1] the
// clusters of R that can be resident at once, out[2] the slices of O's
// columns, out[3] the query rows a block
XT_API int xt_flash_attn_fwd_plan(int B, int Tq, int Tk, int H, int d,
                                  int f32, int* out) {
  if (d < WCH || d % WCH) return (int)cudaErrorInvalidValue;
  FwwPlan p;
  if (int e = f32 ? fww_plan<float>(B, Tq, Tk, H, d, p)
                  : fww_plan<bf16>(B, Tq, Tk, H, d, p))
    return e;
  out[0] = p.R;
  out[1] = p.resident;
  out[2] = p.nsl;
  out[3] = 64 * p.mq;
  return 0;
}

// Registers and local-memory bytes a thread of every kernel, out[2 i] and
// out[2 i + 1] for i = 8 f + w: f = forward, dkv, dq; w = bf16 at 32, 64
// (the wgmma kernels), 128, the wide kernel, then f32 at the same; the
// backward's 128 and wide entries are both the wide pairs' (bf16 the
// wgmma pair, f32 the f32 pair; local memory other than 0 is a spill); the
// forward's 128 and wide entries are the wide forwards' instances of 128
// and 256 columns a block, i = 24, 25 the bf16 one's of 384 and 512, and
// i = 26 the f32 one's of 384
XT_API int xt_flash_attn_attrs(int* out) {
  const void* fns[27] = {
      (const void*)flash_fwd_tc_kernel<bf16, 32>,
      (const void*)flash_fwd_kernel,
      (const void*)flash_fwd_wgmma_wide<1, 2>,
      (const void*)flash_fwd_wgmma_wide<2, 2>,
      (const void*)flash_fwd_tc_kernel<float, 32>,
      (const void*)flash_fwd_tc_kernel<float, 64>,
      (const void*)flash_fwd_f32_wide<1, 2>,
      (const void*)flash_fwd_f32_wide<2, 1>,
      (const void*)flash_bwd_dkv_tc_kernel<bf16, 32>,
      (const void*)flash_bwd_dkv_kernel,
      (const void*)flash_bwd_dkv_wgmma_wide,
      (const void*)flash_bwd_dkv_wgmma_wide,
      (const void*)flash_bwd_dkv_tc_kernel<float, 32>,
      (const void*)flash_bwd_dkv_tc_kernel<float, 64>,
      (const void*)flash_bwd_dkv_f32_wide,
      (const void*)flash_bwd_dkv_f32_wide,
      (const void*)flash_bwd_dq_tc_kernel<bf16, 32>,
      (const void*)flash_bwd_dq_kernel,
      (const void*)flash_bwd_dq_wgmma_wide,
      (const void*)flash_bwd_dq_wgmma_wide,
      (const void*)flash_bwd_dq_tc_kernel<float, 32>,
      (const void*)flash_bwd_dq_tc_kernel<float, 64>,
      (const void*)flash_bwd_dq_f32_wide,
      (const void*)flash_bwd_dq_f32_wide,
      (const void*)flash_fwd_wgmma_wide<3, 1>,
      (const void*)flash_fwd_wgmma_wide<4, 1>,
      (const void*)flash_fwd_f32_wide<3, 1>};
  for (int i = 0; i < 27; ++i) {
    cudaFuncAttributes a;
    const cudaError_t e = cudaFuncGetAttributes(&a, fns[i]);
    if (e != cudaSuccess) return (int)e;
    out[2 * i] = a.numRegs;
    out[2 * i + 1] = (int)a.localSizeBytes;
  }
  return 0;
}
