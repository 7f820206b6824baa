// The 3xTF32 tensor-core GEMM tile shared by the tiled products
// (ns_matmul.cu) and the fused Newton-Schulz chain (ns_fused.cu), in raw
// PTX for sm_90a: mbarriers, TMA tensor loads, wgmma descriptors and the
// m64n128k8 TF32 warpgroup product (A from registers, B from shared
// memory), the hi/lo split of fp32 operands, and gemm_tile, which computes
// one 128 x 128 output tile of alpha*C + beta*A@op(B); a block may run it
// for many tiles in a row.
//
// Shared-memory tiles are K-major (a row holds 32 consecutive k, 128 bytes)
// in the 128-byte swizzle that TMA writes and wgmma reads: inside each
// 1024-byte atom of 8 rows, the 16-byte chunk c of row r sits at chunk
// c ^ (r % 8). Every tile starts on a 1024-byte boundary. (An N-major B
// slice lands unswizzled in a raw buffer of its own and is transposed into
// this layout by split_nmajor.)
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace tc {

constexpr int BM = 128;   // output tile rows: two consumer warpgroups of 64
constexpr int BN = 128;   // output tile columns: one m64n128 wgmma a warpgroup
constexpr int BK = 32;    // K slice: 32 fp32 = 128 bytes, one swizzle row
static_assert(BM == BN, "one K-major map (box BK x BM) serves as A and as B");
// Two warpgroups, 64 output rows each; with one block an SM, a thread may
// hold 255 registers (65,536 / 256), which the accumulator, its fp32 sum
// and two slices of A fragments need.
constexpr int THREADS = 256;
constexpr int TILE_BYTES = BM * BK * 4;        // 16 KB: a 128 x 32 fp32 slice
// The ring: a stage holds A raw, B hi and B lo, plus B raw when B is
// N-major (it is transposed into B hi and lo, so cannot be split in place):
// four stages of 48 KB or three of 64 KB.
template <bool B_KMAJOR>
struct Ring {
  static constexpr int STAGES = B_KMAJOR ? 4 : 3;
  static constexpr int STAGE_BYTES = (B_KMAJOR ? 3 : 4) * TILE_BYTES;
  static constexpr int B_RAW = B_KMAJOR ? TILE_BYTES : 3 * TILE_BYTES;  // TMA's B target
};
constexpr int RING_BYTES = 12 * TILE_BYTES;
constexpr int MAX_STAGES = 4;
// + alignment slack, + a full mbarrier for each of up to 4 stages
constexpr int SMEM_BYTES = 1024 + RING_BYTES + MAX_STAGES * 8;
// A fresh wgmma accumulator takes PROMOTE K slices (PROMOTE * BK terms of
// each of the three products); then it is added into an fp32 register sum
// on the CUDA cores, so no accumulator inside the tensor core runs long.
constexpr int PROMOTE = 4;
constexpr int STAGE_LD = BN + 1;  // row stride of the epilogue's staging tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_inval(uint32_t bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Spins until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Orders this thread's generic-proxy shared stores before later async-proxy
// accesses (wgmma operand reads, TMA writes) of the same bytes.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// TMA: the box at coordinates (c0 innermost, c1, c2) of a 3-D tensor map
// into shared memory at `dst`, completion reported to mbarrier `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major, 128-byte-swizzled tile at
// shared address `addr`: 8-row atoms 1024 bytes apart (SBO), LBO unused in
// this layout (1 by convention), layout type 1 = 128-byte swizzle. Moving
// along K inside the 128-byte row is a plain offset of the start address.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Waits until at most N committed wgmma groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of the accumulator registers
// across the asynchronous wgmma that owns them.
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void fence_operands(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// d += A (64 x 8, TF32, in registers) * B (8 x 128, TF32, K-major in shared
// memory). Fragments of thread (warp w, lane l) of the warpgroup, with
// g = l / 4 and q = l % 4: a[2i + h] is row 16 w + g + 8 h, column q + 4 i;
// d[4j + 2h + e] is row 16 w + g + 8 h, column 8 j + 2 q + e.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t desc_b) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %69, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// x = hi + lo + r with hi = TF32(x), lo = TF32(x - hi) (round to nearest,
// ties away) and |r| <= 2^-22 |x|: x - hi is exact in fp32.
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(u) : "f"(x));
  return __uint_as_float(u);
}

__device__ __forceinline__ void split4(const float4 v, float4& hi, float4& lo) {
  hi = make_float4(tf32_rna(v.x), tf32_rna(v.y), tf32_rna(v.z), tf32_rna(v.w));
  lo = make_float4(tf32_rna(__fsub_rn(v.x, hi.x)), tf32_rna(__fsub_rn(v.y, hi.y)),
                   tf32_rna(__fsub_rn(v.z, hi.z)), tf32_rna(__fsub_rn(v.w, hi.w)));
}

// The A fragments of one k8 step (kk) for rows `row` and `row + 8` of a
// K-major swizzled fp32 tile, split into TF32 hi and lo registers. A warp
// reads 8 rows x 4 columns a load: 8 distinct chunks, no bank conflict.
__device__ __forceinline__ void load_a_split(const float* tile, int row, int kk, int q,
                                             uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row + 8 * (i % 2), c = 8 * kk + q + 4 * (i / 2);
    const float x = tile[r * BK + ((((c >> 2) ^ (r & 7))) << 2) + (c & 3)];
    const float h = tf32_rna(x);
    hi[i] = __float_as_uint(h);
    lo[i] = __float_as_uint(tf32_rna(__fsub_rn(x, h)));
  }
}

// Splits a K-major fp32 slice in place: `hi` (as TMA wrote it) becomes its
// TF32 high part and `lo` gets the remainder at the same (swizzled)
// positions. Thread t of THREADS takes every THREADS-th chunk.
__device__ __forceinline__ void split_kmajor(float* hi, float* lo, int t) {
  float4* h = reinterpret_cast<float4*>(hi);
  float4* l = reinterpret_cast<float4*>(lo);
#pragma unroll
  for (int i = 0; i < TILE_BYTES / 16 / THREADS; ++i) {
    const int idx = t + i * THREADS;
    float4 vh, vl;
    split4(h[idx], vh, vl);
    h[idx] = vh;
    l[idx] = vl;
  }
}

// Splits an N-major fp32 slice `raw` (BK rows of BN values, unswizzled, as
// TMA wrote it) into K-major swizzled hi and lo tiles: the transpose that
// TF32 wgmma needs, since it takes no transposed operand. Thread t owns
// column n = t % BN and the chunks g = t / BN + 2 i of four k each: its
// reads walk consecutive n across the warp, and its 16-byte stores land in
// the 8 distinct chunks of 8 consecutive rows, both free of bank conflicts.
__device__ __forceinline__ void split_nmajor(const float* raw, float* hi, float* lo, int t) {
  const int n = t % BN;
#pragma unroll
  for (int i = 0; i < BK / 4 * BN / THREADS; ++i) {
    const int g = t / BN + 2 * i;
    const float4 v = make_float4(raw[(4 * g) * BN + n], raw[(4 * g + 1) * BN + n],
                                 raw[(4 * g + 2) * BN + n], raw[(4 * g + 3) * BN + n]);
    const int off = n * BK + ((g ^ (n & 7)) << 2);
    float4 vh, vl;
    split4(v, vh, vl);
    *reinterpret_cast<float4*>(hi + off) = vh;
    *reinterpret_cast<float4*>(lo + off) = vl;
  }
}

// ---------------------------------------------------------------------------
// The tile routine.
//
// All 256 threads of a block run gemm_tile for each of the block's tiles,
// in the same order. Thread 0 also issues the TMA loads: the first STAGES
// K slices when the tile starts, then each later slice as soon as the
// block-wide barrier after a slice's split shows that both warpgroups are
// done with the stage it reuses. So there is no producer warpgroup and no
// empty barrier, and a thread keeps up to 255 registers.

// Named barrier 1 is the whole block (0 is __syncthreads); 2 + wg one
// warpgroup.
constexpr int BLOCK_BARRIER = 1;

// out[z] = alpha * C[z] + beta * (A[z] @ op(B[z])) over M x N, rows ld*
// floats apart, matrices stride_* floats apart; C may be null. With
// `symmetric` (M == N, the product and C symmetric) the tile is also
// written to its mirror, and a diagonal tile from its upper triangle.
struct Epilogue {
  const float* C;  // read through L2 (ld.global.cg): another SM may have
                   // written it earlier in the same launch
  long long ldc, stride_c;
  float* out;
  long long ldo, stride_o;
  int M, N;
  int symmetric;
  float alpha, beta;
};

// One output tile: rows m0.., columns n0.. of matrix z, over K. A is read
// through map_a as (K inner, M outer); B through map_b as (K, N) when B is
// K-major (op(B) = B^T), else as (N inner, K outer).
struct TileJob {
  const CUtensorMap* map_a;
  const CUtensorMap* map_b;
  int m0, n0, z, K;
};

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                    ~static_cast<uintptr_t>(1023));
}

__device__ __forceinline__ uint32_t full_bar(uint32_t smem0, int s) {
  return smem0 + RING_BYTES + 8 * s;
}

// Thread 0 initialises the ring's barriers; the caller syncs the block
// after. gemm_tile re-initialises them at the end of each tile, so that
// every tile starts them at phase 0 whatever the ring's geometry (3 or 4
// stages) was before.
__device__ __forceinline__ void ring_init(uint8_t* smem) {
  if (threadIdx.x == 0) {
    const uint32_t smem0 = smem_u32(smem);
    for (int s = 0; s < MAX_STAGES; ++s) mbar_init(full_bar(smem0, s), 1);
    fence_barrier_init();
  }
}

// Upper tile t of a square grid of nt x nt tiles, row by row: (bi, bj), bj >= bi.
__device__ __forceinline__ void upper_tile(int t, int nt, int& bi, int& bj) {
  bi = 0;
  while (t >= nt - bi) {
    t -= nt - bi;
    ++bi;
  }
  bj = bi + t;
}

// One tile (see above). `ep` lies in shared or kernel-parameter memory and
// is read after the K loop, so no register holds it through the loop.
// Ends with a barrier of the whole block: the ring is free, and its
// barriers are back at phase 0, when it returns.
template <bool B_KMAJOR>
__device__ __forceinline__ void gemm_tile(uint8_t* smem, const TileJob& job, const Epilogue& ep) {
  const uint32_t smem0 = smem_u32(smem);
  constexpr int STAGES = Ring<B_KMAJOR>::STAGES, STAGE_BYTES = Ring<B_KMAJOR>::STAGE_BYTES;
  const int nk = (job.K + BK - 1) / BK;
  const int t = threadIdx.x;
  const int wg = t / 128;
  const int lane = t % 32, warp = (t % 128) / 32;
  const int a_row = 64 * wg + 16 * warp + lane / 4;

  // Thread 0: slice kt's A and B into its stage.
  auto load = [&](int kt) {
    const int s = kt % STAGES;
    const uint32_t stage = smem0 + s * STAGE_BYTES;
    const uint32_t full = full_bar(smem0, s);
    mbar_expect_tx(full, 2 * TILE_BYTES);
    tma_load_3d(stage, job.map_a, full, kt * BK, job.m0, job.z);
    const uint32_t b_raw = stage + Ring<B_KMAJOR>::B_RAW;
    if (B_KMAJOR)
      tma_load_3d(b_raw, job.map_b, full, kt * BK, job.n0, job.z);
    else
      tma_load_3d(b_raw, job.map_b, full, job.n0, kt * BK, job.z);
  };
  if (t == 0)
    for (int kt = 0; kt < STAGES && kt < nk; ++kt) load(kt);

  // Slice kt fills its stage's barrier's phase kt / STAGES.
  auto wait_full = [&](int kt) { mbar_wait(full_bar(smem0, kt % STAGES), (kt / STAGES) & 1); };
  // B's split pass (in shared memory, for both warpgroups' wgmmas).
  auto split_b = [&](int s) {
    float* b = reinterpret_cast<float*>(smem + s * STAGE_BYTES + TILE_BYTES);
    if (B_KMAJOR)
      split_kmajor(b, b + TILE_BYTES / 4, t);
    else
      split_nmajor(b + TILE_BYTES / 2, b, b + TILE_BYTES / 4, t);
    fence_async_smem();
  };

  // A's split pass, in registers: this warpgroup's 64 rows of a slice.
  auto split_a = [&](int s, uint32_t (&hi)[BK / 8][4], uint32_t (&lo)[BK / 8][4]) {
    const float* a = reinterpret_cast<const float*>(smem + s * STAGE_BYTES);
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) load_a_split(a, a_row, kk, lane % 4, hi[kk], lo[kk]);
  };

  float acc[64], sum[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) sum[i] = 0.f;
  // Two sets of A fragments: the slice in flight and the next one.
  uint32_t a0_hi[BK / 8][4], a0_lo[BK / 8][4], a1_hi[BK / 8][4], a1_lo[BK / 8][4];

  // One K slice: its wgmmas on `cur` and B's stage, then, while they run,
  // the next slice's split passes into `nxt` (free once the previous
  // slice's wgmmas are done). After the block barrier that ends the split,
  // both warpgroups are done with slice kt - 1's stage: thread 0 refills it.
  auto slice = [&](int kt, uint32_t (&cur_hi)[BK / 8][4], uint32_t (&cur_lo)[BK / 8][4],
                   uint32_t (&nxt_hi)[BK / 8][4], uint32_t (&nxt_lo)[BK / 8][4]) {
    const uint32_t b_hi = smem0 + (kt % STAGES) * STAGE_BYTES + TILE_BYTES;
    const uint32_t b_lo = b_hi + TILE_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const uint32_t off = kk * 8 * 4;  // 8 k = 32 bytes along the swizzled row
      wgmma_tf32(acc, cur_lo[kk], sw128_desc(b_hi + off));
      wgmma_tf32(acc, cur_hi[kk], sw128_desc(b_lo + off));
      wgmma_tf32(acc, cur_hi[kk], sw128_desc(b_hi + off));
    }
    wgmma_commit();
    wgmma_wait<1>();  // slice kt - 1 is done: its stage and fragments are free
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      fence_operands(nxt_hi[kk]);
      fence_operands(nxt_lo[kk]);
    }
    if (kt + 1 < nk) {
      wait_full(kt + 1);
      split_b((kt + 1) % STAGES);
      split_a((kt + 1) % STAGES, nxt_hi, nxt_lo);
      named_sync(BLOCK_BARRIER, THREADS);
      if (t == 0 && kt >= 1 && kt - 1 + STAGES < nk) load(kt - 1 + STAGES);
    }
  };

  if (nk > 0) {
    wait_full(0);
    split_b(0);
    split_a(0, a0_hi, a0_lo);
    named_sync(BLOCK_BARRIER, THREADS);
  }
  // A group of PROMOTE slices runs into one fresh accumulator, written out
  // straight so that nothing touches the accumulator while its wgmmas are in
  // flight; the tensor cores drain only at the end of a group, where it
  // joins the fp32 sum. The last group may be short.
  static_assert(PROMOTE == 4, "the group below is written out for PROMOTE = 4");
  for (int g = 0; g < nk; g += PROMOTE) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    fence_operands(acc);
    slice(g, a0_hi, a0_lo, a1_hi, a1_lo);
    if (g + PROMOTE <= nk) {
      slice(g + 1, a1_hi, a1_lo, a0_hi, a0_lo);
      slice(g + 2, a0_hi, a0_lo, a1_hi, a1_lo);
      slice(g + 3, a1_hi, a1_lo, a0_hi, a0_lo);
    } else if (g + 1 < nk) {
      slice(g + 1, a1_hi, a1_lo, a0_hi, a0_lo);
      if (g + 2 < nk) slice(g + 2, a0_hi, a0_lo, a1_hi, a1_lo);
    }
    wgmma_wait<0>();
    fence_operands(acc);
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      fence_operands(a0_hi[kk]);
      fence_operands(a0_lo[kk]);
      fence_operands(a1_hi[kk]);
      fence_operands(a1_lo[kk]);
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] += acc[i];
  }
  // Both warpgroups are done with the stages, and every load of the tile
  // has landed: reuse the ring for staging, and reset its barriers.
  named_sync(BLOCK_BARRIER, THREADS);
  if (t == 0) {
    for (int s = 0; s < MAX_STAGES; ++s) {
      mbar_inval(full_bar(smem0, s));
      mbar_init(full_bar(smem0, s), 1);
    }
    fence_barrier_init();
  }

  // Epilogue: the tile is staged in shared memory (stride BN + 1, free of
  // bank conflicts both ways) so that the direct and the mirror stores are
  // 128-byte rows. Rounded as PyTorch rounds alpha*c + beta*prod: two
  // products, then a sum, never contracted into an FMA. The job's and the
  // epilogue's fields are read once here, after the K loop.
  const int m0 = job.m0, n0 = job.n0, z = job.z;
  const float* const C = ep.C;
  float* const out = ep.out;
  const long long ldc = ep.ldc, ldo = ep.ldo;
  const int M = ep.M, N = ep.N;
  const bool symmetric = ep.symmetric != 0;
  const float alpha = ep.alpha, beta = ep.beta;
  const float* cz = C == nullptr ? nullptr : C + z * ep.stride_c;
  float* oz = out + z * ep.stride_o;
  float* st = reinterpret_cast<float*>(smem) + wg * 64 * STAGE_LD;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * warp + lane / 4 + 8 * h, c = 8 * j + 2 * (lane % 4);
      st[r * STAGE_LD + c] = __fmul_rn(beta, sum[4 * j + 2 * h]);
      st[r * STAGE_LD + c + 1] = __fmul_rn(beta, sum[4 * j + 2 * h + 1]);
    }
  }
  named_sync(2 + wg, 128);

  const bool diag = symmetric && m0 == n0;
  const int row0 = m0 + 64 * wg;
  for (int r = warp; r < 64 && row0 + r < M; r += 4) {
    const int gm = row0 + r;
#pragma unroll
    for (int q = 0; q < BN / 32; ++q) {
      const int c = lane + 32 * q, gn = n0 + c;
      if (gn < N && (!diag || gn >= gm)) {
        float v = st[r * STAGE_LD + c];
        if (cz != nullptr) v = __fadd_rn(__fmul_rn(alpha, __ldcg(cz + gm * ldc + gn)), v);
        oz[gm * ldo + gn] = v;
        st[r * STAGE_LD + c] = v;
      }
    }
  }
  if (symmetric) {  // (gn, gm) <- (gm, gn) for every gn > gm of the tile
    named_sync(2 + wg, 128);
    for (int c = warp; c < BN && n0 + c < N; c += 4) {
      const int gn = n0 + c;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = lane + 32 * h, gm = row0 + r;
        if (gm < M && gn > gm) oz[gn * ldo + gm] = st[r * STAGE_LD + c];
      }
    }
  }
  // The staging reads and writes (generic proxy) come before the next
  // tile's TMA writes (async proxy) into the same bytes.
  fence_async_smem();
  named_sync(BLOCK_BARRIER, THREADS);
}

// ---------------------------------------------------------------------------
// Host side: TMA tensor maps.

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda.so.1, which the CUDA runtime has
// already loaded (no link against libcuda).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    if (lib != nullptr) fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// A (batch, outer, inner) fp32 operand, rows `ld` floats apart and
// matrices `stride` floats apart, cut into (box_outer x box_inner) boxes;
// boxes past the edge are zero-filled.
inline CUresult make_map(CUtensorMap* map, const float* ptr, int inner, int outer, int batch,
                         long long ld, long long stride, int box_inner, int box_outer,
                         bool swizzle) {
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)outer, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 4, (cuuint64_t)stride * 4};
  const cuuint32_t box[3] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// An operand that a tile reads K-major: A, or a B with op(B) = B^T.
inline CUresult make_kmajor_map(CUtensorMap* map, const float* ptr, int K, int rows, int batch,
                                long long ld, long long stride) {
  return make_map(map, ptr, K, rows, batch, ld, stride, BK, BM, true);
}

// A B that a tile reads N-major: (K, N) with rows ld floats apart.
inline CUresult make_nmajor_map(CUtensorMap* map, const float* ptr, int K, int N, int batch,
                                long long ld, long long stride) {
  return make_map(map, ptr, N, K, batch, ld, stride, BN, BK, false);
}

}  // namespace tc
