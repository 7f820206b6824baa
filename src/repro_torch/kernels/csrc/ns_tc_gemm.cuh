// Building blocks of the 3xTF32 tensor-core GEMM tile (ns_matmul.cu), in raw
// PTX for sm_90a: mbarriers, TMA tensor loads, wgmma descriptors and the
// m64n128k8 TF32 warpgroup product (A from registers, B from shared
// memory), and the hi/lo split of fp32 operands.
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
#include <stdint.h>

namespace tc {

constexpr int BM = 128;   // output tile rows: two consumer warpgroups of 64
constexpr int BN = 128;   // output tile columns: one m64n128 wgmma a warpgroup
constexpr int BK = 32;    // K slice: 32 fp32 = 128 bytes, one swizzle row
constexpr int CONSUMERS = 256;                 // two warpgroups
constexpr int THREADS = CONSUMERS + 128;       // + the producer warpgroup
// setmaxnreg: the producer gives registers up, the consumers take them
// (128 x 24 + 256 x 240 <= 65,536).
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
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
// + alignment slack, + a full and an empty mbarrier for each of up to 4 stages
constexpr int SMEM_BYTES = 1024 + RING_BYTES + 2 * 4 * 8;
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

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
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

template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(REGS));
}
template <int REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(REGS));
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
// positions. Consumer thread t of CONSUMERS takes every CONSUMERS-th chunk.
__device__ __forceinline__ void split_kmajor(float* hi, float* lo, int t) {
  float4* h = reinterpret_cast<float4*>(hi);
  float4* l = reinterpret_cast<float4*>(lo);
#pragma unroll
  for (int i = 0; i < TILE_BYTES / 16 / CONSUMERS; ++i) {
    const int idx = t + i * CONSUMERS;
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
  for (int i = 0; i < BK / 4 * BN / CONSUMERS; ++i) {
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

}  // namespace tc
