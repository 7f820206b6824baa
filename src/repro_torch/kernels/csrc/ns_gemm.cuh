// Shared-memory-tiled exact-fp32 GEMM tile for the Newton-Schulz kernels.
//
// One 256-thread block computes one 128x128 tile of
//
//     out = alpha * C + beta * (A @ op(B))          (C may be null: out = beta * A@op(B))
//
// with op(B) = B (K x N, row stride ldb) or, when trans_b, B^T for a B stored
// as N x K (row stride ldb) -- the Gram product X X^T reads X twice and never
// materialises the transpose. Every product is an fp32 FFMA into an fp32
// register accumulator (no TF32, no tensor cores), summed over k in order,
// so the result holds against an fp32 torch.matmul with TF32 off to
// rounding order.
//
// Tiling: K advances 8 at a time through two double-buffered pairs of
// 8x(128+4) fp32 shared tiles (16.9 KB). The next pair is loaded from
// device memory into registers before the current pair is multiplied, so
// the loads' latency hides behind the 512 FFMAs a thread does per pair.
// Each thread owns an 8x8 sub-tile of the output made of four 4x4 pieces,
// rows {4 ty + i, 64 + 4 ty + i} and columns {4 tx + j, 64 + 4 tx + j}, so
// it reads its operands from shared memory as float4s: 4 loads per 64
// FFMAs. The +4 pad spreads the transposed tile stores over all 32 banks
// and keeps every row 16-byte aligned. Ragged edges are masked in the
// loads (zero fill) and the stores; nothing is padded in device memory.
//
// Pointers are deliberately not __restrict__ const: the fused chain kernel
// reads buffers that its own cluster wrote a stage earlier, and the
// read-only (non-coherent) cache path would be wrong there.
#pragma once

#include <cuda_runtime.h>

namespace ns {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 8;
constexpr int PAD = 4;
constexpr int THREADS = 256;
constexpr int LOADS = BM * BK / THREADS;  // operand values a thread loads per K step

struct alignas(16) Smem {
  float a[2][BK][BM + PAD];
  float b[2][BK][BN + PAD];
};

// Loads this thread's share of the A and op(B) tiles at k0 into registers.
__device__ __forceinline__ void load_tiles(
    const float* A, int lda, const float* B, int ldb, bool trans_b,
    int M, int N, int K, int m0, int n0, int k0, float (&ra)[LOADS], float (&rb)[LOADS]) {
  const int t = threadIdx.x;
#pragma unroll
  for (int r = 0; r < LOADS; ++r) {
    const int l = t + r * THREADS;
    const int mi = l / BK, ki = l % BK;
    const int gm = m0 + mi, gk = k0 + ki;
    ra[r] = (gm < M && gk < K) ? A[(long long)gm * lda + gk] : 0.f;
    if (trans_b) {
      const int gn = n0 + mi;
      rb[r] = (gn < N && gk < K) ? B[(long long)gn * ldb + gk] : 0.f;
    } else {
      const int kb = l / BN, ni = l % BN;
      const int gn = n0 + ni, gkb = k0 + kb;
      rb[r] = (gn < N && gkb < K) ? B[(long long)gkb * ldb + gn] : 0.f;
    }
  }
}

// Stores the registers of load_tiles into shared buffer `buf` (k-major).
__device__ __forceinline__ void store_tiles(Smem& sm, int buf, bool trans_b,
                                            const float (&ra)[LOADS], const float (&rb)[LOADS]) {
  const int t = threadIdx.x;
#pragma unroll
  for (int r = 0; r < LOADS; ++r) {
    const int l = t + r * THREADS;
    sm.a[buf][l % BK][l / BK] = ra[r];
    if (trans_b)
      sm.b[buf][l % BK][l / BK] = rb[r];
    else
      sm.b[buf][l / BN][l % BN] = rb[r];
  }
}

__device__ __forceinline__ void gemm_tile(
    const float* A, int lda,
    const float* B, int ldb, bool trans_b,
    const float* C, int ldc,
    float* out, int ldo,
    int M, int N, int K, int m0, int n0,
    float alpha, float beta, bool mirror, Smem& sm) {
  const int t = threadIdx.x;
  const int tx = t % 16;
  const int ty = t / 16;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float ra[LOADS], rb[LOADS];
  load_tiles(A, lda, B, ldb, trans_b, M, N, K, m0, n0, 0, ra, rb);
  store_tiles(sm, 0, trans_b, ra, rb);
  __syncthreads();

  int buf = 0;
  for (int k0 = 0; k0 < K; k0 += BK) {
    const bool more = k0 + BK < K;
    if (more) load_tiles(A, lda, B, ldb, trans_b, M, N, K, m0, n0, k0 + BK, ra, rb);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[8], bv[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&sm.a[buf][kk][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&sm.a[buf][kk][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sm.b[buf][kk][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&sm.b[buf][kk][64 + 4 * tx]);
      av[0] = a0.x; av[1] = a0.y; av[2] = a0.z; av[3] = a0.w;
      av[4] = a1.x; av[5] = a1.y; av[6] = a1.z; av[7] = a1.w;
      bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
      bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    // The other buffer was last read before the previous barrier, so it can
    // be refilled now; one barrier per K step orders both directions.
    if (more) store_tiles(sm, buf ^ 1, trans_b, ra, rb);
    __syncthreads();
    buf ^= 1;
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
      if (gn >= N) continue;
      // Rounded as PyTorch rounds alpha * c + beta * prod (two products,
      // then a sum), never contracted into an FMA, so that the result does
      // not depend on the compiler's choice of contraction.
      float v = __fmul_rn(beta, acc[i][j]);
      if (C != nullptr) v = __fadd_rn(__fmul_rn(alpha, C[(long long)gm * ldc + gn]), v);
      out[(long long)gm * ldo + gn] = v;
      if (mirror) out[(long long)gn * ldo + gm] = v;
    }
  }
}

// This block's share of the whole M x N product (fused chain): the tiles
// are dealt out round-robin to the `parts` blocks of a unit's cluster, and
// block `part` computes its tiles one after another.
// With `symmetric` (M == N, A@op(B) and C symmetric: the Gram X X^T and
// b A + c A^2) only the tiles on and above the diagonal are computed, and
// each one above it is also written to its mirror image. A mirrored entry
// is the same fp32 FFMA chain as the entry computed in place (the products
// commute exactly), so the result is the one the full product gives.
__device__ __forceinline__ void block_gemm(
    const float* A, int lda,
    const float* B, int ldb, bool trans_b,
    const float* C, int ldc,
    float* out, int ldo,
    int M, int N, int K, float alpha, float beta, bool symmetric,
    int part, int parts, Smem& sm) {
  int tile = 0;
  for (int m0 = 0; m0 < M; m0 += BM)
    for (int n0 = symmetric ? m0 : 0; n0 < N; n0 += BN, ++tile)
      if (tile % parts == part)
        gemm_tile(A, lda, B, ldb, trans_b, C, ldc, out, ldo, M, N, K, m0, n0,
                  alpha, beta, symmetric && n0 != m0, sm);
}

}  // namespace ns
