// Tiled Newton-Schulz matmul and fma_matmul for Hopper (sm_90a): a 3xTF32
// tensor-core GEMM with fp32 inputs and outputs.
//
// Replaces the TPU kernels
//   repro/kernels/newton_schulz/newton_schulz.py:_matmul_kernel      (X @ Y)
//   repro/kernels/newton_schulz/newton_schulz.py:_fma_matmul_kernel  (alpha*C + beta*(X @ Y))
// which ops.ns_iteration chains three times per NS step (A = X X^T,
// P = bA + cA^2, Y = aX + PX). The stack dimension is grid axis z, so one
// launch covers a whole bucket (the reference unrolled the stack in Python).
//
// Precision: each fp32 operand value is split into a TF32 high part and a
// TF32 remainder (hi = rna(x), lo = rna(x - hi)), and the tensor cores sum
// hi*hi + hi*lo + lo*hi in fp32. The dropped lo*lo term is ~2^-22 of a
// product. A wgmma accumulator runs PROMOTE K slices (128 k) and is then
// added into an fp32 register sum, so the tensor core's own accumulation
// never runs long. Measured by chip_smoke.py on an H100 against the plain
// product (cuBLAS fp32, TF32 off), as max abs error over max|plain|: the
// Gram 24 x 1536 x 6144 (K = 6144) 5.0e-6, the polynomial 1.1e-7, the
// update 5.9e-8. Against an fp64 product the Gram is at 1.4e-6 where
// cuBLAS's fp32 product is at 4.9e-6.
//
// Bound on the H100: at the full-phase shapes (1536 x 6144 units, 1536^2
// Grams) the products are bound by tensor-core operations: three TF32
// products of the least work at 495 TFLOP/s, i.e. 165 TFLOP/s of fp32
// work, where the FFMA tile this replaces was capped at 67 TFLOP/s. The
// kernel reaches about half of that bound (PERF.md).
//
// Design (one 128 x 128 output tile a block, 384 threads):
//  * One producer thread keeps TMA loads of the A and B slices (BK = 32 fp32,
//    one 128-byte swizzle row) in flight into a ring of 3-4 stages,
//    reporting completion on mbarriers; ragged M, N and K are zero-filled by
//    TMA, so the loop needs no masks.
//  * Two consumer warpgroups, 64 rows each. Each splits its rows of the A
//    slice into hi and lo registers (wgmma's A operand), and both split the
//    B slice into hi and lo tiles in shared memory (a K-major B in place;
//    an N-major B, the update's X, transposed into the K-major layout TF32
//    wgmma requires); then each issues three m64n128k8 wgmmas a k8 step.
//    The split of the next slice runs while the current wgmmas are in
//    flight, and the wgmmas of consecutive slices queue back to back: the
//    tensor cores drain only at the end of a group of PROMOTE slices. A
//    from registers keeps A's hi and lo tiles out of shared memory, which
//    the three products' operand reads load heavily. The producer
//    warpgroup gives registers up (setmaxnreg) to the two consumer
//    warpgroups, which hold the accumulator, its fp32 sum and two slices
//    of A fragments without spilling.
//  * An N-major B lands in a raw buffer of its own, so its transposed
//    split needs no barrier between its reads and its writes.
//  * symmetric (the Gram X X^T and b A + c A^2 with C = A): only tiles on
//    and above the diagonal are launched; each is also written to its
//    mirror, and a diagonal tile is written from its upper triangle, so the
//    output is exactly symmetric.
//  * Epilogue: the tile is staged in shared memory (stride BN + 1, free of
//    bank conflicts both ways) so that the direct and the mirror stores
//    are 128-byte rows. Rounded as PyTorch rounds alpha*c + beta*prod:
//    two products, then a sum, never contracted into an FMA.

#include <dlfcn.h>

#include "ns_tc_gemm.cuh"

namespace {

using namespace tc;

template <bool B_KMAJOR>
__global__ void __launch_bounds__(THREADS, 1)
tc_gemm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
               const float* __restrict__ C, float* __restrict__ out, int M, int N, int K,
               long long ldc, long long stride_c, long long ldo, long long stride_o,
               int symmetric, float alpha, float beta) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t smem0 = smem_u32(smem);
  constexpr int STAGES = Ring<B_KMAJOR>::STAGES, STAGE_BYTES = Ring<B_KMAJOR>::STAGE_BYTES;
  const uint32_t bar0 = smem0 + RING_BYTES;
  auto full = [&](int s) { return bar0 + 8 * s; };
  auto empty = [&](int s) { return bar0 + 8 * (STAGES + s); };

  int m0, n0;
  if (symmetric) {  // upper tile blockIdx.x, row by row
    const int nt = (N + BN - 1) / BN;
    int t = blockIdx.x, bi = 0;
    while (t >= nt - bi) {
      t -= nt - bi;
      ++bi;
    }
    m0 = bi * BM;
    n0 = (bi + t) * BN;
  } else {
    m0 = blockIdx.y * BM;
    n0 = blockIdx.x * BN;
  }
  const int z = blockIdx.z;
  const int nk = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS / 32);  // one arrival a consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // producer warpgroup: one thread issues the loads
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(empty(s), ((kt / STAGES) - 1) & 1);
        const uint32_t stage = smem0 + s * STAGE_BYTES;
        mbar_expect_tx(full(s), 2 * TILE_BYTES);
        tma_load_3d(stage, &map_a, full(s), kt * BK, m0, z);
        const uint32_t b_raw = stage + Ring<B_KMAJOR>::B_RAW;
        if (B_KMAJOR)
          tma_load_3d(b_raw, &map_b, full(s), kt * BK, n0, z);
        else
          tma_load_3d(b_raw, &map_b, full(s), n0, kt * BK, z);
      }
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  const int t = threadIdx.x;
  const int wg = t / 128;
  const int lane = t % 32, warp = (t % 128) / 32;
  const int a_row = 64 * wg + 16 * warp + lane / 4;
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
  int released = 0;  // stages of slices [0, released) are handed back
  auto release_through = [&](int kt) {
    __syncwarp();
    for (; released <= kt; ++released)
      if (lane == 0) mbar_arrive(empty(released % STAGES));
  };

  // One K slice: its wgmmas on `cur` and B's stage, then, while they run,
  // the next slice's split passes into `nxt` (free once the previous
  // slice's wgmmas are done).
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
    if (kt > 0) release_through(kt - 1);
    if (kt + 1 < nk) {
      mbar_wait(full((kt + 1) % STAGES), ((kt + 1) / STAGES) & 1);
      split_b((kt + 1) % STAGES);
      split_a((kt + 1) % STAGES, nxt_hi, nxt_lo);
      named_sync(1, CONSUMERS);
    }
  };

  if (nk > 0) {
    mbar_wait(full(0), 0);
    split_b(0);
    split_a(0, a0_hi, a0_lo);
    named_sync(1, CONSUMERS);
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
    release_through(min(g + PROMOTE, nk) - 1);
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] += acc[i];
  }
  // Both warpgroups are done with the stages: reuse them for staging.
  named_sync(1, CONSUMERS);

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
  const float* cz = C == nullptr ? nullptr : C + z * stride_c;
  float* oz = out + z * stride_o;
  for (int r = warp; r < 64 && row0 + r < M; r += 4) {
    const int gm = row0 + r;
#pragma unroll
    for (int q = 0; q < BN / 32; ++q) {
      const int c = lane + 32 * q, gn = n0 + c;
      if (gn < N && (!diag || gn >= gm)) {
        float v = st[r * STAGE_LD + c];
        if (cz != nullptr) v = __fadd_rn(__fmul_rn(alpha, cz[gm * ldc + gn]), v);
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
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda.so.1, which the CUDA runtime has
// already loaded (no link against libcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    if (lib != nullptr) fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// A (batch, outer, inner) fp32 operand, rows `ld` floats apart and
// matrices `stride` floats apart, cut into (box_outer x box_inner) boxes.
CUresult make_map(CUtensorMap* map, const float* ptr, int inner, int outer, int batch,
                  long long ld, long long stride, int box_inner, int box_outer, bool swizzle) {
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)outer, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 4, (cuuint64_t)stride * 4};
  const cuuint32_t box[3] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <bool B_KMAJOR>
int launch(const CUtensorMap& ma, const CUtensorMap& mb, const float* C, float* out, int batch,
           int M, int N, int K, long long ldc, long long stride_c, long long ldo,
           long long stride_o, int symmetric, float alpha, float beta, cudaStream_t stream) {
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        tc_gemm_kernel<B_KMAJOR>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  const int mt = (M + BM - 1) / BM, nt = (N + BN - 1) / BN;
  const dim3 grid = symmetric ? dim3(nt * (nt + 1) / 2, 1, batch) : dim3(nt, mt, batch);
  tc_gemm_kernel<B_KMAJOR><<<grid, THREADS, SMEM_BYTES, stream>>>(
      ma, mb, C, out, M, N, K, ldc, stride_c, ldo, stride_o, symmetric, alpha, beta);
  return (int)cudaGetLastError();
}

}  // namespace

// out[z] = alpha * C[z] + beta * (A[z] @ op(B[z])) for z < batch, on `stream`.
// A is (M, K) with rows lda floats apart; B is (N, K) (b_kmajor: op(B) = B^T)
// or (K, N), rows ldb floats apart; matrices stride_* floats apart. Base
// pointers and the strides of A and B must be 16-byte multiples (TMA).
// C may be null (plain matmul). With `symmetric` (M == N, the product and
// C symmetric) only the upper tiles are computed and mirrored.
// Returns cudaGetLastError() after the launch, or the negated CUresult when
// a tensor map cannot be encoded (-999: no cuTensorMapEncodeTiled).
extern "C" int ns_tc_gemm(const float* A, const float* B, const float* C, float* out,
                          int batch, int M, int N, int K,
                          long long lda, long long stride_a, long long ldb, long long stride_b,
                          int b_kmajor, long long ldc, long long stride_c,
                          long long ldo, long long stride_o, int symmetric,
                          float alpha, float beta, void* stream) {
  if (batch <= 0 || M <= 0 || N <= 0) return 0;
  if (encode_tiled() == nullptr) return -999;
  // TMA needs every global dimension >= 1; K = 0 loads nothing.
  const int kdim = K > 0 ? K : 1;
  CUtensorMap ma, mb;
  CUresult res = make_map(&ma, A, kdim, M, batch, lda, stride_a, BK, BM, true);
  if (res != CUDA_SUCCESS) return -(int)res;
  res = b_kmajor ? make_map(&mb, B, kdim, N, batch, ldb, stride_b, BK, BN, true)
                 : make_map(&mb, B, N, kdim, batch, ldb, stride_b, BN, BK, false);
  if (res != CUDA_SUCCESS) return -(int)res;
  const cudaStream_t s = (cudaStream_t)stream;
  return b_kmajor ? launch<true>(ma, mb, C, out, batch, M, N, K, ldc, stride_c, ldo, stride_o,
                                 symmetric, alpha, beta, s)
                  : launch<false>(ma, mb, C, out, batch, M, N, K, ldc, stride_c, ldo, stride_o,
                                  symmetric, alpha, beta, s);
}
