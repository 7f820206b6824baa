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
// Design (one 128 x 128 output tile a block, 256 threads; the tile is
// ns_tc_gemm.cuh's gemm_tile, shared with the fused chain of ns_fused.cu):
//  * Thread 0 keeps TMA loads of the A and B slices (BK = 32 fp32, one
//    128-byte swizzle row) in flight into a ring of 3-4 stages, reporting
//    completion on mbarriers, and refills a stage as soon as the block has
//    split the next slice; ragged M, N and K are zero-filled by TMA, so the
//    loop needs no masks.
//  * Two warpgroups, 64 rows each. Each splits its rows of the A
//    slice into hi and lo registers (wgmma's A operand), and both split the
//    B slice into hi and lo tiles in shared memory (a K-major B in place;
//    an N-major B, the update's X, transposed into the K-major layout TF32
//    wgmma requires); then each issues three m64n128k8 wgmmas a k8 step.
//    The split of the next slice runs while the current wgmmas are in
//    flight, and the wgmmas of consecutive slices queue back to back: the
//    tensor cores drain only at the end of a group of PROMOTE slices. A
//    from registers keeps A's hi and lo tiles out of shared memory, which
//    the three products' operand reads load heavily. With 256 threads and
//    one block an SM, a thread may hold 255 registers: the accumulator, its
//    fp32 sum and two slices of A fragments fit without spilling.
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

#include "ns_tc_gemm.cuh"

namespace {

using namespace tc;

template <bool B_KMAJOR>
__global__ void __launch_bounds__(THREADS, 1)
tc_gemm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
               const __grid_constant__ Epilogue ep, int K) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  ring_init(smem);
  __syncthreads();
  int m0, n0;
  if (ep.symmetric) {  // upper tile blockIdx.x, row by row
    int bi, bj;
    upper_tile(blockIdx.x, (ep.N + BN - 1) / BN, bi, bj);
    m0 = bi * BM;
    n0 = bj * BN;
  } else {
    m0 = blockIdx.y * BM;
    n0 = blockIdx.x * BN;
  }
  gemm_tile<B_KMAJOR>(smem, TileJob{&map_a, &map_b, m0, n0, (int)blockIdx.z, K}, ep);
}

template <bool B_KMAJOR>
int launch(const CUtensorMap& ma, const CUtensorMap& mb, const Epilogue& ep, int batch, int K,
           cudaStream_t stream) {
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        tc_gemm_kernel<B_KMAJOR>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  const int mt = (ep.M + BM - 1) / BM, nt = (ep.N + BN - 1) / BN;
  const dim3 grid = ep.symmetric ? dim3(nt * (nt + 1) / 2, 1, batch) : dim3(nt, mt, batch);
  tc_gemm_kernel<B_KMAJOR><<<grid, THREADS, SMEM_BYTES, stream>>>(ma, mb, ep, K);
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
  CUresult res = make_kmajor_map(&ma, A, kdim, M, batch, lda, stride_a);
  if (res != CUDA_SUCCESS) return -(int)res;
  res = b_kmajor ? make_kmajor_map(&mb, B, kdim, N, batch, ldb, stride_b)
                 : make_nmajor_map(&mb, B, kdim, N, batch, ldb, stride_b);
  if (res != CUDA_SUCCESS) return -(int)res;
  const Epilogue ep = {C, ldc, stride_c, out, ldo, stride_o, M, N, symmetric, alpha, beta};
  const cudaStream_t s = (cudaStream_t)stream;
  return b_kmajor ? launch<true>(ma, mb, ep, batch, K, s) : launch<false>(ma, mb, ep, batch, K, s);
}
