// Tiled Newton-Schulz matmul and fma_matmul for Hopper (sm_90a), exact fp32.
//
// Replaces the TPU kernels
//   repro/kernels/newton_schulz/newton_schulz.py:_matmul_kernel      (X @ Y)
//   repro/kernels/newton_schulz/newton_schulz.py:_fma_matmul_kernel  (alpha*C + beta*(X @ Y))
// which ops.ns_iteration chains three times per NS step (A = X X^T,
// P = bA + cA^2, Y = aX + PX).
//
// Differences from the TPU design:
//  * The stack dimension is grid axis z: one launch covers a whole bucket,
//    where the reference unrolled the stack in Python, one 3-launch chain per
//    matrix (ops.py:96-101).
//  * Ragged edges are masked inside the kernel instead of zero-padding the
//    operands through device memory.
//  * The Gram product reads X twice (trans_b) instead of materialising X^T.
//
// Bound on the H100: at the full-phase shapes (1536 x 6144 units, 1536^2
// Grams) each product does ~2*M*N*K flops on M*K + K*N + M*N floats, far
// above the fp32 ridge point, so it is bound by the 67 TFLOP/s non-tensor-core
// fp32 rate. The design is simple rather than fast: a 128x128x8 tile per
// block, double-buffered through registers, float4 shared reads, two blocks
// an SM, FFMA only (no TF32 wgmma, no TMA), so it reaches about half of that
// rate on a general product. Every tile of a Gram is computed, though the
// upper half would do, so a Gram takes twice the least work and reaches
// about a quarter of its bound. Faster tiles are later work; agreement with
// the plain fp32 product comes first.

#include "ns_gemm.cuh"

namespace {

__global__ void __launch_bounds__(ns::THREADS, 2)
gemm_batched_kernel(const float* A, const float* B, const float* C, float* out,
                    int M, int N, int K,
                    long long stride_a, long long stride_b, long long stride_c,
                    long long stride_o,
                    int lda, int ldb, int ldc, int ldo, int trans_b,
                    float alpha, float beta) {
  __shared__ ns::Smem sm;
  const long long z = blockIdx.z;
  ns::gemm_tile(A + z * stride_a, lda, B + z * stride_b, ldb, trans_b != 0,
                C == nullptr ? nullptr : C + z * stride_c, ldc,
                out + z * stride_o, ldo, M, N, K,
                blockIdx.y * ns::BM, blockIdx.x * ns::BN, alpha, beta, false, sm);
}

}  // namespace

// out[z] = alpha * C[z] + beta * (A[z] @ op(B[z])) for z < batch, on `stream`.
// C may be null (plain matmul). Returns cudaGetLastError() after the launch.
extern "C" int ns_gemm_batched(const float* A, const float* B, const float* C,
                               float* out, int batch, int M, int N, int K,
                               long long stride_a, long long stride_b,
                               long long stride_c, long long stride_o,
                               int lda, int ldb, int ldc, int ldo, int trans_b,
                               float alpha, float beta, void* stream) {
  if (batch <= 0 || M <= 0 || N <= 0) return 0;
  dim3 grid((N + ns::BN - 1) / ns::BN, (M + ns::BM - 1) / ns::BM, batch);
  gemm_batched_kernel<<<grid, ns::THREADS, 0, (cudaStream_t)stream>>>(
      A, B, C, out, M, N, K, stride_a, stride_b, stride_c, stride_o,
      lda, ldb, ldc, ldo, trans_b, alpha, beta);
  return (int)cudaGetLastError();
}
