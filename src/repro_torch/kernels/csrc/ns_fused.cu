// Fused Newton-Schulz chain / iteration for Hopper (sm_90a), on the 3xTF32
// tensor-core tile of ns_tc_gemm.cuh.
//
// Replaces the TPU kernels
//   repro/kernels/newton_schulz/fused.py:_fused_ns_chain_kernel  (all K steps, one launch)
//   repro/kernels/newton_schulz/fused.py:_fused_ns_kernel        (one step per launch)
// Both compute, per stacked unit X (m x n, m <= n, already transposed to the
// small side and normalised by the wrapper), `steps` iterations of
//     A = X X^T;  P = bA + cA^2;  Y = aX + PX.
// With steps = 1 per launch this kernel is the fused iteration; with
// steps = K it is the whole chain.
//
// Precision: every product is the tile routine's 3xTF32 sum (hi*hi + hi*lo + lo*hi
// of TF32 parts, promoted to an fp32 register sum every 128 k), fp32-grade
// like the tiled products of ns_matmul.cu, not bit-equal to an fp32 SGEMM.
//
// Bound on the H100: per unit and step n m(m+1) + m^2(m+1) + 2 m^2 n flops
// (symmetric Gram and A^2, full update), each done three times as TF32
// products at 495 TFLOP/s; the chain reads X once and writes Y once, so it
// is bound by tensor-core operations at every shape it serves.
//
// Design: each unit belongs to one thread-block cluster of `parts` blocks
// (1, 2, 4 or 8, chosen by the wrapper from the units and the stages' tile
// counts), one block an SM (the tile takes ~197 KB of shared memory and 256
// threads). The cluster loops over the steps and the three stages of each,
// and deals each stage's 128 x 128 output tiles out to its blocks, round
// robin; a block runs gemm_tile on its tiles one after another:
//   * Gram A = X X^T: the upper tiles only, A = B = X, both K-major;
//   * polynomial P = bA + cA^2: the upper tiles, A = B = A (K-major by
//     symmetry), C = A;
//   * update Y = aX + PX: every tile, A = P, B = X read N-major (the
//     transposed split), C = X.
// The symmetric stages mirror each tile, so A and P are exactly symmetric.
// The Gram, the polynomial and the Y ping-pong live in a workspace in
// device memory that the wrapper allocates, rows a multiple of 4 floats
// apart so that TMA can read them; Y alternates between `out` and `tmp`
// so that the last step lands in `out`. A stage's tiles of one unit run
// together on its cluster, so the operand panels that they share are read
// from L2 while they are hot; the units of other clusters share nothing,
// so the L2 holds the panels of only a few units' current tiles.
//
// Between stages, a block's epilogue has written the workspace with generic
// stores that the next stage reads with TMA (the async proxy) and, as C,
// with ld.global.cg from another SM: each thread fences its stores (device
// scope and proxy), then the cluster barrier releases and acquires them,
// and the producer fences the proxies again before its next TMA load. C is
// never read through the non-coherent path (no __restrict__, no
// ld.global.nc): inside one launch it was written a stage earlier.

#include <cooperative_groups.h>

#include "ns_tc_gemm.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace tc;

// Buffers of a unit stack read through TMA: 0 = x, 1 = out, 2 = tmp (X-like,
// m x n, rows ldx floats apart); the Gram and the polynomial (m x m, rows
// ldg apart).
struct ChainMaps {
  CUtensorMap xk[3];  // X-like buffers K-major: the Gram's A and B
  CUtensorMap xn[3];  // the same N-major: the update's B
  CUtensorMap gram;   // the polynomial's A and B
  CUtensorMap poly;   // the update's A
};

__device__ __forceinline__ void fence_proxy_global() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

// Orders every block's stage writes before any block of the unit's cluster
// reads them in the next stage (see the note at the top).
__device__ __forceinline__ void stage_barrier() {
  __threadfence();
  fence_proxy_global();
  asm volatile("barrier.cluster.arrive.release;\n\tbarrier.cluster.wait.acquire;" ::: "memory");
  fence_proxy_global();
}

__global__ void __launch_bounds__(THREADS, 1)
ns_chain_kernel(const __grid_constant__ ChainMaps maps, const float* x, float* out, float* tmp,
                float* gram, float* poly, int m, int n, long long ldx, long long ldg, int steps,
                float a, float b, float c) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  ring_init(smem);
  cg::cluster_group cluster = cg::this_cluster();
  const int parts = (int)cluster.num_blocks();
  const int part = (int)cluster.block_rank();
  const int z = blockIdx.x / parts;
  const int mt = (m + BM - 1) / BM, nt = (n + BN - 1) / BN;
  const int upper = mt * (mt + 1) / 2;
  // The stages' epilogues, in shared memory: the Gram, the polynomial, and
  // the update from x (into out or tmp, so that the last step lands in
  // out), from out (into tmp) and from tmp (into out).
  __shared__ Epilogue eps[5];
  if (threadIdx.x == 0) {
    const long long sx = (long long)m * ldx, sg = (long long)m * ldg;
    float* first = (steps - 1) % 2 == 0 ? out : tmp;
    eps[0] = Epilogue{nullptr, 0, 0, gram, ldg, sg, m, m, 1, 0.f, 1.f};
    eps[1] = Epilogue{gram, ldg, sg, poly, ldg, sg, m, m, 1, b, c};
    eps[2] = Epilogue{x, ldx, sx, first, ldx, sx, m, n, 0, a, 1.f};
    eps[3] = Epilogue{out, ldx, sx, tmp, ldx, sx, m, n, 0, a, 1.f};
    eps[4] = Epilogue{tmp, ldx, sx, out, ldx, sx, m, n, 0, a, 1.f};
  }
  __syncthreads();
  int src = 0;  // where X lies: 0 = x, 1 = out, 2 = tmp
  for (int s = 0; s < steps; ++s) {
    // A = X X^T, then P = b A + c A A: the upper tiles.
    for (int stage = 0; stage < 2; ++stage) {
      const CUtensorMap* map = stage == 0 ? &maps.xk[src] : &maps.gram;
      for (int t = part; t < upper; t += parts) {
        int bi, bj;
        upper_tile(t, mt, bi, bj);
        gemm_tile<true>(smem, TileJob{map, map, bi * BM, bj * BN, z, stage == 0 ? n : m},
                        eps[stage]);
      }
      stage_barrier();
    }
    // Y = a X + P X: every tile, column by column, so that the cluster's
    // blocks share each X column panel and P's row panels are reused from
    // one column to the next.
    for (int t = part; t < mt * nt; t += parts)
      gemm_tile<false>(smem, TileJob{&maps.poly, &maps.xn[src], (t % mt) * BM, (t / mt) * BN, z, m},
                       eps[2 + src]);
    if (s + 1 < steps) stage_barrier();
    // The last step lands in `out`; earlier ones alternate with tmp.
    src = (steps - 1 - s) % 2 == 0 ? 1 : 2;
  }
}

}  // namespace

// Run `steps` NS iterations on each of `batch` m x n fp32 units of `x`
// (rows ldx floats apart, units m * ldx apart; ldx % 4 == 0 and x 16-byte
// aligned), each unit on a cluster of `parts` blocks (1, 2, 4 or 8), into
// `out` (same layout). `tmp` holds batch * m * ldx floats (null when
// steps == 1), `gram` and `poly` batch * m * ldg floats each
// (ldg % 4 == 0, ldg >= m). x must not alias out or the workspace.
// Returns cudaGetLastError() after the launch, the launch's own error, or
// the negated CUresult when a tensor map cannot be encoded (-999: no
// cuTensorMapEncodeTiled).
extern "C" int ns_fused_chain(const float* x, float* out, float* tmp, float* gram, float* poly,
                              int batch, int m, int n, long long ldx, long long ldg, int steps,
                              int parts, float a, float b, float c, void* stream) {
  if (batch <= 0 || steps <= 0 || m <= 0) return 0;
  if (encode_tiled() == nullptr) return -999;
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        ns_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  ChainMaps maps;
  const float* bufs[3] = {x, out, tmp == nullptr ? out : tmp};
  const long long sx = (long long)m * ldx, sg = (long long)m * ldg;
  CUresult res = CUDA_SUCCESS;
  for (int i = 0; i < 3 && res == CUDA_SUCCESS; ++i) {
    res = make_kmajor_map(&maps.xk[i], bufs[i], n, m, batch, ldx, sx);
    if (res == CUDA_SUCCESS) res = make_nmajor_map(&maps.xn[i], bufs[i], m, n, batch, ldx, sx);
  }
  if (res == CUDA_SUCCESS) res = make_kmajor_map(&maps.gram, gram, m, m, batch, ldg, sg);
  if (res == CUDA_SUCCESS) res = make_kmajor_map(&maps.poly, poly, m, m, batch, ldg, sg);
  if (res != CUDA_SUCCESS) return -(int)res;

  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(batch * parts);
  config.blockDim = dim3(THREADS);
  config.dynamicSmemBytes = SMEM_BYTES;
  config.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = parts;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&config, ns_chain_kernel, maps, x, out, tmp, gram,
                                             poly, m, n, ldx, ldg, steps, a, b, c);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
