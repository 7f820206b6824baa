// Fused Newton-Schulz chain / iteration for Hopper (sm_90a), exact fp32.
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
// Design: each unit belongs to one thread-block cluster of `parts` blocks
// (1-8, chosen by the wrapper so that units spread evenly over the SMs),
// which loops over the steps. The Gram, the polynomial and the X/Y
// ping-pong live in a per-unit workspace in device memory that the wrapper
// allocates (2 m^2 + m n floats), where the TPU kernel kept them in VMEM,
// which an SM's 227 KB of shared memory cannot hold. Nor can the 50 MB L2:
// a 768 x 1536 block unit holds 9.4 MB, and 132 such units are live at once
// (two blocks an SM, two-block clusters), 1.25 GB, so the stages' operands
// stream from HBM. Each stage is a tiled GEMM (ns_gemm.cuh) whose tiles are dealt out
// to the cluster's blocks; a fence and a cluster barrier separate the
// stages. A and P are symmetric, so, as the reference's upper-triangular
// Gram tiles (fused.py:85-92), only their tiles on and above the diagonal
// are computed and then mirrored.
//
// Bound on the H100: per unit and step n m(m+1) + m^2(m+1) + 2 m^2 n flops
// (symmetric Gram and A^2, full update) on one read and one write of X, so
// the chain is bound by the 67 TFLOP/s fp32 rate. This design is simple
// rather than fast: 128 registers so two blocks share an SM (with some
// spilling), workspace in HBM, FFMA only, no tensor cores.

#include <cooperative_groups.h>

#include "ns_gemm.cuh"

namespace {

namespace cg = cooperative_groups;

// Orders every block's workspace writes of a stage before any block of the
// unit's cluster reads them in the next. The cluster barrier releases and
// acquires at cluster scope; the device-scope fence before it also covers
// the global-memory writes that other SMs of the cluster read.
__device__ __forceinline__ void stage_barrier(cg::cluster_group& cluster) {
  __threadfence();
  cluster.sync();
}

__global__ void __launch_bounds__(ns::THREADS, 2)
fused_chain_kernel(const float* x, float* out, float* work, int m, int n,
                   int steps, float a, float b, float c) {
  __shared__ ns::Smem sm;
  cg::cluster_group cluster = cg::this_cluster();
  const int parts = (int)cluster.num_blocks();
  const int part = (int)cluster.block_rank();
  const long long u = blockIdx.x / parts;
  const long long mn = (long long)m * n;
  const long long mm = (long long)m * m;
  float* gram = work + u * (2 * mm + mn);
  float* poly = gram + mm;
  float* tmp = poly + mm;
  const float* X = x + u * mn;
  float* O = out + u * mn;
  for (int s = 0; s < steps; ++s) {
    // The last step always lands in `out`; earlier ones alternate with tmp.
    float* Y = ((steps - 1 - s) % 2 == 0) ? O : tmp;
    // A = X X^T
    ns::block_gemm(X, n, X, n, true, nullptr, 0, gram, m, m, m, n, 0.f, 1.f, true,
                   part, parts, sm);
    stage_barrier(cluster);
    // P = b A + c A A
    ns::block_gemm(gram, m, gram, m, false, gram, m, poly, m, m, m, m, b, c, true,
                   part, parts, sm);
    stage_barrier(cluster);
    // Y = a X + P X
    ns::block_gemm(poly, m, X, n, false, X, n, Y, n, m, n, m, a, 1.f, false,
                   part, parts, sm);
    stage_barrier(cluster);
    X = Y;
  }
}

}  // namespace

// Run `steps` NS iterations on each of `batch` contiguous m x n fp32 units,
// each unit on a cluster of `parts` blocks (1, 2, 4 or 8). `work` holds
// batch * (2 m^2 + m n) floats. x and out must not alias.
// Returns the launch's error code, else cudaGetLastError().
extern "C" int ns_fused_chain(const float* x, float* out, float* work,
                              int batch, int m, int n, int steps, int parts,
                              float a, float b, float c, void* stream) {
  if (batch <= 0 || steps <= 0) return 0;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(batch * parts);
  config.blockDim = dim3(ns::THREADS);
  config.dynamicSmemBytes = 0;
  config.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = parts;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&config, fused_chain_kernel, x, out, work, m, n,
                                       steps, a, b, c);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
