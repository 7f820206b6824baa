// NorMuon neuron-wise second-moment normalization for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel
//   repro/kernels/normuon.py:_neuron_norm_kernel  (math in _norm_math)
// which, per row of each stacked (m, n) matrix of x (B, m, n), computes
//   on a refresh:  v <- beta2 * v + (1 - beta2) * sum(x^2) / n
//   every call:    y = x / (sqrt(v / corr) + eps)
// with v the row statistics (B, m, 1) and corr the bias correction, a scalar.
//
// What changed from the TPU design: the TPU kernel held a whole zero-padded
// (8 x 128-aligned) matrix in VMEM a grid step and carried v in column 0 of
// a 128-lane block. Here one block owns one row: nothing is padded, the
// ragged row end is masked by the loop bound, and v stays (B, m, 1). The
// padding never changed the result, because the mean divides by the true n.
//
// Bound on the H100: HBM bytes. The kernel reads x once and writes y once,
// 8 bytes an element, plus 4 (apply) or 8 (refresh) bytes a row for v; it
// does 2 flops an element for the sum and one division for the output, far
// below the fp32 rate. The design is simple: one block a row (B m blocks,
// 73,728 on the largest main-path leaf), float4 loads where n % 4 == 0 and
// the rows are 16-byte aligned. On a refresh the block reduces its row's
// sum of squares over warp shuffles and shared memory, one thread forms v
// and the denominator and shares them, and the block then reads its row a
// second time to write y. That second read finds the row in L2: a
// 6144-float row is 24 KB, and only the rows of the blocks in flight are
// live. An apply-only call reads the row once.
//
// Rounding: true division and square root, and every product and sum
// rounded on its own (__fmul_rn / __fadd_rn are never contracted into an
// FMA), as the plain PyTorch version rounds; only the order of the row sum
// differs from it. The build uses no --use_fast_math.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_THREADS = 256;

template <bool REFRESH, bool VEC>
__global__ void __launch_bounds__(MAX_THREADS)
neuron_norm_kernel(const float* __restrict__ x, const float* __restrict__ v,
                   float* __restrict__ y, float* __restrict__ v_out, int n,
                   float beta2, float one_minus_beta2, float inv_n, float corr,
                   float eps) {
  const long long row = blockIdx.x;
  const float* xr = x + row * n;
  float* yr = y + row * n;
  const int nv = VEC ? n / 4 : n;
  float denom;
  if (REFRESH) {
    __shared__ float warp_sums[MAX_THREADS / 32];
    __shared__ float shared_denom;
    float acc = 0.f;
    for (int i = threadIdx.x; i < nv; i += blockDim.x) {
      if (VEC) {
        const float4 q = reinterpret_cast<const float4*>(xr)[i];
        acc = __fadd_rn(acc, __fmul_rn(q.x, q.x));
        acc = __fadd_rn(acc, __fmul_rn(q.y, q.y));
        acc = __fadd_rn(acc, __fmul_rn(q.z, q.z));
        acc = __fadd_rn(acc, __fmul_rn(q.w, q.w));
      } else {
        const float q = xr[i];
        acc = __fadd_rn(acc, __fmul_rn(q, q));
      }
    }
    for (int off = 16; off > 0; off >>= 1)
      acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
    if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      float sum = 0.f;
      for (int w = 0; w < (int)(blockDim.x >> 5); ++w) sum = __fadd_rn(sum, warp_sums[w]);
      const float vn = __fadd_rn(__fmul_rn(beta2, v[row]),
                                 __fmul_rn(one_minus_beta2, __fmul_rn(sum, inv_n)));
      v_out[row] = vn;
      shared_denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(vn, corr)), eps);
    }
    __syncthreads();
    denom = shared_denom;
  } else {
    denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(v[row], corr)), eps);
  }
  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
    if (VEC) {
      float4 q = reinterpret_cast<const float4*>(xr)[i];
      q.x = __fdiv_rn(q.x, denom);
      q.y = __fdiv_rn(q.y, denom);
      q.z = __fdiv_rn(q.z, denom);
      q.w = __fdiv_rn(q.w, denom);
      reinterpret_cast<float4*>(yr)[i] = q;
    } else {
      yr[i] = __fdiv_rn(xr[i], denom);
    }
  }
}

template <bool REFRESH>
void launch(bool vec, int rows, int threads, const float* x, const float* v, float* y,
            float* v_out, int n, float beta2, float one_minus_beta2, float inv_n,
            float corr, float eps, cudaStream_t stream) {
  if (vec)
    neuron_norm_kernel<REFRESH, true><<<rows, threads, 0, stream>>>(
        x, v, y, v_out, n, beta2, one_minus_beta2, inv_n, corr, eps);
  else
    neuron_norm_kernel<REFRESH, false><<<rows, threads, 0, stream>>>(
        x, v, y, v_out, n, beta2, one_minus_beta2, inv_n, corr, eps);
}

}  // namespace

// y = x / (sqrt(v' / corr) + eps) row by row over `rows` contiguous rows of
// n floats, with v' = beta2 v + (1 - beta2) sum(x^2) inv_n written to v_out
// when `refresh` is set, else v' = v (v_out unused). `one_minus_beta2` and
// `inv_n` are passed as the caller rounds them to fp32. `vec` asks for
// float4 access (n % 4 == 0 and x, y 16-byte aligned). Launches on `stream`;
// returns cudaGetLastError() after the launch.
extern "C" int normuon_rows(const float* x, const float* v, float* y, float* v_out,
                            int rows, int n, int refresh, int vec, float beta2,
                            float one_minus_beta2, float inv_n, float corr, float eps,
                            void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  // Whole warps for about four items (float4s where vec) a thread, 32-256
  // threads: n = 6144 -> 256 threads, 1536 -> 96, 384 -> 32.
  const int items = vec ? n / 4 : n;
  int threads = ((items + 3) / 4 + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > MAX_THREADS ? MAX_THREADS : threads);
  if (refresh)
    launch<true>(vec != 0, rows, threads, x, v, y, v_out, n, beta2, one_minus_beta2,
                 inv_n, corr, eps, (cudaStream_t)stream);
  else
    launch<false>(vec != 0, rows, threads, x, v, y, v_out, n, beta2, one_minus_beta2,
                  inv_n, corr, eps, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
