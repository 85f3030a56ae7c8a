// The order in which the tensor-core varlen kernels (flash_varlen_fwd.cu,
// flash_varlen_bwd.cu) start their tiles: longest range first, so that
// the tiles at the end of long documents, which walk ~30 tiles each, start
// in the first wave of CTAs instead of running alone in the last one.
//
// order[rank_i] = i with rank_i = #{j : w_j > w_i} + #{j < i : w_j == w_i}
// and w = hi - lo: a stable descending order of the range lengths,
// computed by counting comparisons, one thread per tile (n^2 compares over
// n threads; ~5 us on the H100 for the 256 tiles of 16,384 tokens). No
// atomics: every run gives the same order. The C entries launch it on the
// caller's stream right before the kernel that reads it; the order only
// changes when tiles start, never what they compute.

#pragma once

#include <cuda_runtime.h>

namespace varlen_order {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) longest_first_kernel(
    const int* __restrict__ lo, const int* __restrict__ hi, int n,
    int* __restrict__ order) {
  __shared__ int w_s[kThreads];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int wi = i < n ? hi[i] - lo[i] : 0;
  int rank = 0;
  for (int j0 = 0; j0 < n; j0 += kThreads) {
    __syncthreads();  // the previous chunk is read by every thread
    const int j = j0 + threadIdx.x;
    if (j < n) w_s[threadIdx.x] = hi[j] - lo[j];
    __syncthreads();
    const int m = min(kThreads, n - j0);
    for (int jj = 0; jj < m; ++jj) {
      const int wj = w_s[jj];
      rank += wj > wi || (wj == wi && j0 + jj < i);
    }
  }
  if (i < n) order[rank] = i;
}

// the order of n tiles with ranges [lo, hi) into `order` (n int32)
inline cudaError_t longest_first(const int* lo, const int* hi, int n,
                                 int* order, cudaStream_t stream) {
  longest_first_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                         stream>>>(lo, hi, n, order);
  return cudaGetLastError();
}

}  // namespace varlen_order
