// The band plan's entries and the second pass of a chunked dW reduction,
// shared by the band conv's kernels (band_conv.cu: K1; band_conv_bwd.cu:
// K2, K3) and the windowed dW (windowed_gather.cu: K5).
//
// BandRows applies the band plan's window predicate: for t = column * kz + dz,
//
//     j = rbt[i, t],  live = j >= 0 && 0 <= j - w0[t / kz, i / block] < window
//
// so the kernels drop exactly the entries the plan's overflow list holds,
// as the TPU kernels do (band_conv.py:_overflow_residual / _overflow_dw add
// them back).

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace band {

constexpr int kReduceThreads = 256;

// The band plan's entries: the in-window input row of (i, t), or -1.
struct BandRows {
  const int* rbt;  // (npad, k3)
  const int* w0;   // (k3 / kz, nblocks)
  int n, k3, kz, nblocks, block, window;

  __device__ __forceinline__ int operator()(int i, int t) const {
    if (i >= n) return -1;
    int j = rbt[(size_t)i * k3 + t];
    if (j >= 0) {
      const int pos = j - w0[(t / kz) * nblocks + i / block];
      if (pos < 0 || pos >= window) j = -1;
    }
    return j;
  }
};

// out[e] = sum_s partial[s, e] over the nchunks partials, in chunk order:
// the second, fixed-order pass of a dW reduction, so that dW is
// deterministic.
__global__ void __launch_bounds__(kReduceThreads)
reduce_partials(const float* __restrict__ partial, float* __restrict__ out,
                long long total, int nchunks) {
  for (long long e = (long long)blockIdx.x * kReduceThreads + threadIdx.x; e < total;
       e += (long long)gridDim.x * kReduceThreads) {
    float s = 0.f;
    for (int c = 0; c < nchunks; ++c) s += partial[(size_t)c * total + e];
    out[e] = s;
  }
}

inline int launch_reduce(const float* partial, float* out, long long total,
                         int nchunks, cudaStream_t stream) {
  const long long want = (total + kReduceThreads - 1) / kReduceThreads;
  const int grid = (int)(want < 65535 ? want : 65535);
  reduce_partials<<<grid, kReduceThreads, 0, stream>>>(partial, out, total, nchunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace band
