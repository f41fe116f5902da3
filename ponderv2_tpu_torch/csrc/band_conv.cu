// Block-banded submanifold conv forward (the band conv's K1) for Hopper.
//
// Replaces the Pallas TPU kernel ponderv2_tpu/ops/band_conv.py:_fwd_kernel
// (launched by _fwd_core). It computes the same function, not the TPU
// blocking: for output row i and tap t (t = column * kz + dz),
//
//     j = rbt[i, t],  pos = j - w0[t / kz, i / block]
//     out[i] += feats[j] @ W[t]   if j >= 0 and 0 <= pos < window
//
// accumulated in f32. Entries outside the window are dropped here exactly as
// the TPU kernel drops them; the caller adds them back from the plan's
// overflow list (band_conv.py:_overflow_residual). The TPU kernel's one-hot
// matmul that selects window rows becomes a direct read of row j, and the
// 8-aligned window survives only as the predicate above.
//
// What bounds it on an H100: the gather of 64 input rows per tap (random
// 128-1024 B rows, served mostly by L2 because rows of nearby outputs are
// nearby in the key-sorted input) and the CUDA-core FMA rate: this first
// version uses no tensor cores. Design: one CTA per 64 output rows x 64
// output channels; per tap it stages the 64 gathered rows (zero where the
// tap is inactive or out of window) and the W[t] slice in shared memory in
// chunks of 32 input channels, and each thread accumulates a 4x4 f32 tile in
// registers. A tap whose 64 rows are all inactive is skipped with one
// barrier vote, which removes most of the work on sparse surfaces.
//
// Plain C interface for ctypes: every launcher returns the cudaError_t of
// cudaGetLastError() right after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int BM = 64;       // output rows per CTA
constexpr int BN = 64;       // output channels per CTA
constexpr int BK = 32;       // input channels per shared-memory chunk
constexpr int THREADS = 256; // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
band_fwd_kernel(const T* __restrict__ feats, const int* __restrict__ rbt,
                const int* __restrict__ w0, const T* __restrict__ wts,
                float* __restrict__ out, int n, int cin, int cout, int k3,
                int kz, int nblocks, int block, int window) {
  __shared__ float As[BK][BM + 1];  // gathered rows, channel-major; +1 pad
  __shared__ float Bs[BK][BN];      // W[t] chunk
  __shared__ int rows[BM];          // input row per output row, -1 = none

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

  for (int t = 0; t < k3; ++t) {
    int live = 0;
    if (tid < BM) {
      const int i = row0 + tid;
      int j = -1;
      if (i < n) {
        j = rbt[(size_t)i * k3 + t];
        if (j >= 0) {
          const int pos = j - w0[(t / kz) * nblocks + i / block];
          if (pos < 0 || pos >= window) j = -1;
        }
      }
      rows[tid] = j;
      live = j >= 0;
    }
    // uniform across the CTA: skip taps with no live row in this tile
    if (!__syncthreads_or(live)) continue;

    const T* wt = wts + (size_t)t * cin * cout;
    for (int k0 = 0; k0 < cin; k0 += BK) {
      // a warp reads 32 consecutive channels of one gathered row
      for (int e = tid; e < BM * BK; e += THREADS) {
        const int m = e / BK;
        const int k = e % BK;
        const int j = rows[m];
        float v = 0.f;
        if (j >= 0 && k0 + k < cin) v = to_float(feats[(size_t)j * cin + k0 + k]);
        As[k][m] = v;
      }
      for (int e = tid; e < BK * BN; e += THREADS) {
        const int k = e / BN;
        const int c = e % BN;
        float v = 0.f;
        if (k0 + k < cin && col0 + c < cout)
          v = to_float(wt[(size_t)(k0 + k) * cout + col0 + c]);
        Bs[k][c] = v;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < BK; ++k) {
        float a[4], b[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) a[q] = As[k][ty + 16 * q];
#pragma unroll
        for (int q = 0; q < 4; ++q) b[q] = Bs[k][tx + 16 * q];
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(a[p], b[q], acc[p][q]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int r = row0 + ty + 16 * p;
    if (r >= n) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = col0 + tx + 16 * q;
      if (c < cout) out[(size_t)r * cout + c] = acc[p][q];
    }
  }
}

template <typename T>
int launch(const void* feats, const void* rbt, const void* w0, const void* wts,
           void* out, int n, int cin, int cout, int k3, int kz, int nblocks,
           int block, int window, void* stream) {
  const dim3 grid((n + BM - 1) / BM, (cout + BN - 1) / BN);
  band_fwd_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(feats), static_cast<const int*>(rbt),
      static_cast<const int*>(w0), static_cast<const T*>(wts),
      static_cast<float*>(out), n, cin, cout, k3, kz, nblocks, block, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int band_fwd_f32(const void* feats, const void* rbt, const void* w0,
                 const void* wts, void* out, int n, int cin, int cout, int k3,
                 int kz, int nblocks, int block, int window, void* stream) {
  return launch<float>(feats, rbt, w0, wts, out, n, cin, cout, k3, kz, nblocks,
                       block, window, stream);
}

int band_fwd_bf16(const void* feats, const void* rbt, const void* w0,
                  const void* wts, void* out, int n, int cin, int cout, int k3,
                  int kz, int nblocks, int block, int window, void* stream) {
  return launch<__nv_bfloat16>(feats, rbt, w0, wts, out, n, cin, cout, k3, kz,
                               nblocks, block, window, stream);
}

const char* band_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
