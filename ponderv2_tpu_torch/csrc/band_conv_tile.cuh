// Device tiles shared by the windowed gather-GEMM kernels: the band conv
// (band_conv.cu: K1; band_conv_bwd.cu: K2, K3) and the windowed conv
// (windowed_gather.cu: K4, K5). A tile reads its tap entries through a
// functor ``rows(i, t)`` that returns the input row j of output row i and
// tap t, or -1 where the entry is absent or outside its window. The band
// plan's functor (BandRows) applies, for t = column * kz + dz,
//
//     j = rbt[i, t],  live = j >= 0 && 0 <= j - w0[t / kz, i / block] < window
//
// so the kernels drop exactly the entries the plan's overflow list holds,
// as the TPU kernels do (band_conv.py:_overflow_residual / _overflow_dw add
// them back). Every tile is 256 threads, 16 x 16, each accumulating a 4 x 4
// f32 block in registers on CUDA cores.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace band {

constexpr int BM = 64;        // rows (fwd) or input channels (dW) per CTA
constexpr int BN = 64;        // output channels per CTA
constexpr int BK = 32;        // reduction chunk staged in shared memory
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

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

// out[row0 : row0 + 64, col0 : col0 + 64] = sum_t feats[rows(i, t)] @ W[t]
// over live entries. Per tap it stages the 64 gathered rows (zero where
// the entry is not live) and the W[t] slice in shared memory in chunks of 32
// input channels; a tap whose 64 rows are all dead is skipped with one
// barrier vote, which removes most of the work on sparse surfaces.
template <typename T, typename Rows>
__device__ __forceinline__ void fwd_tile(
    const T* __restrict__ feats, const Rows& rows_of, const T* __restrict__ wts,
    float* __restrict__ out, int n, int cin, int cout, int k3, int row0,
    int col0) {
  __shared__ float As[BK][BM + 1];  // gathered rows, channel-major; +1 pad
  __shared__ float Bs[BK][BN];      // W[t] chunk
  __shared__ int rows[BM];          // input row per output row, -1 = none

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

  for (int t = 0; t < k3; ++t) {
    int live = 0;
    if (tid < BM) {
      const int j = row0 + tid < n ? rows_of(row0 + tid, t) : -1;
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

// part[ci0 : ci0 + 64, co0 : co0 + 64] = sum over rows i in [r_begin, r_end)
// of a[i']^T b[i''] over the live entries j = rows(i, t), staged 32 rows at a
// time. GATHER_A False: a row i, b row j (the band dW: f[i]^T g[j]); True:
// a row j, b row i (the windowed dW: x[j]^T g[i]).
template <typename T, bool GATHER_A, typename Rows>
__device__ __forceinline__ void dw_tile(
    const T* __restrict__ a, const T* __restrict__ b, const Rows& rows_of,
    float* __restrict__ part, int cin, int cout, int t, int ci0, int co0,
    int r_begin, int r_end) {
  __shared__ float Fs[BK][BM];  // a rows, row-major
  __shared__ float Gs[BK][BN];  // b rows
  __shared__ int rows[BK];      // the entry's input row, -1 = none

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  float acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.f;

  for (int r0 = r_begin; r0 < r_end; r0 += BK) {
    int live = 0;
    if (tid < BK) {
      const int i = r0 + tid;
      const int j = i < r_end ? rows_of(i, t) : -1;
      rows[tid] = j;
      live = j >= 0;
    }
    // uniform across the CTA: skip 32-row steps with no live entry
    if (!__syncthreads_or(live)) continue;

    for (int e = tid; e < BK * BM; e += THREADS) {
      const int r = e / BM;
      const int c = e % BM;
      const int j = rows[r];
      float v = 0.f;
      if (j >= 0 && ci0 + c < cin)
        v = to_float(a[(size_t)(GATHER_A ? j : r0 + r) * cin + ci0 + c]);
      Fs[r][c] = v;
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int r = e / BN;
      const int c = e % BN;
      const int j = rows[r];
      float v = 0.f;
      if (j >= 0 && co0 + c < cout)
        v = to_float(b[(size_t)(GATHER_A ? r0 + r : j) * cout + co0 + c]);
      Gs[r][c] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < BK; ++r) {
      float av[4], bv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) av[q] = Fs[r][ty + 16 * q];
#pragma unroll
      for (int q = 0; q < 4; ++q) bv[q] = Gs[r][tx + 16 * q];
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(av[p], bv[q], acc[p][q]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int ci = ci0 + ty + 16 * p;
    if (ci >= cin) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int co = co0 + tx + 16 * q;
      if (co < cout) part[(size_t)ci * cout + co] = acc[p][q];
    }
  }
}

// out[e] = sum_s partial[s, e] over the nchunks partials, in chunk order:
// the second, fixed-order pass of a dW reduction, so that dW is
// deterministic.
__global__ void __launch_bounds__(THREADS)
reduce_partials(const float* __restrict__ partial, float* __restrict__ out,
                long long total, int nchunks) {
  for (long long e = (long long)blockIdx.x * THREADS + threadIdx.x; e < total;
       e += (long long)gridDim.x * THREADS) {
    float s = 0.f;
    for (int c = 0; c < nchunks; ++c) s += partial[(size_t)c * total + e];
    out[e] = s;
  }
}

inline int launch_reduce(const float* partial, float* out, long long total,
                         int nchunks, cudaStream_t stream) {
  const long long want = (total + THREADS - 1) / THREADS;
  const int grid = (int)(want < 65535 ? want : 65535);
  reduce_partials<<<grid, THREADS, 0, stream>>>(partial, out, total, nchunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace band
