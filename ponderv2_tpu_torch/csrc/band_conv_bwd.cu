// Block-banded submanifold conv backward (the band conv's K2 and K3) for
// Hopper.
//
// Replaces the Pallas TPU kernels ponderv2_tpu/ops/band_conv.py:_dxdw_kernel
// (K2, the fused backward, call at :478) and :_dw_kernel (K3, the split dW,
// call at :510). With the subm tap symmetry (tap t on outputs is tap
// mirror(t) = k3-1-t on inputs) both are sums over the same in-window
// entries (i, t), j = rbt[i, t], as K1 (band_conv_tile.cuh:window_row):
//
//     dx[i]  += g[j] @ Wm[t]            Wm[t] = W[mirror t]^T  (K2 only)
//     dwr[t] += f[i]^T g[j]             dwr[t] = dW[mirror t]  (K2 and K3)
//
// accumulated in f32; the caller un-mirrors dwr and adds the overflow
// entries (_overflow_residual, _overflow_dw) and the plan's ok gate.
//
// The TPU reduced dW over the sequential grid in a VMEM-resident
// accumulator. Here blocks run in parallel, so dW is a two-pass reduction:
// each dW CTA owns (row chunk s, tap t, 64 input x 64 output channels),
// accumulates over its chunk's rows in registers, and writes a partial to
// (S, k3, cin, cout) f32 scratch; band_dw_reduce sums the S partials. No
// atomics, so dW is deterministic. The TPU fused dx and dW into one kernel
// so that one one-hot extraction of g served both; on Hopper a gather is a
// direct read, so K2 is one launch whose CTAs split into two ranges: the
// first runs K1's tile over g with Wm (dx), the rest run the dW tile for all
// 27 taps. A CTA that shares its gathered g rows between dx and dW, and
// tensor cores, are later work.
//
// What bounds them on an H100: as K1, the CUDA-core FMA rate (no tensor
// cores) and the gathered g rows (random 128-1024 B reads, mostly from L2);
// dW CTAs skip each 32-row step whose tap entries are all dead with one
// barrier vote, so padding rows and empty taps cost a vote, not FMAs.
//
// Plain C interface for ctypes: every launcher returns the cudaError_t of
// cudaGetLastError() after each launch.

#include "band_conv_tile.cuh"

namespace {

using band::BK;
using band::BM;
using band::BN;
using band::THREADS;

// part[ci0 : ci0 + 64, co0 : co0 + 64] = sum over rows i in [r_begin, r_end)
// of f[i]^T g[rbt[i, t]] (in-window entries), staged 32 rows at a time.
template <typename T>
__device__ __forceinline__ void dw_tile(
    const T* __restrict__ f, const T* __restrict__ g,
    const int* __restrict__ rbt, const int* __restrict__ w0,
    float* __restrict__ part, int n, int cin, int cout, int k3, int kz,
    int nblocks, int block, int window, int t, int ci0, int co0, int r_begin,
    int r_end) {
  __shared__ float Fs[BK][BM];  // feature rows, row-major
  __shared__ float Gs[BK][BN];  // gathered cotangent rows
  __shared__ int rows[BK];      // cotangent row per feature row, -1 = none

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

  for (int r0 = r_begin; r0 < r_end; r0 += BK) {
    int live = 0;
    if (tid < BK) {
      const int i = r0 + tid;
      const int j = i < r_end ? band::window_row(rbt, w0, i, t, n, k3, kz,
                                                 nblocks, block, window)
                              : -1;
      rows[tid] = j;
      live = j >= 0;
    }
    // uniform across the CTA: skip 32-row steps with no live entry
    if (!__syncthreads_or(live)) continue;

    for (int e = tid; e < BK * BM; e += THREADS) {
      const int r = e / BM;
      const int c = e % BM;
      float v = 0.f;
      if (rows[r] >= 0 && ci0 + c < cin)
        v = band::to_float(f[(size_t)(r0 + r) * cin + ci0 + c]);
      Fs[r][c] = v;
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int r = e / BN;
      const int c = e % BN;
      const int j = rows[r];
      float v = 0.f;
      if (j >= 0 && co0 + c < cout)
        v = band::to_float(g[(size_t)j * cout + co0 + c]);
      Gs[r][c] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < BK; ++r) {
      float a[4], b[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) a[q] = Fs[r][ty + 16 * q];
#pragma unroll
      for (int q = 0; q < 4; ++q) b[q] = Gs[r][tx + 16 * q];
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(a[p], b[q], acc[p][q]);
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

// dW CTA number b of nchunks * k3 * ceil(cin / 64) * ceil(cout / 64):
// consecutive CTAs share (s, t) and so read the same g rows from L2.
template <typename T>
__device__ __forceinline__ void dw_cta(
    const T* __restrict__ f, const T* __restrict__ g,
    const int* __restrict__ rbt, const int* __restrict__ w0,
    float* __restrict__ partial, int n, int cin, int cout, int k3, int kz,
    int nblocks, int block, int window, int chunk, int b) {
  const int nco = (cout + BN - 1) / BN;
  const int nci = (cin + BM - 1) / BM;
  const int tco = b % nco;
  b /= nco;
  const int tci = b % nci;
  b /= nci;
  const int t = b % k3;
  const int s = b / k3;
  const int r_begin = s * chunk;
  const int r_end = min(n, r_begin + chunk);
  dw_tile<T>(f, g, rbt, w0, partial + ((size_t)s * k3 + t) * cin * cout, n, cin,
             cout, k3, kz, nblocks, block, window, t, tci * BM, tco * BN,
             r_begin, r_end);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
band_dw_kernel(const T* __restrict__ f, const T* __restrict__ g,
               const int* __restrict__ rbt, const int* __restrict__ w0,
               float* __restrict__ partial, int n, int cin, int cout, int k3,
               int kz, int nblocks, int block, int window, int chunk) {
  dw_cta<T>(f, g, rbt, w0, partial, n, cin, cout, k3, kz, nblocks, block,
            window, chunk, blockIdx.x);
}

// K2: CTAs [0, ndx) compute dx tiles (K1's tile over g with Wm), the rest
// dW partials. The branch is uniform per CTA.
template <typename T>
__global__ void __launch_bounds__(THREADS)
band_dxdw_kernel(const T* __restrict__ g, const T* __restrict__ f,
                 const int* __restrict__ rbt, const int* __restrict__ w0,
                 const T* __restrict__ wmt, float* __restrict__ dx,
                 float* __restrict__ partial, int n, int cin, int cout, int k3,
                 int kz, int nblocks, int block, int window, int chunk) {
  const int dx_cols = (cin + BN - 1) / BN;
  const int ndx = ((n + BM - 1) / BM) * dx_cols;
  const int b = blockIdx.x;
  if (b < ndx) {
    band::fwd_tile<T>(g, rbt, w0, wmt, dx, n, cout, cin, k3, kz, nblocks, block,
                      window, (b / dx_cols) * BM, (b % dx_cols) * BN);
  } else {
    dw_cta<T>(f, g, rbt, w0, partial, n, cin, cout, k3, kz, nblocks, block,
              window, chunk, b - ndx);
  }
}

// dwr[e] = sum_s partial[s, e] over the nchunks partials, in chunk order.
__global__ void __launch_bounds__(THREADS)
band_dw_reduce(const float* __restrict__ partial, float* __restrict__ dwr,
               long long total, int nchunks) {
  for (long long e = (long long)blockIdx.x * THREADS + threadIdx.x; e < total;
       e += (long long)gridDim.x * THREADS) {
    float s = 0.f;
    for (int c = 0; c < nchunks; ++c) s += partial[(size_t)c * total + e];
    dwr[e] = s;
  }
}

int reduce(const float* partial, float* dwr, int k3, int cin, int cout,
           int nchunks, cudaStream_t stream) {
  const long long total = (long long)k3 * cin * cout;
  const long long want = (total + THREADS - 1) / THREADS;
  const int grid = (int)(want < 65535 ? want : 65535);
  band_dw_reduce<<<grid, THREADS, 0, stream>>>(partial, dwr, total, nchunks);
  return static_cast<int>(cudaGetLastError());
}

long long dw_ctas(int cin, int cout, int k3, int nchunks) {
  return (long long)nchunks * k3 * ((cin + BM - 1) / BM) * ((cout + BN - 1) / BN);
}

template <typename T>
int launch_dw(const void* f, const void* g, const void* rbt, const void* w0,
              void* partial, void* dwr, int n, int cin, int cout, int k3,
              int kz, int nblocks, int block, int window, int chunk,
              int nchunks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  band_dw_kernel<T><<<(unsigned)dw_ctas(cin, cout, k3, nchunks), THREADS, 0, s>>>(
      static_cast<const T*>(f), static_cast<const T*>(g),
      static_cast<const int*>(rbt), static_cast<const int*>(w0),
      static_cast<float*>(partial), n, cin, cout, k3, kz, nblocks, block,
      window, chunk);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return reduce(static_cast<const float*>(partial), static_cast<float*>(dwr),
                k3, cin, cout, nchunks, s);
}

template <typename T>
int launch_dxdw(const void* g, const void* f, const void* rbt, const void* w0,
                const void* wmt, void* dx, void* partial, void* dwr, int n,
                int cin, int cout, int k3, int kz, int nblocks, int block,
                int window, int chunk, int nchunks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long ndx = (long long)((n + BM - 1) / BM) * ((cin + BN - 1) / BN);
  band_dxdw_kernel<T><<<(unsigned)(ndx + dw_ctas(cin, cout, k3, nchunks)),
                        THREADS, 0, s>>>(
      static_cast<const T*>(g), static_cast<const T*>(f),
      static_cast<const int*>(rbt), static_cast<const int*>(w0),
      static_cast<const T*>(wmt), static_cast<float*>(dx),
      static_cast<float*>(partial), n, cin, cout, k3, kz, nblocks, block,
      window, chunk);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return reduce(static_cast<const float*>(partial), static_cast<float*>(dwr),
                k3, cin, cout, nchunks, s);
}

}  // namespace

extern "C" {

int band_dw_f32(const void* f, const void* g, const void* rbt, const void* w0,
                void* partial, void* dwr, int n, int cin, int cout, int k3,
                int kz, int nblocks, int block, int window, int chunk,
                int nchunks, void* stream) {
  return launch_dw<float>(f, g, rbt, w0, partial, dwr, n, cin, cout, k3, kz,
                          nblocks, block, window, chunk, nchunks, stream);
}

int band_dw_bf16(const void* f, const void* g, const void* rbt, const void* w0,
                 void* partial, void* dwr, int n, int cin, int cout, int k3,
                 int kz, int nblocks, int block, int window, int chunk,
                 int nchunks, void* stream) {
  return launch_dw<__nv_bfloat16>(f, g, rbt, w0, partial, dwr, n, cin, cout,
                                  k3, kz, nblocks, block, window, chunk,
                                  nchunks, stream);
}

int band_dxdw_f32(const void* g, const void* f, const void* rbt, const void* w0,
                  const void* wmt, void* dx, void* partial, void* dwr, int n,
                  int cin, int cout, int k3, int kz, int nblocks, int block,
                  int window, int chunk, int nchunks, void* stream) {
  return launch_dxdw<float>(g, f, rbt, w0, wmt, dx, partial, dwr, n, cin, cout,
                            k3, kz, nblocks, block, window, chunk, nchunks,
                            stream);
}

int band_dxdw_bf16(const void* g, const void* f, const void* rbt,
                   const void* w0, const void* wmt, void* dx, void* partial,
                   void* dwr, int n, int cin, int cout, int k3, int kz,
                   int nblocks, int block, int window, int chunk, int nchunks,
                   void* stream) {
  return launch_dxdw<__nv_bfloat16>(g, f, rbt, w0, wmt, dx, partial, dwr, n,
                                    cin, cout, k3, kz, nblocks, block, window,
                                    chunk, nchunks, stream);
}

const char* band_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
