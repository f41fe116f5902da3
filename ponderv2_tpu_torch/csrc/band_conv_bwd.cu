// Block-banded submanifold conv backward (the band conv's K2 and K3) for
// Hopper.
//
// Replaces the Pallas TPU kernels ponderv2_tpu/ops/band_conv.py:_dxdw_kernel
// (K2, the fused backward, call at :478) and :_dw_kernel (K3, the split dW,
// call at :510). With the subm tap symmetry (tap t on outputs is tap
// mirror(t) = k3-1-t on inputs) both are sums over the same in-window
// entries (i, t), j = rbt[i, t], as K1 (band_conv_tile.cuh:BandRows):
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
// (S, k3, cin, cout) f32 scratch; reduce_partials sums the S partials. No
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
  const band::BandRows rows{rbt, w0, n, k3, kz, nblocks, block, window};
  band::dw_tile<T, false>(f, g, rows,
                          partial + ((size_t)s * k3 + t) * cin * cout, cin,
                          cout, t, tci * BM, tco * BN, r_begin, r_end);
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
    const band::BandRows rows{rbt, w0, n, k3, kz, nblocks, block, window};
    band::fwd_tile<T>(g, rows, wmt, dx, n, cout, cin, k3, (b / dx_cols) * BM,
                      (b % dx_cols) * BN);
  } else {
    dw_cta<T>(f, g, rbt, w0, partial, n, cin, cout, k3, kz, nblocks, block,
              window, chunk, b - ndx);
  }
}

int reduce(const float* partial, float* dwr, int k3, int cin, int cout,
           int nchunks, cudaStream_t stream) {
  return band::launch_reduce(partial, dwr, (long long)k3 * cin * cout, nchunks,
                             stream);
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
