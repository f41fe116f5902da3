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
// 8-aligned window survives only as the predicate above. The same kernel
// computes the split backward's dx: feats = the cotangent, W = the mirrored,
// transposed weights (band_conv.py:_bwd_impl, subm tap symmetry).
//
// What bounds it on an H100: the gather of 64 input rows per tap (random
// 128-1024 B rows, served mostly by L2 because rows of nearby outputs are
// nearby in the key-sorted input) and the CUDA-core FMA rate: this first
// version uses no tensor cores. Design: one CTA per 64 output rows x 64
// output channels (band_conv_tile.cuh:fwd_tile over BandRows).
//
// Plain C interface for ctypes: every launcher returns the cudaError_t of
// cudaGetLastError() right after the launch.

#include "band_conv_tile.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(band::THREADS)
band_fwd_kernel(const T* __restrict__ feats, const int* __restrict__ rbt,
                const int* __restrict__ w0, const T* __restrict__ wts,
                float* __restrict__ out, int n, int cin, int cout, int k3,
                int kz, int nblocks, int block, int window) {
  const band::BandRows rows{rbt, w0, n, k3, kz, nblocks, block, window};
  band::fwd_tile<T>(feats, rows, wts, out, n, cin, cout, k3,
                    blockIdx.x * band::BM, blockIdx.y * band::BN);
}

template <typename T>
int launch(const void* feats, const void* rbt, const void* w0, const void* wts,
           void* out, int n, int cin, int cout, int k3, int kz, int nblocks,
           int block, int window, void* stream) {
  const dim3 grid((n + band::BM - 1) / band::BM, (cout + band::BN - 1) / band::BN);
  band_fwd_kernel<T><<<grid, band::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
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
