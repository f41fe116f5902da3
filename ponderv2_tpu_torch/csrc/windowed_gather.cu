// Windowed gather-GEMM sparse conv (K4 forward, K5 dW) for Hopper.
//
// Replaces the Pallas TPU kernels ponderv2_tpu/ops/pallas_gather.py:
// _fwd_kernel (K4, pallas_call in windowed_conv_fwd) and _dw_kernel (K5,
// pallas_call in windowed_conv_dw). They compute, over a tap-major rulebook
// rbb (k3, nb * B) whose taps are grouped g(t) = t / group under one window
// of two aligned wb-row blocks per (group, output block j):
//
//     live(t, i) = lo <= rbb[t, i] < lo + 2 wb,  lo = w0[g(t), i / B] * wb
//     K4: out[i]  = sum_t [live] x[rbb[t, i]] @ W[t]            (nb B, cout)
//     K5: dW[t]   = sum_i [live] x[rbb[t, i]]^T g[i]            (k3, cin, cout)
//
// accumulated in f32. An entry that is -1 or outside its window contributes
// zero, exactly as the TPU kernel's one-hot drops it. The TPU kernel's
// two-level one-hot matmul (8-row slabs at full lane width, an identity
// matmul for the per-row slab position) existed because a TPU gathers rows
// slowly; here the live row is read directly, and the window survives only
// as the predicate (WindowRows). Design: the band conv's tiles
// (band_conv_tile.cuh), one CTA per 64 output rows x 64 output channels for
// K4; for K5 one CTA per (row chunk, tap, 64 x 64 channel tile) writing a
// partial to (S, k3, cin, cout) f32 scratch, then a fixed-order sum of the S
// partials, so dW is deterministic without atomics. Tensor cores and
// cp.async/TMA staging of the window are later work.
//
// What bounds it on an H100, at the probe's shapes (N = 163,840 rows, B =
// 512, wb = 1024; tools/experiments/probe_windowed_torch.py): with about 70%
// of the entries live, (27, 32 -> 32) does 2 * 0.7 * 27 * N * 32 * 32 = 6.3
// GFLOP over ~49 MB (bf16 features 10 MB, int32 rulebook 18 MB, f32 output
// 21 MB): the CUDA-core FMA rate binds (67 TFLOP/s f32 outside the tensor
// cores: ~0.1 ms; the bytes take ~15 us at 3.35 TB/s). (27, 96 -> 96) is 9x
// the FLOPs;
// (125, 8 -> 32) is 2 * 0.7 * 125 * N * 8 * 32 = 7.3 GFLOP. As tensor-core
// work (989 TFLOP/s bf16) all three would be bound by bytes instead.
//
// The same forward, over other row functors (SlabRows), replaces the
// ablations of tools/experiments/probe_pallas_profile.py that kept K4's
// one-hot window but dropped its per-row pick inside an 8-row slab, so that
// every live entry reads the head row of its slab: kern_norbc with dynamic
// windows (P7 V2) and with the windows fixed at the first two blocks (V3:
// the row is rebased by the window start lo), and kern_lo with one window
// (V4):
//
//     live(t, i) = lo <= r < lo + windows wb,  r = rbb[t, i]
//     V2, V4: out[i] = sum_t [live] x[8 floor(r / 8)] @ W[t]
//     V3:     out[i] = sum_t [live] x[8 floor(r / 8) - lo] @ W[t]
//
// Its bound and design are K4's: the same tile, a different row per entry.
//
// Plain C interface for ctypes: every launcher returns the cudaError_t of
// cudaGetLastError() after each launch.

#include "band_conv_tile.cuh"

namespace {

using band::BM;
using band::BN;
using band::THREADS;

// The window's entries: the live input row of (i, t), or -1.
struct WindowRows {
  const int* rbb;  // (k3, nrows) tap-major
  const int* w0;   // (k3 / group, nrows / block)
  int nrows, nb, block, wb, group;

  __device__ __forceinline__ int operator()(int i, int t) const {
    if (i >= nrows) return -1;
    const int j = rbb[(size_t)t * nrows + i];
    const int lo = w0[(t / group) * nb + i / block] * wb;
    return (j >= lo && j < lo + 2 * wb) ? j : -1;
  }
};

// The P7 ablations' entries: the head row of the live entry's 8-row slab
// (less the window start with ``rebase``), or -1. wb is a multiple of 8 and
// w0 >= 0, so a live r is >= 0 and lo is slab-aligned.
struct SlabRows {
  const int* rbb;  // (k3, nrows) tap-major
  const int* w0;   // (k3 / group, nrows / block)
  int nrows, nb, block, wb, group, windows, rebase;

  __device__ __forceinline__ int operator()(int i, int t) const {
    if (i >= nrows) return -1;
    const int r = rbb[(size_t)t * nrows + i];
    const int lo = w0[(t / group) * nb + i / block] * wb;
    if (r < lo || r >= lo + windows * wb) return -1;
    return (r & ~7) - (rebase ? lo : 0);
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
windowed_fwd_kernel(const T* __restrict__ x, const int* __restrict__ rbb,
                    const int* __restrict__ w0, const T* __restrict__ wts,
                    float* __restrict__ out, int nrows, int cin, int cout,
                    int k3, int nb, int block, int wb, int group) {
  const WindowRows rows{rbb, w0, nrows, nb, block, wb, group};
  band::fwd_tile<T>(x, rows, wts, out, nrows, cin, cout, k3,
                    blockIdx.x * BM, blockIdx.y * BN);
}

__global__ void __launch_bounds__(THREADS)
windowed_slab_fwd_kernel(const __nv_bfloat16* __restrict__ x,
                         const int* __restrict__ rbb, const int* __restrict__ w0,
                         const __nv_bfloat16* __restrict__ wts,
                         float* __restrict__ out, int nrows, int cin, int cout,
                         int k3, int nb, int block, int wb, int group, int windows,
                         int rebase) {
  const SlabRows rows{rbb, w0, nrows, nb, block, wb, group, windows, rebase};
  band::fwd_tile<__nv_bfloat16>(x, rows, wts, out, nrows, cin, cout, k3,
                                blockIdx.x * BM, blockIdx.y * BN);
}

// dW CTA number b of nchunks * k3 * ceil(cin / 64) * ceil(cout / 64):
// consecutive CTAs share (s, t) and so read the same rows from L2.
template <typename T>
__global__ void __launch_bounds__(THREADS)
windowed_dw_kernel(const T* __restrict__ x, const T* __restrict__ g,
                   const int* __restrict__ rbb, const int* __restrict__ w0,
                   float* __restrict__ partial, int nrows, int cin, int cout,
                   int k3, int nb, int block, int wb, int group, int chunk) {
  int b = blockIdx.x;
  const int nco = (cout + BN - 1) / BN;
  const int nci = (cin + BM - 1) / BM;
  const int tco = b % nco;
  b /= nco;
  const int tci = b % nci;
  b /= nci;
  const int t = b % k3;
  const int s = b / k3;
  const int r_begin = s * chunk;
  const int r_end = min(nrows, r_begin + chunk);
  const WindowRows rows{rbb, w0, nrows, nb, block, wb, group};
  band::dw_tile<T, true>(x, g, rows, partial + ((size_t)s * k3 + t) * cin * cout,
                         cin, cout, t, tci * BM, tco * BN, r_begin, r_end);
}

template <typename T>
int launch_fwd(const void* x, const void* rbb, const void* w0, const void* wts,
               void* out, int nrows, int cin, int cout, int k3, int nb,
               int block, int wb, int group, void* stream) {
  const dim3 grid((nrows + BM - 1) / BM, (cout + BN - 1) / BN);
  windowed_fwd_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const int*>(rbb),
      static_cast<const int*>(w0), static_cast<const T*>(wts),
      static_cast<float*>(out), nrows, cin, cout, k3, nb, block, wb, group);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dw(const void* x, const void* g, const void* rbb, const void* w0,
              void* partial, void* dw, int nrows, int cin, int cout, int k3,
              int nb, int block, int wb, int group, int chunk, int nchunks,
              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long ctas =
      (long long)nchunks * k3 * ((cin + BM - 1) / BM) * ((cout + BN - 1) / BN);
  windowed_dw_kernel<T><<<(unsigned)ctas, THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const int*>(rbb), static_cast<const int*>(w0),
      static_cast<float*>(partial), nrows, cin, cout, k3, nb, block, wb, group,
      chunk);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return band::launch_reduce(static_cast<const float*>(partial),
                             static_cast<float*>(dw), (long long)k3 * cin * cout,
                             nchunks, s);
}

}  // namespace

extern "C" {

int windowed_fwd_f32(const void* x, const void* rbb, const void* w0,
                     const void* wts, void* out, int nrows, int cin, int cout,
                     int k3, int nb, int block, int wb, int group, void* stream) {
  return launch_fwd<float>(x, rbb, w0, wts, out, nrows, cin, cout, k3, nb, block,
                           wb, group, stream);
}

int windowed_fwd_bf16(const void* x, const void* rbb, const void* w0,
                      const void* wts, void* out, int nrows, int cin, int cout,
                      int k3, int nb, int block, int wb, int group,
                      void* stream) {
  return launch_fwd<__nv_bfloat16>(x, rbb, w0, wts, out, nrows, cin, cout, k3,
                                   nb, block, wb, group, stream);
}

int windowed_dw_f32(const void* x, const void* g, const void* rbb,
                    const void* w0, void* partial, void* dw, int nrows, int cin,
                    int cout, int k3, int nb, int block, int wb, int group,
                    int chunk, int nchunks, void* stream) {
  return launch_dw<float>(x, g, rbb, w0, partial, dw, nrows, cin, cout, k3, nb,
                          block, wb, group, chunk, nchunks, stream);
}

int windowed_dw_bf16(const void* x, const void* g, const void* rbb,
                     const void* w0, void* partial, void* dw, int nrows,
                     int cin, int cout, int k3, int nb, int block, int wb,
                     int group, int chunk, int nchunks, void* stream) {
  return launch_dw<__nv_bfloat16>(x, g, rbb, w0, partial, dw, nrows, cin, cout,
                                  k3, nb, block, wb, group, chunk, nchunks,
                                  stream);
}

// The P7 ablations read bf16 only, as the profile probe does.
int windowed_slab_fwd_bf16(const void* x, const void* rbb, const void* w0,
                           const void* wts, void* out, int nrows, int cin, int cout,
                           int k3, int nb, int block, int wb, int group, int windows,
                           int rebase, void* stream) {
  const dim3 grid((nrows + BM - 1) / BM, (cout + BN - 1) / BN);
  windowed_slab_fwd_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(rbb),
      static_cast<const int*>(w0), static_cast<const __nv_bfloat16*>(wts),
      static_cast<float*>(out), nrows, cin, cout, k3, nb, block, wb, group, windows,
      rebase);
  return static_cast<int>(cudaGetLastError());
}

const char* windowed_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
