// Block-banded submanifold conv backward (the band conv's K2 and K3) for
// Hopper.
//
// Replaces the Pallas TPU kernels ponderv2_tpu/ops/band_conv.py:278
// _dxdw_kernel (K2, the fused backward, call at :478) and :222 _dw_kernel
// (K3, the split dW, call at :510). With the subm tap symmetry (tap t on
// outputs is tap mirror(t) = k3-1-t on inputs) both are sums over the same
// in-window entries (i, t), j = rbt[i, t], as K1 (band_rows.cuh:BandRows):
//
//     dx[i]  += g[j] @ Wm[t]            Wm[t] = W[mirror t]^T  (K2 only)
//     dwr[t] += f[i]^T g[j]             dwr[t] = dW[mirror t]  (K2 and K3)
//
// accumulated in f32; the caller un-mirrors dwr and adds the overflow
// entries (_overflow_residual, _overflow_dw) and the plan's ok gate.
//
// The TPU reduced dW over the sequential grid in a VMEM-resident
// accumulator. Here blocks run in parallel, so dW is a two-pass reduction:
// each dW CTA owns (row chunk s, tap t, a tile of input x output channels),
// accumulates over its chunk's rows in registers, and writes a partial to
// (S, k3, cin, cout) f32 scratch; reduce_partials sums the S partials in
// chunk order. No atomics, so dW is deterministic.
//
// Both run the tensor-core tiles of mma_tile.cuh (bf16 mma, f32 as 3xTF32,
// cp.async staging, tiles of 32-128 columns (32-96 in f32) picked per conv
// by the wrapper, ops/band_conv.py:dxdw_plan / dw_plan). What bounds them on
// an H100: 2 Cin Cout FLOPs per live entry (per half) on the tensor cores,
// against the gathered g rows (L2); the dW CTAs (dw_gather_gemm) compact
// each 1024-row window's live entries and multiply only them.
//
// K2: one launch whose CTAs split into two ranges, first the dW partials
// (long, so they start first), then the dx tiles (gather_gemm over g with
// Wm, 128 rows each; its warps skip a tap whose 16 entries are dead). A CTA
// sharing its gathered g rows between dx and dW is later work.
//
// K3: K2's dW CTAs without the dx range, instantiated only at the tile
// widths of the split convs (256 and 384 channels: 64 x 64 and 96 x 64 in
// f32, 128 x 128 in bf16); other widths take those tiles with zero padding.
//
// Plain C interface for ctypes: every launcher returns the cudaError_t of
// cudaGetLastError() after each launch.

#include "band_rows.cuh"
#include "mma_tile.cuh"

namespace {

int reduce(const float* partial, float* dwr, int k3, int cin, int cout,
           int nchunks, cudaStream_t stream) {
  return band::launch_reduce(partial, dwr, (long long)k3 * cin * cout, nchunks,
                             stream);
}

// ------------------------------------------------------------------ K2

// K2's and K3's operands: g (n, cout_p), f (n, cin_p), wmt (k3, cout_p,
// cin_p; K2 only), the padded widths multiples of 8 (bf16) or 4 (f32)
// elements; dx (n, cin; K2 only) and partial (nchunks, k3, cin, cout) at the
// true widths.
template <typename T>
struct DxdwArgs {
  const T* g;
  const T* f;
  const int* rbt;
  const int* w0;
  const T* wmt;
  float* dx;
  float* partial;
  int n, cin, cout, cin_p, cout_p, k3, kz, nblocks, block, window, chunk, nchunks;
};

constexpr int DX_WARPS = 8;  // dx CTAs: 8 warps x 16 rows
constexpr int NSTAGE = 3;

template <typename T>
constexpr int DX_KC = 32;  // k-chunk of a dx stage

template <typename T, int CI>
using DxTile = mma::GatherGemm<T, CI, DX_WARPS, 1, DX_KC<T>, NSTAGE>;
template <typename T, int CI, int CO>
using DwTile = mma::DwGemm<T, CI, CO, NSTAGE>;
// f32 tiles hold a second accumulator (mma_tile.cuh: kStageSums)
template <typename T>
constexpr int MAX_TILE = sizeof(T) == 2 ? 128 : 96;

// dW CTA b of nchunks * k3 * ceil(cin / CI) * ceil(cout / CO): the partial
// of (row chunk s, tap t, CI x CO channel tile); consecutive CTAs share
// (s, t) and so read the same g rows from L2.
template <typename T, int CI, int CO>
__device__ __forceinline__ void dw_cta(const DxdwArgs<T>& p, const band::BandRows& rows, int b,
                                       unsigned char* smem) {
  const int nco = (p.cout + CO - 1) / CO;
  const int nci = (p.cin + CI - 1) / CI;
  const int tco = b % nco;
  b /= nco;
  const int tci = b % nci;
  b /= nci;
  const int t = b % p.k3;
  const int s = b / p.k3;
  mma::dw_gather_gemm<T, CI, CO, NSTAGE>(
      p.f, p.cin_p, p.g, p.cout_p, rows, t,
      p.partial + ((size_t)s * p.k3 + t) * p.cin * p.cout, p.cin, p.cout, tci * CI,
      tco * CO, s * p.chunk, min(p.n, (s + 1) * p.chunk), smem);
}

// CTAs [0, ndw) compute dW partials, the rest dx tiles of 128 rows x CI
// channels. The branch is uniform per CTA.
template <typename T, int CI, int CO>
__global__ void __launch_bounds__(256, 2) band_dxdw_kernel(DxdwArgs<T> p, int ndw) {
  extern __shared__ __align__(16) unsigned char smem[];
  const band::BandRows rows{p.rbt, p.w0, p.n, p.k3, p.kz, p.nblocks, p.block, p.window};
  int b = blockIdx.x;
  if (b < ndw) {
    dw_cta<T, CI, CO>(p, rows, b, smem);
  } else {
    b -= ndw;
    const int dx_cols = (p.cin + CI - 1) / CI;
    mma::gather_gemm<T, CI, DX_WARPS, 1, DX_KC<T>, NSTAGE>(
        p.g, rows, p.k3, p.wmt, p.cout_p, p.cin_p, p.dx, p.cin, p.n, p.cin,
        (b / dx_cols) * DxTile<T, CI>::BM, (b % dx_cols) * CI, smem);
  }
}

// K3: the dW CTAs alone (p.wmt and p.dx unused)
template <typename T, int CI, int CO>
__global__ void __launch_bounds__(256, 2) band_dw_kernel(DxdwArgs<T> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const band::BandRows rows{p.rbt, p.w0, p.n, p.k3, p.kz, p.nblocks, p.block, p.window};
  dw_cta<T, CI, CO>(p, rows, blockIdx.x, smem);
}

template <typename T, int CI, int CO>
int launch_dxdw_tile(const DxdwArgs<T>& p, cudaStream_t s) {
  const size_t dx_smem = DxTile<T, CI>::smem_bytes(p.k3);
  const size_t dw_smem = DwTile<T, CI, CO>::smem_bytes();
  const size_t smem = dx_smem > dw_smem ? dx_smem : dw_smem;
  cudaError_t err = cudaFuncSetAttribute(band_dxdw_kernel<T, CI, CO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nci = (p.cin + CI - 1) / CI;
  const long long ndw = (long long)p.nchunks * p.k3 * nci * ((p.cout + CO - 1) / CO);
  const long long ndx = (long long)((p.n + DxTile<T, CI>::BM - 1) / DxTile<T, CI>::BM) * nci;
  band_dxdw_kernel<T, CI, CO><<<(unsigned)(ndw + ndx), 256, smem, s>>>(p, (int)ndw);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int CI>
int launch_dxdw_co(const DxdwArgs<T>& p, int co_tile, cudaStream_t s) {
  switch (co_tile) {
    case 32: return launch_dxdw_tile<T, CI, 32>(p, s);
    case 64: return launch_dxdw_tile<T, CI, 64>(p, s);
    case 96: return launch_dxdw_tile<T, CI, 96>(p, s);
    case 128:
      if constexpr (MAX_TILE<T> >= 128) return launch_dxdw_tile<T, CI, 128>(p, s);
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_dxdw(const void* g, const void* f, const void* rbt, const void* w0,
                const void* wmt, void* dx, void* partial, void* dwr, int n,
                int cin, int cout, int cin_p, int cout_p, int k3, int kz,
                int nblocks, int block, int window, int chunk, int nchunks,
                int ci_tile, int co_tile, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k3 > 32) return static_cast<int>(cudaErrorInvalidValue);  // tap masks are 32 bits
  const DxdwArgs<T> p{static_cast<const T*>(g), static_cast<const T*>(f),
                      static_cast<const int*>(rbt), static_cast<const int*>(w0),
                      static_cast<const T*>(wmt), static_cast<float*>(dx),
                      static_cast<float*>(partial), n, cin, cout, cin_p, cout_p,
                      k3, kz, nblocks, block, window, chunk, nchunks};
  int err = static_cast<int>(cudaErrorInvalidValue);
  switch (ci_tile) {
    case 32: err = launch_dxdw_co<T, 32>(p, co_tile, s); break;
    case 64: err = launch_dxdw_co<T, 64>(p, co_tile, s); break;
    case 96: err = launch_dxdw_co<T, 96>(p, co_tile, s); break;
    case 128:
      if constexpr (MAX_TILE<T> >= 128) err = launch_dxdw_co<T, 128>(p, co_tile, s);
      break;
  }
  if (err != 0) return err;
  return reduce(static_cast<const float*>(partial), static_cast<float*>(dwr),
                k3, cin, cout, nchunks, s);
}

// ------------------------------------------------------------------ K3

template <typename T, int CI, int CO>
int launch_dw_tile(const DxdwArgs<T>& p, float* dwr, cudaStream_t s) {
  const size_t smem = DwTile<T, CI, CO>::smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(band_dw_kernel<T, CI, CO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long ndw = (long long)p.nchunks * p.k3 * ((p.cin + CI - 1) / CI) *
                        ((p.cout + CO - 1) / CO);
  band_dw_kernel<T, CI, CO><<<(unsigned)ndw, 256, smem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return reduce(p.partial, dwr, p.k3, p.cin, p.cout, p.nchunks, s);
}

// the split convs' tiles (ops/band_conv.py:K3_TILES)
template <typename T>
int launch_dw_tiles(const DxdwArgs<T>& p, float* dwr, int ci_tile, int co_tile,
                    cudaStream_t s) {
  if constexpr (sizeof(T) == 2) {
    if (ci_tile == 128 && co_tile == 128) return launch_dw_tile<T, 128, 128>(p, dwr, s);
  } else {
    if (ci_tile == 64 && co_tile == 64) return launch_dw_tile<T, 64, 64>(p, dwr, s);
    if (ci_tile == 96 && co_tile == 64) return launch_dw_tile<T, 96, 64>(p, dwr, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_dw(const void* f, const void* g, const void* rbt, const void* w0, void* partial,
              void* dwr, int n, int cin, int cout, int cin_p, int cout_p, int k3, int kz,
              int nblocks, int block, int window, int chunk, int nchunks, int ci_tile,
              int co_tile, void* stream) {
  const DxdwArgs<T> p{static_cast<const T*>(g), static_cast<const T*>(f),
                      static_cast<const int*>(rbt), static_cast<const int*>(w0), nullptr,
                      nullptr, static_cast<float*>(partial), n, cin, cout, cin_p, cout_p,
                      k3, kz, nblocks, block, window, chunk, nchunks};
  return launch_dw_tiles<T>(p, static_cast<float*>(dwr), ci_tile, co_tile,
                            static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

int band_dw_f32(const void* f, const void* g, const void* rbt, const void* w0,
                void* partial, void* dwr, int n, int cin, int cout, int cin_p, int cout_p,
                int k3, int kz, int nblocks, int block, int window, int chunk, int nchunks,
                int ci_tile, int co_tile, void* stream) {
  return launch_dw<float>(f, g, rbt, w0, partial, dwr, n, cin, cout, cin_p, cout_p, k3, kz,
                          nblocks, block, window, chunk, nchunks, ci_tile, co_tile, stream);
}

int band_dw_bf16(const void* f, const void* g, const void* rbt, const void* w0,
                 void* partial, void* dwr, int n, int cin, int cout, int cin_p, int cout_p,
                 int k3, int kz, int nblocks, int block, int window, int chunk, int nchunks,
                 int ci_tile, int co_tile, void* stream) {
  return launch_dw<__nv_bfloat16>(f, g, rbt, w0, partial, dwr, n, cin, cout, cin_p, cout_p,
                                  k3, kz, nblocks, block, window, chunk, nchunks, ci_tile,
                                  co_tile, stream);
}

// K3's dynamic shared memory per CTA (ops/band_conv.py:dw_plan mirrors it)
long long band_dw_smem_bytes(int bf16_, int ci_tile, int co_tile) {
  if (bf16_) {
    if (ci_tile == 128 && co_tile == 128) return (long long)DwTile<__nv_bfloat16, 128, 128>::smem_bytes();
  } else {
    if (ci_tile == 64 && co_tile == 64) return (long long)DwTile<float, 64, 64>::smem_bytes();
    if (ci_tile == 96 && co_tile == 64) return (long long)DwTile<float, 96, 64>::smem_bytes();
  }
  return -1;
}

int band_dxdw_f32(const void* g, const void* f, const void* rbt, const void* w0,
                  const void* wmt, void* dx, void* partial, void* dwr, int n,
                  int cin, int cout, int cin_p, int cout_p, int k3, int kz,
                  int nblocks, int block, int window, int chunk, int nchunks,
                  int ci_tile, int co_tile, void* stream) {
  return launch_dxdw<float>(g, f, rbt, w0, wmt, dx, partial, dwr, n, cin, cout,
                            cin_p, cout_p, k3, kz, nblocks, block, window, chunk,
                            nchunks, ci_tile, co_tile, stream);
}

int band_dxdw_bf16(const void* g, const void* f, const void* rbt,
                   const void* w0, const void* wmt, void* dx, void* partial,
                   void* dwr, int n, int cin, int cout, int cin_p, int cout_p,
                   int k3, int kz, int nblocks, int block, int window, int chunk,
                   int nchunks, int ci_tile, int co_tile, void* stream) {
  return launch_dxdw<__nv_bfloat16>(g, f, rbt, w0, wmt, dx, partial, dwr, n,
                                    cin, cout, cin_p, cout_p, k3, kz, nblocks,
                                    block, window, chunk, nchunks, ci_tile,
                                    co_tile, stream);
}

const char* band_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
