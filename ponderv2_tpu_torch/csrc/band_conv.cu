// Block-banded submanifold conv forward (the band conv's K1) for Hopper.
//
// Replaces the Pallas TPU kernel ponderv2_tpu/ops/band_conv.py:192
// _fwd_kernel (call at :408). It computes the same function, not the TPU
// blocking: for output row i and tap t (t = column * kz + dz),
//
//     j = rbt[i, t],  pos = j - w0[t / kz, i / block]
//     out[i] += feats[j] @ W[t]   if j >= 0 and 0 <= pos < window
//
// accumulated in f32. Entries outside the window are dropped here exactly as
// the TPU kernel drops them; the caller adds them back from the plan's
// overflow list (band_conv.py:_overflow_residual). The TPU kernel's one-hot
// matmul that selects window rows becomes a direct read of row j, and the
// 8-aligned window survives only as the predicate (band_rows.cuh:BandRows).
// The same kernel computes the split backward's dx: feats = the cotangent,
// W = the mirrored, transposed weights (band_conv.py:_bwd_impl, subm tap
// symmetry).
//
// What bounds it on an H100: 2 Cin Cout FLOPs per live entry on the tensor
// cores (bf16 at 989 TFLOP/s; f32 as 3xTF32 at a third of the 495 TFLOP/s
// TF32 rate), against one gathered row per entry (mostly from L2: nearby
// outputs read nearby inputs) and one KC x NT slice of W[t] per CTA and
// stage (from L2). A surface fills about a quarter of the 27 taps, so a
// tile that multiplies whole 16-row slabs whenever one entry is live (the
// dx tile of K2, mma_tile.cuh:gather_gemm) multiplies 1.4-3.3x the live
// rows. The tile follows the dtype:
//
// - f32 (the fine-tune step and serving), where the 3xTF32 products set the
//   pace: mma_tile.cuh:compact_gather_gemm. Per tap the CTA compacts its
//   live entries in row order and multiplies only ceil(live / 16) slabs,
//   adding each slab's product into an f32 output tile in shared memory,
//   taps in order. One CTA per K1_TILE rows x one column tile of the conv's
//   own width (tile_width).
// - bf16 (the pretrain step): gather_gemm, K2's dx tile. There the products
//   are cheap, and the compacted tile's per-stage costs (the shared-memory
//   output tile, one or two CTAs per SM) lose to the slab tile's register
//   sums at three CTAs per SM at every measured conv (PERF.md,
//   tools/experiments/probe_mma_variants_torch.py k1).
//
// Both sum every output element in one fixed order, with no atomics: equal
// bits on every launch.
//
// Plain C interface for ctypes: every launcher returns the cudaError_t of
// cudaGetLastError() right after the launch (or of the attribute call that
// refused the shared memory).

#include <type_traits>

#include "band_rows.cuh"
#include "mma_tile.cuh"

// the compacted tile's rows per CTA, k-chunk and stages in flight
// (ops/band_conv.py:K1_TILE mirrors them;
// tools/experiments/probe_mma_variants_torch.py k1 times edits of this line)
#define K1_TILE 256, 16, 3

namespace {

using bf16 = __nv_bfloat16;

// feats (n, cin_p), w (k3, cin_p, cout_p): padded widths, multiples of 8
// (bf16) or 4 (f32) elements; out (n, cout) f32
template <typename T>
struct FwdArgs {
  const T* feats;
  const int* rbt;
  const int* w0;
  const T* w;
  float* out;
  int n, cin_p, cout, cout_p, k3, kz, nblocks, block, window;
};

template <typename T>
constexpr bool kCompact = sizeof(T) == 4;  // f32: the compacted tile; bf16: slabs

template <typename T, int NT>
using Tile = std::conditional_t<kCompact<T>, mma::CompactGemm<T, NT, K1_TILE>,
                                mma::GatherGemm<T, NT, 8, 1, 32, 3>>;

// CTA b: rows (b / ncol) BM.., columns (b % ncol) NT..; the column tiles of
// one row tile are neighbours, so they read the same gathered rows from L2
template <typename T, int NT>
__global__ void __launch_bounds__(256) band_fwd_kernel(FwdArgs<T> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const band::BandRows rows{p.rbt, p.w0, p.n, p.k3, p.kz, p.nblocks, p.block, p.window};
  const int ncol = (p.cout + NT - 1) / NT;
  const int row0 = (blockIdx.x / ncol) * Tile<T, NT>::BM;
  const int col0 = (blockIdx.x % ncol) * NT;
  if constexpr (kCompact<T>)
    mma::compact_gather_gemm<Tile<T, NT>>(p.feats, rows, p.k3, p.w, p.cin_p, p.cout_p, p.out,
                                          p.cout, p.n, p.cout, row0, col0, smem);
  else
    mma::gather_gemm<T, NT, 8, 1, 32, 3>(p.feats, rows, p.k3, p.w, p.cin_p, p.cout_p, p.out,
                                         p.cout, p.n, p.cout, row0, col0, smem);
}

template <typename T, int NT>
int launch_tile(const FwdArgs<T>& p, cudaStream_t s) {
  const size_t smem = Tile<T, NT>::smem_bytes(p.k3);
  const cudaError_t err = cudaFuncSetAttribute(
      band_fwd_kernel<T, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long ctas = (long long)((p.n + Tile<T, NT>::BM - 1) / Tile<T, NT>::BM) *
                         ((p.cout + NT - 1) / NT);
  band_fwd_kernel<T, NT><<<(unsigned)ctas, 256, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// f32 tiles stop at 96 columns (ops/band_conv.py:tile_width)
template <typename T>
int launch(const void* feats, const void* rbt, const void* w0, const void* w, void* out,
           int n, int cin_p, int cout, int cout_p, int k3, int kz, int nblocks, int block,
           int window, int co_tile, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k3 > 32) return static_cast<int>(cudaErrorInvalidValue);  // tap lists hold 32
  const FwdArgs<T> p{static_cast<const T*>(feats), static_cast<const int*>(rbt),
                     static_cast<const int*>(w0), static_cast<const T*>(w),
                     static_cast<float*>(out), n, cin_p, cout, cout_p, k3, kz, nblocks,
                     block, window};
  switch (co_tile) {
    case 32: return launch_tile<T, 32>(p, s);
    case 64: return launch_tile<T, 64>(p, s);
    case 96: return launch_tile<T, 96>(p, s);
    case 128:
      if constexpr (sizeof(T) == 2) return launch_tile<T, 128>(p, s);
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
long long smem_bytes(int co_tile, int k3) {
  switch (co_tile) {
    case 32: return (long long)Tile<T, 32>::smem_bytes(k3);
    case 64: return (long long)Tile<T, 64>::smem_bytes(k3);
    case 96: return (long long)Tile<T, 96>::smem_bytes(k3);
    case 128:
      if constexpr (sizeof(T) == 2) return (long long)Tile<T, 128>::smem_bytes(k3);
      break;
  }
  return -1;
}

}  // namespace

extern "C" {

int band_fwd_f32(const void* feats, const void* rbt, const void* w0, const void* w, void* out,
                 int n, int cin_p, int cout, int cout_p, int k3, int kz, int nblocks,
                 int block, int window, int co_tile, void* stream) {
  return launch<float>(feats, rbt, w0, w, out, n, cin_p, cout, cout_p, k3, kz, nblocks, block,
                       window, co_tile, stream);
}

int band_fwd_bf16(const void* feats, const void* rbt, const void* w0, const void* w, void* out,
                  int n, int cin_p, int cout, int cout_p, int k3, int kz, int nblocks,
                  int block, int window, int co_tile, void* stream) {
  return launch<bf16>(feats, rbt, w0, w, out, n, cin_p, cout, cout_p, k3, kz, nblocks, block,
                      window, co_tile, stream);
}

// the dynamic shared memory of one CTA (ops/band_conv.py:fwd_plan mirrors it)
long long band_fwd_smem_bytes(int bf16_, int co_tile, int k3) {
  return bf16_ ? smem_bytes<bf16>(co_tile, k3) : smem_bytes<float>(co_tile, k3);
}

const char* band_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
