// Windowed gather-GEMM sparse conv (K4 forward, K5 dW) and the P7 ablations'
// forward for Hopper.
//
// Replaces the Pallas TPU kernels ponderv2_tpu/ops/pallas_gather.py:
// _fwd_kernel (K4, pallas_call in windowed_conv_fwd) and _dw_kernel (K5,
// pallas_call in windowed_conv_dw), and the probe bodies
// tools/experiments/probe_pallas_profile.py:114 kern_norbc and :147 kern_lo
// (P7 V2-V4, below). K4 and K5 compute, over a tap-major rulebook
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
// as the predicate (WindowRows).
//
// Both run the tensor-core tiles of mma_tile.cuh, as the band conv's K1-K3
// do: bf16 mma.sync m16n8k16, f32 as 3xTF32, cp.async staging with
// zero-fill for dead entries, tile widths of each conv's own size
// (ops/windowed_gather.py: windowed_fwd_plan, windowed_dw_plan), every sum
// in a fixed order with no atomics. Both keep per-stage sums in bf16 as in
// f32 (the tiles' SS flag, mma_tile.cuh:kStageSums), so that no sum over
// 125 taps or a 12,000-row chunk stays in a tensor-core accumulator, which
// rounds toward zero: they hold f32 accuracy over bf16 values, and their
// tiles stop at 96 columns.
//
// - K4 is K1's function over another row functor, on K1's bf16 tile
//   gather_gemm in both dtypes (128 rows a CTA, warps of 16-row slabs that
//   skip a tap whose 16 entries are dead). On the dense probe rulebooks
//   (70% live) whole slabs waste little; compact_gather_gemm (per tap only
//   the live entries) was slower in both dtypes over phase 12's convs
//   (PERF.md; tools/experiments/probe_mma_variants_torch.py k4 builds it).
//   The tile fills its entry table along a tap's rows
//   (WindowRows::kTapMajor), and walks 125 taps in groups of 32. With B =
//   512 a CTA lies in one output block, so each tap group reads one window
//   per CTA (a cost, not a condition: the functors compute lo per row).
// - K5 is dw_gather_gemm with its operands swapped: f := the cotangent g,
//   read by output row i, and the gathered operand := x through WindowRows.
//   One CTA per (row chunk, tap, cout x cin tile) computes dW[t]^T's
//   partial, multiplying only each 1024-row window's live entries; the
//   second pass (reduce_transposed) sums the partials in chunk order and
//   writes dW (k3, cin, cout).
//
// What bounds them on an H100, at the probe's shapes (N = 163,840 rows, B =
// 512, wb = 1024; tools/experiments/probe_windowed_torch.py): with about 70%
// of the entries live, (27, 32 -> 32) does 2 * 0.7 * 27 * N * 32 * 32 = 6.3
// GFLOP over ~49 MB (bf16 features 10 MB, int32 rulebook 18 MB, f32 output
// 21 MB): bytes bind (~15 us at 3.35 TB/s; the products take 6 us at 989
// TFLOP/s in bf16, 38 us at f32 accuracy's 165). (27, 96 -> 96) is 9x the
// FLOPs; (125, 8 -> 32) is 2 * 0.7 * 125 * N * 8 * 32 = 7.3 GFLOP. In
// practice the tiles' per-stage latency (a barrier and a round of cp.async
// waits per tap and k-chunk, or per 32 live entries in K5) sets the pace.
// Narrow widths pad: cin 6 to 8 (16-byte copies); K4's k-chunk stays 32
// deep, zero-filled past cin; K5's gathered tile is at least 32 wide.
//
// The P7 ablations of tools/experiments/probe_pallas_profile.py (V2-V4) run
// K4's kernel over another row functor (SlabRows): they keep K4's one-hot
// window but drop its per-row pick inside an 8-row slab, so that every live
// entry reads the head row of its slab: kern_norbc with dynamic windows (P7
// V2) and with the windows fixed at the first two blocks (V3: the row is
// rebased by the window start lo), and kern_lo with one window (V4):
//
//     live(t, i) = lo <= r < lo + windows wb,  r = rbb[t, i]
//     V2, V4: out[i] = sum_t [live] x[8 floor(r / 8)] @ W[t]
//     V3:     out[i] = sum_t [live] x[8 floor(r / 8) - lo] @ W[t]
//
// on K4's tile and plan (gather_gemm in bf16 with stage sums, 128 rows a
// CTA, ops/windowed_gather.py:windowed_fwd_plan). SlabRows computes lo per
// row, so a CTA that spans two output blocks (block < 128) reads two
// windows per tap. Eight entries of a slab read one head row, so their
// 16-byte copies hit L1/L2 again; the bound counts the distinct heads.
//
// Plain C interface for ctypes: every launcher returns the cudaError_t of
// cudaGetLastError() after each launch (or of the attribute call that
// refused the shared memory).

#include "mma_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;

// The window's entries: the live input row of (i, t), or -1.
struct WindowRows {
  static constexpr bool kTapMajor = true;  // rbb is (k3, nrows)
  const int* rbb;
  const int* w0;  // (k3 / group, nrows / block)
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
// w0 >= 0, so a live r is >= 0 and lo is slab-aligned: a head lies in [lo,
// lo + windows wb), rebased in [0, windows wb), inside the padded x.
struct SlabRows {
  static constexpr bool kTapMajor = true;  // rbb is (k3, nrows)
  const int* rbb;
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

constexpr int NSTAGE = 3;

// ------------------------------------------------------------------ K4

// x (n_pad, cin_p), w (k3, cin_p, cout_p): padded widths, multiples of 8
// (bf16) or 4 (f32) elements; out (nrows, cout) f32. rows() is K4's row
// functor.
template <typename T_>
struct FwdArgs {
  using T = T_;
  const T* x;
  const int* rbb;
  const int* w0;
  const T* w;
  float* out;
  int nrows, cin_p, cout, cout_p, k3, nb, block, wb, group;

  __device__ __forceinline__ WindowRows rows() const {
    return {rbb, w0, nrows, nb, block, wb, group};
  }
};

// P7 V2-V4: K4's arguments in bf16, the windows per entry and the rebase
struct SlabFwdArgs : FwdArgs<bf16> {
  int windows, rebase;

  __device__ __forceinline__ SlabRows rows() const {
    return {rbb, w0, nrows, nb, block, wb, group, windows, rebase};
  }
};

template <typename T, int NT>
using FwdTile = mma::GatherGemm<T, NT, 8, 1, 32, NSTAGE>;

// K4 (Args = FwdArgs<T>) and P7 V2-V4 (SlabFwdArgs): the slab tile over
// p.rows(). CTA b: rows (b / ncol) BM.., columns (b % ncol) NT..; the column
// tiles of one row tile are neighbours, so they read the same gathered rows
// from L2
template <typename Args, int NT>
__global__ void __launch_bounds__(256) windowed_fwd_kernel(Args p) {
  using T = typename Args::T;
  extern __shared__ __align__(16) unsigned char smem[];
  const auto rows = p.rows();
  const int ncol = (p.cout + NT - 1) / NT;
  const int row0 = (blockIdx.x / ncol) * FwdTile<T, NT>::BM;
  const int col0 = (blockIdx.x % ncol) * NT;
  mma::gather_gemm<T, NT, 8, 1, 32, NSTAGE, true>(p.x, rows, p.k3, p.w, p.cin_p, p.cout_p, p.out,
                                                  p.cout, p.nrows, p.cout, row0, col0, smem);
}

template <typename Args, int NT>
int launch_fwd_width(const Args& p, cudaStream_t s) {
  using Tile = FwdTile<typename Args::T, NT>;
  const size_t smem = Tile::smem_bytes(p.k3);
  const cudaError_t err = cudaFuncSetAttribute(
      windowed_fwd_kernel<Args, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long ctas = (long long)((p.nrows + Tile::BM - 1) / Tile::BM) *
                         ((p.cout + NT - 1) / NT);
  windowed_fwd_kernel<Args, NT><<<(unsigned)ctas, 256, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename Args>
int launch_fwd(const Args& p, int co_tile, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (co_tile) {
    case 32: return launch_fwd_width<Args, 32>(p, s);
    case 64: return launch_fwd_width<Args, 64>(p, s);
    case 96: return launch_fwd_width<Args, 96>(p, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
FwdArgs<T> fwd_args(const void* x, const void* rbb, const void* w0, const void* w, void* out,
                    int nrows, int cin_p, int cout, int cout_p, int k3, int nb, int block,
                    int wb, int group) {
  return {static_cast<const T*>(x), static_cast<const int*>(rbb), static_cast<const int*>(w0),
          static_cast<const T*>(w), static_cast<float*>(out), nrows, cin_p, cout, cout_p, k3,
          nb, block, wb, group};
}

template <typename T>
long long fwd_smem_bytes(int co_tile, int k3) {
  switch (co_tile) {
    case 32: return (long long)FwdTile<T, 32>::smem_bytes(k3);
    case 64: return (long long)FwdTile<T, 64>::smem_bytes(k3);
    case 96: return (long long)FwdTile<T, 96>::smem_bytes(k3);
  }
  return -1;
}

// ------------------------------------------------------------------ K5

// g (nrows, cout_p) the cotangent, x (n_pad, cin_p); partial (nchunks, k3,
// cout, cin) f32 at the true widths: dW[t]^T per row chunk
template <typename T>
struct DwArgs {
  const T* g;
  const T* x;
  const int* rbb;
  const int* w0;
  float* partial;
  int nrows, cin, cout, cin_p, cout_p, k3, nb, block, wb, group, chunk;
};

template <typename T, int MT, int NT>
using DwTile = mma::DwGemm<T, MT, NT, NSTAGE>;

// CTA b of nchunks * k3 * ceil(cout / MT) * ceil(cin / NT): the partial of
// (row chunk s, tap t, MT x NT tile of cout x cin); consecutive CTAs share
// (s, t) and so read the same rows from L2.
template <typename T, int MT, int NT>
__global__ void __launch_bounds__(256, 2) windowed_dw_kernel(DwArgs<T> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const WindowRows rows{p.rbb, p.w0, p.nrows, p.nb, p.block, p.wb, p.group};
  int b = blockIdx.x;
  const int nn = (p.cin + NT - 1) / NT;
  const int nm = (p.cout + MT - 1) / MT;
  const int tn = b % nn;
  b /= nn;
  const int tm = b % nm;
  b /= nm;
  const int t = b % p.k3;
  const int s = b / p.k3;
  mma::dw_gather_gemm<T, MT, NT, NSTAGE, true>(
      p.g, p.cout_p, p.x, p.cin_p, rows, t,
      p.partial + ((size_t)s * p.k3 + t) * p.cout * p.cin, p.cout, p.cin, tm * MT, tn * NT,
      s * p.chunk, min(p.nrows, (s + 1) * p.chunk), smem);
}

// dw[t, ci, co] = sum_s partial[s, t, co, ci], in chunk order: the second,
// fixed-order pass of K5's reduction, transposing the swapped tiles'
// (cout, cin) partials. A CTA owns (32 cin x 32 cout, tap): reads along
// cin, writes along cout through a shared-memory tile.
constexpr int kTr = 32;

__global__ void __launch_bounds__(256)
reduce_transposed(const float* __restrict__ partial, float* __restrict__ dw, int k3, int cin,
                  int cout, int nchunks) {
  __shared__ float tile[kTr][kTr + 1];  // [co - co0][ci - ci0]
  const int t = blockIdx.z, ci0 = blockIdx.x * kTr, co0 = blockIdx.y * kTr;
  const int tx = threadIdx.x % kTr, ty = threadIdx.x / kTr;
  const size_t per_chunk = (size_t)k3 * cin * cout;
  for (int r = ty; r < kTr; r += 256 / kTr) {
    const int co = co0 + r, ci = ci0 + tx;
    float s = 0.f;
    if (co < cout && ci < cin) {
      const float* src = partial + ((size_t)t * cout + co) * cin + ci;
      for (int c = 0; c < nchunks; ++c) s += src[c * per_chunk];
    }
    tile[r][tx] = s;
  }
  __syncthreads();
  for (int r = ty; r < kTr; r += 256 / kTr) {
    const int ci = ci0 + r, co = co0 + tx;
    if (ci < cin && co < cout) dw[((size_t)t * cin + ci) * cout + co] = tile[tx][r];
  }
}

template <typename T, int MT, int NT>
int launch_dw_tile(const DwArgs<T>& p, float* dw, int nchunks, cudaStream_t s) {
  const size_t smem = DwTile<T, MT, NT>::smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(windowed_dw_kernel<T, MT, NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long ctas = (long long)nchunks * p.k3 * ((p.cout + MT - 1) / MT) *
                         ((p.cin + NT - 1) / NT);
  windowed_dw_kernel<T, MT, NT><<<(unsigned)ctas, 256, smem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.cin + kTr - 1) / kTr, (p.cout + kTr - 1) / kTr, p.k3);
  reduce_transposed<<<grid, 256, 0, s>>>(p.partial, dw, p.k3, p.cin, p.cout, nchunks);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int MT>
int launch_dw_nt(const DwArgs<T>& p, float* dw, int nchunks, int nt, cudaStream_t s) {
  switch (nt) {
    case 32: return launch_dw_tile<T, MT, 32>(p, dw, nchunks, s);
    case 64: return launch_dw_tile<T, MT, 64>(p, dw, nchunks, s);
    case 96: return launch_dw_tile<T, MT, 96>(p, dw, nchunks, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_dw(const void* g, const void* x, const void* rbb, const void* w0, void* partial,
              void* dw, int nrows, int cin, int cout, int cin_p, int cout_p, int k3, int nb,
              int block, int wb, int group, int chunk, int nchunks, int mt, int nt,
              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DwArgs<T> p{static_cast<const T*>(g), static_cast<const T*>(x),
                    static_cast<const int*>(rbb), static_cast<const int*>(w0),
                    static_cast<float*>(partial), nrows, cin, cout, cin_p, cout_p, k3, nb,
                    block, wb, group, chunk};
  float* out = static_cast<float*>(dw);
  switch (mt) {
    case 32: return launch_dw_nt<T, 32>(p, out, nchunks, nt, s);
    case 64: return launch_dw_nt<T, 64>(p, out, nchunks, nt, s);
    case 96: return launch_dw_nt<T, 96>(p, out, nchunks, nt, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int MT>
long long dw_smem_nt(int nt) {
  switch (nt) {
    case 32: return (long long)DwTile<T, MT, 32>::smem_bytes();
    case 64: return (long long)DwTile<T, MT, 64>::smem_bytes();
    case 96: return (long long)DwTile<T, MT, 96>::smem_bytes();
  }
  return -1;
}

template <typename T>
long long dw_smem_bytes(int mt, int nt) {
  switch (mt) {
    case 32: return dw_smem_nt<T, 32>(nt);
    case 64: return dw_smem_nt<T, 64>(nt);
    case 96: return dw_smem_nt<T, 96>(nt);
  }
  return -1;
}

}  // namespace

extern "C" {

int windowed_fwd_f32(const void* x, const void* rbb, const void* w0, const void* w, void* out,
                     int nrows, int cin_p, int cout, int cout_p, int k3, int nb, int block,
                     int wb, int group, int co_tile, void* stream) {
  return launch_fwd(fwd_args<float>(x, rbb, w0, w, out, nrows, cin_p, cout, cout_p, k3, nb,
                                    block, wb, group),
                    co_tile, stream);
}

int windowed_fwd_bf16(const void* x, const void* rbb, const void* w0, const void* w, void* out,
                      int nrows, int cin_p, int cout, int cout_p, int k3, int nb, int block,
                      int wb, int group, int co_tile, void* stream) {
  return launch_fwd(fwd_args<bf16>(x, rbb, w0, w, out, nrows, cin_p, cout, cout_p, k3, nb,
                                   block, wb, group),
                    co_tile, stream);
}

// K4's dynamic shared memory per CTA (ops/windowed_gather.py:windowed_fwd_plan
// mirrors it)
long long windowed_fwd_smem_bytes(int bf16_, int co_tile, int k3) {
  return bf16_ ? fwd_smem_bytes<bf16>(co_tile, k3) : fwd_smem_bytes<float>(co_tile, k3);
}

int windowed_dw_f32(const void* g, const void* x, const void* rbb, const void* w0,
                    void* partial, void* dw, int nrows, int cin, int cout, int cin_p,
                    int cout_p, int k3, int nb, int block, int wb, int group, int chunk,
                    int nchunks, int mt, int nt, void* stream) {
  return launch_dw<float>(g, x, rbb, w0, partial, dw, nrows, cin, cout, cin_p, cout_p, k3, nb,
                          block, wb, group, chunk, nchunks, mt, nt, stream);
}

int windowed_dw_bf16(const void* g, const void* x, const void* rbb, const void* w0,
                     void* partial, void* dw, int nrows, int cin, int cout, int cin_p,
                     int cout_p, int k3, int nb, int block, int wb, int group, int chunk,
                     int nchunks, int mt, int nt, void* stream) {
  return launch_dw<bf16>(g, x, rbb, w0, partial, dw, nrows, cin, cout, cin_p, cout_p, k3, nb,
                         block, wb, group, chunk, nchunks, mt, nt, stream);
}

// K5's dynamic shared memory per CTA (ops/windowed_gather.py:windowed_dw_plan
// mirrors it)
long long windowed_dw_smem_bytes(int bf16_, int mt, int nt) {
  return bf16_ ? dw_smem_bytes<bf16>(mt, nt) : dw_smem_bytes<float>(mt, nt);
}

// The P7 ablations read bf16 only, as the profile probe does: K4's kernel
// and plan over SlabRows.
int windowed_slab_fwd_bf16(const void* x, const void* rbb, const void* w0, const void* w,
                           void* out, int nrows, int cin_p, int cout, int cout_p, int k3, int nb,
                           int block, int wb, int group, int windows, int rebase, int co_tile,
                           void* stream) {
  const SlabFwdArgs p{fwd_args<bf16>(x, rbb, w0, w, out, nrows, cin_p, cout, cout_p, k3, nb,
                                     block, wb, group),
                      windows, rebase};
  return launch_fwd(p, co_tile, stream);
}

const char* windowed_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
