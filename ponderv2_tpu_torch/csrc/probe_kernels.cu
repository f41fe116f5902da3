// Window reads and small constructs for Hopper (families C and D of the probe
// kernels).
//
// Replaces the Pallas TPU probe bodies that the windowed conv's compile
// bisects and ablations launched:
//
// Family C, window copy-accumulate, over output blocks j of B rows:
//   window_copy_sum   out[j B + i] = sum_t (x[w0[t, j] wb + i] + add[t, j])
//     probe_pallas_bisect.py: k0 (P3; w0 the windows' block table);
//     probe_pallas_bisect2.py: a.k, b.k (P4 A, B; w0[t, j] = j mod 8),
//       c.k (C; w0[t, j] = w0[j]), d.k (D; C plus add[t, j] = rb[(t nb + j) B]).
//   window_head_sum   out[j B + i, :] = sum_t (R(sum_c x[lo, c])
//                                              + R(sum_c x[lo + wb, c])),
//     lo = w0[t, j] wb and R the rounding to bf16 (jnp.sum of a bf16 array
//     is bf16): probe_pallas_profile.py kern_dma2 (P7 V5).
// Family D, the grouped-kernel constructs of probe_pallas_bisect3.py (P5):
//   slab_slots   out[b, r] = rb[0, b] >= 0 ? rb[0, b] mod 8 + 1 : 0 (r < 8): ka,
//                the identity-matmul transpose of a row into a column;
//   lane_concat  out[:, p C : p C + C] = x[:, (p mod (W / C)) C : ...]: kb;
//   sum_rows     out[0, b] = sum_{t < rows} rb[t, b]: kc2;
//   tile_matmul  out = g @ w[0]: kd, on the tensor-core gather-GEMM tile
//                of K2 (mma_tile.cuh) with the identity row functor.
// Sums run in the order the TPU grid or body added their terms (taps in
// order, rows in order), so every result but kd's equals the plain version's
// bit for bit; kd sums its 288 products per output in another order than a
// library GEMM. The TPU grid carried each sum across grid steps; here a loop
// inside the thread does.
//
// What bounds them on an H100: at the probes' shapes every one moves under
// 1 MB (P3/P4: an 8192 x 32 f32 output and a few hundred KB of windows) or
// does under 10 MFLOP (kd), so their bound is a few hundred nanoseconds and
// their time is the launch's (kd: one 16-row x 32-column CTA of 4 warps
// per 16 rows, 32 CTAs at 512 rows, with the 288-deep K in flight at once
// and no row table or vote, so that one launch, one round of loads and a
// chain of 18 mma are all it waits on). P7 V5 at
// N = 163,840 writes 21 MB of output (~6 us at 3.35 TB/s) from 27 x 320 x 2 head rows. Design: one thread per
// output element (or per column for sum_rows), consecutive threads on
// consecutive columns so that loads and stores coalesce; window_head_sum
// first forms a block's 2 x taps head sums in shared memory, one thread
// each, then writes the block's rows.
//
// Plain C interface for ctypes: every launcher returns the cudaError_t of
// cudaGetLastError() after its launch.

#include "band_conv_tile.cuh"
#include "mma_tile.cuh"

namespace {

using band::to_float;
using bf16 = __nv_bfloat16;
constexpr int THREADS = 256;


unsigned grid_for(long long threads) {
  return (unsigned)((threads + THREADS - 1) / THREADS);
}

// ---------------------------------------------------------------- family C

// The tables w0 and add are (taps, nb) int32 with any strides (a table that
// repeats over t has stride 0 there); a window row outside [0, rows_x) reads
// as zero.
__global__ void __launch_bounds__(THREADS)
window_copy_sum_kernel(const bf16* __restrict__ x, const int* __restrict__ w0,
                       const int* __restrict__ add, float* __restrict__ out,
                       int rows_x, int c, int taps, int nb, int block, int wb,
                       int w0_s0, int w0_s1, int add_s0, int add_s1) {
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= (long long)nb * block * c) return;
  const int row = (int)(e / c);
  const int col = (int)(e % c);
  const int j = row / block;
  const int i = row % block;
  float acc = 0.f;
  for (int t = 0; t < taps; ++t) {
    const long long r = (long long)w0[t * w0_s0 + j * w0_s1] * wb + i;
    float v = (r >= 0 && r < rows_x) ? to_float(x[(size_t)r * c + col]) : 0.f;
    if (add != nullptr) v += (float)add[t * add_s0 + j * add_s1];
    acc += v;
  }
  out[e] = acc;
}

// One CTA per output block j.
__global__ void __launch_bounds__(THREADS)
window_head_sum_kernel(const bf16* __restrict__ x, const int* __restrict__ w0,
                       float* __restrict__ out, int rows_x, int c, int taps,
                       int block, int wb, int w0_s0, int w0_s1) {
  extern __shared__ float heads[];  // (taps, 2): the rounded head sums
  const int j = blockIdx.x;
  for (int h = threadIdx.x; h < 2 * taps; h += THREADS) {
    const long long r = (long long)w0[(h / 2) * w0_s0 + j * w0_s1] * wb + (h % 2) * wb;
    float s = 0.f;
    if (r >= 0 && r < rows_x)
      for (int k = 0; k < c; ++k) s += to_float(x[(size_t)r * c + k]);
    heads[h] = __bfloat162float(__float2bfloat16(s));
  }
  __syncthreads();
  float total = 0.f;  // every thread forms the same sum, in tap order
  for (int t = 0; t < taps; ++t) total += heads[2 * t] + heads[2 * t + 1];
  float* dst = out + (size_t)j * block * c;
  for (int e = threadIdx.x; e < block * c; e += THREADS) dst[e] = total;
}

// ---------------------------------------------------------------- family D

__global__ void __launch_bounds__(THREADS)
slab_slots_kernel(const int* __restrict__ rb, float* __restrict__ out, int b) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= b * 8) return;
  const int r = rb[e / 8];
  out[e] = r >= 0 ? (float)(r % 8 + 1) : 0.f;
}

__global__ void __launch_bounds__(THREADS)
lane_concat_kernel(const bf16* __restrict__ x, float* __restrict__ out, int rows,
                   int w_in, int width, int pieces) {
  const int w_out = width * pieces;
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= (long long)rows * w_out) return;
  const int row = (int)(e / w_out);
  const int k = (int)(e % w_out);
  const int src = (k / width) % (w_in / width) * width + k % width;
  out[e] = to_float(x[(size_t)row * w_in + src]);
}

__global__ void __launch_bounds__(THREADS)
sum_rows_kernel(const int* __restrict__ rb, float* __restrict__ out, int rows,
                int b) {
  const int col = blockIdx.x * THREADS + threadIdx.x;
  if (col >= b) return;
  float acc = 0.f;
  for (int t = 0; t < rows; ++t) acc += (float)rb[(size_t)t * b + col];
  out[col] = acc;
}

// Every output row reads its own input row through the one tap.
struct IdentityRows {
  int n;
  __device__ __forceinline__ int operator()(int i, int) const {
    return i < n ? i : -1;
  }
};

// kd's tile: 16 rows x 32 columns per CTA, one warp per 8 columns; one
// 288-deep stage, the probe's whole K in flight at once (gather_gemm's
// one-tap path). tools/experiments/probe_mma_variants_torch.py kd times the
// other shapes tried.
#define KD_TILE bf16, 32, 1, 4, 288, 2
using KdTile = mma::GatherGemm<KD_TILE>;

__global__ void __launch_bounds__(KdTile::THREADS)
tile_matmul_kernel(const bf16* __restrict__ g, const bf16* __restrict__ w,
                   float* __restrict__ out, int m, int k, int n, int ldb) {
  extern __shared__ __align__(16) unsigned char smem[];
  mma::gather_gemm<KD_TILE>(g, IdentityRows{m}, 1, w, k, ldb, out, n, m, n,
                            blockIdx.x * KdTile::BM, blockIdx.y * KdTile::BN, smem);
}

}  // namespace

// The probes read bf16 (P3, P4, P5 kb/kd, P7 V5) or int32 (P5 ka/kc2): one
// entry point each.
extern "C" {

int window_copy_sum_bf16(const void* x, const void* w0, const void* add, void* out,
                         int rows_x, int c, int taps, int nb, int block, int wb,
                         int w0_s0, int w0_s1, int add_s0, int add_s1, void* stream) {
  window_copy_sum_kernel<<<grid_for((long long)nb * block * c), THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const int*>(w0),
      static_cast<const int*>(add), static_cast<float*>(out), rows_x, c, taps, nb,
      block, wb, w0_s0, w0_s1, add_s0, add_s1);
  return static_cast<int>(cudaGetLastError());
}

int window_head_sum_bf16(const void* x, const void* w0, void* out, int rows_x, int c,
                         int taps, int nb, int block, int wb, int w0_s0, int w0_s1,
                         void* stream) {
  const size_t smem = 2 * (size_t)taps * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        window_head_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  window_head_sum_kernel<<<nb, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const int*>(w0),
      static_cast<float*>(out), rows_x, c, taps, block, wb, w0_s0, w0_s1);
  return static_cast<int>(cudaGetLastError());
}

int slab_slots(const void* rb, void* out, int b, void* stream) {
  slab_slots_kernel<<<grid_for((long long)b * 8), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(rb), static_cast<float*>(out), b);
  return static_cast<int>(cudaGetLastError());
}

int lane_concat_bf16(const void* x, void* out, int rows, int w_in, int width,
                     int pieces, void* stream) {
  lane_concat_kernel<<<grid_for((long long)rows * width * pieces), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<float*>(out), rows, w_in, width, pieces);
  return static_cast<int>(cudaGetLastError());
}

int sum_rows(const void* rb, void* out, int rows, int b, void* stream) {
  sum_rows_kernel<<<grid_for(b), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(rb), static_cast<float*>(out), rows, b);
  return static_cast<int>(cudaGetLastError());
}

// g (m, k) and w (k, ldb) with k and ldb multiples of 8 (the wrapper pads
// ragged widths with zeros); out (m, n).
int tile_matmul_bf16(const void* g, const void* w, void* out, int m, int k, int n,
                     int ldb, void* stream) {
  const size_t smem = KdTile::smem_bytes(1);
  const cudaError_t err = cudaFuncSetAttribute(
      tile_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + KdTile::BM - 1) / KdTile::BM, (n + KdTile::BN - 1) / KdTile::BN);
  tile_matmul_kernel<<<grid, KdTile::THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(g), static_cast<const bf16*>(w), static_cast<float*>(out),
      m, k, n, ldb);
  return static_cast<int>(cudaGetLastError());
}

const char* probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
