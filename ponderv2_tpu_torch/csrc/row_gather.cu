// Row gather-sum for Hopper (family A of the probe kernels).
//
// Replaces the Pallas TPU probe bodies
//   tools/experiments/probe_pallas_gather.py: kernel_take (P1, a jnp.take of
//     1024-row tiles) and probe_full_length's kernel (P2, take_along_axis
//     over the full length);
//   tools/experiments/probe_pallas_bisect.py: k1 (P3, a one-hot matmul that
//     picks rows out of one wb-row window per (tap, output block)).
// They compute, in f32,
//
//     out[i] = sum_{t < taps} [live(t, i)] feats[rows[t, i]]           (n, C)
//     live(t, i) = rows[t, i] >= 0, and where a window table w0 (taps, nb)
//                  is given, lo <= rows[t, i] < lo + wb, lo = w0[t, i / B] wb
//
// summed in tap order, the order in which the TPU grid added its taps, so
// the result equals the plain version's bit for bit. The TPU bodies pick
// rows with jnp.take or a one-hot matmul because a TPU gathers rows slowly;
// here the live rows are read directly, and the window survives only as
// the predicate that drops what the one-hot drops.
//
// What bounds it on an H100. P1/P2 (16384 x 128 f32) read ~5.3 MB of
// distinct rows and write 8.4 MB: ~4.1 us at 3.35 TB/s, against one add
// per element, so bytes bind. P3's k1 (8192 x 32 bf16, 4 taps) moves
// ~1.6 MB, a bound of ~0.5 us, under the ~1.2-1.7 us that an empty kernel
// takes to launch and retire on this card (the launch floor); what is left
// above that floor is the chain of dependent reads: a row's address is
// known only once its entry (and its window entry) has arrived. The first
// design (one thread per 16 bytes of one output row, reading entry,
// window, then row, tap after tap) paid up to 8 dependent round trips per
// thread and, at P1/P2's shape, two waves of that chain.
//
// The vector path (a width of whole 16-byte pieces, 16-byte aligned
// features, at most 8 taps): one thread per item, a (row, 16-byte piece)
// of the output, consecutive threads on consecutive pieces; the grid is at
// most the CTAs resident at once, a thread walking its items. For an item
// the thread first loads every tap's entry and window entry (one round
// trip; the lanes of a row read the same ones), then every live tap's
// piece (the second), adds the taps in order and stores its piece: two
// dependent round trips instead of up to eight. Three other designs were
// timed against it on the card (PERF.md): a warp per batch of 8 rows (its
// lanes load the batch's entries in coalesced loads and pass them on with
// __shfl_sync, 4 steps in flight, streaming stores; the `warp` variant of
// tools/experiments/probe_mma_variants_torch.py p1), streaming or L2-only
// stores on this path, and one bulk copy per row into a shared tile with
// one bulk store of the output tile. None was faster at P1, P2 and P3 k1,
// so this path with plain stores is built. At P1/P2 the kernel without its
// stores takes about half its time: the 8.4 MB written, not the reads,
// hold it.
//
// Ragged widths, unaligned features and more than 8 taps take the scalar
// path: one thread per output element's slice, taps in a loop.
//
// Plain C interface for ctypes: the launcher returns the cudaError_t of
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// acc[v] += element v of the 16 bytes u (4 floats, or 8 bf16, low first)
__device__ __forceinline__ void add16(float* acc, const uint4& u, const float*) {
  acc[0] += __uint_as_float(u.x);
  acc[1] += __uint_as_float(u.y);
  acc[2] += __uint_as_float(u.z);
  acc[3] += __uint_as_float(u.w);
}
__device__ __forceinline__ void add16(float* acc, const uint4& u, const __nv_bfloat16*) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {  // a bf16 is the high half of its f32
    acc[2 * e] += __uint_as_float(w[e] << 16);
    acc[2 * e + 1] += __uint_as_float(w[e] & 0xffff0000u);
  }
}

// The vector path (taps <= TB): thread e takes items e, e + S, ... (S the
// grid's threads), item = row * nvec + 16-byte piece. It loads an item's
// entries and window entries (the lanes of one row read the same ones),
// then every live tap's piece, before any add.
template <typename T, int TB>
__global__ void __launch_bounds__(THREADS)
gather_sum_vec_kernel(const T* __restrict__ feats, const int* __restrict__ rows,
                      const int* __restrict__ w0, float* __restrict__ out, int n, int c,
                      int taps, int nb, int block, int wb) {
  constexpr int V = 16 / sizeof(T);
  const int nvec = c / V;
  const long long items = (long long)n * nvec;
  for (long long e = (long long)blockIdx.x * THREADS + threadIdx.x; e < items;
       e += (long long)gridDim.x * THREADS) {
    const int row = (int)(e / nvec), piece = (int)(e % nvec);
    int r[TB], lo[TB];
#pragma unroll
    for (int t = 0; t < TB; ++t) {
      r[t] = -1;
      lo[t] = 0;
      if (t < taps) {
        r[t] = __ldg(rows + (size_t)t * n + row);
        if (w0 != nullptr) lo[t] = __ldg(w0 + (size_t)t * nb + row / block);
      }
    }
    uint4 buf[TB];
#pragma unroll
    for (int t = 0; t < TB; ++t) {
      const long long l = (long long)lo[t] * wb;
      buf[t] = make_uint4(0u, 0u, 0u, 0u);
      if (r[t] >= 0 && (w0 == nullptr || (r[t] >= l && r[t] < l + wb)))
        buf[t] = __ldg(reinterpret_cast<const uint4*>(feats + (size_t)r[t] * c) + piece);
    }
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.f;
#pragma unroll
    for (int t = 0; t < TB; ++t)
      if (t < taps) add16(acc, buf[t], feats);
    float4* dst = reinterpret_cast<float4*>(out + (size_t)row * c) + piece * (V / 4);
#pragma unroll
    for (int q = 0; q < V / 4; ++q)
      dst[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
  }
}

// The scalar path: e = i * nvec + v, thread e sums elements [v V, v V + V)
// of output row i.
template <typename T>
__global__ void __launch_bounds__(THREADS)
gather_sum_scalar_kernel(const T* __restrict__ feats, const int* __restrict__ rows,
                         const int* __restrict__ w0, float* __restrict__ out, int n,
                         int c, int taps, int nb, int block, int wb) {
  constexpr int V = 16 / sizeof(T);
  const int nvec = (c + V - 1) / V;
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= (long long)n * nvec) return;
  const int i = (int)(e / nvec);
  const int c0 = (int)(e % nvec) * V;
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;
  for (int t = 0; t < taps; ++t) {
    const int r = rows[(size_t)t * n + i];
    if (r < 0) continue;
    if (w0 != nullptr) {
      const long long lo = (long long)w0[(size_t)t * nb + i / block] * wb;
      if (r < lo || r >= lo + wb) continue;
    }
    const T* src = feats + (size_t)r * c + c0;
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (c0 + v < c) acc[v] += to_float(src[v]);
  }
  float* dst = out + (size_t)i * c + c0;
#pragma unroll
  for (int v = 0; v < V; ++v)
    if (c0 + v < c) dst[v] = acc[v];
}

// CTAs of a kernel resident on one SM of the current device at `threads`
// threads, times the SMs.
template <typename K>
int resident_ctas(K kernel, int threads) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  return std::max(per_sm, 1) * sms;
}

// At most the CTAs that are resident at once on the current device (asked
// at every launch: a host-side query); a thread walks its items.
template <typename T, int TB>
void launch_vec(const T* feats, const int* rows, const int* w0, float* out, int n, int c,
                int taps, int nb, int block, int wb, cudaStream_t s) {
  auto kernel = gather_sum_vec_kernel<T, TB>;
  const int resident = resident_ctas(kernel, THREADS);
  const long long items = (long long)n * (c / (16 / (int)sizeof(T)));
  const long long grid = std::min<long long>((items + THREADS - 1) / THREADS, resident);
  kernel<<<(unsigned)grid, THREADS, 0, s>>>(feats, rows, w0, out, n, c, taps, nb, block, wb);
}

template <typename T>
int launch(const void* feats_, const void* rows_, const void* w0_, void* out_, int n,
           int c, int taps, int nb, int block, int wb, int vec, void* stream) {
  const T* feats = static_cast<const T*>(feats_);
  const int* rows = static_cast<const int*>(rows_);
  const int* w0 = static_cast<const int*>(w0_);
  float* out = static_cast<float*>(out_);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec && taps == 1) {
    launch_vec<T, 1>(feats, rows, w0, out, n, c, taps, nb, block, wb, s);
  } else if (vec && taps <= 4) {
    launch_vec<T, 4>(feats, rows, w0, out, n, c, taps, nb, block, wb, s);
  } else if (vec && taps <= 8) {
    launch_vec<T, 8>(feats, rows, w0, out, n, c, taps, nb, block, wb, s);
  } else {
    constexpr int V = 16 / sizeof(T);
    const long long threads = (long long)n * ((c + V - 1) / V);
    gather_sum_scalar_kernel<T><<<(unsigned)((threads + THREADS - 1) / THREADS), THREADS, 0,
                                  s>>>(feats, rows, w0, out, n, c, taps, nb, block, wb);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// vec: c a multiple of 16 / sizeof(T) and feats 16-byte aligned.
int gather_sum_f32(const void* feats, const void* rows, const void* w0, void* out,
                   int n, int c, int taps, int nb, int block, int wb, int vec,
                   void* stream) {
  return launch<float>(feats, rows, w0, out, n, c, taps, nb, block, wb, vec, stream);
}

int gather_sum_bf16(const void* feats, const void* rows, const void* w0, void* out,
                    int n, int c, int taps, int nb, int block, int wb, int vec,
                    void* stream) {
  return launch<__nv_bfloat16>(feats, rows, w0, out, n, c, taps, nb, block, wb, vec,
                               stream);
}

const char* gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
