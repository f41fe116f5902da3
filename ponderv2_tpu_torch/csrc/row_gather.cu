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
// here each thread reads its 16 bytes of the live row directly, and the
// window survives only as the predicate that drops what the one-hot drops.
//
// What bounds it on an H100: bytes. P1/P2 (16384 x 128 f32) read ~5.3 MB of
// distinct rows and write 8.4 MB: ~4 us at 3.35 TB/s, against one add per
// element. Design: one thread per 16 bytes of an output row (32 threads
// cover a 128-float row, so a warp reads one 512-byte row in one
// transaction set); vector loads and stores where the width allows them,
// scalar ones on a ragged width.
//
// Plain C interface for ctypes: the launcher returns the cudaError_t of
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// e = i * nvec + v: thread e sums elements [v V, v V + V) of output row i.
template <typename T>
__global__ void __launch_bounds__(THREADS)
gather_sum_kernel(const T* __restrict__ feats, const int* __restrict__ rows,
                  const int* __restrict__ w0, float* __restrict__ out, int n,
                  int c, int taps, int nb, int block, int wb, int vec) {
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
      const int lo = w0[t * nb + i / block] * wb;
      if (r < lo || r >= lo + wb) continue;
    }
    const T* src = feats + (size_t)r * c + c0;
    if (vec) {
      const uint4 u = *reinterpret_cast<const uint4*>(src);
      const T* p = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] += to_float(p[v]);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (c0 + v < c) acc[v] += to_float(src[v]);
    }
  }
  float* dst = out + (size_t)i * c + c0;
  if (vec) {
#pragma unroll
    for (int v = 0; v < V; v += 4)
      *reinterpret_cast<float4*>(dst + v) =
          make_float4(acc[v], acc[v + 1], acc[v + 2], acc[v + 3]);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (c0 + v < c) dst[v] = acc[v];
  }
}

template <typename T>
int launch(const void* feats, const void* rows, const void* w0, void* out, int n,
           int c, int taps, int nb, int block, int wb, int vec, void* stream) {
  constexpr int V = 16 / sizeof(T);
  const long long threads = (long long)n * ((c + V - 1) / V);
  const unsigned grid = (unsigned)((threads + THREADS - 1) / THREADS);
  gather_sum_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(feats), static_cast<const int*>(rows),
      static_cast<const int*>(w0), static_cast<float*>(out), n, c, taps, nb, block,
      wb, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

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
