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
// What bounds them on an H100: at the probes' shapes every one but P7 V5
// moves under 1 MB (P3/P4: an 8192 x 32 f32 output and a few hundred KB of
// windows) or does under 10 MFLOP (kd), so their bound is a few hundred
// nanoseconds and their time is the launch's (kd: one 16-row x 32-column CTA
// of 4 warps per 16 rows, 32 CTAs at 512 rows, with the 288-deep K in flight
// at once and no row table or vote, so that one launch, one round of loads
// and a chain of 18 mma are all it waits on).
//
// slab_slots (ka: 2 KB of rb's first row read, a (512, 8) f32 output of 16
// KB written, a bound of ~5.5 ns) costs a launch and one round trip, so it
// is built for the fewest threads, loads and stores that round trip takes:
// a thread per column (ka: 4 CTAs of 128), which loads its entry once and
// writes its output row by two 16-byte streaming stores. The first design,
// a thread per output element, had 8 threads load each entry and made one
// 4-byte store each, with the element index b * 8 an int32 that overflowed
// for b >= 2^28. At ka it measured 0-0.0002 ms faster than this one: both
// are an empty kernel's time plus one round trip, and no layout of the
// 16 KB of stores changes that. Fewer SMs write slower: one CTA of 512, or
// one of 128 with 4 columns a thread, measured ~0.0003 and ~0.0009 ms
// slower (tools/experiments/probe_mma_variants_torch.py ka; PERF.md).
//
// lane_concat (kb: (512, 256) bf16 -> (512, 288) f32, 0.85 MB, a bound of
// ~0.25 us) and sum_rows (kc2: 9 rows of a (16, 512) int32 table, a bound
// of ~6 ns) sit in the launch's shadow too, so each is built for one round
// trip. lane_concat is out[r, c] = x[r, c mod w_in]: a thread loads one
// 16-byte piece of x (8 bf16) once, widens it to f32 by shifts, and writes
// it with two 16-byte streaming stores to each output column j + k w_in it
// feeds (kb: block 0 to pieces 0 and 8), so x is read once and no thread
// divides (the first design, a thread per output element, did a 64-bit
// divide and modulo and 2-byte loads: 147,456 threads against 16,384). A
// CTA is 2-D, pieces by rows (kb: 64 CTAs of 8 rows x 32 pieces). A width
// that is not a multiple of 8, or an x not 16-byte aligned, takes the same
// walk one column a thread. sum_rows gives a thread one column (kc2: 4 CTAs
// of 128), whose loads of up to 16 rows all go out before its first add, so
// kc2's 9 rows cost one round trip, not a chain of loads; rows are added in
// order in f32, each converted first. PERF.md times the other designs
// (tools/experiments/probe_mma_variants_torch.py kb, kc2): other CTA sizes,
// a thread per output piece for kb, 4 columns a thread by 16-byte loads for
// kc2 (slower, on one or four SMs).
//
// window_copy_sum (P3 k0, P4 A-D: 8192 x 32 f32 out from four 512 x 32 bf16
// windows per block, ~1.3 MB, a bound of ~0.39 us) lies under the ~1.2 us
// an empty kernel takes to launch and retire on this card, so what it can
// save is the chain of dependent reads above that floor. Its first design
// (one thread per output element, reading w0[t, j], then the row, tap
// after tap) paid that chain per tap, with 2-byte loads. Now a CTA owns
// a chunk of consecutive rows of one output block j (256 / (C / 8) rows:
// 64 at C = 32, 128 CTAs, about one per SM), and each thread one 16-byte
// piece (8 columns) of one row. Per round of up to COPY_TAPS taps the CTA
// reads w0[t, j] and add[t, j] once (one round trip; the tables keep any
// strides, 0 for one repeated over the taps); then each thread issues
// every tap's 16-byte load of its piece (a row outside [0, rows_x) reads
// as zero) before its first add, adds the taps in order in f32 (x + add
// formed first) and writes its 8 floats with streaming stores: two round
// trips in all. A route that brought each tap's window chunk (a contiguous
// run of rows x C bf16 of x) by one bulk copy (cp.async.bulk, the TMA's
// non-tensor form) into shared memory, all taps' copies on one mbarrier,
// measured 0.4-0.7 us slower at P3/P4 in the same call (PERF.md), so the
// register route is built. A width that is not a multiple of 8 or an x
// that is not 16-byte aligned takes scalar loads; more than 2048 columns
// split a row over CTAs.
//
// P7 V5 at N = 163,840 writes 21 MB of f32 output (~6.3 us at 3.35 TB/s)
// from 27 x 320 x 2 head rows of 64 bytes: bytes bind, and a CTA's critical
// path is two dependent reads (its window table, then its head rows) and
// the sums before its writes. window_head_sum therefore gives each head row
// to one thread, which issues the row's 16-byte loads (4 x uint4 for 32 bf16
// columns) before it adds any, so that a CTA waits about one memory latency
// for all of its heads; sums them in registers in column order; and writes
// the rounded sum to shared memory. One thread then adds the taps in order
// (cheaper than every thread doing so: 40 warps an SM would read the same 54
// sums from shared memory; PERF.md), and every thread writes its share of
// the CTA's rows with 16-byte streaming stores (nothing reads the output
// again). A CTA owns 128 rows of one output block, so the probe's
// 320 blocks make 1,280 CTAs of 128 threads: all resident at once, about 10
// to an SM, so that the 21 MB write is spread evenly over the 132 SMs. A
// width that is not a multiple of 8, or an x not 16-byte aligned, takes
// scalar head reads (HEAD_VEC false); an output range that is not 16-byte
// aligned takes scalar stores at its ends.
//
// Plain C interface for ctypes: every launcher returns the cudaError_t of
// cudaGetLastError() after its launch.

#include <algorithm>

#include "mma_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

// ---------------------------------------------------------------- family C

constexpr int COPY_THREADS = 256;
constexpr int COPY_TAPS = 8;  // taps per round: one table read, their loads before any add

// window_copy_sum: a CTA owns rows [i0, i0 + rows) of output block j and
// column pieces [cp uc, cp uc + uc) (uc = min(units, COPY_THREADS) pieces
// of E columns; rows = COPY_THREADS / uc), a thread one piece of one row.
// The tables w0 and add are (taps, nb) int32 with any strides (a table that
// repeats over t has stride 0 there); a window row outside [0, rows_x)
// reads as zero.
template <bool VEC>
__global__ void __launch_bounds__(COPY_THREADS)
window_copy_sum_kernel(const bf16* __restrict__ x, const int* __restrict__ w0,
                       const int* __restrict__ add, float* __restrict__ out,
                       int rows_x, int c, int taps, int block, int wb, int w0_s0,
                       int w0_s1, int add_s0, int add_s1, int parts, int col_parts) {
  constexpr int E = VEC ? 8 : 1;  // columns per piece: a 16-byte load, or one
  __shared__ long long first[COPY_TAPS];  // x row of each tap's chunk's first row
  __shared__ int add_t[COPY_TAPS];
  const int tid = threadIdx.x;
  const int units = c / E, uc = min(units, COPY_THREADS), rows = COPY_THREADS / uc;
  const int cp = blockIdx.x % col_parts, part = blockIdx.x / col_parts % parts;
  const int j = blockIdx.x / col_parts / parts;
  const int i0 = part * rows, nrows = min(rows, block - i0);
  const int row = tid / uc, u = cp * uc + tid % uc;
  const bool mine = row < nrows && u < units;
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  for (int t0 = 0; t0 < taps; t0 += COPY_TAPS) {
    const int nt = min(COPY_TAPS, taps - t0);
    if (tid < nt) {  // this round's tables: one round trip
      first[tid] = (long long)w0[(t0 + tid) * w0_s0 + j * w0_s1] * wb + i0;
      add_t[tid] = add != nullptr ? add[(t0 + tid) * add_s0 + j * add_s1] : 0;
    }
    __syncthreads();
    uint4 raw[COPY_TAPS];  // VEC: the round's 16-byte pieces, loaded before any add
    bf16 one[COPY_TAPS];   // scalar
    if (mine) {
#pragma unroll
      for (int k = 0; k < COPY_TAPS; ++k) {
        if (k >= nt) break;
        const long long r = first[k] + row;
        const bool in = r >= 0 && r < rows_x;
        if constexpr (VEC) {
          raw[k] = make_uint4(0u, 0u, 0u, 0u);
          if (in) raw[k] = __ldg(reinterpret_cast<const uint4*>(x + (size_t)r * c) + u);
        } else {
          one[k] = in ? x[(size_t)r * c + u] : __float2bfloat16(0.f);
        }
      }
#pragma unroll
      for (int k = 0; k < COPY_TAPS; ++k) {
        if (k >= nt) break;
        const float a = (float)add_t[k];
        if constexpr (VEC) {
          const unsigned w[4] = {raw[k].x, raw[k].y, raw[k].z, raw[k].w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {  // a bf16 is the high half of its f32
            acc[2 * q] += __uint_as_float(w[q] << 16) + a;
            acc[2 * q + 1] += __uint_as_float(w[q] & 0xffff0000u) + a;
          }
        } else {
          acc[0] += to_float(one[k]) + a;
        }
      }
    }
    if (t0 + COPY_TAPS < taps) __syncthreads();  // the next round rewrites the tables
  }
  if (!mine) return;
  float* dst = out + ((size_t)j * block + i0 + row) * c + (size_t)u * E;
  if constexpr (VEC) {
    __stcs(reinterpret_cast<float4*>(dst), make_float4(acc[0], acc[1], acc[2], acc[3]));
    __stcs(reinterpret_cast<float4*>(dst) + 1, make_float4(acc[4], acc[5], acc[6], acc[7]));
  } else {
    *dst = acc[0];
  }
}

template <bool VEC>
int launch_window_copy_sum(const bf16* x, const int* w0, const int* add, float* out,
                           int rows_x, int c, int taps, int nb, int block, int wb,
                           int w0_s0, int w0_s1, int add_s0, int add_s1, cudaStream_t s) {
  const int units = VEC ? c / 8 : c;
  const int uc = std::min(units, COPY_THREADS), rows = COPY_THREADS / uc;
  const int parts = (block + rows - 1) / rows, col_parts = (units + uc - 1) / uc;
  window_copy_sum_kernel<VEC>
      <<<(unsigned)((long long)nb * parts * col_parts), COPY_THREADS, 0, s>>>(
          x, w0, add, out, rows_x, c, taps, block, wb, w0_s0, w0_s1, add_s0, add_s1, parts,
          col_parts);
  return static_cast<int>(cudaGetLastError());
}

// window_head_sum: a CTA writes HEAD_ROWS rows of one output block.
constexpr int HEAD_THREADS = 128;
constexpr int HEAD_ROWS = 128;

// R(sum_k x[r, k]): row r of x summed over its c columns in order (zero
// outside [0, rows_x)), rounded to bf16. HEAD_VEC (c a multiple of 8, x
// 16-byte aligned): the row's 16-byte loads go out, 4 at a time, before
// their adds.
template <bool HEAD_VEC>
__device__ __forceinline__ float head_sum(const bf16* __restrict__ x, long long r, int rows_x,
                                          int c) {
  float s = 0.f;
  if (r >= 0 && r < rows_x) {
    const bf16* row = x + (size_t)r * c;
    if constexpr (HEAD_VEC) {
      for (int k0 = 0; k0 < c; k0 += 32) {
        const int n = min(4, (c - k0) / 8);
        uint4 u[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (q < n) u[q] = __ldg(reinterpret_cast<const uint4*>(row + k0) + q);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (q >= n) break;
          // a bf16 is the high half of its f32: the low element first
          const unsigned w[4] = {u[q].x, u[q].y, u[q].z, u[q].w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s += __uint_as_float(w[e] << 16);
            s += __uint_as_float(w[e] & 0xffff0000u);
          }
        }
      }
    } else {
      for (int k = 0; k < c; ++k) s += to_float(row[k]);
    }
  }
  return __bfloat162float(__float2bfloat16(s));
}

// CTA b: output block j = b / parts, its rows part * HEAD_ROWS.. (parts =
// ceil(block / HEAD_ROWS)).
template <bool HEAD_VEC>
__global__ void __launch_bounds__(HEAD_THREADS)
window_head_sum_kernel(const bf16* __restrict__ x, const int* __restrict__ w0,
                       float* __restrict__ out, int rows_x, int c, int taps, int block,
                       int parts, int wb, int w0_s0, int w0_s1) {
  extern __shared__ float heads[];  // (taps, 2): the rounded head sums; then the total
  const int j = blockIdx.x / parts, part = blockIdx.x % parts, tid = threadIdx.x;
  for (int h = tid; h < 2 * taps; h += HEAD_THREADS) {
    const long long r = (long long)w0[(h / 2) * w0_s0 + j * w0_s1] * wb + (h % 2) * wb;
    heads[h] = head_sum<HEAD_VEC>(x, r, rows_x, c);
  }
  __syncthreads();
  if (tid == 0) {  // one thread adds the taps in order; the others read it
    float total = 0.f;
#pragma unroll 9
    for (int t = 0; t < taps; ++t) total += heads[2 * t] + heads[2 * t + 1];
    heads[2 * taps] = total;
  }
  __syncthreads();
  const float total = heads[2 * taps];

  // rows [r0, r1) of the output: floats [r0 c, r1 c), 16-byte streaming
  // stores between scalar ends
  const int r0 = j * block + part * HEAD_ROWS;
  const int len = (min(block, (part + 1) * HEAD_ROWS) - part * HEAD_ROWS) * c;
  float* dst = out + (size_t)r0 * c;
  const int head = min(len, (int)((16 - reinterpret_cast<uintptr_t>(dst) % 16) % 16 / 4));
  const int nvec = (len - head) / 4;
  for (int e = tid; e < head; e += HEAD_THREADS) dst[e] = total;
  float4* v = reinterpret_cast<float4*>(dst + head);
  const float4 t4 = make_float4(total, total, total, total);
#pragma unroll 4
  for (int e = tid; e < nvec; e += HEAD_THREADS) __stcs(v + e, t4);
  for (int e = head + 4 * nvec + tid; e < len; e += HEAD_THREADS) dst[e] = total;
}

template <bool HEAD_VEC>
int launch_window_head_sum(const bf16* x, const int* w0, float* out, int rows_x, int c,
                           int taps, int nb, int block, int wb, int w0_s0, int w0_s1,
                           cudaStream_t s) {
  const size_t smem = (2 * (size_t)taps + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        window_head_sum_kernel<HEAD_VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int parts = (block + HEAD_ROWS - 1) / HEAD_ROWS;
  window_head_sum_kernel<HEAD_VEC><<<(unsigned)((long long)nb * parts), HEAD_THREADS, smem, s>>>(
      x, w0, out, rows_x, c, taps, block, parts, wb, w0_s0, w0_s1);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- family D

// slab_slots: out[c, k] = v(rb[0, c]) for k < 8. A thread owns column c:
// one 4-byte load (a warp reads one 128-byte line, once), v formed in int32
// and converted once, and its 32-byte output row written by two 16-byte
// streaming stores (a warp writes 1 KB contiguously); out must be 16-byte
// aligned. Indices are 32-bit; a row's offset is their 64-bit product.
constexpr int SLOT_THREADS = 128;

__global__ void __launch_bounds__(SLOT_THREADS)
slab_slots_kernel(const int* __restrict__ rb, float* __restrict__ out, int b) {
  const unsigned col = blockIdx.x * SLOT_THREADS + threadIdx.x;
  if (col >= (unsigned)b) return;
  const int r = __ldg(rb + col);
  const float v = (float)(r >= 0 ? r % 8 + 1 : 0);
  float* dst = out + (size_t)col * 8;
  const float4 v4 = make_float4(v, v, v, v);
  __stcs(reinterpret_cast<float4*>(dst), v4);
  __stcs(reinterpret_cast<float4*>(dst) + 1, v4);
}

// lane_concat: out[r, c] = x[r, c mod w_in] for c < w_out (piece p is x's
// block p mod (w_in / width)). A thread owns one piece of E columns of one
// row of x (E = 8: one 16-byte load; 1 on the scalar path), loads it once
// and writes it to every output column j + k w_in below w_out: no division.
// A CTA is (uc pieces) x (CONCAT_THREADS / uc rows); blockIdx.y splits a row
// of more than CONCAT_THREADS pieces. Indices are int32; a row's base is
// their 64-bit product.
constexpr int CONCAT_THREADS = 256;

template <bool VEC>
__global__ void __launch_bounds__(CONCAT_THREADS)
lane_concat_kernel(const bf16* __restrict__ x, float* __restrict__ out, int rows, int w_in,
                   int w_out) {
  constexpr int E = VEC ? 8 : 1;
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  const int j = (blockIdx.y * blockDim.x + threadIdx.x) * E;
  if (row >= rows || j >= min(w_in, w_out)) return;
  const bf16* src = x + (size_t)row * w_in + j;
  float* dst = out + (size_t)row * w_out;
  if constexpr (VEC) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
    // a bf16 is the high half of its f32: the low element first
    const float4 lo = make_float4(__uint_as_float(raw.x << 16), __uint_as_float(raw.x & 0xffff0000u),
                                  __uint_as_float(raw.y << 16), __uint_as_float(raw.y & 0xffff0000u));
    const float4 hi = make_float4(__uint_as_float(raw.z << 16), __uint_as_float(raw.z & 0xffff0000u),
                                  __uint_as_float(raw.w << 16), __uint_as_float(raw.w & 0xffff0000u));
    for (int c = j; c < w_out; c += w_in) {
      __stcs(reinterpret_cast<float4*>(dst + c), lo);
      __stcs(reinterpret_cast<float4*>(dst + c) + 1, hi);
    }
  } else {
    const float v = to_float(*src);
    for (int c = j; c < w_out; c += w_in) dst[c] = v;
  }
}

template <bool VEC>
int launch_lane_concat(const bf16* x, float* out, int rows, int w_in, int w_out,
                       cudaStream_t s) {
  const int units = std::min(w_in, w_out) / (VEC ? 8 : 1);  // pieces a row's threads own
  if (units <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int uc = std::min(units, CONCAT_THREADS);
  const dim3 block(uc, CONCAT_THREADS / uc);
  const dim3 grid((rows + block.y - 1) / block.y, (units + uc - 1) / uc);
  lane_concat_kernel<VEC><<<grid, block, 0, s>>>(x, out, rows, w_in, w_out);
  return static_cast<int>(cudaGetLastError());
}

// sum_rows: out[0, b] = sum_{t < rows} rb[t, b] in f32, rows in order, each
// converted first. A thread owns one column and walks the rows in rounds of
// SUM_ROUND, every load of a round sent before the round's first add. The
// loads take no condition (a row past `rows` reads the last row again and
// adds +0, which leaves the sum's bits as they are: it is never -0); loads
// under `t < rows` let the compiler sink each to its add, a chain of round
// trips (PERF.md).
constexpr int SUM_THREADS = 128;
constexpr int SUM_ROUND = 16;

__global__ void __launch_bounds__(SUM_THREADS)
sum_rows_kernel(const int* __restrict__ rb, float* __restrict__ out, int rows, int b) {
  const int col = blockIdx.x * SUM_THREADS + threadIdx.x;
  if (col >= b) return;
  float acc = 0.f;
  for (int t0 = 0; t0 < rows; t0 += SUM_ROUND) {
    int v[SUM_ROUND];
#pragma unroll
    for (int k = 0; k < SUM_ROUND; ++k) v[k] = __ldg(rb + (size_t)min(t0 + k, rows - 1) * b + col);
#pragma unroll
    for (int k = 0; k < SUM_ROUND; ++k) acc += t0 + k < rows ? (float)v[k] : 0.f;
  }
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
  const bf16* xb = static_cast<const bf16*>(x);
  const int* w0i = static_cast<const int*>(w0);
  const int* addi = static_cast<const int*>(add);
  float* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c % 8 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return launch_window_copy_sum<false>(xb, w0i, addi, o, rows_x, c, taps, nb, block, wb,
                                         w0_s0, w0_s1, add_s0, add_s1, s);
  return launch_window_copy_sum<true>(xb, w0i, addi, o, rows_x, c, taps, nb, block, wb,
                                      w0_s0, w0_s1, add_s0, add_s1, s);
}

int window_head_sum_bf16(const void* x, const void* w0, void* out, int rows_x, int c,
                         int taps, int nb, int block, int wb, int w0_s0, int w0_s1,
                         void* stream) {
  const bf16* xb = static_cast<const bf16*>(x);
  const int* w0i = static_cast<const int*>(w0);
  float* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0)
    return launch_window_head_sum<true>(xb, w0i, o, rows_x, c, taps, nb, block, wb, w0_s0,
                                        w0_s1, s);
  return launch_window_head_sum<false>(xb, w0i, o, rows_x, c, taps, nb, block, wb, w0_s0, w0_s1,
                                       s);
}

// rb's first row (b int32); out (b, 8), 16-byte aligned
int slab_slots(const void* rb, void* out, int b, void* stream) {
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* r = static_cast<const int*>(rb);
  float* o = static_cast<float*>(out);
  slab_slots_kernel<<<(unsigned)(((long long)b + SLOT_THREADS - 1) / SLOT_THREADS), SLOT_THREADS,
                      0, s>>>(r, o, b);
  return static_cast<int>(cudaGetLastError());
}

// x (rows, w_in) with w_in a multiple of width; out (rows, width * pieces)
int lane_concat_bf16(const void* x, void* out, int rows, int w_in, int width,
                     int pieces, void* stream) {
  const bf16* xb = static_cast<const bf16*>(x);
  float* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0)
    return launch_lane_concat<true>(xb, o, rows, w_in, width * pieces, s);
  return launch_lane_concat<false>(xb, o, rows, w_in, width * pieces, s);
}

int sum_rows(const void* rb, void* out, int rows, int b, void* stream) {
  const int* r = static_cast<const int*>(rb);
  float* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  sum_rows_kernel<<<(b + SUM_THREADS - 1) / SUM_THREADS, SUM_THREADS, 0, s>>>(r, o, rows, b);
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
