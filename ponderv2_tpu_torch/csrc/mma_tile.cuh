// Tensor-core gather-GEMM tiles for Hopper: the band conv's forward
// (band_conv.cu: K1), fused backward (band_conv_bwd.cu: K2) and split dW
// (band_conv_bwd.cu: K3), and the probe product tile_matmul
// (probe_kernels.cu: P5 kd).
//
// Replaces, on the card, the Pallas TPU kernels
// ponderv2_tpu/ops/band_conv.py:192 _fwd_kernel (K1), :278 _dxdw_kernel
// (K2), :222 _dw_kernel (K3) and
// tools/experiments/probe_pallas_bisect3.py:96 kd. All are sums of products
// of gathered rows: a row functor ``rows(i, t)`` gives the input row j of
// output row i and tap t, or -1 where the entry is absent or outside its
// window (band_rows.cuh:BandRows; the identity for kd).
//
//   gather_gemm          out[i, c]  = sum_t sum_k a[rows(i, t), k] b[t, k, c]
//                        over whole 16-row slabs (K2's dx: a = g, b = Wm;
//                        kd: one tap, rows(i) = i)
//   compact_gather_gemm  the same function over the live entries only
//                        (K1: a = feats or g, b = W or Wm)
//   dw_gather_gemm       part[m, c] = sum_i f[i, m] g[rows(i, t), c]
//                        over a chunk of rows (K2's and K3's dW, one tap
//                        per CTA)
//
// What bounds them on an H100: at the band conv's widths (32-192 channels)
// a live entry costs one gathered row (64-768 B, mostly from L2) per
// 2 x Cin x Cout FLOPs, and most entries are dead (a surface fills about a
// quarter of the 27 taps). The CUDA-core tile they replace multiplied dead
// rows whenever one of 64 rows was live, padded 96 channels to 128, staged
// synchronously and ran f32 FMAs at half the FMA peak. The design:
//
// - Tensor cores, warp-level mma.sync with f32 accumulation: bf16 runs
//   m16n8k16; f32 runs 3xTF32 (m16n8k8 on hi = tf32(x), lo = tf32(x - hi),
//   accumulating lo.hi + hi.lo + hi.hi), which keeps f32 accuracy (about
//   3 x 2^-22 of each product, against 2^-11 for one TF32 pass) at a third
//   of the TF32 rate.
// - cp.async staging, 16 bytes a thread, zero-fill (src-size 0) for a dead
//   entry, so a dead row costs no memory traffic; NS stages in flight, so
//   the next tap's rows and weights load while this one multiplies.
//   Fragments come from shared memory by ldmatrix (.trans for the operands
//   stored k-major); the f32 operands that ldmatrix cannot transpose are
//   read as scalars from rows padded to 8 mod 32 words (no bank conflicts).
// - Tile widths are template parameters (32, 64, 96 or 128 columns) picked
//   by the wrapper per conv, so 96-channel levels multiply no padding.
// - Skipping: in gather_gemm each warp owns a 16-row slab and skips a tap
//   whose 16 entries are all dead (a warp vote); the CTA loads only taps
//   that some warp needs. compact_gather_gemm compacts each tap's live
//   entries of its rows (in row order) and multiplies only them, adding
//   the products into an output tile in shared memory. dw_gather_gemm
//   reduces over rows, so it compacts the live entries of each 1024-row
//   window (in row order) and multiplies only them.
//
// kStageSums: the tensor cores add into their f32 accumulator rounding
// toward zero, so a sum kept there over thousands of mma (dW's row chunks)
// shrinks by ~1e-4 of its size. The f32 tiles therefore start each stage's
// mma from zero and add the stage's sum into f32 registers with
// round-to-nearest adds; the bias then stays within a stage (12 mma). The
// extra registers limit f32 tiles to 96 columns (the wrapper splits 128
// into two 64s). bf16 keeps one accumulator: its 3e-2 bound leaves room.
//
// Widths must be multiples of 8 (bf16) or 4 (f32) elements and row
// pointers 16-byte aligned: the wrappers pad ragged widths with zeros.
// No atomics: every sum runs in a fixed order, so results are
// deterministic.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace mma {

using bf16 = __nv_bfloat16;

// ------------------------------------------------------------------ PTX

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; a dead copy reads nothing and writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(live ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo + O(2^-22 x): hi and lo are TF32 (10 mantissa bits, rounded
// to nearest)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// 3xTF32: d += a b in three TF32 passes, the small terms first
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh[0], bh[1]);
  mma_tf32(d, ah, bl[0], bl[1]);
  mma_tf32(d, ah, bh[0], bh[1]);
}

template <typename T>
struct Elt;
template <>
struct Elt<bf16> {
  static constexpr int VEC = 8;    // elements per 16-byte copy
  static constexpr int KSTEP = 16;  // depth of one mma
};
template <>
struct Elt<float> {
  static constexpr int VEC = 4;
  static constexpr int KSTEP = 8;
};

__device__ __forceinline__ void store(float* out, int ld, int r, int c, int rows, int cols,
                                      float v) {
  if (r < rows && c < cols) out[(size_t)r * ld + c] = v;
}

// ------------------------------------------------------------------ gather_gemm

// out[row0 : row0 + 16 WM, col0 : col0 + NT] = sum over the CTA's live taps t
// and k < kdim of a[rows(i, t), k] b[t, k, c]. WM x WN warps; warp (wm, wn)
// owns rows 16 wm.. and columns wn NT / WN.. of the tile. Stages are (live
// tap, KC-deep chunk) pairs, NS of them in flight.
template <typename T, int NT, int WM, int WN, int KC, int NS>
struct GatherGemm {
  static constexpr int BN = NT;
  static constexpr int BM = 16 * WM;
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int WNT = NT / WN;
  static constexpr int NTILES = WNT / 8;
  static constexpr int LDA = KC + (sizeof(T) == 2 ? 8 : 4);  // 16 mod 128 B rows: ldmatrix
  static constexpr int LDB = NT + 8;                         // 8 mod 32 words
  static constexpr int STAGE = BM * LDA + KC * LDB;          // elements
  static_assert(WNT % 8 == 0 && KC % Elt<T>::KSTEP == 0 && NS >= 2, "tile shape");

  static __host__ __device__ constexpr size_t smem_bytes(int taps) {
    return (size_t)NS * STAGE * sizeof(T) + (size_t)taps * BM * 4 + (WM + 33) * 4;
  }
};

// The input row of tile row r for one tap: from the tile's lookup table in
// shared memory, or straight from the row functor.
struct TableRow {
  const int* jr;  // the tap's entries
  __device__ __forceinline__ int operator()(int r) const { return jr[r]; }
};
template <typename Rows>
struct DirectRow {
  const Rows& rows_of;
  int row0, m, t;
  __device__ __forceinline__ int operator()(int r) const {
    return row0 + r < m ? rows_of(row0 + r, t) : -1;
  }
};

// Stage s's copies: the A rows of tap t (row_of(r)) from depth k0, and
// W[t]'s k0.. rows at columns col0..; dead entries zero-fill.
template <typename T, int BM, int NT, int KC, int LDA, int LDB, int THREADS, typename RowOf>
__device__ __forceinline__ void gg_copy(T* As, const T* __restrict__ a, const RowOf& row_of,
                                         const T* __restrict__ b, int t, int kdim, int ldb,
                                         int k0, int col0, int tid) {
  constexpr int VEC = Elt<T>::VEC, ACH = KC / VEC, BCH = NT / VEC;
  T* Bs = As + BM * LDA;
  for (int e = tid; e < BM * ACH; e += THREADS) {
    const int r = e / ACH, c = (e % ACH) * VEC;
    const int j = row_of(r);
    const bool live = j >= 0 && k0 + c < kdim;
    cp_async16(As + r * LDA + c, live ? a + (size_t)j * kdim + k0 + c : a, live);
  }
  const T* bt = b + (size_t)t * kdim * ldb;
  for (int e = tid; e < KC * BCH; e += THREADS) {
    const int k = e / BCH, c = (e % BCH) * VEC;
    const bool live = k0 + k < kdim && col0 + c < ldb;
    cp_async16(Bs + k * LDB + c, live ? bt + (size_t)(k0 + k) * ldb + col0 + c : b, live);
  }
}

// acc (16 rows x 8 NTILES columns of the warp) += As (16 x KC) Bs (KC x ...)
template <typename T, int NTILES, int KC, int LDA, int LDB>
__device__ __forceinline__ void gg_mult(float (&acc)[NTILES][4], const T* As, const T* Bs,
                                        int lane) {
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      uint32_t af[4];
      ldsm_x4(af, As + (lane & 15) * LDA + kk + (lane >> 4) * 8);
      const T* bk = Bs + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LDB;
#pragma unroll
      for (int q = 0; q + 1 < NTILES; q += 2) {
        uint32_t bfr[4];
        ldsm_x4_t(bfr, bk + q * 8 + (lane >> 4) * 8);
        mma_bf16(acc[q], af, bfr[0], bfr[1]);
        mma_bf16(acc[q + 1], af, bfr[2], bfr[3]);
      }
      if constexpr (NTILES % 2) {
        uint32_t bfr[2];
        ldsm_x2_t(bfr, bk + (NTILES - 1) * 8);
        mma_bf16(acc[NTILES - 1], af, bfr[0], bfr[1]);
      }
    }
  } else {
    float part[NTILES][4];  // this stage's sum, see kStageSums
#pragma unroll
    for (int q = 0; q < NTILES; ++q) part[q][0] = part[q][1] = part[q][2] = part[q][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 8) {
      uint32_t araw[4], ah[4], al[4];
      ldsm_x4(araw, As + (lane & 15) * LDA + kk + (lane >> 4) * 4);
#pragma unroll
      for (int q = 0; q < 4; ++q) split_tf32(__uint_as_float(araw[q]), ah[q], al[q]);
      const float* bk = reinterpret_cast<const float*>(Bs) + (kk + (lane & 3)) * LDB + (lane >> 2);
#pragma unroll
      for (int q = 0; q < NTILES; ++q) {
        uint32_t bh[2], bl[2];
        split_tf32(bk[q * 8], bh[0], bl[0]);
        split_tf32(bk[q * 8 + 4 * LDB], bh[1], bl[1]);
        mma_3xtf32(part[q], ah, al, bh, bl);
      }
    }
#pragma unroll
    for (int q = 0; q < NTILES; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] += part[q][e];
  }
}

template <typename T, int NT, int WM, int WN, int KC, int NS, typename Rows>
__device__ __forceinline__ void gather_gemm(const T* __restrict__ a, const Rows& rows_of,
                                            int taps, const T* __restrict__ b, int kdim,
                                            int ldb, float* __restrict__ out, int ldo,
                                            int m, int ncols, int row0, int col0,
                                            unsigned char* smem) {
  using G = GatherGemm<T, NT, WM, WN, KC, NS>;
  constexpr int BM = G::BM, THREADS = G::THREADS, LDA = G::LDA, LDB = G::LDB;
  constexpr int NTILES = G::NTILES;
  T* stages = reinterpret_cast<T*>(smem);
  int* jrows = reinterpret_cast<int*>(smem + (size_t)NS * G::STAGE * sizeof(T));
  unsigned* wmask = reinterpret_cast<unsigned*>(jrows + taps * BM);
  int* tap_list = reinterpret_cast<int*>(wmask + WM);  // [32] and the count

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WM, wn = warp / WM;

  const int nkc = (kdim + KC - 1) / KC;
  float acc[NTILES][4];
#pragma unroll
  for (int q = 0; q < NTILES; ++q) acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.f;
#define GG_MULT(s)                                                                     \
  gg_mult<T, NTILES, KC, LDA, LDB>(acc, stages + ((s) % NS) * G::STAGE + wm * 16 * LDA, \
                                   stages + ((s) % NS) * G::STAGE + BM * LDA + wn * G::WNT, lane)

  if (taps == 1 && nkc <= NS - 1) {
    // one tap, all of K in flight at once (kd): no lookup table and no vote
    // (the dead rows are zeros), so the copies start at once
    const DirectRow<Rows> row_of{rows_of, row0, m, 0};
    for (int s = 0; s < nkc; ++s)
      gg_copy<T, BM, NT, KC, LDA, LDB, THREADS>(stages + s * G::STAGE, a, row_of, b, 0, kdim,
                                                 ldb, s * KC, col0, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int s = 0; s < nkc; ++s) GG_MULT(s);
  } else {
    // every entry of the tile; e runs along rbt's rows, so the reads coalesce
    for (int e = tid; e < taps * BM; e += THREADS) {
      const int r = e / taps, t = e % taps;
      jrows[t * BM + r] = row0 + r < m ? rows_of(row0 + r, t) : -1;
    }
    __syncthreads();
    // the warp's vote: a tap is live for its slab if one of 16 entries is
    unsigned my_taps = 0;
    for (int t = 0; t < taps; ++t)
      if (__any_sync(0xffffffffu, jrows[t * BM + wm * 16 + (lane & 15)] >= 0))
        my_taps |= 1u << t;
    if (lane == 0 && warp < WM) wmask[wm] = my_taps;
    __syncthreads();
    if (tid == 0) {
      unsigned any = 0;
      for (int w = 0; w < WM; ++w) any |= wmask[w];
      int c = 0;
      for (int t = 0; t < taps; ++t)
        if (any >> t & 1u) tap_list[c++] = t;
      tap_list[32] = c;
    }
    __syncthreads();
    const int nstages = tap_list[32] * nkc;

    // stage s: its buffer, tap and depth; a warp multiplies the stages whose
    // tap is live in its slab
#define GG_COPY(s)                                                                    \
  gg_copy<T, BM, NT, KC, LDA, LDB, THREADS>(                                          \
      stages + ((s) % NS) * G::STAGE, a, TableRow{jrows + tap_list[(s) / nkc] * BM}, b, \
      tap_list[(s) / nkc], kdim, ldb, ((s) % nkc) * KC, col0, tid)
    for (int s = 0; s < NS - 1; ++s) {
      if (s < nstages) GG_COPY(s);
      cp_async_commit();
    }
    for (int s = 0; s < nstages; ++s) {
      cp_async_wait<NS - 2>();
      __syncthreads();  // stage s landed; stage s - 1's buffer is free
      if (s + NS - 1 < nstages) GG_COPY(s + NS - 1);
      cp_async_commit();
      if (my_taps >> tap_list[s / nkc] & 1u) GG_MULT(s);  // else all 16 entries dead
    }
    cp_async_wait<0>();
#undef GG_COPY
  }
#undef GG_MULT

  const int r = wm * 16 + (lane >> 2);
#pragma unroll
  for (int q = 0; q < NTILES; ++q) {
    const int c = col0 + wn * G::WNT + q * 8 + 2 * (lane & 3);
    store(out, ldo, row0 + r, c, m, ncols, acc[q][0]);
    store(out, ldo, row0 + r, c + 1, m, ncols, acc[q][1]);
    store(out, ldo, row0 + r + 8, c, m, ncols, acc[q][2]);
    store(out, ldo, row0 + r + 8, c + 1, m, ncols, acc[q][3]);
  }
}

// ------------------------------------------------------------------ compact_gather_gemm

// out[row0 : row0 + BM, col0 : col0 + NT] = sum over taps t < taps, in
// order, of a[rows(i, t)] b[t] over the live entries only (gather_gemm's
// function, without its dead rows). BM (a multiple of 32, at most 256)
// output rows per CTA, 8 warps.
//
// - Entries: the tile's rows(i, t) are read once (along rbt's rows, so the
//   reads coalesce) into a (tap, row) table; then warp w compacts taps w,
//   w + 8, ... in place, in row order (a ballot and a running prefix per
//   32 rows), keeping each live entry's input row and local output row.
// - Stages: (live tap, KC-deep chunk) pairs, NS in flight (cp.async). A
//   stage copies the tap's compacted rows, rounded up to whole 16-row
//   slabs (zero-filled past the last live one), and W[t]'s KC x NT slice.
// - Products: a stage's work is ceil(live / 16) slabs x NT / 32 column
//   groups; each warp takes items w, w + 8, ..., multiplies its slab and
//   32 columns from zero (gg_mult: bf16 mma, f32 as 3xTF32), and adds the
//   16 x 32 result into an f32 output tile in shared memory at the rows
//   the list names, with round-to-nearest adds.
// - Order: within a stage the items' rows and columns are disjoint, and a
//   barrier separates stages, which run in (tap, chunk) order; so every
//   output element is summed in one fixed order, with no atomics, and no
//   sum is kept in a tensor-core accumulator for longer than one stage.
// - Epilogue: the tile is written once, coalesced.
template <typename T_, int NT_, int BM_, int KC_, int NS_>
struct CompactGemm {
  using T = T_;
  static constexpr int NT = NT_, BM = BM_, KC = KC_, NS = NS_;
  static constexpr int THREADS = 256, WARPS = THREADS / 32;
  static constexpr int CG = 32;  // columns of a warp's item: 4 n-tiles
  static constexpr int NG = NT / CG;
  static constexpr int LDA = KC + (sizeof(T) == 2 ? 8 : 4);  // as GatherGemm's
  static constexpr int LDB = NT + 8;
  static constexpr int LDO = NT + 8;  // f32 output tile, 8 mod 32 words
  static constexpr int STAGE = BM * LDA + KC * LDB;  // elements
  static_assert(NT % CG == 0 && KC % Elt<T>::KSTEP == 0 && NS >= 2 && BM % 32 == 0 &&
                    BM <= 256,
                "tile shape");

  // stages | output tile (f32) | entries (int, taps x BM) | counts and the
  // live-tap list (int, 32 + 33) | local rows (uint8, taps x BM)
  static __host__ __device__ constexpr size_t smem_bytes(int taps) {
    return (size_t)NS * STAGE * sizeof(T) + (size_t)BM * LDO * 4 + (size_t)taps * BM * 4 +
           65 * 4 + (size_t)taps * BM;
  }
};

template <typename C, typename Rows, typename T = typename C::T>
__device__ __forceinline__ void compact_gather_gemm(const T* __restrict__ a, const Rows& rows_of,
                                                    int taps, const T* __restrict__ b, int kdim,
                                                    int ldb, float* __restrict__ out, int ldo,
                                                    int m, int ncols, int row0, int col0,
                                                    unsigned char* smem) {
  constexpr int NT = C::NT, BM = C::BM, KC = C::KC, NS = C::NS;
  constexpr int THREADS = C::THREADS, WARPS = C::WARPS, LDA = C::LDA, LDB = C::LDB;
  constexpr int LDO = C::LDO, NG = C::NG, VEC = Elt<T>::VEC;
  constexpr int ACH = KC / VEC, BCH = NT / VEC;
  T* stages = reinterpret_cast<T*>(smem);
  float* outs = reinterpret_cast<float*>(smem + (size_t)NS * C::STAGE * sizeof(T));
  int* lj = reinterpret_cast<int*>(outs + BM * LDO);  // [t][pos]: input row
  int* cnt = lj + taps * BM;                          // [32]: live entries per tap
  int* tap_list = cnt + 32;                           // [32] and the count
  unsigned char* li = reinterpret_cast<unsigned char*>(tap_list + 33);  // [t][pos]: row - row0

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int e = tid; e < BM * NT / 4; e += THREADS) {
    const int r = e / (NT / 4), c = (e % (NT / 4)) * 4;
    *reinterpret_cast<float4*>(outs + r * LDO + c) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int e = tid; e < taps * BM; e += THREADS) {
    const int r = e / taps, t = e % taps;
    lj[t * BM + r] = row0 + r < m ? rows_of(row0 + r, t) : -1;
  }
  __syncthreads();
  // in place: the entries of rows g.. land at positions < g + 32, which
  // the warp has read already
  for (int t = warp; t < taps; t += WARPS) {
    int* jt = lj + t * BM;
    unsigned char* it = li + t * BM;
    int base = 0;
    for (int g = 0; g < BM; g += 32) {
      const int j = jt[g + lane];
      const unsigned vote = __ballot_sync(0xffffffffu, j >= 0);
      if (j >= 0) {
        const int pos = base + __popc(vote & ((1u << lane) - 1u));
        jt[pos] = j;
        it[pos] = static_cast<unsigned char>(g + lane);
      }
      base += __popc(vote);
    }
    if (lane == 0) cnt[t] = base;
  }
  __syncthreads();
  if (tid == 0) {
    int c = 0;
    for (int t = 0; t < taps; ++t)
      if (cnt[t] > 0) tap_list[c++] = t;
    tap_list[32] = c;
  }
  __syncthreads();
  const int nkc = (kdim + KC - 1) / KC;
  const int nstages = tap_list[32] * nkc;

  // stage s: tap tap_list[s / nkc], depth (s % nkc) KC
  auto copy = [&](int s) {
    T* As = stages + (s % NS) * C::STAGE;
    T* Bs = As + BM * LDA;
    const int t = tap_list[s / nkc], k0 = (s % nkc) * KC, live = cnt[t];
    const int* jt = lj + t * BM;
    const int nrows = (live + 15) / 16 * 16;
    for (int e = tid; e < nrows * ACH; e += THREADS) {
      const int r = e / ACH, c = (e % ACH) * VEC;
      const bool ok = r < live && k0 + c < kdim;
      cp_async16(As + r * LDA + c, ok ? a + (size_t)jt[r] * kdim + k0 + c : a, ok);
    }
    const T* bt = b + (size_t)t * kdim * ldb;
    for (int e = tid; e < KC * BCH; e += THREADS) {
      const int k = e / BCH, c = (e % BCH) * VEC;
      const bool ok = k0 + k < kdim && col0 + c < ldb;
      cp_async16(Bs + k * LDB + c, ok ? bt + (size_t)(k0 + k) * ldb + col0 + c : b, ok);
    }
  };

  for (int s = 0; s < NS - 1; ++s) {
    if (s < nstages) copy(s);
    cp_async_commit();
  }
  for (int s = 0; s < nstages; ++s) {
    cp_async_wait<NS - 2>();
    __syncthreads();  // stage s landed; stage s - 1's products are added
    if (s + NS - 1 < nstages) copy(s + NS - 1);
    cp_async_commit();
    const T* As = stages + (s % NS) * C::STAGE;
    const T* Bs = As + BM * LDA;
    const int t = tap_list[s / nkc], live = cnt[t];
    const unsigned char* it = li + t * BM;
    const int items = (live + 15) / 16 * NG;
    for (int item = warp; item < items; item += WARPS) {
      const int slab = item / NG, cg = item % NG;
      float acc[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.f;
      gg_mult<T, 4, KC, LDA, LDB>(acc, As + slab * 16 * LDA, Bs + cg * C::CG, lane);
      const int p0 = slab * 16 + (lane >> 2), p1 = p0 + 8;
      const int c = cg * C::CG + 2 * (lane & 3);
      if (p0 < live) {
        float* o = outs + it[p0] * LDO + c;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float2 v = *reinterpret_cast<float2*>(o + q * 8);
          v.x += acc[q][0];
          v.y += acc[q][1];
          *reinterpret_cast<float2*>(o + q * 8) = v;
        }
      }
      if (p1 < live) {
        float* o = outs + it[p1] * LDO + c;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float2 v = *reinterpret_cast<float2*>(o + q * 8);
          v.x += acc[q][2];
          v.y += acc[q][3];
          *reinterpret_cast<float2*>(o + q * 8) = v;
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  for (int e = tid; e < BM * NT; e += THREADS) {
    const int r = e / NT, c = e % NT;
    if (row0 + r < m && col0 + c < ncols) out[(size_t)(row0 + r) * ldo + col0 + c] = outs[r * LDO + c];
  }
}

// ------------------------------------------------------------------ dw_gather_gemm

// part[m, c] over the tile (ci0 + MT, co0 + NT) = sum over rows i in
// [r_begin, r_end) of f[i, m] g[rows(i, t), c]. 8 warps as 2 (M) x 4 (N).
// Per window of WIN rows: each row's entry, then the live entries compacted
// in row order (warp ballots and a prefix over the warps), then stages of
// KR live entries each, NS in flight. Only live entries are multiplied
// (a window's last stage is padded with zero rows).
template <typename T, int MT, int NT, int NS>
struct DwGemm {
  static constexpr int THREADS = 256;
  static constexpr int WMT = MT / 2, WNT = NT / 4;
  static constexpr int MTILES = WMT / 16, NTILES = WNT / 8;
  static constexpr int KR = 32;  // entries per stage
  static constexpr int LDF = MT + 8, LDG = NT + 8;
  static constexpr int STAGE = KR * (LDF + LDG);
  static constexpr int WIN = 1024, SUB = WIN / THREADS;
  static_assert(WMT % 16 == 0 && WNT % 8 == 0 && NS >= 2, "tile shape");

  static __host__ __device__ constexpr size_t smem_bytes() {
    return (size_t)NS * STAGE * sizeof(T) + (2 * WIN + SUB * 8) * 4;
  }
};

// Stage s's copies: the f rows (w0 + li) and g rows (lj) of live entries
// s KR.. of the window, zero rows past the last.
template <typename T, int MT, int NT, int KR, int LDF, int LDG, int THREADS>
__device__ __forceinline__ void dw_copy(T* Fs, const T* __restrict__ f, int ldf,
                                         const T* __restrict__ g, int ldg, const int* li,
                                         const int* lj, int w0, int nlive, int s, int ci0,
                                         int co0, int tid) {
  constexpr int VEC = Elt<T>::VEC, FCH = MT / VEC, GCH = NT / VEC;
  T* Gs = Fs + KR * LDF;
  for (int e = tid; e < KR * (FCH + GCH); e += THREADS) {
    const bool is_f = e < KR * FCH;
    const int e2 = is_f ? e : e - KR * FCH;
    const int ch = is_f ? FCH : GCH;
    const int r = e2 / ch, c = (e2 % ch) * VEC;
    const int pos = s * KR + r;
    if (is_f) {
      const bool ok = pos < nlive && ci0 + c < ldf;
      cp_async16(Fs + r * LDF + c, ok ? f + (size_t)(w0 + li[pos]) * ldf + ci0 + c : f, ok);
    } else {
      const bool ok = pos < nlive && co0 + c < ldg;
      cp_async16(Gs + r * LDG + c, ok ? g + (size_t)lj[pos] * ldg + co0 + c : g, ok);
    }
  }
}

template <typename T, int MT, int NT, int NS, typename Rows>
__device__ __forceinline__ void dw_gather_gemm(const T* __restrict__ f, int ldf,
                                               const T* __restrict__ g, int ldg,
                                               const Rows& rows_of, int t,
                                               float* __restrict__ part, int cin, int cout,
                                               int ci0, int co0, int r_begin, int r_end,
                                               unsigned char* smem) {
  using D = DwGemm<T, MT, NT, NS>;
  constexpr int THREADS = D::THREADS, LDF = D::LDF, LDG = D::LDG, WIN = D::WIN;
  constexpr int SUB = D::SUB, KR = D::KR;
  constexpr int MTILES = D::MTILES, NTILES = D::NTILES;
  T* stages = reinterpret_cast<T*>(smem);
  int* li = reinterpret_cast<int*>(smem + (size_t)NS * D::STAGE * sizeof(T));  // row - w0
  int* lj = li + WIN;                                                          // its entry
  int* cnt = lj + WIN;  // live entries per (sub-window, warp)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mb = (warp & 1) * D::WMT, nb = (warp >> 1) * D::WNT;

  float acc[MTILES][NTILES][4];
#pragma unroll
  for (int p = 0; p < MTILES; ++p)
#pragma unroll
    for (int q = 0; q < NTILES; ++q) acc[p][q][0] = acc[p][q][1] = acc[p][q][2] = acc[p][q][3] = 0.f;

  for (int w0 = r_begin; w0 < r_end; w0 += WIN) {
    __syncthreads();  // the last window's stages and lists are consumed
    int js[SUB];
    unsigned votes[SUB];
#pragma unroll
    for (int q = 0; q < SUB; ++q) {
      const int i = w0 + q * THREADS + tid;
      js[q] = i < r_end ? rows_of(i, t) : -1;
      votes[q] = __ballot_sync(0xffffffffu, js[q] >= 0);
      if (lane == 0) cnt[q * 8 + warp] = __popc(votes[q]);
    }
    __syncthreads();
    int nlive = 0, base[SUB];
#pragma unroll
    for (int k = 0; k < SUB * 8; ++k) {
      if (k % 8 == warp) base[k / 8] = nlive;
      nlive += cnt[k];
    }
#pragma unroll
    for (int q = 0; q < SUB; ++q)
      if (js[q] >= 0) {
        const int pos = base[q] + __popc(votes[q] & ((1u << lane) - 1u));
        li[pos] = q * THREADS + tid;
        lj[pos] = js[q];
      }
    __syncthreads();
    const int nstages = (nlive + KR - 1) / KR;


    for (int s = 0; s < NS - 1; ++s) {
      if (s < nstages)
        dw_copy<T, MT, NT, KR, LDF, LDG, THREADS>(stages + (s % NS) * D::STAGE, f, ldf, g, ldg,
                                                   li, lj, w0, nlive, s, ci0, co0, tid);
      cp_async_commit();
    }
    for (int s = 0; s < nstages; ++s) {
      cp_async_wait<NS - 2>();
      __syncthreads();
      const int sn = s + NS - 1;
      if (sn < nstages)
        dw_copy<T, MT, NT, KR, LDF, LDG, THREADS>(stages + (sn % NS) * D::STAGE, f, ldf, g, ldg,
                                                   li, lj, w0, nlive, sn, ci0, co0, tid);
      cp_async_commit();
      const T* Fs = stages + (s % NS) * D::STAGE;
      const T* Gs = Fs + KR * LDF;
      const int kr = min(KR, nlive - s * KR);  // the rows past it are zeros
      if constexpr (sizeof(T) == 2) {
        for (int kk = 0; kk < kr; kk += 16) {
          uint32_t bfr[NTILES][2];
          const T* gk = Gs + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LDG + nb;
#pragma unroll
          for (int q = 0; q + 1 < NTILES; q += 2) {
            uint32_t r4[4];
            ldsm_x4_t(r4, gk + q * 8 + (lane >> 4) * 8);
            bfr[q][0] = r4[0], bfr[q][1] = r4[1], bfr[q + 1][0] = r4[2], bfr[q + 1][1] = r4[3];
          }
          if constexpr (NTILES % 2) ldsm_x2_t(bfr[NTILES - 1], gk + (NTILES - 1) * 8);
          // A = F^T from the k-major F rows: .trans
          const T* fk = Fs + (kk + (lane & 7) + (lane >> 4) * 8) * LDF + mb + ((lane >> 3) & 1) * 8;
#pragma unroll
          for (int p = 0; p < MTILES; ++p) {
            uint32_t af[4];
            ldsm_x4_t(af, fk + p * 16);
#pragma unroll
            for (int q = 0; q < NTILES; ++q) mma_bf16(acc[p][q], af, bfr[q][0], bfr[q][1]);
          }
        }
      } else {
        const float* Ff = reinterpret_cast<const float*>(Fs);
        const float* Gf = reinterpret_cast<const float*>(Gs);
        float sum[MTILES][NTILES][4];  // this stage's sum, see kStageSums
#pragma unroll
        for (int p = 0; p < MTILES; ++p)
#pragma unroll
          for (int q = 0; q < NTILES; ++q) sum[p][q][0] = sum[p][q][1] = sum[p][q][2] = sum[p][q][3] = 0.f;
        for (int kk = 0; kk < kr; kk += 8) {
          uint32_t bh[NTILES][2], bl[NTILES][2];
          const float* gk = Gf + (kk + (lane & 3)) * LDG + nb + (lane >> 2);
#pragma unroll
          for (int q = 0; q < NTILES; ++q) {
            split_tf32(gk[q * 8], bh[q][0], bl[q][0]);
            split_tf32(gk[q * 8 + 4 * LDG], bh[q][1], bl[q][1]);
          }
          const float* fk = Ff + (kk + (lane & 3)) * LDF + mb + (lane >> 2);
#pragma unroll
          for (int p = 0; p < MTILES; ++p) {
            uint32_t ah[4], al[4];
            split_tf32(fk[p * 16], ah[0], al[0]);
            split_tf32(fk[p * 16 + 8], ah[1], al[1]);
            split_tf32(fk[p * 16 + 4 * LDF], ah[2], al[2]);
            split_tf32(fk[p * 16 + 4 * LDF + 8], ah[3], al[3]);
#pragma unroll
            for (int q = 0; q < NTILES; ++q) mma_3xtf32(sum[p][q], ah, al, bh[q], bl[q]);
          }
        }
#pragma unroll
        for (int p = 0; p < MTILES; ++p)
#pragma unroll
          for (int q = 0; q < NTILES; ++q)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[p][q][e] += sum[p][q][e];
      }
    }
    cp_async_wait<0>();
  }

#pragma unroll
  for (int p = 0; p < MTILES; ++p) {
    const int r = ci0 + mb + p * 16 + (lane >> 2);
#pragma unroll
    for (int q = 0; q < NTILES; ++q) {
      const int c = co0 + nb + q * 8 + 2 * (lane & 3);
      store(part, cout, r, c, cin, cout, acc[p][q][0]);
      store(part, cout, r, c + 1, cin, cout, acc[p][q][1]);
      store(part, cout, r + 8, c, cin, cout, acc[p][q][2]);
      store(part, cout, r + 8, c + 1, cin, cout, acc[p][q][3]);
    }
  }
}

}  // namespace mma
