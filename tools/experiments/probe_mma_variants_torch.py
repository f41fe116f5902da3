#!/usr/bin/env python3
"""Time variants of the tensor-core gather-GEMM tiles (``csrc/mma_tile.cuh``)
on a GPU: K1 (``band_fwd_core``) and K2 (``band_dxdw_core``) at the
fine-tune batch's real band plans, K4 (``windowed_conv_fwd``) at
``chip_smoke.py`` phase 12's six convs, and P5 ``kd`` (``tile_matmul``) at
its probe's shape; and of P7 V5 (``window_head_sum``), the row gather-sum
(``csrc/row_gather.cu``: P1, P2, P3 ``k1``) and the window copy-sum
(``window_copy_sum``: P3 ``k0``, P4 A-D), P5 ``ka`` (``slab_slots``),
``kb`` (``lane_concat``) and ``kc2`` (``sum_rows``) at their probes'
shapes.

    python tools/experiments/probe_mma_variants_torch.py k1 [variant,...]
    python tools/experiments/probe_mma_variants_torch.py k2 [variant,...]
    python tools/experiments/probe_mma_variants_torch.py k4 [variant,...]
    python tools/experiments/probe_mma_variants_torch.py kd [variant,...]
    python tools/experiments/probe_mma_variants_torch.py v5 [variant,...]
    python tools/experiments/probe_mma_variants_torch.py p1 [variant,...]
    python tools/experiments/probe_mma_variants_torch.py k0 [variant,...]
    python tools/experiments/probe_mma_variants_torch.py ka [variant,...]
    python tools/experiments/probe_mma_variants_torch.py kb [variant,...]
    python tools/experiments/probe_mma_variants_torch.py kc2 [variant,...]

Each variant is a copy of the kernel sources with a few text edits (K1:
``routed`` as built, the compacted tile in f32 and K2's dx tile in bf16;
``slabs`` K2's dx tile, ``gather_gemm``, which multiplies whole 16-row
slabs, in both dtypes; ``compacted`` and ``rRRR_kcKK_nsN`` (other rows per
CTA, k-chunks and stages) the compacted tile in both; K4: ``slabs`` as
built, ``compacted`` the other tile, in both dtypes; K2: ``nodw`` / ``nodx`` launch
only one CTA range, ``onepass`` keeps one TF32 product of three; K1, K2: ``kstep`` adds each
k-step's products into the output with round-to-nearest adds; kd: other
tile shapes, ``noload`` / ``nomult`` drop the copies or the products,
``empty`` returns at once; v5: ``nostore`` forms the head sums and writes
nothing, ``noop`` returns at once, ``alltotal`` has every thread add the
taps, ``plainst`` / ``wt`` / ``evictfirst`` store without the streaming
hint, write-through, or with an L2 evict-first policy, ``rows64`` /
``rows512`` give a CTA other rows; p1: ``base`` the vector path, ``warp``
a warp per batch of rows with its entries passed on by shuffles, ``stcs`` /
``stcg`` other store hints, ``noidx`` / ``nowin`` / ``nostore`` drop the
entry reads, the window or the stores, ``empty`` returns at once; k0:
``base`` the register route, ``ctaN`` N threads a CTA, ``plainst`` plain
stores, ``empty``; ka: ``base`` a column a thread, ``ctaN`` N-thread
CTAs, ``vec4`` 4 columns a thread by one 16-byte load, ``plainst`` plain
stores, ``old`` the former design, a thread per output element,
``nostore``, ``empty``; kb: ``base`` a thread per 16-byte piece of x,
``ctaN`` N-thread CTAs, ``outpiece`` a thread per 8-column piece of the
output, ``old`` the former design, a thread per output element, ``nostore``,
``empty``; kc2: ``base`` a column a thread in 128-thread CTAs, ``ctaN``
N-thread CTAs, ``vec`` / ``vec32`` 4 columns a thread by 16-byte loads in
128- or 32-thread CTAs, ``predload`` loads and adds under ``t < rows``,
``old`` the former kernel, ``empty``), built with
the package's nvcc flags into
``ponderv2_tpu_torch/csrc/_build/variants/`` in parallel and bound in place
of the package's build. K1, K2: CUDA events over 5 calls after a warm-up,
each variant twice (in order, then reversed), f32 and bf16, with the max
abs error against the plain version, and the plain version's and each
variant's error against the plain version in float64 (of max|out|). kd: the probe timing of
``chip_smoke.py`` phase 13 (CUDA-graph replay, L2 flushed before each call)
beside ``torch.mm``; v5 the same timing, L2 flushed and warm, in turns,
beside ``Tensor.fill_`` of the same 21 MB output (a fresh tensor and one
reused), the least a kernel that writes it could take; p1 and k0 the same
timing at each of their probes, and whether the output equals the plain
version's (ka, kb and kc2 too), then the floor's time beside each probe
with one. Variants that drop work give wrong results on purpose.
"""

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tools", "experiments")]

import torch  # noqa: E402

from ponderv2_tpu_torch.ops import band_conv as bc  # noqa: E402
from ponderv2_tpu_torch.ops import probe_kernels as pk  # noqa: E402
from ponderv2_tpu_torch.ops.cuda_build import BUILD_DIR, CSRC, NVCC_FLAGS, _nvcc  # noqa: E402

HEADERS = ("band_rows.cuh", "mma_tile.cuh")
ONEPASS = ("  mma_tf32(d, al, bh[0], bh[1]);\n  mma_tf32(d, ah, bl[0], bl[1]);\n", "")
# gg_mult's f32 path (K1's compacted tile, K2's dx slabs) with each k-step's
# three TF32 products summed from zero and added into the output with
# round-to-nearest adds, instead of a stage's KC / 8 k-steps kept in one
# tensor-core accumulator (which rounds toward zero)
KSTEP = [
    ("mma_tile.cuh", """    float part[NTILES][4];  // this stage's sum, see kStageSums
#pragma unroll
    for (int q = 0; q < NTILES; ++q) part[q][0] = part[q][1] = part[q][2] = part[q][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 8) {
      uint32_t araw[4], ah[4], al[4];""", """#pragma unroll
    for (int kk = 0; kk < KC; kk += 8) {
      float part[NTILES][4];
#pragma unroll
      for (int q = 0; q < NTILES; ++q) part[q][0] = part[q][1] = part[q][2] = part[q][3] = 0.f;
      uint32_t araw[4], ah[4], al[4];"""),
    ("mma_tile.cuh", """        mma_3xtf32(part[q], ah, al, bh, bl);
      }
    }
#pragma unroll
    for (int q = 0; q < NTILES; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] += part[q][e];
  }
}""", """        mma_3xtf32(part[q], ah, al, bh, bl);
      }
#pragma unroll
      for (int q = 0; q < NTILES; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][e] += part[q][e];
    }
  }
}"""),
]
K2 = {
    "base": [],
    "nodw": [("band_conv_bwd.cu", "  if (b < ndw) {\n", "  if (b < ndw) {\n    return;\n")],
    "nodx": [("band_conv_bwd.cu", "    b -= ndw;\n", "    return;\n    b -= ndw;\n")],
    "onepass": [("mma_tile.cuh", *ONEPASS)],
    "kstep": KSTEP,
}
# K1: the tile follows the dtype (kCompact: f32 compacted, bf16 slabs);
# a variant edits that choice or the compacted tile's shape.
K1_LINE = "#define K1_TILE 256, 16, 3"
K1_CHOICE = "constexpr bool kCompact = sizeof(T) == 4;"
K1 = {
    "routed": [],
    "slabs": [("band_conv.cu", K1_CHOICE, "constexpr bool kCompact = false;")],
    "compacted": [("band_conv.cu", K1_CHOICE, "constexpr bool kCompact = true;")],
    "kstep": KSTEP,
    **{f"r{r}_kc{k}_ns{n}": [("band_conv.cu", K1_CHOICE, "constexpr bool kCompact = true;"),
                             ("band_conv.cu", K1_LINE, f"#define K1_TILE {r}, {k}, {n}")]
       for r, k, n in [(128, 32, 2), (128, 32, 3), (64, 32, 3)]},
}
# K4: the slab tile in both dtypes as built, or compact_gather_gemm (256
# rows, 16-deep stages, 3 in flight: K1's f32 tile) over the tap-major
# rulebook: the table filled along a tap's rows, taps from t0, and 125 taps
# walked in groups of 32 into one output tile (zeroed by the first group,
# written by the last)
K4_COMPACT_ROWS = 256
COMPACT_GROUPS = """// compact_gather_gemm over any number of taps, in groups of kTapGroup
template <typename C, typename Rows, typename T = typename C::T>
__device__ __forceinline__ void compact_gather_gemm_groups(
    const T* __restrict__ a, const Rows& rows_of, int taps, const T* __restrict__ b, int kdim,
    int ldb, float* __restrict__ out, int ldo, int m, int ncols, int row0, int col0,
    unsigned char* smem) {
  for (int t0 = 0; t0 < taps; t0 += kTapGroup)
    compact_gather_gemm<C>(a, rows_of, min(kTapGroup, taps - t0), b, kdim, ldb, out, ldo, m,
                           ncols, row0, col0, smem, t0, t0 == 0, t0 + kTapGroup >= taps);
}

"""
K4 = {
    "slabs": [],
    "compacted": [
        ("mma_tile.cuh", "(size_t)BM * LDO * 4 + (size_t)taps * BM * 4 +\n"
                         "           65 * 4 + (size_t)taps * BM;",
         "(size_t)BM * LDO * 4 + (size_t)table_taps(taps) * BM * 4 +\n"
         "           65 * 4 + (size_t)table_taps(taps) * BM;"),
        ("mma_tile.cuh", "unsigned char* smem) {\n  constexpr int NT = C::NT,",
         "unsigned char* smem, int t0 = 0, bool first = true, bool last = true) {\n"
         "  constexpr int NT = C::NT,"),
        ("mma_tile.cuh", "  for (int e = tid; e < BM * NT / 4; e += THREADS) {",
         "  if (first)\n  for (int e = tid; e < BM * NT / 4; e += THREADS) {"),
        ("mma_tile.cuh", "    const int r = e / taps, t = e % taps;\n"
                         "    lj[t * BM + r] = row0 + r < m ? rows_of(row0 + r, t) : -1;",
         "    const int r = e % BM, t = e / BM;\n"
         "    lj[t * BM + r] = row0 + r < m ? rows_of(row0 + r, t0 + t) : -1;"),
        ("mma_tile.cuh", "    const T* bt = b + (size_t)t * kdim * ldb;",
         "    const T* bt = b + (size_t)(t0 + t) * kdim * ldb;"),
        ("mma_tile.cuh", "  cp_async_wait<0>();\n  __syncthreads();\n\n"
                         "  for (int e = tid; e < BM * NT; e += THREADS) {",
         "  cp_async_wait<0>();\n  __syncthreads();\n  if (!last) return;\n"
         "  for (int e = tid; e < BM * NT; e += THREADS) {"),
        ("mma_tile.cuh", "// ------------------------------------------------------------------ "
                         "dw_gather_gemm", COMPACT_GROUPS + "// ---------------------------------"
                         "--------------------------------- dw_gather_gemm"),
        ("windowed_gather.cu", "using FwdTile = mma::GatherGemm<T, NT, 8, 1, 32, NSTAGE>;",
         f"using FwdTile = mma::CompactGemm<T, NT, {K4_COMPACT_ROWS}, 16, NSTAGE>;"),
        ("windowed_gather.cu", "mma::gather_gemm<T, NT, 8, 1, 32, NSTAGE, true>(",
         "mma::compact_gather_gemm_groups<FwdTile<T, NT>>("),
    ],
}
KD_LINE = "#define KD_TILE "
# kd runs gather_gemm's one-tap path
NOLOAD = ("mma_tile.cuh", "      gg_copy<T, BM, NT, KC, LDA, LDB, THREADS>(stages + s * G::STAGE, a, row_of, b, 0, kdim,\n"
          "                                                 ldb, s * KC, col0, tid);\n", "      ;\n")
NOMULT = ("mma_tile.cuh", "    for (int s = 0; s < nkc; ++s) GG_MULT(s);\n", "")
EMPTY = ("probe_kernels.cu", "  extern __shared__ __align__(16) unsigned char smem[];\n  mma::",
         "  extern __shared__ __align__(16) unsigned char smem[];\n  if (m > 0) return;\n  mma::")
# kd: (tile parameters of KD_TILE, or None for the source's own; edits)
KD = {
    "base": (None, []),
    "noload": (None, [NOLOAD]),
    "nomult": (None, [NOMULT]),
    "empty": (None, [EMPTY]),
    "n32_wn4_kc96": ("bf16, 32, 1, 4, 96, 4", []),
    "n32_wn4_kc144": ("bf16, 32, 1, 4, 144, 3", []),
    "n32_wn4_kc32": ("bf16, 32, 1, 4, 32, 10", []),
    "n16_wn2_kc288": ("bf16, 16, 1, 2, 288, 2", []),
    "n8_kc288": ("bf16, 8, 1, 1, 288, 2", []),
}

# V5: the output stores, or the whole body, dropped
V5_STORE = "  for (int e = tid; e < nvec; e += HEAD_THREADS) __stcs(v + e, t4);"
V5_BODY = ("  extern __shared__ float heads[];  // (taps, 2): the rounded head sums; "
           "then the total\n")
# every thread adds the taps itself, reading the 54 sums from shared memory
V5_TOTAL = """  if (tid == 0) {  // one thread adds the taps in order; the others read it
    float total = 0.f;
#pragma unroll 9
    for (int t = 0; t < taps; ++t) total += heads[2 * t] + heads[2 * t + 1];
    heads[2 * taps] = total;
  }
  __syncthreads();
  const float total = heads[2 * taps];
"""
V5_ALL = """  float total = 0.f;
  for (int t = 0; t < taps; ++t) total += heads[2 * t] + heads[2 * t + 1];
"""
# the output stores with an L2 evict-first policy; a CTA's rows
V5_EVICT_FIRST = """  for (int e = tid; e < nvec; e += HEAD_THREADS) {
    uint64_t pol;
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(pol));
    asm volatile("st.global.L2::cache_hint.v4.f32 [%0], {%1, %2, %3, %4}, %5;" ::"l"(v + e),
                 "f"(total), "f"(total), "f"(total), "f"(total), "l"(pol) : "memory");
  }"""
V5_ROWS = "constexpr int HEAD_ROWS = 128;"
V5 = {
    "base": [],
    "nostore": [("probe_kernels.cu", V5_STORE,
                 V5_STORE.replace("e < nvec;", "e < nvec && total == -1.5e30f;"))],
    "noop": [("probe_kernels.cu", V5_BODY, V5_BODY + "  if (taps >= 0) return;\n")],
    "alltotal": [("probe_kernels.cu", V5_TOTAL, V5_ALL)],
    "plainst": [("probe_kernels.cu", V5_STORE,
                 V5_STORE.replace("__stcs(v + e, t4)", "v[e] = t4"))],
    "wt": [("probe_kernels.cu", V5_STORE, V5_STORE.replace("__stcs", "__stwt"))],
    "evictfirst": [("probe_kernels.cu", V5_STORE, V5_EVICT_FIRST)],
    "rows64": [("probe_kernels.cu", V5_ROWS, V5_ROWS.replace("128", "64"))],
    "rows512": [("probe_kernels.cu", V5_ROWS, V5_ROWS.replace("128", "512"))],
}

# P1/P2/P3 k1 (row_gather.cu): the vector path as built, a warp per batch
# of rows, the output written with streaming stores or cached in L2 only,
# diagnostics, and the vector path emptied (the launch floor at the
# probes' grids)
GATHER_VEC = "  const int nvec = c / V;\n  const long long items = (long long)n * nvec;\n"
GATHER_EMPTY = [("row_gather.cu", GATHER_VEC, "  if (n >= 0) return;\n" + GATHER_VEC)]
# The warp-per-batch design, run in place of the vector path's loop (whose
# item count it sets to 0): a warp takes a batch of WB rows (batch b on warp
# b / gridDim.x of CTA b % gridDim.x, so that the batches spread over the
# SMs); its lanes load the batch's entries and window entries for every tap
# in coalesced loads (lane k: tap k / WB, row k % WB), then walk the batch's
# (row, 16-byte piece) items 32 at a time, WU steps in flight: each step's
# entries come from their lanes by __shfl_sync, and every tap's piece of
# every step is loaded before the first add; streaming stores.
GATHER_WARP = """  {
    constexpr int WB = 8, WE = (TB * WB + 31) / 32, WU = 4;
    const int wv = c / V, lane = threadIdx.x % 32;
    const int steps = (WB * wv + 31) / 32;
    const long long batches = ((long long)n + WB - 1) / WB;
    for (long long b = blockIdx.x + (long long)gridDim.x * (threadIdx.x / 32); b < batches;
         b += (long long)gridDim.x * (THREADS / 32)) {
      const long long i0 = b * WB;
      int er[WE], el[WE];
#pragma unroll
      for (int q = 0; q < WE; ++q) {
        const int k = q * 32 + lane, t = k / WB;
        const long long i = i0 + k % WB;
        er[q] = -1;
        el[q] = 0;
        if (t < taps && i < n) {
          er[q] = __ldg(rows + (size_t)t * n + i);
          if (w0 != nullptr) el[q] = __ldg(w0 + (size_t)t * nb + i / block);
        }
      }
      for (int s0 = 0; s0 < steps; s0 += WU) {
        uint4 wbuf[WU][TB];
#pragma unroll
        for (int u = 0; u < WU; ++u) {
          const int m = (s0 + u) * 32 + lane, ib = min(m / wv, WB - 1);
          const bool item = s0 + u < steps && m < WB * wv && i0 + m / wv < n;
#pragma unroll
          for (int t = 0; t < TB; ++t) {
            const int src = (t * WB) % 32 + ib;
            const int r = __shfl_sync(0xffffffffu, er[t * WB / 32], src);
            const long long l = (long long)__shfl_sync(0xffffffffu, el[t * WB / 32], src) * wb;
            wbuf[u][t] = make_uint4(0u, 0u, 0u, 0u);
            if (item && t < taps && r >= 0 && (w0 == nullptr || (r >= l && r < l + wb)))
              wbuf[u][t] = __ldg(reinterpret_cast<const uint4*>(feats + (size_t)r * c) + m % wv);
          }
        }
#pragma unroll
        for (int u = 0; u < WU; ++u) {
          const int m = (s0 + u) * 32 + lane;
          if (s0 + u >= steps || m >= WB * wv || i0 + m / wv >= n) continue;
          float acc[V];
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] = 0.f;
#pragma unroll
          for (int t = 0; t < TB; ++t)
            if (t < taps) add16(acc, wbuf[u][t], feats);
          float4* dst = reinterpret_cast<float4*>(out + (size_t)(i0 + m / wv) * c) + (m % wv) * (V / 4);
#pragma unroll
          for (int q = 0; q < V / 4; ++q)
            __stcs(dst + q, make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]));
        }
      }
    }
  }
"""
GATHER_STORE = ("dst[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], "
                "acc[4 * q + 3]);")
GATHER = {
    "base": [],
    "warp": [("row_gather.cu", GATHER_VEC,
              GATHER_WARP + GATHER_VEC.replace("(long long)n * nvec", "0"))],
    **{hint: [("row_gather.cu", GATHER_STORE,
               GATHER_STORE.replace("dst[q] = ", f"__{hint}(dst + q, ").replace(");", "));"))]
       for hint in ("stcs", "stcg")},
    # diagnostics of the vector path (wrong results on purpose): row i's
    # entries not read (row i taken), no window entry read or checked, no
    # output written
    "noidx": [("row_gather.cu", "        r[t] = __ldg(rows + (size_t)t * n + row);",
               "        r[t] = row;")],
    "nowin": [("row_gather.cu", "      if (r[t] >= 0 && (w0 == nullptr || (r[t] >= l",
               "      if (r[t] >= 0 && (true || (r[t] >= l"),
              ("row_gather.cu", "        if (w0 != nullptr) lo[t] = __ldg(",
               "        if (false) lo[t] = __ldg(")],
    "nostore": [("row_gather.cu", "      dst[q] = make_float4(",
                 "      if (acc[0] == -1.5e30f) dst[q] = make_float4(")],
    "empty": GATHER_EMPTY,
}
# P3 k0 / P4 (probe_kernels.cu:window_copy_sum): the register route as built
# (every tap's 16-byte load issued before the first add), other CTA sizes
# (rows of a chunk: the threads / (C / 8)), plain stores, and the kernel
# emptied
COPY_BODY = "  constexpr int E = VEC ? 8 : 1;  // columns per piece: a 16-byte load, or one\n"
COPY_CTA = "constexpr int COPY_THREADS = 256;"
COPY = {
    "base": [],
    **{f"cta{n}": [("probe_kernels.cu", COPY_CTA, COPY_CTA.replace("256", str(n)))]
       for n in (64, 128, 512)},
    "plainst": [("probe_kernels.cu", "__stcs(reinterpret_cast<float4*>(dst), ",
                 "*(reinterpret_cast<float4*>(dst)) = ("),
                ("probe_kernels.cu", "__stcs(reinterpret_cast<float4*>(dst) + 1, ",
                 "*(reinterpret_cast<float4*>(dst) + 1) = (")],
    "empty": [("probe_kernels.cu", COPY_BODY, COPY_BODY + "  if (taps >= 0) return;\n")],
}


# P5 kb (probe_kernels.cu:lane_concat): a thread per 16-byte piece of x as
# built, other CTA sizes, a thread per 8-column piece of the output (piece
# 8's re-read of x's block 0 served by L2), the former thread per output
# element, diagnostics (no stores: wrong on purpose) and the kernel emptied
FAMILY_D_END = "// Every output row reads its own input row through the one tap.\n"
# the former designs' launch: 256-thread CTAs over a count of threads
OLD_LAUNCH = """constexpr int THREADS = 256;

unsigned grid_for(long long threads) {
  return (unsigned)((threads + THREADS - 1) / THREADS);
}

"""
CONCAT_CTA = "constexpr int CONCAT_THREADS = 256;"
CONCAT_VEC = "    return launch_lane_concat<true>(xb, o, rows, w_in, width * pieces, s);\n"
CONCAT_DISPATCH = ("  if (width % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0)\n"
                   + CONCAT_VEC)
CONCAT_OLD = OLD_LAUNCH + """__global__ void __launch_bounds__(THREADS)
lane_concat_old_kernel(const bf16* __restrict__ x, float* __restrict__ out, int rows,
                       int w_in, int width, int pieces) {
  const int w_out = width * pieces;
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= (long long)rows * w_out) return;
  const int row = (int)(e / w_out);
  const int k = (int)(e % w_out);
  const int src = (k / width) % (w_in / width) * width + k % width;
  out[e] = to_float(x[(size_t)row * w_in + src]);
}

"""
CONCAT_OUT = """__global__ void __launch_bounds__(CONCAT_THREADS)
lane_concat_out_kernel(const bf16* __restrict__ x, float* __restrict__ out, int rows, int w_in,
                       int w_out) {
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  const int c = (blockIdx.y * blockDim.x + threadIdx.x) * 8;
  if (row >= rows || c >= w_out) return;
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(x + (size_t)row * w_in + c % w_in));
  float4* dst = reinterpret_cast<float4*>(out + (size_t)row * w_out + c);
  __stcs(dst, make_float4(__uint_as_float(raw.x << 16), __uint_as_float(raw.x & 0xffff0000u),
                          __uint_as_float(raw.y << 16), __uint_as_float(raw.y & 0xffff0000u)));
  __stcs(dst + 1, make_float4(__uint_as_float(raw.z << 16), __uint_as_float(raw.z & 0xffff0000u),
                              __uint_as_float(raw.w << 16), __uint_as_float(raw.w & 0xffff0000u)));
}

int launch_lane_concat_out(const bf16* x, float* out, int rows, int w_in, int w_out,
                           cudaStream_t s) {
  const int units = w_out / 8, uc = std::min(units, CONCAT_THREADS);
  const dim3 block(uc, CONCAT_THREADS / uc);
  const dim3 grid((rows + block.y - 1) / block.y, (units + uc - 1) / uc);
  lane_concat_out_kernel<<<grid, block, 0, s>>>(x, out, rows, w_in, w_out);
  return static_cast<int>(cudaGetLastError());
}

"""
CONCAT_SIG = ("lane_concat_kernel(const bf16* __restrict__ x, float* __restrict__ out, int rows, "
              "int w_in,\n                   int w_out) {\n")
CONCAT_STORES = "    for (int c = j; c < w_out; c += w_in) {\n      __stcs("
CONCAT = {
    "base": [],
    **{f"cta{n}": [("probe_kernels.cu", CONCAT_CTA, CONCAT_CTA.replace("256", str(n)))]
       for n in (64, 128)},
    "outpiece": [("probe_kernels.cu", FAMILY_D_END, CONCAT_OUT + FAMILY_D_END),
                 ("probe_kernels.cu", CONCAT_VEC, CONCAT_VEC.replace(
                     "launch_lane_concat<true>", "launch_lane_concat_out"))],
    "old": [("probe_kernels.cu", FAMILY_D_END, CONCAT_OLD + FAMILY_D_END),
            ("probe_kernels.cu", CONCAT_DISPATCH,
             "  lane_concat_old_kernel<<<grid_for((long long)rows * width * pieces), THREADS, 0, "
             "s>>>(\n      xb, o, rows, w_in, width, pieces);\n"
             "  return static_cast<int>(cudaGetLastError());\n")],
    "nostore": [("probe_kernels.cu", CONCAT_STORES,
                 CONCAT_STORES.replace("c < w_out;", "c < w_out && lo.x == -1.5e30f;"))],
    "empty": [("probe_kernels.cu", CONCAT_SIG, CONCAT_SIG + "  if (rows >= 0) return;\n")],
}
# P5 kc2 (probe_kernels.cu:sum_rows): a column a thread, a round's loads
# (no condition) before its adds, 4 CTAs of 128 at the probe as built; other
# CTA sizes (256: the former layout, 2 CTAs, with its loads hoisted); 4
# columns a thread by 16-byte loads where B is a multiple of 4 and rb
# 16-byte aligned (one CTA of 128, or 4 of 32); loads and adds under
# t < rows; the former kernel; the kernel emptied
SUM_CTA = "constexpr int SUM_THREADS = 128;"
SUM_LAUNCH = ("  sum_rows_kernel<<<(b + SUM_THREADS - 1) / SUM_THREADS, SUM_THREADS, 0, s>>>"
              "(r, o, rows, b);\n")
SUM_OLD = OLD_LAUNCH + """__global__ void __launch_bounds__(THREADS)
sum_rows_old_kernel(const int* __restrict__ rb, float* __restrict__ out, int rows,
                    int b) {
  const int col = blockIdx.x * THREADS + threadIdx.x;
  if (col >= b) return;
  float acc = 0.f;
  for (int t = 0; t < rows; ++t) acc += (float)rb[(size_t)t * b + col];
  out[col] = acc;
}

"""
SUM_VEC = """__global__ void __launch_bounds__(SUM_THREADS)
sum_rows_vec_kernel(const int* __restrict__ rb, float* __restrict__ out, int rows, int b) {
  const int col = (blockIdx.x * SUM_THREADS + threadIdx.x) * 4;
  if (col >= b) return;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int t0 = 0; t0 < rows; t0 += SUM_ROUND) {
    int4 v[SUM_ROUND];
#pragma unroll
    for (int k = 0; k < SUM_ROUND; ++k)
      v[k] = __ldg(reinterpret_cast<const int4*>(rb + (size_t)min(t0 + k, rows - 1) * b + col));
#pragma unroll
    for (int k = 0; k < SUM_ROUND; ++k)
      if (t0 + k < rows) {
        acc[0] += (float)v[k].x;
        acc[1] += (float)v[k].y;
        acc[2] += (float)v[k].z;
        acc[3] += (float)v[k].w;
      }
  }
  *reinterpret_cast<float4*>(out + col) = make_float4(acc[0], acc[1], acc[2], acc[3]);
}

"""
SUM_VEC_LAUNCH = """  if (b % 4 == 0 && reinterpret_cast<uintptr_t>(rb) % 16 == 0) {
    sum_rows_vec_kernel<<<(b / 4 + SUM_THREADS - 1) / SUM_THREADS, SUM_THREADS, 0, s>>>(
        r, o, rows, b);
    return static_cast<int>(cudaGetLastError());
  }
"""
SUM_VEC_EDITS = [("probe_kernels.cu", FAMILY_D_END, SUM_VEC + FAMILY_D_END),
                 ("probe_kernels.cu", SUM_LAUNCH, SUM_VEC_LAUNCH + SUM_LAUNCH)]
SUM_SIG = ("sum_rows_kernel(const int* __restrict__ rb, float* __restrict__ out, int rows, "
           "int b) {\n")
SUM_LOAD = ("    for (int k = 0; k < SUM_ROUND; ++k) v[k] = __ldg(rb + (size_t)min(t0 + k, "
            "rows - 1) * b + col);\n")
SUM_ADDS = "    for (int k = 0; k < SUM_ROUND; ++k) acc += t0 + k < rows ? (float)v[k] : 0.f;\n"
SUM_PRED = [("probe_kernels.cu", SUM_LOAD, "    for (int k = 0; k < SUM_ROUND; ++k)\n"
             "      v[k] = t0 + k < rows ? __ldg(rb + (size_t)(t0 + k) * b + col) : 0;\n"),
            ("probe_kernels.cu", SUM_ADDS, "    for (int k = 0; k < SUM_ROUND; ++k)\n"
             "      if (t0 + k < rows) acc += (float)v[k];\n")]
SUM_ROWS = {
    "base": [],
    "predload": SUM_PRED,
    **{f"cta{n}": [("probe_kernels.cu", SUM_CTA, SUM_CTA.replace("128", str(n)))]
       for n in (64, 256)},
    "vec": SUM_VEC_EDITS,
    "vec32": SUM_VEC_EDITS + [("probe_kernels.cu", SUM_CTA, SUM_CTA.replace("128", "32"))],
    "old": [("probe_kernels.cu", FAMILY_D_END, SUM_OLD + FAMILY_D_END),
            ("probe_kernels.cu", SUM_LAUNCH,
             "  sum_rows_old_kernel<<<grid_for(b), THREADS, 0, s>>>(r, o, rows, b);\n")],
    "empty": [("probe_kernels.cu", SUM_SIG, SUM_SIG + "  if (rows >= 0) return;\n")],
}
# P5 ka (probe_kernels.cu:slab_slots): a column a thread, two 16-byte
# streaming stores of its output row, 4 CTAs of 128 at the probe as built;
# other CTA sizes (1 x 512, 2 x 256, 16 x 32); 4 columns a thread by one
# 16-byte load and eight 16-byte stores where B is a multiple of 4 and rb and
# out are 16-byte aligned (1 CTA of 128); plain stores; the former thread per
# output element; diagnostics (no stores, the load kept: wrong on purpose)
# and the kernel emptied
SLOT_CTA = "constexpr int SLOT_THREADS = 128;"
SLOT_SIG = "slab_slots_kernel(const int* __restrict__ rb, float* __restrict__ out, int b) {\n"
SLOT_LAUNCH = ("  slab_slots_kernel<<<(unsigned)(((long long)b + SLOT_THREADS - 1) / SLOT_THREADS), "
               "SLOT_THREADS,\n")
SLOT_STORES = ("  __stcs(reinterpret_cast<float4*>(dst), v4);\n"
               "  __stcs(reinterpret_cast<float4*>(dst) + 1, v4);\n")
SLOT_ROW = "  float* dst = out + (size_t)col * 8;\n"
SLOT_OLD = OLD_LAUNCH + """__global__ void __launch_bounds__(THREADS)
slab_slots_old_kernel(const int* __restrict__ rb, float* __restrict__ out, int b) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= b * 8) return;
  const int r = rb[e / 8];
  out[e] = r >= 0 ? (float)(r % 8 + 1) : 0.f;
}

"""
SLOT_VEC4 = """__global__ void __launch_bounds__(SLOT_THREADS)
slab_slots_vec4_kernel(const int* __restrict__ rb, float* __restrict__ out, int b) {
  const unsigned c = (blockIdx.x * SLOT_THREADS + threadIdx.x) * 4;
  if (c >= (unsigned)b) return;
  const int4 r = __ldg(reinterpret_cast<const int4*>(rb + c));
  const int rs[4] = {r.x, r.y, r.z, r.w};
  float4* dst = reinterpret_cast<float4*>(out + (size_t)c * 8);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float v = (float)(rs[q] >= 0 ? rs[q] % 8 + 1 : 0);
    const float4 v4 = make_float4(v, v, v, v);
    __stcs(dst + 2 * q, v4);
    __stcs(dst + 2 * q + 1, v4);
  }
}

"""
SLOT_VEC4_LAUNCH = """  if (b % 4 == 0 && reinterpret_cast<uintptr_t>(rb) % 16 == 0) {
    slab_slots_vec4_kernel<<<(unsigned)(((long long)b / 4 + SLOT_THREADS - 1) / SLOT_THREADS),
                             SLOT_THREADS, 0, s>>>(r, o, b);
    return static_cast<int>(cudaGetLastError());
  }
"""
SLOTS = {
    "base": [],
    **{f"cta{n}": [("probe_kernels.cu", SLOT_CTA, SLOT_CTA.replace("128", str(n)))]
       for n in (512, 256, 32)},
    "vec4": [("probe_kernels.cu", FAMILY_D_END, SLOT_VEC4 + FAMILY_D_END),
             ("probe_kernels.cu", SLOT_LAUNCH, SLOT_VEC4_LAUNCH + SLOT_LAUNCH)],
    "plainst": [("probe_kernels.cu", SLOT_STORES,
                 "  reinterpret_cast<float4*>(dst)[0] = v4;\n"
                 "  reinterpret_cast<float4*>(dst)[1] = v4;\n")],
    "old": [("probe_kernels.cu", FAMILY_D_END, SLOT_OLD + FAMILY_D_END),
            ("probe_kernels.cu", SLOT_LAUNCH,
             "  slab_slots_old_kernel<<<grid_for((long long)b * 8), THREADS, 0, s>>>(r, o, b);\n"
             "  return static_cast<int>(cudaGetLastError());\n" + SLOT_LAUNCH)],
    "nostore": [("probe_kernels.cu", SLOT_ROW, "  if (r != -123456789) return;\n" + SLOT_ROW)],
    "empty": [("probe_kernels.cu", SLOT_SIG, SLOT_SIG + "  if (b >= 0) return;\n")],
}

def build(source, variants):
    """{name: CDLL} of ``csrc/<source>.cu`` with each variant's edits."""
    out_dir = os.path.join(BUILD_DIR, "variants", source)
    procs = {}
    for name, edits in variants.items():
        d = os.path.join(out_dir, name)
        os.makedirs(d, exist_ok=True)
        for f in (f"{source}.cu",) + HEADERS:
            with open(os.path.join(CSRC, f)) as fh:
                src = fh.read()
            for target, old, new in edits:
                if target == f:
                    if old not in src:
                        raise ValueError(f"{name}: edit not found in {f}: {old!r}")
                    src = src.replace(old, new)
            with open(os.path.join(d, f), "w") as fh:
                fh.write(src)
        procs[name] = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", os.path.join(d, "lib.so"),
             os.path.join(d, f"{source}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(f"{name}: build failed\n{log[-3000:]}", flush=True)
            continue
        spills = [ln.strip() for ln in log.splitlines()
                  if "stack frame" in ln and not ln.strip().startswith("0 bytes")]
        print(f"{name}: built; stack/spills {spills}", flush=True)
        libs[name] = ctypes.CDLL(os.path.join(out_dir, name, "lib.so"))
    return libs


def bind(kernel, lib):
    for dtype in kernel.dtypes or (None,):
        fn = getattr(lib, kernel._entry(dtype))
        fn.argtypes, fn.restype = kernel.argtypes, ctypes.c_int
    err = getattr(lib, kernel.error_symbol)
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    kernel._lib = lib


def empty_kernel_ms(source, edits, kernel, fn, iters=20):
    """A launch floor: ``csrc/<source>.cu`` built with ``edits`` (which
    empty ``kernel``), bound in place of the real build for ``fn``, one
    launch of ``kernel`` at its real grid, and timed as the probes are
    (``probe_windowed_torch.graph_ms``: CUDA-graph replay, L2 flushed). The
    real build and the launch count are restored after."""
    import probe_windowed_torch as probe

    libs = build(source, {"empty": edits})
    if "empty" not in libs:
        raise RuntimeError(f"the emptied {source}.cu did not build")
    real, launches = kernel.lib(), kernel.launches
    try:
        bind(kernel, libs["empty"])
        return probe.graph_ms(fn, iters)
    finally:
        bind(kernel, real)
        kernel.launches = launches


def fine_tune_levels():
    """The fine-tune batch's (first batch, 12 scenes) per-level band plans
    and coords, as the backbone builds them."""
    import chip_smoke as cs
    from ponderv2_tpu_torch.datasets import build_dataloader, build_dataset
    from ponderv2_tpu_torch.engines.common import split_batch
    from ponderv2_tpu_torch.engines.defaults import default_config_parser
    from ponderv2_tpu_torch.models import build_model
    from ponderv2_tpu_torch.models.default import batch_to_sparse_tensor
    from ponderv2_tpu_torch.ops.sparse import maybe_sort_by_key

    dev = torch.device("cuda:0")
    tmp = tempfile.mkdtemp(prefix="mma_variants_")
    try:
        tcfg = default_config_parser(cs.TRAIN_CONFIG, {"save_path": tmp})
        loader = build_dataloader(build_dataset(dict(tcfg.data.train)), batch_size=12,
                                  num_workers=0, shuffle=True, drop_last=True,
                                  point_budget=tcfg.point_budget, scene_budget=12,
                                  mix_prob=tcfg.mix_prob, seed=0)
        inputs = {k: torch.as_tensor(v, device=dev)
                  for k, v in split_batch(next(iter(loader)))[0].items()}
        inputs.update(spatial_shape=tuple(tcfg.sparse_shape), batch_size=12)
        st, _ = maybe_sort_by_key(batch_to_sparse_tensor(inputs))
        level_rb, level_coords, _ = cs.level_plans(build_model(dict(tcfg.model)).backbone, st)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return level_rb, level_coords


def time_variants(kernel, libs, convs, make_args, core, plain):
    """Each variant of ``libs`` bound to ``kernel`` and timed, with its max
    abs error against ``plain``, at each (level, cin, cout) of ``convs``,
    f32 and bf16, the variants in order and then reversed."""
    import chip_smoke as cs

    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    level_rb, level_coords = fine_tune_levels()
    gen = torch.Generator(device=dev).manual_seed(0)
    for level, cin, cout in convs:
        legacy, plan = cs.band_plan_of(level_rb[level])
        n = legacy.shape[1]
        valid = (level_coords[level][:, 0] >= 0)[:, None]
        live, compacted, slabs = cs.band_rows_multiplied(plan, n)
        for dtype in (torch.float32, torch.bfloat16):
            args = make_args(plan, n, cin, cout, valid, dtype, gen)
            ref = plain(*args)
            ref = ref if isinstance(ref, tuple) else (ref,)
            exact = plain(*(a.double() if torch.is_tensor(a) and a.is_floating_point() else a
                            for a in args))
            exact = exact if isinstance(exact, tuple) else (exact,)

            def vs64(out):
                return max(((o.double() - e).abs().max() / e.abs().max()).item()
                           for o, e in zip(out, exact))

            line = [f"plain vs float64 {vs64(ref):.2e}"]
            for name in list(libs) + list(libs)[::-1]:
                bind(kernel, libs[name])
                out = core(*args)
                out = out if isinstance(out, tuple) else (out,)
                err = max(cs.max_err(o, r)[0] for o, r in zip(out, ref))
                ms = cs.cuda_ms(lambda: core(*args), 5)
                line.append(f"{name} {ms:.3f} ms (err {err:.1e}, vs float64 {vs64(out):.2e})")
            print(f"L{level} {n} rows, {live} live entries (rows multiplied per column "
                  f"tile: compacted {compacted}, slabs {slabs}), {cin}->{cout} "
                  f"{str(dtype)[6:]}: " + "; ".join(line), flush=True)


def run_k1(names):
    libs = build("band_conv", {n: K1[n] for n in names})

    def make_args(plan, n, cin, cout, valid, dtype, gen):
        dev = valid.device
        f = (torch.randn(n, cin, device=dev, generator=gen) * valid).to(dtype)
        w = (torch.randn(27, cin, cout, device=dev, generator=gen) / (27 * cin) ** 0.5).to(dtype)
        return (f, plan.rbt, plan.w0, w, 3, bc.BLOCK, bc.WINDOW)

    time_variants(bc.BAND_FWD, libs, [(0, 96, 96), (0, 128, 96), (1, 96, 96), (2, 128, 128),
                                      (2, 192, 128), (3, 256, 256), (3, 384, 256),
                                      (4, 256, 256)],
                  make_args, bc.band_fwd_core, bc.band_fwd_core_plain)


def run_k2(names):
    libs = build("band_conv_bwd", {n: K2[n] for n in names})

    def make_args(plan, n, cin, cout, valid, dtype, gen):
        dev = valid.device
        f = (torch.randn(n, cin, device=dev, generator=gen) * valid).to(dtype)
        g = (torch.randn(n, cout, device=dev, generator=gen) * valid).to(dtype)
        wmt = (torch.randn(27, cout, cin, device=dev, generator=gen)
               / (27 * cout) ** 0.5).to(dtype)
        return (g, f, plan.rbt, plan.w0, wmt, 3, bc.BLOCK, bc.WINDOW)

    time_variants(bc.BAND_DXDW, libs, [(0, 96, 96), (0, 128, 96), (1, 96, 96), (2, 128, 128)],
                  make_args, bc.band_dxdw_core, bc.band_dxdw_core_plain)


def compacted_rows(geom, wb):
    """Rows the compacted K4 variant multiplies per output column tile: per
    CTA of K4_COMPACT_ROWS rows and tap, the live entries rounded up to
    whole 16-row slabs."""
    import probe_windowed_torch as probe

    live = probe._live(geom, wb, 2)[2]
    per_cta = live.reshape(live.shape[0], -1, K4_COMPACT_ROWS).sum(2)
    return int(((per_cta + 15) // 16 * 16).sum())


def pretrain_plans(dev):
    """``chip_smoke.level_plans`` of a batch of ``chip_smoke.py``'s pretrain
    config (the loader's first at seed ``chip_smoke.SEED``, as
    ``repro_torch.first_batch`` draws it; phase 12 takes the batch of its
    pretrain run, other scenes of the same kind), as the backbone builds
    them: (level plans, level coords, the k5 stem's plan)."""
    import chip_smoke as cs
    from repro_torch import first_batch

    from ponderv2_tpu_torch.engines.defaults import default_config_parser
    from ponderv2_tpu_torch.models import build_model
    from ponderv2_tpu_torch.models.default import batch_to_sparse_tensor
    from ponderv2_tpu_torch.ops.sparse import maybe_sort_by_key

    tmp = tempfile.mkdtemp(prefix="probe_mma_variants_")
    try:
        cfg = default_config_parser(cs.PRETRAIN_CONFIG, {"save_path": tmp})
        cfg.seed = cs.SEED
        st, _ = maybe_sort_by_key(batch_to_sparse_tensor(first_batch(cfg, dev)))
        return cs.level_plans(build_model(dict(cfg.model)).backbone, st)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_k4(names):
    """Each K4 variant at phase 12's six convs (``chip_smoke.windowed_cases``
    on ``pretrain_plans``; the probe's inputs, seeded as phase 12 seeds
    them), f32 and bf16, with the rows each tile multiplies against the live
    entries."""
    import chip_smoke as cs
    import probe_windowed_torch as probe
    from ponderv2_tpu_torch.ops import windowed_gather as wg

    libs = build("windowed_gather", {n: K4[n] for n in names})
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    level_rb, _, stem = pretrain_plans(dev)
    cases = cs.windowed_cases(probe, dev, level_rb, stem)
    totals = {}
    for i, (label, group, rb, cin, cout) in enumerate(cases):
        n = rb.shape[1]
        feats, w, _ = probe.case_inputs(rb, cin, cout, cs.SEED + i, dev)
        geom = wg.prepare_geometry(rb, n, probe.BLOCK, probe.WB, group)
        rows = {False: probe.k4_rows_multiplied(geom, probe.WB),
                True: compacted_rows(geom, probe.WB)}
        for dtype in (torch.float32, torch.bfloat16):
            f = wg.pad_features(feats, wg.padded_rows(n, probe.WB), dtype)
            wc = w.to(dtype).contiguous()
            ref = wg.windowed_conv_fwd_plain(f, geom, wc, probe.WB, group)
            line = []
            for name in list(libs) + list(libs)[::-1]:
                bind(wg.WINDOWED_FWD, libs[name])
                err = cs.max_err(wg.windowed_conv_fwd(f, geom, wc, probe.WB, group), ref)[0]
                ms = cs.cuda_ms(lambda: wg.windowed_conv_fwd(f, geom, wc, probe.WB, group), 5)
                totals[name, dtype] = totals.get((name, dtype), 0.0) + ms / 2
                line.append(f"{name} {ms:.3f} ms (err {err:.1e}, vs float64 {vs64(out):.2e})")
            print(f"{label} {n} rows, {probe.live_entries(geom, probe.WB)} live entries (rows "
                  f"multiplied per column tile: compacted {rows[True]}, slabs {rows[False]}), "
                  f"{cin}->{cout} {str(dtype)[6:]}: " + "; ".join(line), flush=True)
    for (name, dtype), ms in totals.items():
        print(f"six convs, {name} {str(dtype)[6:]}: {ms:.3f} ms (mean of the two passes)")


def run_kd(names):
    import probe_bisect_torch
    import probe_windowed_torch as probe

    with open(os.path.join(CSRC, "probe_kernels.cu")) as fh:
        own = next(ln for ln in fh.read().splitlines() if ln.startswith(KD_LINE))
    variants = {}
    for name in names:
        params, edits = KD[name]
        tile = [("probe_kernels.cu", own, KD_LINE + params)] if params else []
        variants[name] = tile + edits
    libs = build("probe_kernels", variants)
    dev = torch.device("cuda:0")
    v = next(v for v in probe_bisect_torch.variants(dev) if "kd" in v.name)
    for name in list(libs) + list(libs)[::-1]:
        bind(pk.TILE_MATMUL, libs[name])
        out = v.run(False)
        torch.cuda.synchronize()
        m = probe.measure(v, out, 20)
        print(f"{name} ({KD[name][0] or own[len(KD_LINE):]}): kernel {m['ms']:.5f} ms, "
              f"torch.mm {m['library_ms']:.5f} ms, kernel L2 warm {m['warm_ms']:.5f} ms; "
              f"max_abs_err {m['max_abs_err']:.2e} agree {m['agree']}", flush=True)


def run_v5(names):
    import probe_windowed_torch as probe

    libs = build("probe_kernels", {n: V5[n] for n in names})
    dev = torch.device("cuda:0")
    v = next(v for v in probe.profile_variants(dev) if "V5" in v.name)
    ref = v.run(True)
    out_buf = torch.empty((probe.N, probe.PROFILE_C), device=dev)
    fills = {"fill_ fresh": lambda: torch.empty_like(out_buf).fill_(1.5),
             "fill_ reused": lambda: out_buf.fill_(1.5)}
    calls = list(libs) + list(fills)
    for name in calls + calls[::-1]:
        if name in libs:
            bind(pk.WINDOW_HEAD_SUM, libs[name])
            out = v.run(False)
            torch.cuda.synchronize()
            fn, equal = (lambda: v.run(False)), torch.equal(out, ref)
        else:
            fn, equal = fills[name], None
        print(f"{name}: L2 cold {probe.graph_ms(fn, 20):.5f} ms, warm "
              f"{probe.graph_ms(fn, 20, cold=False):.5f} ms; equal to plain {equal}",
              flush=True)


def run_probe_routes(source, table, kernel, pick, names):
    """Each variant of ``source`` bound in place of ``kernel``, at the probe
    functions ``pick`` selects, in turns (in order, then reversed): device
    ms with the L2 flushed and warm (``chip_smoke.py`` phase 13's timing),
    and whether the output equals the plain version's."""
    import probe_bisect_torch
    import probe_gather_torch
    import probe_windowed_torch as probe

    libs = build(source, {n: table[n] for n in names})
    dev = torch.device("cuda:0")
    vs = [v for v in probe_gather_torch.variants(dev) + probe_bisect_torch.variants(dev)
          if pick(v)]
    refs = {v.name: v.run(True) for v in vs}
    for name in list(libs) + list(libs)[::-1]:
        bind(kernel, libs[name])
        for v in vs:
            out = v.run(False)
            torch.cuda.synchronize()
            fn = lambda v=v: v.run(False)  # noqa: E731
            print(f"{name} {v.name}: L2 cold {probe.graph_ms(fn, 20):.5f} ms, warm "
                  f"{probe.graph_ms(fn, 20, cold=False):.5f} ms; equal to plain "
                  f"{torch.equal(out, refs[v.name])}", flush=True)
    for v in vs:
        if v.floor:
            print(f"floor of {v.name}, {v.floor[0]}: L2 cold {probe.graph_ms(v.floor[1], 20):.5f}"
                  " ms", flush=True)


def run_p1(names):
    from ponderv2_tpu_torch.ops import row_gather as rg

    run_probe_routes("row_gather", GATHER, rg.GATHER_SUM,
                     lambda v: v.kernel is rg.GATHER_SUM, names)


def run_k0(names):
    run_probe_routes("probe_kernels", COPY, pk.WINDOW_COPY_SUM,
                     lambda v: v.kernel is pk.WINDOW_COPY_SUM, names)


def run_kb(names):
    run_probe_routes("probe_kernels", CONCAT, pk.LANE_CONCAT,
                     lambda v: v.kernel is pk.LANE_CONCAT, names)


def run_kc2(names):
    run_probe_routes("probe_kernels", SUM_ROWS, pk.SUM_ROWS,
                     lambda v: v.kernel is pk.SUM_ROWS, names)


def run_ka(names):
    run_probe_routes("probe_kernels", SLOTS, pk.SLAB_SLOTS,
                     lambda v: v.kernel is pk.SLAB_SLOTS, names)


def main():
    if not torch.cuda.is_available():
        print("probe_mma_variants_torch: needs a CUDA GPU", file=sys.stderr)
        return 2
    which = sys.argv[1] if len(sys.argv) > 1 else "kd"
    table = {"k1": K1, "k2": K2, "k4": K4, "kd": KD, "v5": V5, "p1": GATHER,
             "k0": COPY, "ka": SLOTS, "kb": CONCAT, "kc2": SUM_ROWS}[which]
    names = sys.argv[2].split(",") if len(sys.argv) > 2 else list(table)
    print(os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip())
    {"k1": run_k1, "k2": run_k2, "k4": run_k4, "kd": run_kd, "v5": run_v5, "p1": run_p1,
     "k0": run_k0, "ka": run_ka, "kb": run_kb, "kc2": run_kc2}[which](names)
    return 0


if __name__ == "__main__":
    sys.exit(main())
