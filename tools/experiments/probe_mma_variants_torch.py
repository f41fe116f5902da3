#!/usr/bin/env python3
"""Time variants of the tensor-core gather-GEMM tiles (``csrc/mma_tile.cuh``)
on a GPU: K1 (``band_fwd_core``) and K2 (``band_dxdw_core``) at the
fine-tune batch's real band plans, K4 (``windowed_conv_fwd``) at
``chip_smoke.py`` phase 12's six convs, and P5 ``kd`` (``tile_matmul``) at
its probe's shape; and of P7 V5 (``window_head_sum``) at its probe's shape.

    python tools/experiments/probe_mma_variants_torch.py k1 [variant,...]
    python tools/experiments/probe_mma_variants_torch.py k2 [variant,...]
    python tools/experiments/probe_mma_variants_torch.py k4 [variant,...]
    python tools/experiments/probe_mma_variants_torch.py kd [variant,...]
    python tools/experiments/probe_mma_variants_torch.py v5 [variant,...]

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
``rows512`` give a CTA other rows), built with the package's nvcc flags into
``ponderv2_tpu_torch/csrc/_build/variants/`` in parallel and bound in place
of the package's build. K1, K2: CUDA events over 5 calls after a warm-up,
each variant twice (in order, then reversed), f32 and bf16, with the max
abs error against the plain version, and the plain version's and each
variant's error against the plain version in float64 (of max|out|). kd: the probe timing of
``chip_smoke.py`` phase 13 (CUDA-graph replay, L2 flushed before each call)
beside ``torch.mm``; v5 the same timing, L2 flushed and warm, in turns,
beside ``Tensor.fill_`` of the same 21 MB output (a fresh tensor and one
reused), the least a kernel that writes it could take. Variants that drop
work give wrong results on purpose.
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


def main():
    if not torch.cuda.is_available():
        print("probe_mma_variants_torch: needs a CUDA GPU", file=sys.stderr)
        return 2
    which = sys.argv[1] if len(sys.argv) > 1 else "kd"
    table = {"k1": K1, "k2": K2, "k4": K4, "kd": KD, "v5": V5}[which]
    names = sys.argv[2].split(",") if len(sys.argv) > 2 else list(table)
    print(os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip())
    {"k1": run_k1, "k2": run_k2, "k4": run_k4, "kd": run_kd, "v5": run_v5}[which](names)
    return 0


if __name__ == "__main__":
    sys.exit(main())
