#!/usr/bin/env python3
"""Time variants of the tensor-core gather-GEMM tiles (``csrc/mma_tile.cuh``)
on a GPU: K1 (``band_fwd_core``) and K2 (``band_dxdw_core``) at the
fine-tune batch's real band plans, and P5 ``kd`` (``tile_matmul``) at its
probe's shape.

    python tools/experiments/probe_mma_variants_torch.py k1 [variant,...]
    python tools/experiments/probe_mma_variants_torch.py k2 [variant,...]
    python tools/experiments/probe_mma_variants_torch.py kd [variant,...]

Each variant is a copy of the kernel sources with a few text edits (K1:
``routed`` as built, the compacted tile in f32 and K2's dx tile in bf16;
``slabs`` K2's dx tile, ``gather_gemm``, which multiplies whole 16-row
slabs, in both dtypes; ``compacted`` and ``rRRR_kcKK_nsN`` (other rows per
CTA, k-chunks and stages) the compacted tile in both; K2: ``nodw`` / ``nodx`` launch
only one CTA range, ``onepass`` keeps one TF32 product of three; kd: other
tile shapes, ``noload`` / ``nomult`` drop the copies or the products,
``empty`` returns at once), built with the package's nvcc flags into
``ponderv2_tpu_torch/csrc/_build/variants/`` in parallel and bound in place
of the package's build. K1, K2: CUDA events over 5 calls after a warm-up,
each variant twice (in order, then reversed), f32 and bf16, with the max
abs error against the plain version. kd: the probe timing of
``chip_smoke.py`` phase 13 (CUDA-graph replay, L2 flushed before each call)
beside ``torch.mm``. Variants that drop work give wrong results on purpose.
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

HEADERS = ("band_conv_tile.cuh", "band_rows.cuh", "mma_tile.cuh")
ONEPASS = ("  mma_tf32(d, al, bh[0], bh[1]);\n  mma_tf32(d, ah, bl[0], bl[1]);\n", "")
K2 = {
    "base": [],
    "nodw": [("band_conv_bwd.cu", "  if (b < ndw) {\n", "  if (b < ndw) {\n    return;\n")],
    "nodx": [("band_conv_bwd.cu", "    b -= ndw;\n", "    return;\n    b -= ndw;\n")],
    "onepass": [("mma_tile.cuh", *ONEPASS)],
}
# K1: the tile follows the dtype (kCompact: f32 compacted, bf16 slabs);
# a variant edits that choice or the compacted tile's shape.
K1_LINE = "#define K1_TILE 256, 16, 3"
K1_CHOICE = "constexpr bool kCompact = sizeof(T) == 4;"
K1 = {
    "routed": [],
    "slabs": [("band_conv.cu", K1_CHOICE, "constexpr bool kCompact = false;")],
    "compacted": [("band_conv.cu", K1_CHOICE, "constexpr bool kCompact = true;")],
    **{f"r{r}_kc{k}_ns{n}": [("band_conv.cu", K1_CHOICE, "constexpr bool kCompact = true;"),
                             ("band_conv.cu", K1_LINE, f"#define K1_TILE {r}, {k}, {n}")]
       for r, k, n in [(128, 32, 2), (128, 32, 3), (64, 32, 3)]},
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
            line = []
            for name in list(libs) + list(libs)[::-1]:
                bind(kernel, libs[name])
                out = core(*args)
                out = out if isinstance(out, tuple) else (out,)
                err = max(cs.max_err(o, r)[0] for o, r in zip(out, ref))
                ms = cs.cuda_ms(lambda: core(*args), 5)
                line.append(f"{name} {ms:.3f} ms (err {err:.1e})")
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


def main():
    if not torch.cuda.is_available():
        print("probe_mma_variants_torch: needs a CUDA GPU", file=sys.stderr)
        return 2
    which = sys.argv[1] if len(sys.argv) > 1 else "kd"
    table = {"k1": K1, "k2": K2, "kd": KD}[which]
    names = sys.argv[2].split(",") if len(sys.argv) > 2 else list(table)
    print(os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip())
    {"k1": run_k1, "k2": run_k2, "kd": run_kd}[which](names)
    return 0


if __name__ == "__main__":
    sys.exit(main())
