"""The paper's outdoor half on a CUDA GPU: ``chip_smoke.py``'s phases 17
and 18 alone.

    python tools/experiments/nuscenes_torch.py

Builds K1-K3, writes the phases' procedural nuScenes scans into a
temporary directory and runs ``chip_smoke.py:nuscenes_pretrain_phase``
(3 steps of ``configs/nuscenes/pretrain-ponder-spunet-v1m1-0-base.py`` at
batch 4 and one step of each other outdoor pretrain config) and
``nuscenes_semseg_phase`` (3 steps of
``configs/nuscenes/semseg-ppt-v1m1-0-nu-sk-wa-spunet-ft.py`` at batch 12
from the pretrain's checkpoint, its evaluation, the val scans served), with
the phases' checks. First prints the interpreter, torch and whether
``imageio`` and PIL import (the port reads PNG without them). Needs a CUDA
GPU.
"""

import importlib.util
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]


def main() -> int:
    import torch

    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda "
          f"{torch.version.cuda}; importable: " + ", ".join(
              f"{m} {importlib.util.find_spec(m) is not None}" for m in ("imageio", "PIL")))
    if not torch.cuda.is_available():
        print("nuscenes_torch: needs a CUDA GPU", file=sys.stderr)
        return 2
    import chip_smoke
    from ponderv2_tpu_torch.ops import band_conv as bc
    from ponderv2_tpu_torch.ops.cuda_build import load_libraries

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    load_libraries(*sorted({k.source for k in bc.KERNELS}))
    bc.build_kernels()
    print(f"[build] K1-K3 in {time.perf_counter() - t0:.1f} s")

    def new_stats():
        return {name: dict(err=0.0, err_bf16=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                           bytes_ms=0.0, ops_ms=0.0) for name in chip_smoke.BAND_CORES}

    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    tmp = tempfile.mkdtemp(prefix="nuscenes_")
    stats = {"17": new_stats(), "18": new_stats()}
    try:
        t0 = time.perf_counter()
        nus = chip_smoke.nuscenes_pretrain_phase(dev, tmp, gen, stats["17"])
        t1 = time.perf_counter()
        nseg = chip_smoke.nuscenes_semseg_phase(dev, tmp, gen, stats["18"], nus["ckpt"])
        t2 = time.perf_counter()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[nuscenes] phase 17 {t1 - t0:.1f} s, phase 18 {t2 - t1:.1f} s")
    for phase, out in (("17", nus["runs"]["base"]), ("18", nseg)):
        print(f"[nuscenes] phase {phase}: steps {out['step_ms']} ms, data wait "
              f"{out['data_ms']} ms, peak {out['peak_gib']:.3f} GiB, band levels "
              f"{out['band_levels']}, plain gather convs {out['rulebook_ms']:.1f} ms a "
              f"step, grads bound {out['grads_bound']}")
        for name in chip_smoke.BAND_CORES:
            st = stats[phase][name]
            print(f"[nuscenes] phase {phase} {name} {st['ms']:.3f} ms vs plain "
                  f"{st['plain_ms']:.3f} ms a step (bound {st['bound_ms']:.3f} ms)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
