"""The paper's ScanNet instance-segmentation recipe on a CUDA GPU:
``chip_smoke.py``'s phase 16 alone.

    python tools/experiments/insseg_torch.py

Builds K1-K3 and the native clustering, writes phase 16's scene files (36
train + 2 val in ScanNet's layout, one instance per box) into a temporary
directory and runs ``chip_smoke.py:insseg_recipe_phase`` on them: 3 steps of
``configs/scannet/insseg-ppt-v1m1-0-pointgroup-spunet-ft.py`` at batch 12
in f32 and its ``InsSegEvaluator`` over the val scenes, with the phase's
checks (the ground truth as predictions, native clustering against plain,
K1-K3 against their plain versions, the seeded step's grads). Needs a CUDA
GPU.
"""

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

    if not torch.cuda.is_available():
        print("insseg_torch: needs a CUDA GPU", file=sys.stderr)
        return 2
    import chip_smoke
    from ponderv2_tpu_torch.models.point_group import cluster
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
    cluster.load_native()
    print(f"[build] K1-K3 and the native clustering in {time.perf_counter() - t0:.1f} s")
    stats = {name: dict(err=0.0, err_bf16=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                        bytes_ms=0.0, ops_ms=0.0) for name in chip_smoke.BAND_CORES}
    tmp = tempfile.mkdtemp(prefix="insseg_")
    t0 = time.perf_counter()
    try:
        out = chip_smoke.insseg_recipe_phase(
            dev, tmp, torch.Generator(device=dev).manual_seed(chip_smoke.SEED), stats)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[insseg] phase {time.perf_counter() - t0:.1f} s; steps {out['step_ms']} ms, peak "
          f"{out['peak_gib']:.3f} GiB, mAP {out['scores']}, oracle mAP50 "
          f"{out['oracle_mAP50']}, the grads bound that holds: {out['grads_bound']}")
    for name in chip_smoke.BAND_CORES:
        st = stats[name]
        print(f"[insseg] {name} {st['ms']:.3f} ms vs plain {st['plain_ms']:.3f} ms a step "
              f"(bound {st['bound_ms']:.3f} ms)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
