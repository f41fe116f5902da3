"""The paper's multi-dataset pretrain on a CUDA GPU: ``chip_smoke.py``'s
phase 15 alone.

    python tools/experiments/multi_pretrain_torch.py [--no-remat]

Builds K1-K3, writes phase 15's RGB-D scene files (Structured3D, ScanNet and
S3DIS layouts) into a temporary directory and runs
``chip_smoke.py:multi_pretrain_phase`` on them: 4 steps of
``configs/scannet/pretrain-ponder-ppt-v1m1-0-sc-s3-st-spunet.py`` at batch
8 in f32 with its checks, K1-K3 against their plain versions and float64,
and the seeded step's grads. With ``--no-remat`` the backbone's ``remat``
is turned off (it is on by default); if a step runs out of device memory it
prints the memory allocated then and exits 1. Needs a CUDA GPU.
"""

import argparse
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--no-remat", action="store_true",
                        help="turn the backbone's remat off")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("multi_pretrain_torch: needs a CUDA GPU", file=sys.stderr)
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
    load_libraries(*sorted({k.source for k in bc.KERNELS}))
    bc.build_kernels()
    if args.no_remat:
        options = chip_smoke.multi_pretrain_options
        chip_smoke.multi_pretrain_options = lambda *a, **k: {
            **options(*a, **k), "model.backbone.remat": False}
    stats = {name: dict(err=0.0, err_bf16=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                        bytes_ms=0.0, ops_ms=0.0) for name in chip_smoke.BAND_CORES}
    tmp = tempfile.mkdtemp(prefix="multi_pretrain_")
    try:
        out = chip_smoke.multi_pretrain_phase(
            dev, tmp, torch.Generator(device=dev).manual_seed(chip_smoke.SEED), stats)
    except torch.cuda.OutOfMemoryError as e:
        print(f"out of device memory with remat {not args.no_remat}: "
              f"{torch.cuda.memory_allocated(dev) / 2 ** 30:.3f} GiB allocated, peak "
              f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.3f} GiB; "
              f"{str(e).splitlines()[0]}")
        return 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[multi] steps {out['step_ms']} ms, peak {out['peak_gib']:.3f} GiB, "
          f"the grads bound that holds: {out['grads_bound']}")
    for name in chip_smoke.BAND_CORES:
        st = stats[name]
        print(f"[multi] {name} {st['ms']:.3f} ms vs plain {st['plain_ms']:.3f} ms a step "
              f"(bound {st['bound_ms']:.3f} ms)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
