"""Probe: the port's row gather kernel (P1, P2) against its plain PyTorch
version and ``torch.index_select`` on a CUDA GPU.

    python tools/experiments/probe_gather_torch.py [--iters 50]

The counterpart of ``probe_pallas_gather.py``: a 16384 x 128 f32 feature
table gathered through 16384 sorted random int32 indices (``RandomState(0)``,
drawn as the probe draws them), once as ``kernel_take`` views the indices
((16, 8, 128) tiles of 1024 rows, P1) and once as ``probe_full_length``'s
kernel does ((128, 128), P2). Both are ``ops/row_gather.py:row_gather``.
Per variant it prints the kernel's device time with the L2 cache flushed
before each call (``probe_windowed_torch.measure``) beside the plain
version's, ``index_select``'s and the bound, and whether
the kernel equals the plain version. It needs a CUDA device and refuses to
run without one.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from probe_windowed_torch import PEAK_F32, Variant, run_variants  # noqa: E402

N, C, T = 16384, 128, 1024
PROBE = "tools/experiments/probe_pallas_gather.py"


def gather_inputs(n=N, c=C, seed=0):
    """The probe's feature table (n, c) f32 and sorted indices (n,) int32."""
    rng = np.random.RandomState(seed)
    feats = rng.randn(n, c).astype(np.float32)
    return feats, np.sort(rng.randint(0, n, (n,))).astype(np.int32)


def variants(device, n=N, c=C, tile=T):
    """P1 and P2 as ``Variant``s of ``row_gather`` on the probe's inputs."""
    import torch

    from ponderv2_tpu_torch.ops import row_gather as rg

    feats, idx = gather_inputs(n, c)
    feats = torch.from_numpy(feats).to(device)
    idx = torch.from_numpy(idx).to(device)
    # the distinct rows read, the indices, the f32 rows written; one add each
    moved = int(torch.unique(idx).numel()) * c * 4 + 4 * n + n * c * 4
    out = []
    for name, line, view in (("P1 kernel_take", 27, idx.reshape(n // tile, 8, tile // 8)),
                             ("P2 kernel (full length)", 82, idx.reshape(n // 128, 128))):
        def run(plain, view=view):
            return (rg.row_gather_plain if plain else rg.row_gather)(feats, view)

        out.append(Variant(name, f"{PROBE}:{line}", rg.GATHER_SUM, run, "exact", moved,
                           float(n * c), PEAK_F32,
                           lambda: torch.index_select(feats, 0, idx)))
    return out


def launch_floor_ms(device, iters=20):
    """The launch floor beside the probes' bounds: an empty kernel at P1's
    launch (``row_gather.cu`` with its vector path emptied,
    ``probe_mma_variants_torch.GATHER_EMPTY``), timed as the probes are."""
    import torch

    import probe_mma_variants_torch as mv
    from ponderv2_tpu_torch.ops import row_gather as rg

    feats, idx = (torch.from_numpy(a).to(device) for a in gather_inputs())
    return mv.empty_kernel_ms("row_gather", mv.GATHER_EMPTY, rg.GATHER_SUM,
                              lambda: rg.row_gather(feats, idx), iters)


def main(argv=None) -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iters", type=int, default=50)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_gather_torch: needs a CUDA GPU", file=sys.stderr)
        return 2
    from ponderv2_tpu_torch.ops import row_gather as rg

    rg.build_kernels()
    print(f"device {torch.cuda.get_device_name(0)}")
    return 0 if run_variants(variants(torch.device("cuda")), args.iters) else 1


if __name__ == "__main__":
    sys.exit(main())
