"""The band convs' least time (live pairs counted from the voxel rows, operands moved once) over the device time of their band_*_kernel launches, in the traced fragments."""

from benchmark.harness import readers

UNIT = "%"
LAYER = "band conv kernels"
MOVES = "test_fragments_per_s"


def read(run):
    return readers.band_roofline(run)
