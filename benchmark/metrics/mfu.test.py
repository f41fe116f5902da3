"""The traced fragments' forward FLOPs (counts.sparse.forward_flops) at the dtype's peak, over the traced window."""

from benchmark.harness import readers

UNIT = "%"
LAYER = "whole step"
MOVES = "test_fragments_per_s"


def read(run):
    return readers.mfu(run)
