"""% of the traced window with no kernel, copy or set on the device (1 - the union of their intervals over the window)."""

from benchmark.harness import readers

UNIT = "%"
LAYER = "device"
MOVES = "test_fragments_per_s"


def read(run):
    return readers.idle_share(run)
