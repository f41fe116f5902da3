"""The median of every window fragment's host-to-logits time (the tester's fragment_seconds)."""

from benchmark.harness import readers

UNIT = "ms"


def read(run):
    return readers.quantile_ms(run, 0.5)
