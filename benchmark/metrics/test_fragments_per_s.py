"""Fragments whose logits came back and were voted, divided by the window."""

from benchmark.harness import readers

UNIT = "fragments/s"


def read(run):
    return readers.rate(run.count, run)
