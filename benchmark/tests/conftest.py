"""The benchmark's own tests: ``python -m pytest benchmark/tests`` from the
root of a checkout. They run on the CPU at small sizes; the one test
marked ``requires_cuda`` runs a cell on a card and skips without one."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "requires_cuda: needs a CUDA GPU and nvcc; skips without one")
