"""Simple perf_counter timer (reference: ``ponder/utils/timer.py``).

A copy of ``ponderv2_tpu/utils/timer.py``.
"""

from __future__ import annotations

import time


class Timer:
    def __init__(self):
        self.reset()

    def reset(self):
        self._start = time.perf_counter()
        self._paused = None
        self._total_paused = 0.0

    def pause(self):
        if self._paused is not None:
            raise RuntimeError("timer already paused")
        self._paused = time.perf_counter()

    def resume(self):
        if self._paused is None:
            raise RuntimeError("timer is not paused")
        self._total_paused += time.perf_counter() - self._paused
        self._paused = None

    def seconds(self) -> float:
        end = self._paused if self._paused is not None else time.perf_counter()
        return end - self._start - self._total_paused
