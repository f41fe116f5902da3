"""Training-event storage and writers (reference: ``ponder/utils/events.py:57-593``).

``EventStorage`` accumulates per-iteration scalar histories; writers flush them to the
console, a JSON-lines file, or TensorBoard. Used by the trainer's hook loop.

A copy of ``ponderv2_tpu/utils/events.py`` (numpy-free, no imports changed).
"""

from __future__ import annotations

import datetime
import json
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

_CURRENT_STORAGE_STACK: List["EventStorage"] = []


def get_event_storage() -> "EventStorage":
    assert _CURRENT_STORAGE_STACK, "get_event_storage() called outside a storage context"
    return _CURRENT_STORAGE_STACK[-1]


class HistoryBuffer:
    """Ring buffer of (value, iteration) pairs with running statistics."""

    def __init__(self, max_length: int = 1000000):
        self._max_length = max_length
        self._data: List[Tuple[float, float]] = []
        self._count = 0
        self._global_avg = 0.0

    def update(self, value: float, iteration: Optional[float] = None) -> None:
        if iteration is None:
            iteration = self._count
        if len(self._data) == self._max_length:
            self._data.pop(0)
        self._data.append((value, iteration))
        self._count += 1
        self._global_avg += (value - self._global_avg) / self._count

    def latest(self) -> float:
        return self._data[-1][0]

    def median(self, window_size: int) -> float:
        import statistics

        return statistics.median(v for v, _ in self._data[-window_size:])

    def avg(self, window_size: int) -> float:
        window = [v for v, _ in self._data[-window_size:]]
        return sum(window) / len(window)

    def global_avg(self) -> float:
        return self._global_avg

    def values(self) -> List[Tuple[float, float]]:
        return self._data


class EventStorage:
    """Scalar history store, used as a context manager around training."""

    def __init__(self, start_iter: int = 0):
        self._history: Dict[str, HistoryBuffer] = defaultdict(HistoryBuffer)
        self._smoothing_hints: Dict[str, bool] = {}
        self._latest_scalars: Dict[str, Tuple[float, int]] = {}
        self._iter = start_iter

    @property
    def iter(self) -> int:
        return self._iter

    @iter.setter
    def iter(self, val: int) -> None:
        self._iter = int(val)

    def put_scalar(self, name: str, value: float, smoothing_hint: bool = True) -> None:
        value = float(value)
        self._history[name].update(value, self._iter)
        self._latest_scalars[name] = (value, self._iter)
        existing = self._smoothing_hints.get(name)
        if existing is not None and existing != smoothing_hint:
            raise ValueError(f"inconsistent smoothing_hint for {name}")
        self._smoothing_hints[name] = smoothing_hint

    def put_scalars(self, *, smoothing_hint: bool = True, **kwargs) -> None:
        for k, v in kwargs.items():
            self.put_scalar(k, v, smoothing_hint=smoothing_hint)

    def history(self, name: str) -> HistoryBuffer:
        if name not in self._history:
            raise KeyError(f"no history for {name}")
        return self._history[name]

    def histories(self) -> Dict[str, HistoryBuffer]:
        return self._history

    def latest(self) -> Dict[str, Tuple[float, int]]:
        return self._latest_scalars

    def latest_with_smoothing_hint(self, window_size: int = 20):
        out = {}
        for k, (v, it) in self._latest_scalars.items():
            out[k] = (
                self._history[k].median(window_size) if self._smoothing_hints[k] else v,
                it,
            )
        return out

    def smoothing_hints(self) -> Dict[str, bool]:
        return self._smoothing_hints

    def step(self) -> None:
        self._iter += 1

    def __enter__(self) -> "EventStorage":
        _CURRENT_STORAGE_STACK.append(self)
        return self

    def __exit__(self, exc_type, exc_val, exc_tb) -> None:
        assert _CURRENT_STORAGE_STACK[-1] is self
        _CURRENT_STORAGE_STACK.pop()


class EventWriter:
    def write(self) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class JSONWriter(EventWriter):
    """Appends one JSON line of smoothed scalars per write."""

    def __init__(self, json_file: str, window_size: int = 20):
        os.makedirs(os.path.dirname(os.path.abspath(json_file)), exist_ok=True)
        self._file = open(json_file, "a")
        self._window_size = window_size
        self._last_write = -1

    def write(self) -> None:
        storage = get_event_storage()
        to_save = defaultdict(dict)
        for k, (v, it) in storage.latest_with_smoothing_hint(self._window_size).items():
            if it <= self._last_write:
                continue
            to_save[it][k] = v
        if to_save:
            self._last_write = max(to_save.keys())
        for it in sorted(to_save.keys()):
            to_save[it]["iteration"] = it
            self._file.write(json.dumps(to_save[it], sort_keys=True) + "\n")
        self._file.flush()

    def close(self) -> None:
        self._file.close()


class TensorboardWriter(EventWriter):
    """TensorBoard scalar writer; no-op if tensorboard is unavailable."""

    def __init__(self, log_dir: str, window_size: int = 20):
        self._window_size = window_size
        self._writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(log_dir)
        except Exception:
            pass

    def add_scalar(self, name: str, value: float, step: int) -> None:
        if self._writer is not None:
            self._writer.add_scalar(name, value, step)

    def write(self) -> None:
        if self._writer is None:
            return
        storage = get_event_storage()
        for k, (v, it) in storage.latest_with_smoothing_hint(self._window_size).items():
            self._writer.add_scalar(k, v, it)

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()


class CommonMetricPrinter(EventWriter):
    """Human-readable per-iteration console line with ETA."""

    def __init__(self, max_iter: int, logger=None, window_size: int = 20):
        self._max_iter = max_iter
        self._window_size = window_size
        if logger is None:
            from .logger import get_root_logger

            logger = get_root_logger()
        self._logger = logger

    def write(self) -> None:
        storage = get_event_storage()
        it = storage.iter
        pieces = [f"iter: {it}/{self._max_iter}"]
        try:
            t = storage.history("batch_time").avg(self._window_size)
            eta = datetime.timedelta(seconds=int(t * (self._max_iter - it)))
            pieces.append(f"time: {t:.3f}s eta: {eta}")
        except KeyError:
            pass
        for k, (v, _) in sorted(storage.latest_with_smoothing_hint(self._window_size).items()):
            if k in ("batch_time", "data_time"):
                continue
            pieces.append(f"{k}: {v:.4g}")
        self._logger.info("  ".join(pieces))
