"""Arithmetic the metric readers share. A reader that finds nothing to
read returns None, and the metric is left out of the run's line."""

from __future__ import annotations

import re
import statistics
from typing import Optional

from .core import Run

BAND_KERNEL = re.compile(r"\bband_\w+_kernel\b")


def per_unit_ms(run: Run, *spans: str) -> Optional[float]:
    """The window's host seconds in ``spans``, in ms per finished unit."""
    if not run.count or not any(s in run.host for s in spans):
        return None
    return sum(sum(run.host.get(s, ())) for s in spans) / run.count * 1e3


def idle_share(run: Run) -> Optional[float]:
    """% of the traced window in which no operation ran on the device."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return (1.0 - run.trace.busy_s() / run.trace.window_s) * 100.0


def band_roofline(run: Run) -> Optional[float]:
    """The band convs' least time, counted from the inputs, as a % of the
    device time of every ``band_*_kernel`` in the traced window."""
    if run.trace is None or run.work is None or not run.work.band_bound_s:
        return None
    t = run.trace.device_seconds(BAND_KERNEL.search)
    return run.work.band_bound_s / t * 100.0 if t > 0 else None


def mfu(run: Run) -> Optional[float]:
    """% of the traced window the model's FLOPs take at the dtype's peak."""
    if run.trace is None or run.work is None or not run.work.stats:
        return None
    return run.work.flop_seconds() / run.trace.window_s * 100.0


def rate(count: float, run: Run) -> Optional[float]:
    return count / run.window_s if count and run.window_s > 0 else None


def quantile_ms(run: Run, q: float) -> Optional[float]:
    """The ``q`` quantile of every unit's seconds in the window, in ms,
    where at least ten units lie beyond it."""
    n = len(run.unit_s)
    if n < 2 or n * (1.0 - q) < 10:
        return None
    cuts = statistics.quantiles(run.unit_s, n=100, method="inclusive")
    return cuts[round(q * 100) - 1] * 1e3
