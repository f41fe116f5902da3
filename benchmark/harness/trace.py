"""The traced part of a ``--trace 1`` run: the profiler's device timeline,
the band-conv calls made in it, and the work its units needed.

The traced window is a few units (steps or fragments) inside the measured
window, taken whole, data waits included. ``torch.profiler`` records the
device's kernels and copies and the host's operations on one clock; the
benchmark's own host spans (``bench::*``) are ``record_function`` ranges.
"""

from __future__ import annotations

import bisect
import sys
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

Interval = Tuple[float, float]

WINDOW_SPAN = "bench::traced"


def union_length(intervals: Sequence[Interval], lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` clipped to [lo, hi]."""
    total, end = 0.0, lo
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, hi)
        if e > s:
            total += e - s
            end = e
    return total


def merged(intervals: Sequence[Interval], lo: float, hi: float) -> List[Interval]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Timeline(NamedTuple):
    """Times in microseconds on the profiler's clock."""

    window: Interval
    device: List[Tuple[str, float, float]]  # kernels, copies, sets
    host: List[Tuple[str, float, float]]  # host operations and spans

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_s(self) -> float:
        return union_length([(s, e) for _, s, e in self.device], *self.window) * 1e-6

    def device_seconds(self, match) -> float:
        """Summed device time of the operations whose name ``match`` accepts."""
        lo, hi = self.window
        return sum(max(0.0, min(e, hi) - max(s, lo))
                   for n, s, e in self.device if match(n)) * 1e-6

    def top_ops(self, k: int = 10) -> List[list]:
        lo, hi = self.window
        by: Dict[str, float] = {}
        for n, s, e in self.device:
            d = min(e, hi) - max(s, lo)
            if d > 0:
                by[n] = by.get(n, 0.0) + d * 1e-6
        return [[n[:160], v] for n, v in sorted(by.items(), key=lambda x: -x[1])[:k]]

    def idle_gaps(self, k: int = 10, min_us: float = 5.0, scan: int = 400) -> List[list]:
        """Idle device time by what the host was doing: each gap between
        device operations is named by the innermost host operation under
        its midpoint, and the gaps are summed by name."""
        lo, hi = self.window
        busy = merged([(s, e) for _, s, e in self.device], lo, hi)
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        by: Dict[str, float] = {}
        for s, e in zip(edges[0::2], edges[1::2]):
            if e - s < min_us:
                continue
            mid = 0.5 * (s + e)
            i = bisect.bisect_right(starts, mid) - 1
            best, name = None, "no host operation"
            for j in range(i, max(i - scan, -1), -1):
                n, hs, he = host[j]
                if he >= mid and (best is None or he - hs < best):
                    best, name = he - hs, n
            by[name] = by.get(name, 0.0) + (e - s) * 1e-6
        return [[n[:160], v] for n, v in sorted(by.items(), key=lambda x: -x[1])[:k]]


class Tracer:
    """The profiler over the traced window: ``start()`` and ``stop()`` at
    unit boundaries; ``stop`` returns the ``Timeline``."""

    def __init__(self):
        self.prof = None
        self.mark = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.mark = record_function(WINDOW_SPAN)
        self.mark.__enter__()

    @property
    def active(self) -> bool:
        return self.mark is not None

    def stop(self) -> Timeline:
        torch.cuda.synchronize()
        self.mark.__exit__(None, None, None)
        self.mark = None
        self.prof.__exit__(None, None, None)
        window, device, host = None, [], []
        cuda = torch.autograd.DeviceType.CUDA
        for ev in self.prof.events():
            tr = ev.time_range
            if ev.name == WINDOW_SPAN:
                if ev.device_type != cuda:
                    window = (tr.start, tr.end)
            elif ev.device_type == cuda:
                if not getattr(ev, "is_user_annotation", False):
                    device.append((ev.name, tr.start, tr.end))
            else:
                host.append((ev.name, tr.start, tr.end))
        self.prof = None
        if window is None:
            raise RuntimeError("the profiler recorded no traced window")
        return Timeline(window, device, host)


class BandCall(NamedTuple):
    unit: int  # the traced unit (step or fragment) it ran in
    mask: torch.Tensor  # its rows' validity: the level's row count
    cin: int
    cout: int
    grad: bool  # its inputs take a gradient
    recompute: bool  # run by the backward (activation checkpointing)
    dtype: torch.dtype


class BandRecorder:
    """Records every call of the program's band submanifold conv (K1 in
    the forward; K2 or K1 + K3 in its backward) while installed, by
    wrapping ``band_subm_conv`` where the program's modules hold it, and
    notes whether the call runs inside ``torch.autograd.backward``."""

    def __init__(self):
        self.calls: List[BandCall] = []
        self.unit = -1
        self._patched = []
        self._in_backward = False

    def install(self) -> None:
        from ponderv2_tpu_torch.ops import band_conv

        orig = band_conv.band_subm_conv
        rec = self

        def band_subm_conv(cfg, features, plan, w, mask, compute_dtype=None, *a, **k):
            grad = torch.is_grad_enabled() and (features.requires_grad or w.requires_grad)
            rec.calls.append(BandCall(rec.unit, mask, int(features.shape[1]),
                                      int(w.shape[-1]), grad, rec._in_backward,
                                      compute_dtype or features.dtype))
            return orig(cfg, features, plan, w, mask, compute_dtype, *a, **k)

        for name, mod in list(sys.modules.items()):
            if (name.startswith("ponderv2_tpu_torch")
                    and getattr(mod, "band_subm_conv", None) is orig):
                setattr(mod, "band_subm_conv", band_subm_conv)
                self._patched.append((mod, orig))
        backward = torch.autograd.backward

        def tracked(*a, **k):
            rec._in_backward = True
            try:
                return backward(*a, **k)
            finally:
                rec._in_backward = False

        torch.autograd.backward = tracked
        self._patched.append((torch.autograd, backward))

    def remove(self) -> None:
        for mod, orig in self._patched:
            attr = "backward" if mod is torch.autograd else "band_subm_conv"
            setattr(mod, attr, orig)
        self._patched = []


class Work:
    """The traced units' work, counted from their voxel rows by
    ``counts.sparse``: per unit the levels' rows and live pairs, and each
    band call's least time."""

    def __init__(self, convs, dtype, training: bool):
        from ..counts import dtype_name

        self.convs, self.dtype, self.training = convs, dtype_name(dtype), training
        self.stats = []
        self.band_bound_s: Optional[float] = None

    def add_unit(self, rows: torch.Tensor) -> None:
        from ..counts.sparse import level_stats

        self.stats.append(level_stats(rows))

    def flops(self) -> float:
        from ..counts.sparse import forward_flops, train_flops

        count = train_flops if self.training else forward_flops
        return sum(count(self.convs, st) for st in self.stats)

    def flop_seconds(self) -> float:
        from ..counts import flop_seconds

        return flop_seconds(self.flops(), self.dtype)

    def count_band_calls(self, calls: Sequence[BandCall]) -> None:
        """Least seconds of every recorded band call: its forward, and its
        dx + dW once for each conv whose backward ran: the recomputed
        forward's where the backward recomputes, else the forward's. A call
        whose rows match no level leaves the bound unset."""
        from ..counts.sparse import subm_call_bound

        recomputed = {c.unit for c in calls if c.recompute}
        total = 0.0
        for c in calls:
            st = self.stats[c.unit]
            n = int(c.mask.sum())
            if n not in st.rows:
                return
            pairs = st.pairs3[st.rows.index(n)]
            total += subm_call_bound(n, pairs, c.cin, c.cout, 27, False, c.dtype)
            owns_bwd = c.grad and (c.recompute or c.unit not in recomputed)
            if self.training and owns_bwd:
                total += subm_call_bound(n, pairs, c.cin, c.cout, 27, True, c.dtype)
        self.band_bound_s = total
