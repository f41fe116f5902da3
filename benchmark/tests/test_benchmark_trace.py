"""The device's busy time is the union of its operations' intervals, not
the sum of their durations."""

import pytest

from benchmark.harness import core, readers
from benchmark.harness.trace import Timeline, merged, union_length


def test_union_of_overlapping_kernels():
    # two streams: [0, 10) and [5, 12) overlap; [20, 25) apart; [30, 40) cut by the window
    kernels = [(0, 10), (5, 12), (20, 25), (30, 40)]
    assert union_length(kernels, 0, 35) == 12 + 5 + 5
    assert sum(e - s for s, e in kernels) == 32  # what a sum of self times would say
    assert merged(kernels, 0, 35) == [(0, 12), (20, 25), (30, 35)]
    assert union_length([(3, 4), (1, 2), (0, 5)], 0, 10) == 5  # nested, unsorted


def test_idle_share_and_gaps_named_by_the_host():
    device = [("k1", 0.0, 10.0), ("k2", 5.0, 12.0), ("memcpy", 20.0, 25.0)]
    host = [("bench::step", -1.0, 40.0), ("aten::item", 12.0, 19.0),
            ("aten::nonzero", 25.5, 39.0)]
    tl = Timeline((0.0, 40.0), device, host)
    assert tl.busy_s() == pytest.approx(17e-6)
    run = core.Run("w", "test", 0.0)
    run.trace = tl
    assert readers.idle_share(run) == pytest.approx((1 - 17 / 40) * 100)
    gaps = dict(tl.idle_gaps(min_us=1.0))
    # [12, 20) under aten::item, [25, 40) under aten::nonzero
    assert gaps == pytest.approx({"aten::item": 8e-6, "aten::nonzero": 15e-6})
    assert tl.device_seconds(lambda n: n.startswith("k")) == pytest.approx(17e-6)
    assert tl.top_ops(2) == [["k1", pytest.approx(10e-6)], ["k2", pytest.approx(7e-6)]]


def test_readers_leave_out_what_they_cannot_read():
    run = core.Run("w", "test", 0.0)
    for read in (readers.idle_share, readers.band_roofline, readers.mfu):
        assert read(run) is None
    assert readers.per_unit_ms(run, "collate") is None
    run.count, run.window_s = 4, 2.0
    run.span("collate", 0.1)
    run.span("collate", 0.3)
    assert readers.per_unit_ms(run, "collate") == pytest.approx(100.0)
    assert readers.rate(48, run) == pytest.approx(24.0)
