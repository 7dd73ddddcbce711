"""The window's arithmetic and the trace's reduction, on made-up
numbers."""
from __future__ import annotations

import pytest

from rstbench import stats
from rstbench import trace as tracing


def test_rate_is_over_the_whole_window():
    assert stats.per_call_ms(10.0, 250) == pytest.approx(40.0)
    assert stats.per_call_ms(10.0, 0) is None


@pytest.mark.parametrize("n,want", [(1, 1), (19, 19), (20, 19), (21, 20),
                                    (100, 95), (101, 96)])
def test_p95_is_nearest_rank_over_every_call(n, want):
    values = list(range(n, 0, -1))           # order does not matter
    assert stats.percentile(values, 95) == want


def test_percentile_of_nothing():
    assert stats.percentile([], 95) is None


def test_union_counts_overlaps_once():
    iv = [(0, 4), (2, 6), (10, 11), (5, 7), (20, 20), (11, 12)]
    assert stats.merge(iv) == [(0, 7), (10, 12)]
    assert stats.gaps(stats.merge(iv), 0, 15) == [(7, 10), (12, 15)]


def test_idle_share():
    assert stats.idle_pct(0.9, 1.0) == pytest.approx(10.0)
    assert stats.idle_pct(0.0, 1.0) is None       # no device op: nothing


def test_reduce_events_busy_breakdown_and_gap_labels():
    device = [("k1", 0, 40), ("k2", 30, 50), ("copy", 100, 120),
              ("k1", 200, 260)]
    host = [("aten::nonzero", 45, 110), ("cudaStreamSynchronize", 60, 95),
            ("aten::add", 130, 140)]
    got = tracing.reduce_events(device, host, window_s=300e-9)
    assert got["busy_s"] == pytest.approx(130e-9)
    assert got["window_s"] == 300e-9
    assert got["device_ops"][0] == ["k1", pytest.approx(100e-9)]
    gaps = dict((k, v) for k, v in got["idle_gaps"])
    # 50-100: middle 75 lies in the sync, inside the nonzero.
    assert gaps["cudaStreamSynchronize"] == pytest.approx(50e-9)
    # 120-200: middle 160 under no host event.
    assert gaps["(host outside any op)"] == pytest.approx(80e-9)


def test_reduce_events_without_device_work():
    assert tracing.reduce_events([], [("aten::add", 0, 5)], 1.0) is None


def test_breakdown_keeps_ten():
    device = [(f"k{i}", 10 * i, 10 * i + i + 1) for i in range(30)]
    got = tracing.reduce_events(device, [], 1.0)
    assert len(got["device_ops"]) == 10
    assert got["device_ops"][0][0] == "k29"
