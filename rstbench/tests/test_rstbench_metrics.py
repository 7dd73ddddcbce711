"""The metric readers: byte counts, rooflines, and nothing where there is
nothing to read."""
from __future__ import annotations

import pytest

from rstbench import catalog
from rstbench.tests.conftest import REPO


def _read(name, window):
    return catalog.metric(REPO, name).read(window)


def _window(**kw):
    w = {"n": 16_777_216, "half_edges": 67_092_480, "setup_s": 9.5,
         "window_s": 30.0, "calls": 800, "latencies_s": [0.0375] * 800,
         "counters": [{"steps": 1, "rank_syncs": 5, "aux_rounds": 25,
                       "seg_syncs": 24}] * 800,
         "profile": {"busy_s": 0.68, "window_s": 0.73, "calls": 20},
         "host_syncs": [14, 14, 15], "peak_bytes_per_s": 3.35e12}
    w.update(kw)
    return w


def test_least_bytes():
    rst = catalog.metric(REPO, "kernel_roofline.rst").least_bytes
    bfs = catalog.metric(REPO, "kernel_roofline.bfs").least_bytes
    bcc = catalog.metric(REPO, "kernel_roofline.bcc").least_bytes
    assert rst(16_777_216, 67_092_480) == 603_848_704
    assert bfs(16_777_216, 67_092_480) == 603_848_704
    assert bcc(16_777_216, 67_092_480) == 1_157_414_912
    assert rst(1, 0) == 4 and bcc(1, 2) == 43


@pytest.mark.parametrize("name", ["kernel_roofline.rst",
                                  "kernel_roofline.bfs"])
def test_roofline_is_bound_over_busy_time_of_one_call(name):
    got = _read(name, _window())
    assert got == pytest.approx(100 * (603_848_704 / 3.35e12) / (0.68 / 20))
    assert 0 < got < 1


@pytest.mark.parametrize("change", [{"profile": None},
                                    {"peak_bytes_per_s": None}])
@pytest.mark.parametrize("name", ["kernel_roofline.rst",
                                  "kernel_roofline.bfs",
                                  "kernel_roofline.bcc"])
def test_roofline_finds_nothing(name, change):
    assert _read(name, _window(**change)) is None


@pytest.mark.parametrize("name", ["rst_ms", "bfs_rst_ms", "bcc_ms"])
def test_rate_readers(name):
    assert _read(name, _window()) == pytest.approx(37.5)


@pytest.mark.parametrize("name", ["rst_p95_ms", "bfs_rst_p95_ms"])
def test_tail_readers(name):
    lat = [0.010] * 95 + [0.050] * 5
    assert _read(name, _window(latencies_s=lat)) == pytest.approx(10.0)
    assert _read(name, _window(latencies_s=lat[4:])) == pytest.approx(50.0)


def test_setup_reader():
    assert _read("setup_s", _window()) == 9.5


@pytest.mark.parametrize("name", ["device_idle.rst", "device_idle.bfs",
                                  "device_idle.bcc"])
def test_idle_readers(name):
    assert _read(name, _window()) == pytest.approx(100 * (1 - 0.68 / 0.73))
    assert _read(name, _window(profile=None)) is None


@pytest.mark.parametrize("name", ["host_syncs.rst", "host_syncs.bfs",
                                  "host_syncs.bcc"])
def test_sync_readers(name):
    assert _read(name, _window()) == pytest.approx(43 / 3)
    assert _read(name, _window(host_syncs=None)) is None


def test_counter_readers():
    w = _window()
    assert _read("hook_rounds.rst", w) == 1
    assert _read("bfs_levels", w) == 1
    assert _read("rank_syncs.rst", w) == 5
    assert _read("aux_rounds.bcc", w) == 49
    bfs = _window(counters=[{"steps": 9, "rank_syncs": None},
                            {"steps": 12, "rank_syncs": None}])
    assert _read("bfs_levels", bfs) == 10.5
    assert _read("rank_syncs.rst", bfs) is None
