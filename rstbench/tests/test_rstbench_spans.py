"""The program's spans in a traced run (``rstbench/spans.py``) and the six
readers of them, on made-up events; and ``trace.reduce_events``, which
the spans' annotations must not move."""
from __future__ import annotations

import pytest
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from rstbench import catalog, spans
from rstbench import trace as tracing
from rstbench.tests.conftest import REPO

# Two trees: the first holds connectivity (with one launch of the
# pointer_jump kernel) and the Euler tour, the second connectivity alone.
RANGES = [("rst", 0, 1000), ("connectivity", 10, 400),
          ("kernel.pointer_jump_double", 100, 120), ("euler.root", 500, 900),
          ("rst", 2000, 2500), ("connectivity", 2010, 2100)]
LAUNCHES = {1: 50, 2: 110, 3: 600, 4: 950, 5: 1500, 6: 2050}
DEVICE = [("scatter", 60, 200, 1), ("pointer_jump_double", 200, 300, 2),
          ("list_rank_double", 700, 1100, 3),    # runs past its span
          ("gather", 1100, 1150, 4),             # rst's own
          ("copy", 1500, 1600, 5),               # launched between calls
          ("scatter", 2060, 2300, 6),
          ("copy", 2400, 2450, 99)]              # no launch seen
RECORDS = [{"type": "span", "name": "kernel.pointer_jump_double",
            "args": {"entries": 10, "passes": 5}},
           {"type": "span", "name": "kernel.pointer_jump_double",
            "args": {"entries": 10, "passes": 5}},
           {"type": "event", "name": "kernel.pointer_jump_double",
            "args": {"entries": 99, "passes": 99}},
           {"type": "span", "name": "connectivity", "args": {}}]


def test_device_time_goes_to_the_innermost_span_at_launch_inclusive():
    got = spans.reduce_spans(RANGES, LAUNCHES, DEVICE, RECORDS)
    assert set(got) == {"rst", "connectivity", "kernel.pointer_jump_double",
                        "euler.root"}
    ns = {k: round(v["device_s"] * 1e9) for k, v in got.items()}
    assert ns == {"kernel.pointer_jump_double": 100,
                  "connectivity": 240 + 240,
                  "euler.root": 400,
                  "rst": 240 + 450 + 240}
    assert {k: v["count"] for k, v in got.items()} == {
        "rst": 2, "connectivity": 2, "kernel.pointer_jump_double": 1,
        "euler.root": 1}


def test_idle_is_inside_the_spans_host_ranges():
    got = spans.reduce_spans(RANGES, LAUNCHES, DEVICE, RECORDS)
    idle = {k: round(v["idle_s"] * 1e9) for k, v in got.items()}
    # connectivity: 10-400 less 60-300, 2010-2100 less 2060-2100.
    assert idle["connectivity"] == 150 + 50
    assert idle["kernel.pointer_jump_double"] == 0
    # rst: 0-1000 less 60-300 and 700-1000; 2000-2500 less 2060-2300 and
    # 2400-2450 (an operation's busy time counts wherever it came from).
    assert idle["rst"] == 460 + 210


def test_args_are_summed_over_span_records():
    got = spans.reduce_spans(RANGES, LAUNCHES, DEVICE, RECORDS)
    assert got["kernel.pointer_jump_double"]["args"] == {
        "entries": 20, "passes": 10, "entry_passes": 100}
    assert got["connectivity"]["args"] == {}
    assert got["rst"]["args"] == {}


def test_a_span_inside_one_of_its_name_counts_once():
    got = spans.reduce_spans([("a", 0, 100), ("a", 10, 50)], {1: 20},
                             [("k", 0, 30, 1)], [])
    assert round(got["a"]["device_s"] * 1e9) == 30
    assert round(got["a"]["idle_s"] * 1e9) == 70
    assert got["a"]["count"] == 2


def test_gaps_by_span():
    got = dict(spans.span_gaps(RANGES, DEVICE))
    # 300-700: middle 500 opens euler.root; 1150-1500 and 1600-2060 lie
    # between the trees; 2300-2400 inside the second rst.
    assert {k: round(v * 1e9) for k, v in got.items()} == {
        "euler.root": 400, spans.OUTSIDE: 350 + 460, "rst": 100}
    assert spans.span_gaps(RANGES, []) == []


def _window(**kw):
    reduced = spans.reduce_spans(RANGES, LAUNCHES, DEVICE, RECORDS)
    reduced["bfs.levels"] = {"device_s": 3e-3, "idle_s": 6e-4, "count": 2,
                             "args": {}}
    reduced["bcc.core"] = {"device_s": 0.16, "idle_s": 0.0, "count": 2,
                           "args": {}}
    reduced["kernel.list_rank_double"] = {
        "device_s": 2e-3, "idle_s": 0.0, "count": 2,
        "args": {"entries": 2 * 33_554_430, "passes": 10,
                 "entry_passes": 5 * 2 * 33_554_430}}
    w = {"profile": {"busy_s": 0.68, "window_s": 0.73, "calls": 2},
         "counters": [{"steps": 8}, {"steps": 10}, {"steps": 99}],
         "peak_bytes_per_s": 3.35e12, "spans": reduced}
    w.update(kw)
    return w


def _read(name, w):
    return catalog.metric(REPO, name).read(w)


def test_span_time_readers():
    w = _window()
    assert _read("connectivity_ms.rst", w) == pytest.approx(480e-9 * 1e3 / 2)
    assert _read("euler_ms.rst", w) == pytest.approx(400e-9 * 1e3 / 2)
    assert _read("bcc_core_ms.bcc", w) == pytest.approx(80.0)


def test_level_gap_reads_the_traced_calls_levels():
    # Two traced trees of 8 and 10 steps: 9 + 11 host reads of a flag.
    assert _read("level_gap_us.bfs", _window()) == pytest.approx(6e-4 * 1e6
                                                                 / 20)
    assert _read("level_gap_us.bfs",
                 _window(counters=[{"steps": None}] * 2)) is None


def test_kernel_rooflines_count_the_passes_bytes():
    w = _window()
    assert _read("pointer_jump_roofline.rst", w) == pytest.approx(
        100 * (8 * 100 / 3.35e12) / 100e-9)
    assert _read("list_rank_roofline.rst", w) == pytest.approx(
        100 * (16 * 5 * 2 * 33_554_430 / 3.35e12) / 2e-3)
    assert _read("list_rank_roofline.rst",
                 _window(peak_bytes_per_s=None)) is None


READERS = ["connectivity_ms.rst", "euler_ms.rst", "bcc_core_ms.bcc",
           "level_gap_us.bfs", "list_rank_roofline.rst",
           "pointer_jump_roofline.rst"]


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("change", [{"spans": None}, {"spans": {}},
                                    {"profile": None}])
def test_readers_find_nothing_without_spans(name, change):
    w = _window(**change)
    if "spans" in change and change["spans"] is None:
        del w["spans"]
    assert _read(name, w) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_find_nothing_where_the_span_never_ran(name):
    w = _window()
    w["spans"] = {"rst": w["spans"]["rst"]}
    assert _read(name, w) is None


class _Event:
    """A Kineto event as ``profile_events`` and ``span_events`` read it."""

    def __init__(self, kind, name, start, end, corr=0):
        self.kind, self._name, self.s, self.e, self.c = (kind, name, start,
                                                         end, corr)

    def activity_type(self):
        return self.kind

    def name(self):
        return self._name

    def start_ns(self):
        return self.s

    def end_ns(self):
        return self.e

    def correlation_id(self):
        return self.c


class _Prof:
    def __init__(self, events):
        results = type("R", (), {"events": lambda _self: events})()
        self.profiler = type("P", (), {"kineto_results": results})()


HOST = [_Event("cpu_op", "aten::scatter_reduce_", 40, 70),
        _Event("cuda_runtime", "cudaLaunchKernel", 50, 55, 1),
        _Event("cpu_op", "aten::index", 105, 115),
        _Event("cuda_driver", "cuLaunchCooperativeKernel", 110, 112, 2),
        _Event("cuda_runtime", "cudaStreamSynchronize", 320, 480)]
KERNELS = [_Event("kernel", "scatter", 60, 200, 1),
           _Event("kernel", "pointer_jump_double", 200, 300, 2),
           _Event("gpu_memcpy", "Memcpy DtoH", 310, 315, 7)]
ANNOTATIONS = [_Event("user_annotation", name, s, e)
               for name, s, e in RANGES[:3]]


class _UntypedEvent(_Event):
    """The same event from a torch build whose events carry no activity
    type: device type and annotation flag only."""

    activity_type = property()         # hasattr() is False

    def device_type(self):
        on_device = self.kind in tracing.DEVICE_ACTIVITIES + (
            "gpu_user_annotation",)
        return DeviceType.CUDA if on_device else DeviceType.CPU

    def is_user_annotation(self):
        return self.kind in ("user_annotation", "gpu_user_annotation")


def _untyped(events):
    return [_UntypedEvent(e.kind, e._name, e.s, e.e, e.c) for e in events]


# Kineto's copy of an annotation on the device's timeline.
ON_DEVICE = [_Event("gpu_user_annotation", "connectivity", 60, 300)]


@pytest.mark.parametrize("form", [list, _untyped], ids=["typed", "untyped"])
def test_reduce_events_ignores_the_spans_annotations(form):
    with_spans = tracing.profile_events(
        _Prof(form(HOST + ANNOTATIONS + ON_DEVICE + KERNELS)))
    without = tracing.profile_events(_Prof(form(HOST + KERNELS)))
    assert with_spans == without
    assert tracing.reduce_events(*with_spans, 1e-6) == \
        tracing.reduce_events(*without, 1e-6)


@pytest.mark.parametrize("form", [list, _untyped], ids=["typed", "untyped"])
def test_span_events_split_ranges_launches_and_device(form):
    ranges, launches, device = spans.span_events(
        _Prof(form(HOST + ANNOTATIONS + ON_DEVICE + KERNELS)))
    assert ranges == RANGES[:3]
    assert launches == {1: 50, 2: 110, 0: 320}
    assert device == [("scatter", 60, 200, 1),
                      ("pointer_jump_double", 200, 300, 2),
                      ("Memcpy DtoH", 310, 315, 7)]


def test_a_real_profile_of_the_program_keeps_its_spans_apart():
    """The CPU profiler over a traced tree: the ranges are the tracer's
    spans, and none reaches the host events ``reduce_events`` labels gaps
    with."""
    from repro_torch import obs
    from repro_torch.core import rooted_spanning_tree
    from repro_torch.data import graphs
    g = graphs.grid2d(5, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.Tracer() as tracer:
            rooted_spanning_tree(g, 2, device="cpu")
    ranges, _launches, device = spans.span_events(prof)
    names = sorted(r["name"] for r in tracer.spans())
    assert sorted(name for name, _, _ in ranges) == names
    assert device == []
    _dev, host = tracing.profile_events(prof)
    assert not {name for name, _, _ in host} & set(names)
