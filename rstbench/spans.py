"""What a traced run reads of the program's own spans.

While a ``repro_torch.obs.Tracer`` is installed, every span of the program
(``rst``, ``connectivity``, ``euler.root``, ``bcc.core``, the doubling
kernels' launches, ...) is also a ``user_annotation`` range in the
profiler's trace, on the clock of the device's operations.
``span_events`` takes from a stopped ``torch.profiler.profile`` the
ranges, the host start of each launch (its ``cuda_runtime`` or
``cuda_driver`` event, by correlation id) and the device's operations;
``reduce_spans`` charges each device operation to the innermost range open
on the host when it was launched, and sums by span name; ``span_gaps``
labels the device's idle gaps by the innermost range over each gap's
middle. ``trace.reduce_events`` never sees the ranges: ``profile_events``
drops user annotations.

All work on plain tuples, so the CPU tests hold them on made-up events.
"""
from __future__ import annotations

import bisect
import re

from torch.autograd import DeviceType

from rstbench import stats
from rstbench import trace as tracing

LAUNCH_ACTIVITIES = ("cuda_runtime", "cuda_driver")
# The CUDA runtime's and driver's calls (cudaLaunchKernel, cuLaunchKernel,
# cudaMemcpyAsync, ...), for torch builds whose events carry no activity
# type.
CUDA_API = re.compile(r"^cu(da)?[A-Z]")
OUTSIDE = "(between calls)"
NO_HOST = "(host outside any op)"      # reduce_events's label for none


def span_events(prof) -> tuple[list, dict, list]:
    """``(ranges, launches, device)`` from a stopped profiler: the user
    annotations as ``(name, start_ns, end_ns)``, ``{correlation_id:
    start_ns}`` of the host's launch calls, and the device's operations as
    ``(name, start_ns, end_ns, correlation_id)``."""
    ranges, launches, device = [], {}, []
    for e in prof.profiler.kineto_results.events():
        kind = _kind(e)
        if kind == "range":
            ranges.append((e.name(), e.start_ns(), e.end_ns()))
        elif kind == "launch":
            launches[e.correlation_id()] = e.start_ns()
        elif kind == "device":
            device.append((e.name(), e.start_ns(), e.end_ns(),
                           e.correlation_id()))
    return ranges, launches, device


def _kind(e) -> str | None:
    """``"range"`` for a user annotation on the host, ``"launch"`` for a
    call of the CUDA runtime or driver, ``"device"`` for the device's
    work, None for anything else (a torch op, an annotation's copy on the
    device's timeline). ``trace._on_device`` splits device from host;
    torch builds whose events carry no activity type tell the rest apart
    by device type and name."""
    where = tracing._on_device(e)
    if where:
        return "device"
    typed = hasattr(e, "activity_type")
    if where is None:
        on_host = (e.activity_type() == "user_annotation" if typed else
                   e.device_type() != DeviceType.CUDA)
        return "range" if on_host else None
    launch = (e.activity_type() in LAUNCH_ACTIVITIES if typed else
              CUDA_API.match(e.name()))
    return "launch" if launch else None


class _Tree:
    """Ranges that nest as the calls did, sorted by start (outer first
    where two start together), each with the index of the range around
    it (-1: none)."""

    def __init__(self, ranges):
        self.ranges = sorted(ranges, key=lambda r: (r[1], -r[2]))
        self.starts = [s for _, s, _ in self.ranges]
        self.parent, stack = [], []
        for i, (_, s, _) in enumerate(self.ranges):
            while stack and self.ranges[stack[-1]][2] <= s:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def innermost(self, t) -> int:
        """The innermost range open at ``t``, or -1."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.ranges[i][2] < t:
            i = self.parent[i]
        return i

    def names(self, i) -> set[str]:
        """The names of range ``i`` and of every range around it."""
        out = set()
        while i >= 0:
            out.add(self.ranges[i][0])
            i = self.parent[i]
        return out


def _overlap_ns(a, b) -> float:
    """The length of the intersection of two sorted disjoint interval
    lists."""
    total, j = 0.0, 0
    for lo, hi in a:
        while j < len(b) and b[j][1] <= lo:
            j += 1
        k = j
        while k < len(b) and b[k][0] < hi:
            total += min(hi, b[k][1]) - max(lo, b[k][0])
            k += 1
    return total


def reduce_spans(ranges, launches, device, records) -> dict:
    """``{name: {"device_s", "idle_s", "count", "args"}}`` for every span
    name in ``ranges``.

    ``device_s``: the union of the device operations whose launch the span
    held, its child spans included (a span nested in one of its own name
    counts once). ``idle_s``: the time inside the span's host ranges in
    which the device ran nothing. ``count``: its ranges. ``args``: each
    numeric arg summed over the tracer's ``records`` of the name, and
    ``entry_passes``, the sum of ``entries × passes`` where a record has
    both. A device operation whose launch is not in ``launches``, or was
    made outside every span, is charged to none.
    """
    tree = _Tree(ranges)
    by_name: dict[str, list] = {name: [] for name, _, _ in tree.ranges}
    for _, s, e, corr in device:
        t = launches.get(corr)
        if t is None:
            continue
        for name in tree.names(tree.innermost(t)):
            by_name[name].append((s, e))
    busy = stats.merge((s, e) for _, s, e, _ in device)
    out = {}
    for name, ops in by_name.items():
        host = stats.merge((s, e) for n, s, e in tree.ranges if n == name)
        host_ns = sum(e - s for s, e in host)
        out[name] = {
            "device_s": sum(e - s for s, e in stats.merge(ops)) * 1e-9,
            "idle_s": (host_ns - _overlap_ns(host, busy)) * 1e-9,
            "count": sum(n == name for n, _, _ in tree.ranges),
            "args": _args(r for r in records
                          if r["type"] == "span" and r["name"] == name)}
    return out


def _args(records) -> dict:
    total: dict[str, float] = {}
    for r in records:
        a = r["args"]
        for k, v in a.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                total[k] = total.get(k, 0) + v
        if "entries" in a and "passes" in a:
            total["entry_passes"] = (total.get("entry_passes", 0)
                                     + a["entries"] * a["passes"])
    return total


def span_gaps(ranges, device) -> list:
    """The idle gaps between the first and the last device operation,
    summed by the innermost span over each gap's middle (``OUTSIDE`` where
    none is), the ``trace.TOP`` longest as ``[label, seconds]``:
    ``trace.reduce_events``'s gap table with the spans as its host
    events."""
    p = tracing.reduce_events([d[:3] for d in device], ranges, 0.0)
    if p is None:
        return []
    return [[OUTSIDE if k == NO_HOST else k, v] for k, v in p["idle_gaps"]]
