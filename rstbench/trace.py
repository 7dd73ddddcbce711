"""What a traced run reads: the device's busy time and its idle gaps from
``torch.profiler``, and the synchronising CUDA calls of a call from torch's
sync debug mode.

``reduce_events`` works on plain tuples, so the CPU tests hold it on
made-up events; ``profile_events`` turns the profiler's raw Kineto events
into those tuples (not its parsed tree, whose parsing takes long on many
calls).
"""
from __future__ import annotations

import bisect
import warnings

import torch
from torch.autograd import DeviceType

from rstbench import stats

# Kineto's activity types of work that occupies the device.
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset", "concurrent_kernel")
# ... and of what the host was doing meanwhile.
HOST_ACTIVITIES = ("cpu_op", "cuda_runtime", "cuda_driver")
TOP = 10


def _on_device(e) -> bool | None:
    """True for the device's work, False for the host's, None for
    neither. Torch builds whose events carry no activity type tell them
    apart by device type (a user annotation is neither)."""
    if hasattr(e, "activity_type"):
        kind = e.activity_type()
        return (True if kind in DEVICE_ACTIVITIES else
                False if kind in HOST_ACTIVITIES else None)
    if getattr(e, "is_user_annotation", lambda: False)():
        return None
    return e.device_type() == DeviceType.CUDA


def profile_events(prof) -> tuple[list, list]:
    """``(device, host)`` lists of ``(name, start_ns, end_ns)`` from a
    stopped ``torch.profiler.profile``."""
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        where = _on_device(e)
        if where is not None:
            (device if where else host).append(
                (e.name(), e.start_ns(), e.end_ns()))
    return device, host


def reduce_events(device, host, window_s: float) -> dict | None:
    """Busy seconds (the union of the device's operations), the window,
    and the breakdown: device time by operation name, and the idle gaps
    between the first and the last device operation summed by the
    innermost host event that covers each gap's middle.

    ``None`` where the device ran nothing: a reader then finds nothing.
    """
    if not device:
        return None
    merged = stats.merge((s, e) for _, s, e in device)
    busy_ns = sum(e - s for s, e in merged)
    by_op: dict[str, float] = {}
    for name, s, e in device:
        by_op[name] = by_op.get(name, 0.0) + (e - s) * 1e-9
    host = sorted(host, key=lambda h: h[1])
    starts = [s for _, s, _ in host]
    reach, cur = [], float("-inf")       # latest end among events 0..i
    for _, _, e in host:
        cur = max(cur, e)
        reach.append(cur)
    by_host: dict[str, float] = {}
    for lo, hi in stats.gaps(merged, merged[0][0], merged[-1][1]):
        mid = (lo + hi) / 2
        label = "(host outside any op)"
        # The latest-starting event that still covers the middle.
        i = bisect.bisect_right(starts, mid) - 1
        while i >= 0 and reach[i] >= mid:
            if host[i][2] >= mid:
                label = host[i][0]
                break
            i -= 1
        by_host[label] = by_host.get(label, 0.0) + (hi - lo) * 1e-9
    top = lambda d: sorted(([k, v] for k, v in d.items()),
                           key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy_ns * 1e-9, "window_s": window_s,
            "device_ops": top(by_op), "idle_gaps": top(by_host)}


def count_syncs(fn):
    """``(fn(), n)``: n is the synchronising CUDA calls ``fn`` made (host
    reads of the card, blocking copies), as torch's sync debug mode reports
    them. Only on a CUDA device; the caller synchronises afterwards."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("called a synchronizing" in str(w.message)
                    for w in caught)
