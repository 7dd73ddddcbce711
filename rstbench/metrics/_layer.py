"""Readers shared by the per-layer metrics. ``BENCHMARK.json`` decides in
which cells a metric is read (``catalog.applies``); a reader only reads.
"""
from rstbench import stats


def device_idle(w):
    """1 - the union of the device's operations over the profiled wall
    time, in %."""
    p = w["profile"]
    if p is None:
        return None
    return stats.idle_pct(p["busy_s"], p["window_s"])


def roofline(w, least_bytes):
    """The least bytes of one call at the peak bandwidth, over the
    device-busy time of one call, in %."""
    p, bw = w["profile"], w["peak_bytes_per_s"]
    if p is None or bw is None or p["busy_s"] <= 0:
        return None
    bound_s = least_bytes(w["n"], w["half_edges"]) / bw
    return 100.0 * bound_s / (p["busy_s"] / p["calls"])


def tree_least_bytes(n: int, half_edges: int) -> int:
    """The least bytes of one rooted spanning tree, whatever builds it,
    BFS included: each half-edge's two int32 ends read once (8 B), each
    vertex's int32 parent written once (4 B)."""
    return 8 * half_edges + 4 * n


def host_syncs(w):
    """Synchronising CUDA calls a call, as torch's sync debug mode
    counts them, averaged over the counted calls."""
    s = w["host_syncs"]
    if not s:
        return None
    return sum(s) / len(s)


def counter_mean(w, *keys):
    """The mean over the window's calls of the sum of counters the entry
    returns; None where a call lacks one."""
    vals = [sum(c[k] for k in keys) for c in w["counters"]
            if all(c.get(k) is not None for k in keys)]
    return sum(vals) / len(vals) if vals else None
