"""Metrics registry: counters, gauges, histograms (DESIGN.md §14).

The port's own copy of ``repro.obs.metrics``.

Absorbs the hand-rolled percentile/counter reporting the serving loops
grew (``serve_stream``'s per-op latency dict, ``serve_fleet``'s
``_percentiles``, the ``ForestView`` refresh-latency lists, the
``ResilientStreamLoop`` telemetry counters) behind one registry with a
stable export schema:

  * ``Counter`` — monotonically increasing int (applied events, faults
    injected, quarantined events, ...);
  * ``Gauge``   — last-set value (live edges, components, residency);
  * ``Histogram`` — fixed log-spaced buckets plus exact sample
    percentiles (latencies; sample retention capped so a long soak
    can't grow without bound — bucket counts stay exact forever).

Metrics are keyed by (name, labels): the fleet axis labels per-tenant
series (``registry.counter("applied", tenant=3)``) without minting a
name per tenant. ``to_dict``/``write`` flush the registry as JSON
(stable sort order) for the ``--metrics-out`` flag.

``percentile_line`` is the shared latency-report formatter both serving
loops print through — including the zero-sample path ("no samples"
instead of handing ``np.percentile`` an empty list, which raised; a
shared-path test pins it).
"""
from __future__ import annotations

import json
import pathlib

import numpy as np

METRICS_SCHEMA_VERSION = 1

#: log-spaced default bucket upper bounds (milliseconds-oriented, but
#: unit-free): 13 buckets from 0.25 to 2^10, plus the +inf overflow.
DEFAULT_BUCKETS = tuple(0.25 * 2 ** i for i in range(13))

#: exact-percentile sample retention cap per histogram.
SAMPLE_CAP = 65536


def percentile_line(samples, *, unit: float = 1e3, width: int = 6,
                    count_suffix: bool = False,
                    empty_reason: str | None = None) -> str:
    """One p50/p95 latency line, shared by every serving report.

    ``samples`` are seconds (scaled by ``unit`` to ms). An empty sample
    list reports "no samples" (with ``empty_reason`` appended when
    given) instead of crashing the percentile math.
    """
    if not len(samples):
        return "no samples" if empty_reason is None \
            else f"no samples ({empty_reason})"
    ms = np.asarray(samples) * unit
    line = (f"p50 {np.percentile(ms, 50):{width}.2f} ms  "
            f"p95 {np.percentile(ms, 95):{width}.2f} ms")
    if count_suffix:
        line += f"  ({len(ms)} batches)"
    return line


class Counter:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def snapshot(self) -> dict:
        return {"value": self.value}


class Gauge:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v) -> None:
        self.value = float(v)

    def snapshot(self) -> dict:
        return {"value": self.value}


class Histogram:
    """Fixed-bucket histogram + capped raw samples for exact percentiles."""

    __slots__ = ("bounds", "bucket_counts", "count", "total", "min", "max",
                 "samples")

    def __init__(self, bounds=DEFAULT_BUCKETS) -> None:
        self.bounds = tuple(float(b) for b in bounds)
        self.bucket_counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None
        self.samples: list[float] = []

    def observe(self, x) -> None:
        x = float(x)
        i = int(np.searchsorted(self.bounds, x, side="left"))
        self.bucket_counts[i] += 1
        self.count += 1
        self.total += x
        self.min = x if self.min is None else min(self.min, x)
        self.max = x if self.max is None else max(self.max, x)
        if len(self.samples) < SAMPLE_CAP:
            self.samples.append(x)

    def percentile(self, q: float):
        if not self.samples:
            return None
        return float(np.percentile(np.asarray(self.samples), q))

    def snapshot(self) -> dict:
        return {"count": self.count, "sum": self.total,
                "min": self.min, "max": self.max,
                "buckets": {str(b): c for b, c in
                            zip(self.bounds + ("inf",),
                                self.bucket_counts)},
                "p50": self.percentile(50), "p95": self.percentile(95),
                "p99": self.percentile(99)}


class MetricsRegistry:
    """Get-or-create metric instruments keyed by (name, labels)."""

    _TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}

    def __init__(self) -> None:
        self._metrics: dict[tuple, object] = {}

    def _get(self, kind: str, name: str, labels: dict, **kwargs):
        key = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
        m = self._metrics.get(key)
        if m is None:
            m = self._TYPES[kind](**kwargs)
            self._metrics[key] = m
        elif not isinstance(m, self._TYPES[kind]):
            raise TypeError(f"metric {name!r}{labels} already registered "
                            f"as {type(m).__name__}, not {kind}")
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels)

    def histogram(self, name: str, bounds=DEFAULT_BUCKETS,
                  **labels) -> Histogram:
        return self._get("histogram", name, labels, bounds=bounds)

    # -- export --------------------------------------------------------------

    def to_dict(self) -> dict:
        """The full registry as one JSON-able dict, stable-sorted."""
        out = []
        for (name, labels), m in sorted(self._metrics.items()):
            out.append({"name": name, "labels": dict(labels),
                        "type": type(m).__name__.lower(),
                        **m.snapshot()})
        return {"schema_version": METRICS_SCHEMA_VERSION, "metrics": out}

    def write(self, path) -> None:
        pathlib.Path(path).write_text(
            json.dumps(self.to_dict(), indent=1, sort_keys=True) + "\n")
