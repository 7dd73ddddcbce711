"""Observability layer (DESIGN.md §14): the port's own copy of ``repro.obs``.

Three pieces, all host-side, all free when nothing is installed:

  * ``SyncLedger`` (``ledger``) — the single sync-accounting path.
    Engine-loop host wrappers ``record(phase, syncs)`` the convergence
    counts the loops already return; benchmarks and reports read
    per-phase totals instead of re-deriving ad-hoc sums.
  * ``Tracer`` (``trace``) — span tracing of the serving loops with
    per-span wall-clock AND sync attribution; exports JSONL and Chrome
    trace-event JSON (Perfetto-loadable). Spans also mark the tree and
    BCC paths' layers and the doubling kernels' launches, and enter a
    running ``torch.profiler``'s trace as ``user_annotation`` ranges.
  * ``MetricsRegistry`` (``metrics``) — counters/gauges/histograms with
    per-tenant labels; ``percentile_line`` is the shared latency-report
    formatter (including the zero-sample path).

The hard contract, regression-tested in tests/test_torch_obs.py:
recording adds no sync and leaves every output bit-identical with
recording on or off. The wrappers run the same code either way; only the
host-side bookkeeping is conditional.
"""
from repro_torch.obs.ledger import (SyncLedger, current_ledger, record,
                                    recording)
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, METRICS_SCHEMA_VERSION,
                                     percentile_line)
from repro_torch.obs.trace import (SCHEMA_VERSION, Tracer, chrome_to_records,
                                   current_tracer, event, read_jsonl,
                                   records_to_chrome, span, spanned)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "METRICS_SCHEMA_VERSION", "SCHEMA_VERSION", "SyncLedger", "Tracer",
    "chrome_to_records", "current_ledger", "current_tracer", "event",
    "percentile_line", "read_jsonl", "record", "recording",
    "records_to_chrome", "span", "spanned",
]
