"""Span tracing for the serving loops and the tree and BCC paths
(DESIGN.md §14).

The port's own copy of ``repro.obs.trace``.

A ``Tracer`` records *spans* (named wall-clock intervals with sync
attribution) and *events* (instants with structured args) from the
serving loop: tick → dispatch → apply_batch → refresh_tour/bcc/tables →
query batch → audit/recover ladder rungs. Each span charges itself the
ledger delta across its body — inclusive of children, like any sampling
profiler — so a trace answers "where did the sync budget go" per phase
AND per wall-clock interval.

Spans also mark the layer boundaries of the tree and BCC paths (``rst``,
``connectivity``, ``rst.forest``, ``euler.root``, ``bfs.levels``,
``bcc``, ``bcc.numbering``, ``bcc.core``) and each launch of the two
doubling kernels (``kernel.pointer_jump_double``,
``kernel.list_rank_double``, with ``entries`` and ``passes``). While a
tracer is installed every span also opens
``torch.profiler.record_function(name)``, so a running profiler records
it as a ``user_annotation`` range on the clock of the device's kernels.

Two export formats from the same records:

  * JSONL (``write_jsonl``) — one record per line, schema below; the
    last line is a ``summary`` record carrying the ledger's per-phase
    totals.
  * Chrome trace-event JSON (``write_chrome``) — loadable in Perfetto
    (https://ui.perfetto.dev) / chrome://tracing: spans as ``ph: "X"``
    complete events, events as ``ph: "i"`` instants.

JSONL record schema (``v`` = SCHEMA_VERSION on every line)::

    {"v": 1, "type": "span",  "name": ..., "ts": µs, "dur": µs,
     "syncs": int, "step": int|null, "args": {...}}
    {"v": 1, "type": "event", "name": ..., "ts": µs,
     "step": int|null, "args": {...}}
    {"v": 1, "type": "summary", "sync_by_phase": {...},
     "sync_total": int, "span_count": int}

The round-trip ``chrome_to_records(read chrome file)`` reconstructs the
span/event records bit-for-bit (regression-tested in
tests/test_torch_obs.py).

Like the ledger, tracing is ambient: ``with Tracer() as tr:`` installs
the tracer (and its ledger); module-level ``span(...)``/``event(...)``
no-op when nothing is installed, so instrumented code paths cost nothing
in untraced runs.
"""
from __future__ import annotations

import contextlib
import functools
import json
import pathlib
import time

from repro_torch.obs.ledger import SyncLedger

SCHEMA_VERSION = 1

_TRACERS: list["Tracer"] = []


def current_tracer() -> "Tracer | None":
    return _TRACERS[-1] if _TRACERS else None


def span(name: str, *, step: int | None = None, **args):
    """A span on the innermost tracer; a no-op context otherwise."""
    tr = current_tracer()
    if tr is None:
        return contextlib.nullcontext()
    return tr.span(name, step=step, **args)


def spanned(name: str):
    """Decorator: every call of the function is the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*a, **k):
            with span(name):
                return fn(*a, **k)
        return call
    return wrap


def event(name: str, *, step: int | None = None, **args) -> None:
    """An instant event on the innermost tracer; no-op otherwise."""
    tr = current_tracer()
    if tr is not None:
        tr.event(name, step=step, **args)


class Tracer:
    """Span/event recorder with sync attribution via an owned ledger.

    Entering installs the tracer AND its ``SyncLedger``, so the engine
    wrappers' ``record(...)`` calls feed span attribution without any
    extra plumbing. ``ledger`` may be shared (pass one in) or owned.
    """

    def __init__(self, ledger: SyncLedger | None = None) -> None:
        self.ledger = ledger if ledger is not None else SyncLedger()
        self.records: list[dict] = []
        self._t0 = time.perf_counter()

    # -- recording -----------------------------------------------------------

    def _now_us(self) -> int:
        return int((time.perf_counter() - self._t0) * 1e6)

    @contextlib.contextmanager
    def span(self, name: str, *, step: int | None = None, **args):
        from torch.profiler import record_function
        ts = self._now_us()
        s0 = self.ledger.total()
        try:
            with record_function(name):
                yield self
        finally:
            self.records.append({
                "v": SCHEMA_VERSION, "type": "span", "name": name,
                "ts": ts, "dur": self._now_us() - ts,
                "syncs": self.ledger.total() - s0,
                "step": step, "args": args})

    def event(self, name: str, *, step: int | None = None, **args) -> None:
        self.records.append({
            "v": SCHEMA_VERSION, "type": "event", "name": name,
            "ts": self._now_us(), "step": step, "args": args})

    # -- reading -------------------------------------------------------------

    def spans(self, name: str | None = None) -> list[dict]:
        return [r for r in self.records if r["type"] == "span"
                and (name is None or r["name"] == name)]

    def events(self, name: str | None = None) -> list[dict]:
        return [r for r in self.records if r["type"] == "event"
                and (name is None or r["name"] == name)]

    def summary(self) -> dict:
        return {"v": SCHEMA_VERSION, "type": "summary",
                "sync_by_phase": self.ledger.totals(),
                "sync_total": self.ledger.total(),
                "span_count": len(self.spans())}

    # -- export --------------------------------------------------------------

    def write_jsonl(self, path) -> None:
        lines = [json.dumps(r, sort_keys=True)
                 for r in self.records + [self.summary()]]
        pathlib.Path(path).write_text("\n".join(lines) + "\n")

    def write_chrome(self, path) -> None:
        pathlib.Path(path).write_text(
            json.dumps(records_to_chrome(self.records, self.summary()),
                       indent=1) + "\n")

    # -- install/uninstall ---------------------------------------------------

    def __enter__(self) -> "Tracer":
        _TRACERS.append(self)
        self.ledger.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self.ledger.__exit__(*exc)
        for i in range(len(_TRACERS) - 1, -1, -1):
            if _TRACERS[i] is self:
                del _TRACERS[i]
                break


# -- format conversion (JSONL records ↔ Chrome trace events) ------------------

def read_jsonl(path) -> list[dict]:
    """Load a trace JSONL file back into its records (summary included)."""
    return [json.loads(line)
            for line in pathlib.Path(path).read_text().splitlines() if line]


def records_to_chrome(records: list[dict],
                      summary: dict | None = None) -> dict:
    """Span/event records → Chrome trace-event JSON (Perfetto-loadable).

    Spans become ``ph: "X"`` complete events (ts/dur in µs), events
    ``ph: "i"`` instants; the native args (incl. sync attribution and
    step) ride each event's ``args``. The summary lands in
    ``otherData`` so a renderer can recover per-phase totals.
    """
    trace_events = []
    for r in records:
        if r["type"] == "span":
            trace_events.append({
                "name": r["name"], "ph": "X", "ts": r["ts"],
                "dur": r["dur"], "pid": 0, "tid": 0,
                "args": {"syncs": r["syncs"], "step": r["step"],
                         **r["args"]}})
        elif r["type"] == "event":
            trace_events.append({
                "name": r["name"], "ph": "i", "ts": r["ts"], "s": "t",
                "pid": 0, "tid": 0,
                "args": {"step": r["step"], **r["args"]}})
    out = {"traceEvents": trace_events, "displayTimeUnit": "ms"}
    if summary is not None:
        out["otherData"] = {"sync_by_phase": summary["sync_by_phase"],
                            "sync_total": summary["sync_total"],
                            "schema_version": SCHEMA_VERSION}
    return out


def chrome_to_records(chrome: dict) -> list[dict]:
    """Chrome trace-event JSON → the native span/event records.

    Inverse of ``records_to_chrome`` for the fields the native schema
    defines (the round-trip contract tests/test_torch_obs.py enforces).
    """
    records = []
    for ev in chrome.get("traceEvents", ()):
        args = dict(ev.get("args", {}))
        step = args.pop("step", None)
        if ev.get("ph") == "X":
            syncs = args.pop("syncs", 0)
            records.append({"v": SCHEMA_VERSION, "type": "span",
                            "name": ev["name"], "ts": ev["ts"],
                            "dur": ev["dur"], "syncs": syncs,
                            "step": step, "args": args})
        elif ev.get("ph") == "i":
            records.append({"v": SCHEMA_VERSION, "type": "event",
                            "name": ev["name"], "ts": ev["ts"],
                            "step": step, "args": args})
    return records
