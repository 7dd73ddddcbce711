"""Streaming RST serving loop: sustain edge-update batches, report rates.

    PYTHONPATH=src python -m repro_torch.launch.serve_stream \
        --graph grid_64 --stream churn --batch 64 --steps 32

The port of ``repro.launch.serve_stream``, with the reference's flag
schema verbatim (``launch.config.ServeConfig``). It admits one
``StreamBatch`` per step and drives ``launch.resilient.ResilientStreamLoop``
(DESIGN.md §9–§12): apply under a watchdog with retry, refresh the
Euler-tour numbering at ``--tour-every`` cadence (``--tour full`` is the
from-scratch ablation, ``--tour off`` skips it), maintain the pool's
biconnectivity at the same cadence (``--bcc incremental|full``), audit and
repair (``--audit-every``), inject seeded faults (``--chaos``),
quarantine malformed events (``--sanitize``), checkpoint and resume
(``--ckpt-dir/--ckpt-every/--resume``), and report sustained updates/sec
plus batch latency percentiles.

The sustained rate counts *applied* updates only: insertions dropped by
pool overflow and deletions that matched no live edge are excluded (and
reported on a separate line when nonzero). ``--validate`` cross-checks the
final forest against a from-scratch build (``core.validate``) with a
canonical-relabel partition comparison over all vertices.

``--read-ratio r`` interleaves query batches (LCA / connectivity /
aggregates / BCC membership, round-robin) so that reads are fraction r of
all events, answered by a ``dynamic.queries.QuerySession`` that the loop's
``ForestView`` re-adopts at each refresh; ``--query-staleness`` picks the
policy between refreshes (``stale``, ``strict``, ``refresh``).

``--trace-out`` installs an ``obs.Tracer`` around the run (per-tick spans
with wall-clock and sync attribution, JSONL plus Chrome JSON) and
``--metrics-out`` flushes an ``obs.MetricsRegistry`` as JSON.

Everything runs on the card unless ``main`` is called with
``device="cpu"``; without a card the default raises.
"""
from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np

import torch

from repro_torch import obs
from repro_torch.core.graph import resolve_device
from repro_torch.dynamic.view import _wait


def canonical_partition(rep: np.ndarray) -> np.ndarray:
    """Relabel a representative array to first-occurrence order.

    Two rep arrays describe the same partition iff their canonical forms
    are elementwise equal — an O(n log n) ``np.unique`` cross-check over
    every vertex (replacing the old quadratic strided double loop, which
    sampled pairs and still dominated ``--validate`` wall-clock).
    """
    _, first, inverse = np.unique(rep, return_index=True,
                                  return_inverse=True)
    # np.unique codes are sorted by value; remap them so code k is the
    # k-th distinct representative *encountered*, making labels
    # assignment-order-free.
    order = np.argsort(np.argsort(first))
    return order[inverse]


class _ReadDriver:
    """Interleave query batches with the write loop (DESIGN.md §12).

    Per write batch, accumulates fractional read *debt* so that reads
    make up ``read_ratio`` of all events, then drains it one query batch
    at a time: a round-robin op mix (BCC membership ops only when the
    loop maintains biconnectivity) over seeded-random vertex ids. The
    ``QuerySession`` is owned by the loop's ``ForestView`` — adoption
    (rebuild on tour-refresh, carry counters across generations) is the
    view's job; this class only issues queries and records latencies.
    """

    def __init__(self, loop, cfg, n: int, device: torch.device):
        self.loop = loop
        self.policy = cfg.read.query_staleness
        self.read_batch = cfg.read.read_batch
        self.per_write = (cfg.read.read_ratio / (1.0 - cfg.read.read_ratio)
                          * cfg.stream.batch / cfg.read.read_batch)
        self.n = n
        self.rng = np.random.default_rng(cfg.stream.seed + 104729)
        self.payload = torch.as_tensor(
            self.rng.integers(1, 100, n), dtype=torch.int32, device=device)
        self.debt = 0.0
        self.lat: dict[str, list[float]] = {}
        self.batches = 0
        self.skipped_stale = 0

    def _ops(self, sess):
        ops = ["lca", "connected", "depth", "subtree_add", "path_add",
               "path_min"]
        if sess is not None and sess.bcc is not None:
            ops += ["is_bridge", "is_articulation"]
        return ops

    def serve(self, step: int) -> None:
        from repro_torch.dynamic.queries import StaleQueryError

        sess = self.loop.view.adopt_session(self.loop.state)
        self.debt += self.per_write
        while self.debt >= 1.0:
            self.debt -= 1.0
            ops = self._ops(sess)
            op = ops[self.batches % len(ops)]
            u = self.rng.integers(0, self.n, self.read_batch)
            v = self.rng.integers(0, self.n, self.read_batch)
            state = self.loop.state
            t0 = time.perf_counter()
            try:
                if op == "lca":
                    out = sess.lca(state, u, v)
                elif op == "connected":
                    out = sess.connected(state, u, v)
                elif op == "depth":
                    out = sess.depth(state, u)
                elif op == "subtree_add":
                    out = sess.subtree_agg(state, u, self.payload)
                elif op == "path_add":
                    out = sess.path_agg(state, u, v, self.payload)
                elif op == "path_min":
                    out = sess.path_agg(state, u, v, self.payload,
                                        "min")
                elif op == "is_bridge":
                    out = sess.is_bridge(state, u, v)
                else:
                    out = sess.is_articulation(state, u)
            except StaleQueryError:
                self.skipped_stale += 1   # strict policy between refreshes
                self.batches += 1
                continue
            _wait(out)
            self.lat.setdefault(op, []).append(time.perf_counter() - t0)
            self.batches += 1

    def report(self) -> None:
        served = sum(len(v) for v in self.lat.values())
        total = served * self.read_batch
        print(f"\nreads: {total} queries in {served} batches of "
              f"{self.read_batch} (staleness={self.policy}"
              + (f", {self.skipped_stale} batches skipped stale"
                 if self.skipped_stale else "") + ")")
        # Full op mix, in round-robin order: a short run may never reach
        # the later ops — obs.percentile_line reports "no samples"
        # instead of handing np.percentile an empty list (shared path
        # with serve_fleet, regression-tested in tests/test_obs.py).
        sess = self.loop.view.session
        mix = self._ops(sess)
        extras = sorted(set(self.lat) - set(mix))
        for op in mix + extras:
            line = obs.percentile_line(
                self.lat.get(op, ()), width=7, count_suffix=True,
                empty_reason=f"op never reached in {self.batches} "
                             "read batches")
            print(f"  {op:15s}: {line}")
        t = sess.sync_stats() if sess is not None else {
            "builds": 0, "build_syncs_total": 0, "stale_served": 0,
            "auto_refreshes": 0}
        amort = t["build_syncs_total"] / max(served, 1)
        print(f"query sync accounting: {t['builds']} table builds, "
              f"{t['build_syncs_total']} build syncs "
              f"({amort:.2f} amortized per read batch; queries are "
              f"sync-free gathers), stale_served={t['stale_served']}, "
              f"auto_refreshes={t['auto_refreshes']}")


def main(argv=None, *, device: str | torch.device | None = None) -> None:
    """Run the serving loop on ``argv`` (the ``ServeConfig`` flags), on
    ``device``: the card unless the caller names another."""
    from repro_torch.launch.config import ServeConfig

    ap = argparse.ArgumentParser(
        description="batch-dynamic RST serving loop (DESIGN.md §9–§12)")
    ServeConfig.add_args(ap)
    args = ap.parse_args(argv)
    try:
        cfg = ServeConfig.from_args(args).check()
    except ValueError as e:
        ap.error(str(e))

    from repro_torch.data.graphs import SUITE
    from repro_torch.data.streams import STREAMS
    from repro_torch.dynamic.chaos import INJECTORS
    from repro_torch.launch.resilient import ResilientStreamLoop

    dev = resolve_device(device)
    factory, kwargs, regime = SUITE[cfg.stream.graph]
    g = factory(**kwargs, device=dev)
    n = g.n_nodes
    stream = STREAMS[cfg.stream.stream](g, **cfg.stream_kwargs())
    batches = stream.batches[:cfg.stream.steps]

    try:
        chaos = cfg.injector_names(INJECTORS)
    except ValueError as e:
        ap.error(str(e))

    print(f"graph {cfg.stream.graph} ({regime}): V={n} E={g.n_edges}; "
          f"stream {cfg.stream.stream}, batch={cfg.stream.batch}, "
          f"{len(batches)} batches, tour={cfg.refresh.tour}, "
          f"bcc={cfg.refresh.bcc}"
          + (f", chaos={','.join(chaos)}@{cfg.chaos.chaos_every}" if chaos
             else "")
          + (f", audit@{cfg.chaos.audit_every}" if cfg.chaos.audit_every
             else ""))

    loop = ResilientStreamLoop.from_config(stream, cfg, device=dev)
    if cfg.read.read_ratio:
        # Let the loop's view own the QuerySession at the refresh cadence.
        loop.view.policy = cfg.cadence()
    if cfg.ckpt.resume:
        start = loop.resume()
        if start:
            print(f"resumed from checkpoint at batch {start}")

    # Warm the kernels and the allocator on the first batch (not timed).
    if batches and loop.cursor < len(batches):
        from repro_torch.dynamic import replay_batch
        warm, _ = replay_batch(loop.state, batches[loop.cursor])
        _wait(warm.parent)

    reads = (_ReadDriver(loop, cfg, n, dev) if cfg.read.read_ratio
             else None)

    def snapshot_metrics() -> "obs.MetricsRegistry":
        """The loop's cumulative telemetry as one registry (rebuilt per
        flush — every instrument reflects run-so-far totals)."""
        m = obs.MetricsRegistry()
        m.counter("applied_events").inc(loop.applied)
        m.counter("dropped_overflow").inc(loop.dropped_overflow)
        m.counter("dropped_unmatched").inc(loop.dropped_unmatched)
        m.counter("retries").inc(loop.retries)
        m.counter("faults_injected").inc(len(loop.injected))
        m.counter("recoveries").inc(len(loop.recoveries))
        for cat, count in sorted(loop.quarantine.items()):
            m.counter("quarantined", category=cat).inc(count)
        m.gauge("components").set(int(loop.state.n_components))
        for name, samples in (("batch_latency_ms", loop.lat),
                              ("tour_refresh_ms", loop.tour_lat),
                              ("bcc_refresh_ms", loop.bcc_lat)):
            h = m.histogram(name)
            for s in samples:
                h.observe(s * 1e3)
        if reads is not None:
            m.counter("read_batches").inc(reads.batches)
            m.counter("reads_skipped_stale").inc(reads.skipped_stale)
            for op, samples in sorted(reads.lat.items()):
                h = m.histogram("query_latency_ms", op=op)
                for s in samples:
                    h.observe(s * 1e3)
        return m

    def on_batch(step, stats, dt):
        if reads is not None:
            with obs.span("query_batch", step=step):
                reads.serve(step)
        if cfg.obs.metrics_out and cfg.obs.metrics_every \
                and (step + 1) % cfg.obs.metrics_every == 0:
            snapshot_metrics().write(cfg.obs.metrics_out)
        if step < 3 or (step + 1) % 8 == 0:
            line = (f"  batch {step:3d}: {dt*1e3:6.1f} ms  "
                    f"cuts={int(stats['cuts'])} links={int(stats['links'])} "
                    f"rounds={int(stats['rounds'])} "
                    f"components={int(loop.state.n_components)}")
            if loop.bcc is not None:
                line += (f" n_bcc={int(loop.bcc.n_bcc)} "
                         f"bridges={int(loop.bcc.n_bridges)}")
            print(line)

    tracer = obs.Tracer() if cfg.obs.trace_out else None
    t_loop = time.perf_counter()
    with tracer if tracer is not None else contextlib.nullcontext():
        state = loop.run(batches, on_batch=on_batch)
    elapsed = time.perf_counter() - t_loop

    if not loop.lat:
        print("\nno batches applied (empty stream or --steps 0); "
              "nothing to report")
    else:
        print(f"\nsustained: {loop.applied / max(elapsed, 1e-9):,.0f} "
              f"updates/sec ({loop.applied} applied events / "
              f"{elapsed:.2f} s)")
        dropped = loop.dropped_overflow + loop.dropped_unmatched
        if dropped:
            print(f"dropped: {dropped} events excluded from the rate "
                  f"(pool overflow={loop.dropped_overflow}, "
                  f"unmatched deletes={loop.dropped_unmatched})")
        print(f"batch latency: {obs.percentile_line(loop.lat)}")
        if loop.tour_lat:
            print(f"tour refresh ({cfg.refresh.tour}): median "
                  f"{np.median(loop.tour_lat)*1e3:.1f} ms over "
                  f"{len(loop.tour_lat)} calls")
        if loop.bcc_lat:
            print(f"bcc refresh ({cfg.refresh.bcc}): median "
                  f"{np.median(loop.bcc_lat)*1e3:.1f} ms over "
                  f"{len(loop.bcc_lat)} calls; "
                  f"final n_bcc={int(loop.bcc.n_bcc)} "
                  f"bridges={int(loop.bcc.n_bridges)} "
                  f"articulation={int(loop.bcc.n_articulation)}")
    if reads is not None:
        reads.report()
    if loop.quarantine:
        total = sum(loop.quarantine.values())
        cats = ", ".join(f"{k}={v}" for k, v in
                         sorted(loop.quarantine.items()) if v)
        print(f"quarantined: {total} malformed events rejected by the "
              f"sanitizer ({cats})" if total else
              "quarantined: 0 malformed events")
    if chaos or cfg.chaos.audit_every:
        n_rec = len(loop.recoveries)
        modes = {}
        for _, info in loop.recoveries:
            modes[info["mode"]] = modes.get(info["mode"], 0) + 1
        print(f"chaos: {len(loop.injected)} faults injected; "
              f"recoveries: {n_rec}"
              + (f" ({', '.join(f'{k}={v}' for k, v in sorted(modes.items()))})"
                 if n_rec else ""))
        if loop.last_report is not None:
            print(f"final audit: {loop.last_report.summary()}")

    if tracer is not None:
        tracer.write_jsonl(cfg.obs.trace_out)
        tracer.write_chrome(cfg.obs.trace_out + ".chrome.json")
        s = tracer.summary()
        print(f"trace: {s['span_count']} spans, "
              f"sync_total={s['sync_total']} -> {cfg.obs.trace_out} "
              f"(+ .chrome.json)")
    if cfg.obs.metrics_out:
        snapshot_metrics().write(cfg.obs.metrics_out)
        print(f"metrics -> {cfg.obs.metrics_out}")

    if cfg.validate:
        from repro_torch.core.compress import roots_of
        from repro_torch.core.rst import rooted_spanning_tree
        from repro_torch.core.validate import validate_rst
        from repro_torch.dynamic import live_graph

        lg = live_graph(state)
        root = int(state.rep[0])
        v = validate_rst(lg, state.parent, root, connected=False)
        scratch = rooted_spanning_tree(lg, root, method="gconn_euler",
                                       device=dev)
        rep_d = state.rep.cpu().numpy()
        rep_s = roots_of(scratch.parent).cpu().numpy()
        same = bool(np.array_equal(canonical_partition(rep_d),
                                   canonical_partition(rep_s)))
        print(f"validate: forest {v}, partition==from-scratch: {same} "
              f"(all {n} vertices)")
        if not (v["all_ok"] and same):
            raise SystemExit("validate: FAILED")


if __name__ == "__main__":
    main()
