"""Multi-tenant fleet serving loop: T session graphs, one process.

    PYTHONPATH=src python -m repro_torch.launch.serve_fleet \
        --graph grid_64 --stream churn --batch 64 --steps 32 \
        --tenants 6 --slots 4

The port of ``repro.launch.serve_fleet``, with the reference's flags
(``launch.config.ServeConfig`` + ``FleetConfig``) and report lines. Each
*tenant* is an independent session graph driven by its own edge stream
(same generator, per-tenant seed ``--seed + t``). Per tick the
``FleetDispatcher`` coalesces one queued batch unit per resident tenant
into a fixed-shape ``(T, B)`` event block and ``apply_batches`` applies
it as one disjoint-union call (DESIGN.md §13): the fleet pays
``max_t(rounds_t) + 1`` convergence reads where T sequential loops would
pay ``Σ_t(rounds_t + 1)``. Cache refreshes (tour, optional BCC, the
stacked ``QueryTables``) run over the union the same way at
``--tour-every`` cadence, and reads are served per tenant by a
``FleetQuerySession`` under the ``--query-staleness`` policy.

When ``--tenants`` exceeds ``--slots``, residency rotates: admission
evicts the least-recently-used resident through ``train.checkpoint``
(forest + stream cursor, atomic publish) and re-admission restores it
bit-identically, so eviction is invisible to a tenant's stream history.

``--buckets`` (DESIGN.md §15) replaces the single-schema fleet with
shape-bucketed sub-fleets: each ``graph:tenants[:slots[:batch]]`` spec
becomes a ``FleetBucket`` with its own ``(T_b, B_b)`` block shape,
refresh cadence, idle-LRU admission (async checkpoint prefetch), and
``max_t(rounds)+1`` sync bill —

    PYTHONPATH=src python -m repro_torch.launch.serve_fleet \
        --buckets chain_64:12:4,rmat_9:2:2:32 --stream churn \
        --batch 8 --steps 8 --validate

Everything runs on the card unless ``main`` is called with
``device="cpu"``; without a card the default raises.
"""
from __future__ import annotations

import argparse
import contextlib
import tempfile
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.graph import resolve_device
from repro_torch.dynamic.view import _wait


def _validate(forest, dev) -> bool:
    """The forest's partition equals a from-scratch RST's on its live
    graph (every vertex, canonical relabelling)."""
    from repro_torch.core.compress import roots_of
    from repro_torch.core.rst import rooted_spanning_tree
    from repro_torch.dynamic import live_graph
    from repro_torch.launch.serve_stream import canonical_partition

    lg = live_graph(forest)
    root = int(forest.rep[0])
    scratch = rooted_spanning_tree(lg, root, method="gconn_euler",
                                   device=dev)
    return bool(np.array_equal(
        canonical_partition(forest.rep.cpu().numpy()),
        canonical_partition(roots_of(scratch.parent).cpu().numpy())))


def main(argv=None, *, device: str | torch.device | None = None) -> None:
    """Run the fleet serving loop on ``argv`` (the ``ServeConfig`` and
    ``FleetConfig`` flags), on ``device``: the card unless the caller
    names another."""
    from repro_torch.launch.config import FleetConfig, ServeConfig

    ap = argparse.ArgumentParser(
        description="multi-tenant batch-dynamic serving loop "
                    "(DESIGN.md §13)")
    ServeConfig.add_args(ap)
    FleetConfig.add_args(ap)
    args = ap.parse_args(argv)
    try:
        cfg = ServeConfig.from_args(args).check()
        fcfg = FleetConfig.from_args(args).check()
    except ValueError as e:
        ap.error(str(e))

    dev = resolve_device(device)
    if fcfg.buckets:
        _main_bucketed(cfg, fcfg, dev)
        return

    from repro_torch.data.graphs import SUITE
    from repro_torch.data.streams import STREAMS, StreamBatch
    from repro_torch.dynamic.fleet import (FleetDispatcher, FleetManager,
                                           FleetQuerySession, apply_batches,
                                           fleet_empty, fleet_sync_cost,
                                           refresh_bccs, refresh_tours)
    from repro_torch.dynamic.queries import StaleQueryError
    from repro_torch.dynamic.replay import stream_capacity

    factory, kwargs, regime = SUITE[cfg.stream.graph]
    g = factory(**kwargs, device=dev)
    n = g.n_nodes

    # Per-tenant streams: same workload shape, decorrelated seeds. The
    # initially-live edges ride the dispatcher as batch 0 (insert-only),
    # so every tenant's history replays through the same (T, B) path.
    streams = []
    for t in range(fcfg.tenants):
        kw = dict(cfg.stream_kwargs())
        kw["seed"] = cfg.stream.seed + t
        streams.append(STREAMS[cfg.stream.stream](g, **kw))
    capacity = max(stream_capacity(s) for s in streams)
    n_slots = min(fcfg.slots, fcfg.tenants)
    steps = min(cfg.stream.steps, min(len(s.batches) for s in streams))

    evict_dir = fcfg.evict_dir or tempfile.mkdtemp(prefix="fleet_evict_")
    fleet = fleet_empty(n_slots, n, capacity, device=dev)
    manager = FleetManager(fleet, evict_dir)
    dispatcher = FleetDispatcher(n, cfg.stream.batch, device=dev)

    for t, stream in enumerate(streams):
        if stream.init_u.shape[0]:
            b = cfg.stream.batch
            for off in range(0, stream.init_u.shape[0], b):
                iu = np.full(b, n, np.int32)
                iv = np.full(b, n, np.int32)
                chunk = stream.init_u[off:off + b]
                iu[:chunk.shape[0]] = chunk
                iv[:chunk.shape[0]] = stream.init_v[off:off + b]
                dispatcher.offer(t, StreamBatch(
                    ins_u=iu, ins_v=iv,
                    del_u=np.full(b, n, np.int32),
                    del_v=np.full(b, n, np.int32)))
        for batch in stream.batches[:steps]:
            dispatcher.offer(t, batch)

    print(f"graph {cfg.stream.graph} ({regime}): V={n} E={g.n_edges}; "
          f"stream {cfg.stream.stream}, batch={cfg.stream.batch}, "
          f"{steps} batches x {fcfg.tenants} tenants in {n_slots} slots "
          f"(capacity {capacity}), tour={cfg.refresh.tour}, "
          f"bcc={cfg.refresh.bcc}")

    tn = None
    bcc = None
    sess = None
    cadence = cfg.cadence()
    applied = {t: 0 for t in range(fcfg.tenants)}
    batch_lat: dict[int, list] = {t: [] for t in range(fcfg.tenants)}
    query_lat: dict[int, list] = {t: [] for t in range(fcfg.tenants)}
    sync_fleet = 0
    sync_seq_equiv = 0
    refresh_lat: list = []
    rng = np.random.default_rng(cfg.stream.seed + 104729)
    payload_reads = cfg.read.read_ratio > 0
    read_per_tick = 0.0
    if payload_reads:
        r = cfg.read.read_ratio
        read_per_tick = r / (1.0 - r) * cfg.stream.batch / cfg.read.read_batch
    read_debt = {t: 0.0 for t in range(fcfg.tenants)}

    def snapshot_metrics() -> obs.MetricsRegistry:
        """Fresh registry from the cumulative loop telemetry (rebuilt per
        flush so monotonic counters never double-count)."""
        m = obs.MetricsRegistry()
        m.gauge("tenants").set(fcfg.tenants)
        m.gauge("slots").set(n_slots)
        m.counter("fleet_syncs").inc(sync_fleet)
        m.counter("sequential_equiv_syncs").inc(sync_seq_equiv)
        m.counter("admissions").inc(manager.admissions)
        m.counter("evictions").inc(manager.evictions)
        m.counter("restores").inc(manager.restores)
        for s in refresh_lat:
            m.histogram("refresh_ms").observe(s * 1e3)
        for t in range(fcfg.tenants):
            m.counter("applied_events", tenant=t).inc(applied[t])
            for s in batch_lat[t]:
                m.histogram("batch_latency_ms", tenant=t).observe(s * 1e3)
            for s in query_lat[t]:
                m.histogram("query_latency_ms", tenant=t).observe(s * 1e3)
        return m

    tracer = obs.Tracer() if cfg.obs.trace_out else None

    t_loop = time.perf_counter()
    tick = 0
    with tracer if tracer is not None else contextlib.nullcontext():
        while dispatcher.pending():
            with obs.span("tick", step=tick):
                # Residency: every tenant with queued traffic gets a slot
                # this tick if one is free; otherwise LRU eviction rotates
                # them in, preferring idle victims.
                busy = lambda x: dispatcher.pending(x) > 0  # noqa: E731
                waiting = [t for t in range(fcfg.tenants)
                           if dispatcher.pending(t)]
                for t in waiting[:n_slots]:
                    manager.ensure(t, busy=busy)
                fleet = manager.fleet

                (iu, iv, du, dv), served = dispatcher.tick(
                    manager.tenant_at)
                t0 = time.perf_counter()
                with obs.span("apply_batch", step=tick,
                              tenants=len(served)):
                    fleet, stats = apply_batches(fleet, iu, iv, du, dv)
                    _wait(fleet.parent)
                dt = time.perf_counter() - t0
                manager.fleet = fleet
                manager.note_applied(served)

                rounds = stats["rounds"].cpu().numpy()
                sync_fleet += fleet_sync_cost(stats)
                overflow = stats["overflow"].cpu().numpy()
                found = stats["deletes_found"].cpu().numpy()
                ins_live = (iu < n).sum(1).cpu().numpy()
                for tenant, events in served.items():
                    slot = manager.slot_of[tenant]
                    sync_seq_equiv += int(rounds[slot]) + 1
                    applied[tenant] += (int(ins_live[slot])
                                        - int(overflow[slot])
                                        + int(found[slot]))
                    batch_lat[tenant].append(dt)

                if cadence.tour != "off" and cadence.due(tick):
                    t0 = time.perf_counter()
                    with obs.span("refresh_tour", step=tick):
                        tn, fleet = refresh_tours(
                            fleet, tn,
                            incremental=(cadence.tour == "incremental"))
                    if cadence.bcc != "off":
                        with obs.span("refresh_bcc", step=tick):
                            bcc = refresh_bccs(
                                fleet, bcc, tour=tn,
                                incremental=(cadence.bcc == "incremental"))
                    _wait(tn.pre)
                    refresh_lat.append(time.perf_counter() - t0)
                    manager.fleet = fleet
                    if payload_reads:
                        # Telemetry is keyed on stable tenant ids, not
                        # slot indices: a rotated tenant's counters
                        # continue where they left off.
                        if sess is None:
                            sess = FleetQuerySession.from_fleet(
                                fleet, tn, bcc,
                                policy=cfg.read.query_staleness,
                                labels=[t if t is not None else s
                                        for s, t in enumerate(
                                            manager.tenant_at)])
                        else:
                            for s, tenant in enumerate(manager.tenant_at):
                                if tenant is not None:
                                    sess.set_label(s, tenant)
                            sess.restamp(fleet, tn, bcc)

                if payload_reads and sess is not None:
                    for tenant in served:
                        slot = manager.slot_of[tenant]
                        read_debt[tenant] += read_per_tick
                        while read_debt[tenant] >= 1.0:
                            read_debt[tenant] -= 1.0
                            u = rng.integers(0, n, cfg.read.read_batch)
                            v = rng.integers(0, n, cfg.read.read_batch)
                            t0 = time.perf_counter()
                            try:
                                with obs.span("query_batch", step=tick,
                                              tenant=tenant):
                                    out = sess.lca(fleet, slot, u, v) \
                                        if tick % 2 else sess.connected(
                                            fleet, slot, u, v)
                                    _wait(out)
                            except StaleQueryError:
                                continue
                            query_lat[tenant].append(
                                time.perf_counter() - t0)
            if (cfg.obs.metrics_out and cfg.obs.metrics_every
                    and (tick + 1) % cfg.obs.metrics_every == 0):
                snapshot_metrics().write(cfg.obs.metrics_out)
            tick += 1
    elapsed = time.perf_counter() - t_loop

    total_applied = sum(applied.values())
    print(f"\nfleet: {total_applied} applied events across "
          f"{fcfg.tenants} tenants in {tick} ticks / {elapsed:.2f} s "
          f"({total_applied / max(elapsed, 1e-9):,.0f} events/sec "
          f"aggregate)")
    print(f"admission: {manager.admissions} admissions, "
          f"{manager.evictions} evictions, {manager.restores} restores "
          f"(evict checkpoints under {evict_dir})")
    print(f"sync accounting: fleet={sync_fleet} convergence checks vs "
          f"sequential-equivalent={sync_seq_equiv} "
          f"({sync_fleet / max(sync_seq_equiv, 1):.2f}x); "
          f"per applied event {sync_fleet / max(total_applied, 1):.4f} "
          f"vs {sync_seq_equiv / max(total_applied, 1):.4f}")
    if refresh_lat:
        print(f"union refresh ({cfg.refresh.tour}"
              + (f"+bcc {cfg.refresh.bcc}" if cadence.bcc != "off" else "")
              + f"): median {np.median(refresh_lat)*1e3:.1f} ms over "
              f"{len(refresh_lat)} calls")
    print("\nper-tenant:")
    for t in range(fcfg.tenants):
        line = (f"  tenant {t}: {applied[t]:6d} applied  "
                f"batch {obs.percentile_line(batch_lat[t])}")
        if payload_reads:
            line += f"  query {obs.percentile_line(query_lat[t])}"
        print(line)
    if payload_reads and sess is not None:
        s = sess.sync_stats()
        print(f"\nquery sync accounting (fleet totals): {s['builds']} "
              f"table builds, {s['build_syncs_total']} build syncs, "
              f"stale_served={s['stale_served']}, "
              f"auto_refreshes={s['auto_refreshes']}")

    if tracer is not None:
        tracer.write_jsonl(cfg.obs.trace_out)
        tracer.write_chrome(cfg.obs.trace_out + ".chrome.json")
        print(f"\ntrace: {len(tracer.records)} records -> "
              f"{cfg.obs.trace_out} (+ .chrome.json); "
              f"ledger sync_total={tracer.ledger.total()}")
    if cfg.obs.metrics_out:
        snapshot_metrics().write(cfg.obs.metrics_out)
        print(f"metrics -> {cfg.obs.metrics_out}")

    if cfg.validate:
        ok = True
        for t in range(fcfg.tenants):
            slot = manager.ensure(t)
            same = _validate(manager.fleet.tenant(slot), dev)
            ok = ok and same
            print(f"validate tenant {t}: partition==from-scratch: {same}")
        if not ok:
            raise SystemExit("validate: FAILED")


def _main_bucketed(cfg, fcfg, dev: torch.device) -> None:
    """Shape-bucketed serving loop (DESIGN.md §15).

    Each ``--buckets`` spec becomes a ``FleetBucket``; tenants are routed
    by exact ``FleetSchema`` and every bucket ticks with its own block
    shape and sync bill. Per-tenant/per-bucket telemetry rides stable
    ids; ``--validate`` checks every tenant's final partition against a
    from-scratch RST on its live graph.
    """
    from repro_torch.data.graphs import resolve_graph
    from repro_torch.data.streams import STREAMS
    from repro_torch.dynamic.fleet import BucketedFleet, FleetSchema
    from repro_torch.dynamic.queries import StaleQueryError
    from repro_torch.dynamic.replay import init_state, stream_capacity

    specs = fcfg.bucket_specs()
    cadence = cfg.cadence()
    evict_dir = fcfg.evict_dir or tempfile.mkdtemp(prefix="fleet_evict_")
    bf = BucketedFleet(evict_dir, max_drain=fcfg.drain, device=dev)

    tenants: list[tuple[str, str]] = []   # (tenant id, bucket name)
    global_idx = 0
    for i, spec in enumerate(specs):
        g = resolve_graph(spec.graph, seed=cfg.stream.seed + i, device=dev)
        batch = spec.batch or cfg.stream.batch
        bucket_streams = []
        for _ in range(spec.tenants):
            kw = dict(cfg.stream_kwargs())
            kw["batch"] = batch
            kw["seed"] = cfg.stream.seed + global_idx
            bucket_streams.append(STREAMS[cfg.stream.stream](g, **kw))
            global_idx += 1
        capacity = max(stream_capacity(s) for s in bucket_streams)
        schema = FleetSchema(g.n_nodes, capacity, batch)
        name = (spec.graph if spec.graph not in bf.buckets
                else f"{spec.graph}#{i}")
        bucket = bf.add_bucket(schema, min(spec.slots, spec.tenants),
                               cadence=cadence, name=name)
        steps_b = min(cfg.stream.steps,
                      min(len(s.batches) for s in bucket_streams))
        for j, s in enumerate(bucket_streams):
            tid = f"{name}.{j}"
            # The initially-live edges ride as a seed forest installed on
            # first admission, so queues hold only the update stream.
            bf.route(tid, schema, seed=init_state(s, capacity, device=dev))
            for unit in s.batches[:steps_b]:
                bf.offer(tid, unit)
            tenants.append((tid, name))
        print(f"bucket {name}: schema {schema.key} "
              f"(slot_cost {schema.slot_cost} rows/slot), "
              f"{spec.tenants} tenants in "
              f"{bucket.manager.fleet.n_slots} slots, "
              f"{steps_b} units/tenant, stream {cfg.stream.stream}")

    payload_reads = cfg.read.read_ratio > 0
    rng = np.random.default_rng(cfg.stream.seed + 104729)
    read_debt = {tid: 0.0 for tid, _ in tenants}
    query_lat: dict[str, list] = {tid: [] for tid, _ in tenants}
    r = cfg.read.read_ratio

    def snapshot_metrics() -> obs.MetricsRegistry:
        m = obs.MetricsRegistry()
        m.gauge("buckets").set(len(bf.buckets))
        for bname, b in bf.buckets.items():
            mgr = b.manager
            m.gauge("slots", bucket=bname).set(mgr.fleet.n_slots)
            m.gauge("tenants", bucket=bname).set(len(b.tenants))
            m.counter("fleet_syncs", bucket=bname).inc(
                b.sync_apply + b.sync_refresh)
            m.counter("blocks", bucket=bname).inc(b.blocks)
            m.counter("padded_slot_events", bucket=bname).inc(
                b.padded_events)
            m.counter("padded_rows", bucket=bname).inc(b.padded_rows)
            m.counter("admissions", bucket=bname).inc(mgr.admissions)
            m.counter("evictions", bucket=bname).inc(mgr.evictions)
            m.counter("restores", bucket=bname).inc(mgr.restores)
            m.counter("prefetches", bucket=bname).inc(mgr.prefetches)
        for tid, bname in tenants:
            b = bf.buckets[bname]
            m.counter("applied_events", tenant=tid,
                      bucket=bname).inc(b.applied[tid])
            for s in query_lat[tid]:
                m.histogram("query_latency_ms", tenant=tid,
                            bucket=bname).observe(s * 1e3)
        return m

    tracer = obs.Tracer() if cfg.obs.trace_out else None
    t_loop = time.perf_counter()
    tick = 0
    with tracer if tracer is not None else contextlib.nullcontext():
        while bf.pending():
            served = bf.step(tick)
            if payload_reads:
                for tid in served:
                    b = bf.bucket_of(tid)
                    slot = b.manager.slot_of.get(tid)
                    if b.session is None or slot is None:
                        continue
                    n_b = b.schema.n_nodes
                    read_debt[tid] += (r / (1.0 - r) * b.schema.batch
                                       / cfg.read.read_batch)
                    while read_debt[tid] >= 1.0:
                        read_debt[tid] -= 1.0
                        u = rng.integers(0, n_b, cfg.read.read_batch)
                        v = rng.integers(0, n_b, cfg.read.read_batch)
                        t0 = time.perf_counter()
                        try:
                            with obs.span("query_batch", step=tick,
                                          tenant=tid, bucket=b.name):
                                out = (b.session.lca(
                                    b.manager.fleet, slot, u, v)
                                    if tick % 2 else b.session.connected(
                                        b.manager.fleet, slot, u, v))
                                _wait(out)
                        except StaleQueryError:
                            continue
                        query_lat[tid].append(time.perf_counter() - t0)
            if (cfg.obs.metrics_out and cfg.obs.metrics_every
                    and (tick + 1) % cfg.obs.metrics_every == 0):
                snapshot_metrics().write(cfg.obs.metrics_out)
            tick += 1
    bf.finalize()
    elapsed = time.perf_counter() - t_loop

    total_applied = bf.applied_events()
    print(f"\nfleet: {total_applied} applied events across "
          f"{len(tenants)} tenants / {len(bf.buckets)} buckets in "
          f"{tick} steps / {elapsed:.2f} s "
          f"({total_applied / max(elapsed, 1e-9):,.0f} events/sec "
          f"aggregate)")
    for bname, b in bf.buckets.items():
        mgr = b.manager
        print(f"bucket {bname}: {sum(b.applied.values()):6d} applied in "
              f"{b.ticks} ticks / {b.blocks} blocks; "
              f"sync apply={b.sync_apply} refresh={b.sync_refresh}; "
              f"padded slot-events={b.padded_events} "
              f"rows={b.padded_rows}; "
              f"admissions={mgr.admissions} evictions={mgr.evictions} "
              f"restores={mgr.restores} prefetches={mgr.prefetches}; "
              f"max backlog={b.max_backlog}")
    print(f"sync accounting: total={bf.sync_total()} convergence checks "
          f"(Σ buckets, each max-over-own-lanes+1); "
          f"per applied event "
          f"{bf.sync_total() / max(total_applied, 1):.4f}; "
          f"padded slot-work {bf.padded_rows()} int32-rows")
    print("\nper-tenant:")
    for tid, bname in tenants:
        b = bf.buckets[bname]
        line = f"  {tid}: {b.applied[tid]:6d} applied"
        if payload_reads:
            line += f"  query {obs.percentile_line(query_lat[tid])}"
        print(line)
    if payload_reads:
        for bname, b in bf.buckets.items():
            if b.session is None:
                continue
            s = b.session.sync_stats()
            print(f"query sync accounting [{bname}]: {s['builds']} "
                  f"table builds, {s['build_syncs_total']} build syncs, "
                  f"stale_served={s['stale_served']}, "
                  f"auto_refreshes={s['auto_refreshes']}")

    if tracer is not None:
        tracer.write_jsonl(cfg.obs.trace_out)
        tracer.write_chrome(cfg.obs.trace_out + ".chrome.json")
        print(f"\ntrace: {len(tracer.records)} records -> "
              f"{cfg.obs.trace_out} (+ .chrome.json); "
              f"ledger sync_total={tracer.ledger.total()}")
    if cfg.obs.metrics_out:
        snapshot_metrics().write(cfg.obs.metrics_out)
        print(f"metrics -> {cfg.obs.metrics_out}")

    if cfg.validate:
        ok = True
        for tid, _ in tenants:
            same = _validate(bf.tenant_forest(tid), dev)
            ok = ok and same
            print(f"validate {tid}: partition==from-scratch: {same}")
        if not ok:
            bf.close()
            raise SystemExit("validate: FAILED")
    bf.close()


if __name__ == "__main__":
    main()
