"""The port's shape-bucketed sub-fleets against ``repro.dynamic.fleet``.

Mirrors the reference's bucket tests: routing bit-equality against
independent single-tenant loops, the single-bucket anchor (one bucket is
the flat fleet loop), async-admission adoption at the tick boundary,
idle-LRU eviction, stable-label telemetry across rotation, dispatcher
carryover, schema-stamped checkpoints and the ``--buckets`` surface. Also
held against the reference on the same streams: a two-bucket run's tenant
forests, numberings, BCC labels, counters and query telemetry, the
bucketed ``serve_fleet`` report, and the 2 ``table9_buckets`` smoke rows'
counts from ``BENCH_rst.json``.
Tolerance: bit-equal (every output is int32 or bool, every count an int).
"""
import concurrent.futures
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro.data import graphs as jax_graphs
from repro.data import streams as jax_streams
from repro.dynamic import fleet as jf
from repro.dynamic import replay as jreplay
from repro.dynamic.view import CadencePolicy as JaxCadence
from repro_torch import dynamic as td
from repro_torch import obs
from repro_torch.core import Graph
from repro_torch.core import queries as q
from repro_torch.data import graphs, streams
from repro_torch.data.graphs import resolve_graph
from repro_torch.data.streams import StreamBatch
from repro_torch.dynamic import fleet as tf
from repro_torch.dynamic.view import CadencePolicy
from repro_torch.launch.config import BucketSpec, FleetConfig
from test_torch_fleet import _report_lines, bench_rows

FOREST = ("parent", "rep", "pool_src", "pool_dst", "pool_valid", "tree_mask")
TOUR = ("pre", "size", "last", "comp", "parent")
BCC_FIELDS = ("parent", "pool_src", "pool_dst", "pool_valid", "tree_mask",
              "pre", "rep", "low", "high", "articulation", "bridge",
              "edge_bcc", "n_bcc", "aux_rounds", "seg_syncs", "dirty_count")


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _group(graph, tenants, kind, batch, n_units=3, seed0=0):
    kw = {"batch": batch}
    if kind == "sliding_window":
        kw["window"] = 2
    if kind == "churn":
        kw["n_batches"] = n_units
    ss = [streams.STREAMS[kind](graph, **{**kw, "seed": seed0 + t})
          for t in range(tenants)]
    units = min(n_units, min(len(s.batches) for s in ss))
    capacity = max(td.stream_capacity(s) for s in ss)
    return ss, units, tf.FleetSchema(graph.n_nodes, capacity, batch)


def _oracle(stream, capacity, units):
    state = td.init_state(stream, capacity, device="cpu")
    for i in range(units):
        state, _ = td.replay_batch(state, stream.batches[i])
    return state


def _assert_forest(got, want, fields=FOREST, tag=""):
    for f in fields:
        np.testing.assert_array_equal(_np(getattr(got, f)),
                                      _np(getattr(want, f)),
                                      err_msg=f"{tag}: {f}")


def _two_buckets(pkg, mk_graph, kind, tmp, device_kw):
    """The reference test's two-bucket run: grid2d(4) × 3 tenants in 2
    slots (rotation), chain(32) × 2 in 2 slots with full BCC and a strict
    query session. Returns (bf, groups)."""
    cad = JaxCadence if pkg is jf else CadencePolicy
    ga, gb = mk_graph("grid", 4), mk_graph("chain", 32)
    out = []
    bf = pkg.BucketedFleet(tmp, **device_kw)
    for name, g, tenants, batch, seed0, slots, cadence in (
            ("a", ga, 3, 8, 0, 2, cad(tour="incremental", every=2)),
            ("b", gb, 2, 16, 7, 2, cad(tour="incremental", bcc="full",
                                       every=2, queries=True,
                                       staleness="strict"))):
        mod = jax_streams if pkg is jf else streams
        kw = {"batch": batch}
        if kind == "sliding_window":
            kw["window"] = 2
        if kind == "churn":
            kw["n_batches"] = 3
        ss = [mod.STREAMS[kind](g, **{**kw, "seed": seed0 + t})
              for t in range(tenants)]
        units = min(3, min(len(s.batches) for s in ss))
        cap_fn = (jreplay.stream_capacity if pkg is jf
                  else td.stream_capacity)
        capacity = max(cap_fn(s) for s in ss)
        schema = pkg.FleetSchema(g.n_nodes, capacity, batch)
        bf.add_bucket(schema, slots, name=name, cadence=cadence)
        for j, s in enumerate(ss):
            seed = (jreplay.init_state(s, capacity=capacity) if pkg is jf
                    else td.init_state(s, capacity, device="cpu"))
            bf.route(f"{name}{j}", schema, seed=seed)
            for unit in s.batches[:units]:
                bf.offer(f"{name}{j}", unit)
        out.append((name, ss, units, schema))
    bf.run()
    bf.finalize()
    return bf, out


@functools.cache
def _jgraph(kind, size):
    return (jax_graphs.grid2d(size) if kind == "grid"
            else jax_graphs.chain(size))


def _tgraph(kind, size):
    jg = _jgraph(kind, size)
    return Graph.from_reference_arrays(jg.n_nodes, np.asarray(jg.src),
                                       np.asarray(jg.dst), device="cpu")


@functools.cache
def _reference_buckets(kind, tmp):
    bf, groups = _two_buckets(jf, _jgraph, kind, tmp, {})
    forests = {}
    for name, ss, _, _ in groups:
        for j in range(len(ss)):
            f = bf.tenant_forest(f"{name}{j}")
            forests[f"{name}{j}"] = {k: np.asarray(getattr(f, k))
                                     for k in FOREST + ("dirty", "version")}
    counters = {b.name: (b.sync_apply, b.sync_refresh, b.blocks, b.ticks,
                         b.padded_events, b.padded_rows,
                         b.manager.evictions, b.manager.restores,
                         b.manager.prefetches, b.manager.admissions)
                for b in bf.buckets.values()}
    bb = bf.buckets["b"]
    caches = {"tn": {k: np.asarray(getattr(bb.tn, k)) for k in TOUR},
              "bcc": {k: np.asarray(getattr(bb.bcc, k)) for k in BCC_FIELDS},
              "slots": dict(bb.manager.slot_of),
              "stats": {t: bb.session.sync_stats(t) for t in ("b0", "b1")}}
    bf.close()
    return forests, counters, caches


@pytest.mark.parametrize("kind", ["churn", "sliding_window"])
def test_bucketed_matches_reference(kind, tmp_path_factory):
    """Two buckets (one rotating through checkpoints): every tenant's
    forest, every bucket's counters, the stable bucket's numbering, BCC
    and query telemetry equal the reference's on the same streams."""
    forests, counters, caches = _reference_buckets(
        kind, str(tmp_path_factory.mktemp("ref")))
    bf, groups = _two_buckets(tf, _tgraph, kind,
                              tmp_path_factory.mktemp("port"),
                              {"device": "cpu"})
    for tid, want in forests.items():
        got = bf.tenant_forest(tid)
        for k, v in want.items():
            np.testing.assert_array_equal(_np(getattr(got, k)), v,
                                          err_msg=f"{tid}: {k}")
    assert {b.name: (b.sync_apply, b.sync_refresh, b.blocks, b.ticks,
                     b.padded_events, b.padded_rows, b.manager.evictions,
                     b.manager.restores, b.manager.prefetches,
                     b.manager.admissions)
            for b in bf.buckets.values()} == counters
    bb = bf.buckets["b"]
    assert dict(bb.manager.slot_of) == caches["slots"]
    for k in TOUR:
        np.testing.assert_array_equal(_np(getattr(bb.tn, k)),
                                      caches["tn"][k], k)
    for k in BCC_FIELDS:
        np.testing.assert_array_equal(_np(getattr(bb.bcc, k)),
                                      caches["bcc"][k], k)
    assert {t: bb.session.sync_stats(t) for t in ("b0", "b1")} == \
        caches["stats"]
    assert bf.buckets["a"].manager.evictions > 0
    bf.close()


@pytest.mark.parametrize("kind", sorted(streams.STREAMS))
def test_bucketed_matches_independent_loops(kind, tmp_path):
    """Tenants across 2 shape buckets end bit-identical (forests, and on
    the stable bucket tours, BCC labels and query answers) to the port's
    own single-tenant loops."""
    bf, groups = _two_buckets(tf, _tgraph, kind, tmp_path,
                              {"device": "cpu"})
    for name, ss, units, schema in groups:
        for j, s in enumerate(ss):
            want = _oracle(s, schema.capacity, units)
            _assert_forest(bf.tenant_forest(f"{name}{j}"), want,
                           tag=f"{kind}/{name}{j}")
    assert bf.buckets["a"].manager.evictions > 0
    bb = bf.buckets["b"]
    _, ss, units, schema = groups[1]
    for j, s in enumerate(ss):
        tid = f"b{j}"
        slot = bb.manager.slot_of[tid]
        state = _oracle(s, schema.capacity, units)
        tn, state = td.refresh_tour(state, None)
        bcc = td.refresh_bcc(state, tour=tn, incremental=False)
        for f in TOUR:
            assert torch.equal(getattr(bb.tn, f)[slot], getattr(tn, f))
        for f in BCC_FIELDS:
            np.testing.assert_array_equal(_np(getattr(bb.bcc, f))[slot],
                                          _np(getattr(bcc, f)), f)
        tab = q.build_tables(tn)
        rng = np.random.default_rng(11 * (j + 1))
        u = torch.from_numpy(rng.integers(0, 32, 32).astype(np.int32))
        v = torch.from_numpy(rng.integers(0, 32, 32).astype(np.int32))
        fleet = bb.manager.fleet
        assert torch.equal(bb.session.connected(fleet, slot, u, v),
                           q.connected(tab, u, v))
        assert torch.equal(bb.session.lca(fleet, slot, u, v),
                           q.lca(tab, u, v))
        assert bb.session.sync_stats(tid)["builds"] >= 1
    bf.close()


def test_single_bucket_matches_flat_fleet(tmp_path):
    """One bucket with slots == tenants is the flat fleet loop bit for bit:
    forests, numbering and the per-tick sync bill."""
    g = graphs.grid2d(8, device="cpu")
    ss, units, schema = _group(g, 3, "churn", batch=16, n_units=4)
    cadence = CadencePolicy(tour="incremental", every=2)
    fleet = tf.fleet_empty(3, g.n_nodes, schema.capacity, device="cpu")
    for t, s in enumerate(ss):
        fleet.set_tenant(t, td.init_state(s, schema.capacity,
                                          device="cpu"))
    tn, sync = None, 0
    for i in range(units):
        block = tuple(np.stack([getattr(s.batches[i], f) for s in ss])
                      for f in ("ins_u", "ins_v", "del_u", "del_v"))
        fleet, stats = tf.apply_batches(fleet, *block)
        sync += tf.fleet_sync_cost(stats)
        if cadence.due(i):
            tn, fleet = tf.refresh_tours(fleet, tn,
                                         incremental=(tn is not None))
    tn, fleet = tf.refresh_tours(fleet, tn, incremental=True)

    bf = tf.BucketedFleet(tmp_path, device="cpu")
    b = bf.add_bucket(schema, 3, cadence=cadence, name="only")
    for t, s in enumerate(ss):
        bf.route(t, schema, seed=td.init_state(s, schema.capacity,
                                               device="cpu"))
        for unit in s.batches[:units]:
            bf.offer(t, unit)
    bf.run()
    b.refresh()
    assert b.sync_apply == sync
    for t in range(3):
        slot = b.manager.slot_of[t]
        _assert_forest(b.manager.fleet.tenant(slot), fleet.tenant(t),
                       fields=FOREST + ("dirty", "version"), tag=f"t{t}")
        for f in TOUR:
            assert torch.equal(getattr(b.tn, f)[slot], getattr(tn, f)[t])
    bf.close()


def _mgr(tmp_path, slots=1, **kw):
    return tf.FleetManager(tf.fleet_empty(slots, 16, 8, device="cpu"),
                           tmp_path, **kw)


def test_prefetch_adopts_only_at_boundary(tmp_path):
    mgr = _mgr(tmp_path, schema=tf.FleetSchema(16, 8, 4))
    mgr.ensure("a")
    mgr.evict("a")
    mgr.ensure("b")
    assert mgr.prefetch("a") is True
    assert mgr._prefetch["a"].done()        # restore finished "mid-tick"
    assert "a" not in mgr.slot_of           # ...but not visible yet
    assert mgr.prefetching("a")
    assert mgr.prefetch("a") is True        # idempotent while in flight
    # The worker restores into host tensors; adoption copies to the fleet.
    forest, _ = mgr._prefetch["a"].result()
    assert forest.parent.device.type == "cpu"
    assert mgr.adopt_ready() == ["a"]
    assert mgr.slot_of["a"] == 0 and "b" not in mgr.slot_of
    assert mgr.restores == 1 and mgr.prefetches == 1


def test_prefetch_threaded_restore_and_unfinished_future(tmp_path):
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        mgr = _mgr(tmp_path, slots=2, executor=ex)
        mgr.ensure("a")
        mgr.evict("a")
        mgr.prefetch("a")
        mgr._prefetch["a"].result()
        assert "a" not in mgr.slot_of
        mgr._prefetch["slow"] = concurrent.futures.Future()
        assert mgr.adopt_ready() == ["a"]
        assert mgr.prefetching("slow")
        del mgr._prefetch["slow"]
    assert mgr.prefetch("a") is False


def test_ensure_joins_inflight_prefetch(tmp_path):
    mgr = _mgr(tmp_path)
    mgr.ensure("a")
    mgr.evict("a")
    mgr.prefetch("a")
    assert mgr.ensure("a") == 0 and not mgr.prefetching("a")
    assert mgr.restores == 1


def test_pick_victim_prefers_idle_over_lru(tmp_path):
    mgr = _mgr(tmp_path, slots=3)
    for t in ("a", "b", "c"):
        mgr.ensure(t)
    mgr.touch("b")
    mgr.touch("c")
    busy = {"a": True, "b": False, "c": True}
    assert mgr.pick_victim() == "a"
    assert mgr.pick_victim(busy=lambda t: busy[t]) == "b"
    assert mgr.pick_victim(busy=lambda t: True) == "a"
    assert mgr.has_room(busy=lambda t: busy[t])
    assert not mgr.has_room(busy=lambda t: True)
    mgr.ensure("d", busy=lambda t: busy.get(t, False))
    assert set(mgr.slot_of) == {"a", "c", "d"}


def test_bucket_rotation_never_evicts_busy_when_idle_exists(tmp_path):
    g = graphs.grid2d(4, device="cpu")
    ss, units, schema = _group(g, 4, "churn", batch=8, n_units=2)
    bf = tf.BucketedFleet(tmp_path, device="cpu")
    b = bf.add_bucket(schema, 2, name="only")
    for t, s in enumerate(ss):
        bf.route(t, schema, seed=td.init_state(s, schema.capacity,
                                               device="cpu"))
        for unit in s.batches[:units]:
            bf.offer(t, unit)
    bf.run()
    assert b.manager.evictions > 0 and b.manager.restores == 0
    bf.close()


def _two_lane_fleet(labels=None, policy="stale"):
    g = graphs.grid2d(4, device="cpu")
    ss, _, schema = _group(g, 2, "churn", batch=8, n_units=3)
    fleet = tf.fleet_empty(2, g.n_nodes, schema.capacity, device="cpu")
    for t, s in enumerate(ss):
        fleet.set_tenant(t, td.init_state(s, schema.capacity,
                                          device="cpu"))
    sess = tf.FleetQuerySession.from_fleet(fleet, policy=policy,
                                           labels=labels)
    block = tuple(np.stack([getattr(s.batches[0], f) for s in ss])
                  for f in ("ins_u", "ins_v", "del_u", "del_v"))
    return fleet, sess, block


def test_session_labels_survive_rotation():
    fleet, sess, block = _two_lane_fleet(labels=["a", "b"])
    assert sess.sync_stats("a")["builds"] == 1
    fleet, _ = tf.apply_batches(fleet, *block)
    u = np.arange(4, dtype=np.int32)
    sess.connected(fleet, 0, u, u)
    assert sess.sync_stats("a")["stale_served"] == 1
    assert sess.sync_stats("b")["stale_served"] == 0
    sess.set_label(0, "c")
    sess.rebuild_tenant(fleet, 0)
    c = sess.sync_stats("c")
    assert c == {"builds": 1, "build_syncs_total": c["build_syncs_total"],
                 "stale_served": 0, "auto_refreshes": 0}
    assert sess.sync_stats("a")["stale_served"] == 1
    sess.set_label(1, "a")
    sess.rebuild_tenant(fleet, 1)
    assert sess.sync_stats("a")["stale_served"] == 1
    assert sess.sync_stats("a")["builds"] == 2
    assert sess.sync_stats()["builds"] == \
        sum(sess.sync_stats(t)["builds"] for t in ("a", "b", "c"))


def test_session_default_labels_keep_slot_indexing():
    fleet, sess, _ = _two_lane_fleet()
    assert sess.labels == [0, 1]
    assert sess.sync_stats(0)["builds"] == 1
    with pytest.raises(ValueError, match="labels"):
        tf.FleetQuerySession.from_fleet(fleet, labels=["only-one"])


def test_dispatcher_drain_carryover_fifo_and_backlog():
    n, width = 16, 4
    d = tf.FleetDispatcher(n, width, device="cpu")

    def mk(lo):
        return StreamBatch(
            ins_u=np.arange(lo, lo + width, dtype=np.int32) % n,
            ins_v=(np.arange(lo, lo + width, dtype=np.int32) + 1) % n,
            del_u=np.full(width, n, np.int32),
            del_v=np.full(width, n, np.int32))

    units_a = [mk(0), mk(4), mk(8)]
    for u in units_a:
        d.offer("a", u)
    d.offer("b", mk(12))
    blocks = d.drain(["a", "b"], max_blocks=2)
    assert len(blocks) == 2
    (iu0, _, _, _), served0 = blocks[0]
    (iu1, _, _, _), served1 = blocks[1]
    assert set(served0) == {"a", "b"}
    np.testing.assert_array_equal(iu0[0].numpy(), units_a[0].ins_u)
    assert set(served1) == {"a"}
    np.testing.assert_array_equal(iu1[0].numpy(), units_a[1].ins_u)
    assert bool((iu1[1] == n).all())
    assert d.backlog() == {"a": 1}
    assert len(d.drain(["a", "b"], max_blocks=5)) == 1
    assert d.backlog() == {}


def test_checkpoint_schema_mismatch_rejected(tmp_path):
    s1 = tf.FleetSchema(16, 8, 4)
    s2 = tf.FleetSchema(16, 8, 8)
    m1 = _mgr(tmp_path, schema=s1)
    m1.ensure("x")
    m1.evict("x")
    with pytest.raises(ValueError, match="cannot be admitted"):
        _mgr(tmp_path, schema=s2).ensure("x")
    m3 = _mgr(tmp_path, schema=s1)
    m3.ensure("x")
    assert m3.restores == 1
    m4 = _mgr(tmp_path)
    m4.ensure("x")
    assert m4.restores == 1


def test_bucketed_routing_contracts(tmp_path):
    bf = tf.BucketedFleet(tmp_path, device="cpu")
    s1, s2 = tf.FleetSchema(16, 8, 4), tf.FleetSchema(32, 8, 4)
    bf.add_bucket(s1, 1, name="small")
    with pytest.raises(ValueError, match="already exists"):
        bf.add_bucket(s1, 1, name="small")
    with pytest.raises(KeyError, match="no bucket"):
        bf.route("t", s2)
    bf.add_bucket(s2, 1, name="big")
    assert bf.route("t", s2).name == "big"
    assert bf.route("t", s2).name == "big"
    with pytest.raises(ValueError, match="cannot re-route"):
        bf.route("t", s1)
    with pytest.raises(ValueError, match="does not fit"):
        bf.buckets["small"].route("u", seed=td.forest_empty(
            32, 8, device="cpu"))
    with pytest.raises(KeyError, match="not routed"):
        bf.buckets["small"].offer("ghost", StreamBatch(
            *(np.full(4, 16, np.int32) for _ in range(4))))
    bf.close()


def test_fleet_schema_contract():
    s = tf.FleetSchema(64, 40, 8)
    assert s.key == "n64_c40_b8"
    assert s.slot_cost == 3 * 64 + 4 * 40
    assert tf.FleetSchema.from_dict(s.to_dict()) == s
    assert s.to_dict() == jf.FleetSchema(64, 40, 8).to_dict()


def test_bucket_specs_parse_and_flags_bind():
    import argparse
    fcfg = FleetConfig(buckets="chain_64:12,rmat_9:2:2:32, grid_8:3:1 ")
    assert fcfg.bucket_specs() == (
        BucketSpec("chain_64", 12, 12, None),
        BucketSpec("rmat_9", 2, 2, 32),
        BucketSpec("grid_8", 3, 1, None))
    for bad in ("chain_64", "chain_64:0", "g:1:2:3:4", "g:x",
                "chain_64:2:0"):
        with pytest.raises(ValueError):
            FleetConfig(buckets=bad).bucket_specs()
    with pytest.raises(ValueError, match="--drain"):
        FleetConfig(drain=0).check()
    ap = argparse.ArgumentParser()
    FleetConfig.add_args(ap)
    fcfg = FleetConfig.from_args(ap.parse_args(
        ["--buckets", "chain_16:4:2", "--drain", "3"]))
    assert fcfg.buckets == "chain_16:4:2" and fcfg.drain == 3


def test_resolve_graph_patterns():
    assert resolve_graph("chain_32", device="cpu").n_nodes == 32
    assert resolve_graph("grid_6", device="cpu").n_nodes == 36
    assert resolve_graph("rmat_5", device="cpu").n_nodes == 32
    for bad in ("mystery_7", "chain_x", "chain"):
        with pytest.raises(ValueError, match="unknown graph"):
            resolve_graph(bad, device="cpu")


def test_serve_fleet_bucketed_matches_reference(tmp_path, capsys):
    argv = ["--buckets", "chain_16:3:2,grid_4:2:2:16", "--stream", "churn",
            "--batch", "8", "--steps", "3", "--drain", "2",
            "--tour-every", "2", "--validate"]
    from repro.launch import serve_fleet as jsf
    from repro_torch.launch import serve_fleet
    jsf.main(argv + ["--evict-dir", str(tmp_path / "j")])
    want = _report_lines(capsys.readouterr().out)
    serve_fleet.main(argv + ["--evict-dir", str(tmp_path / "t")],
                     device="cpu")
    out = capsys.readouterr().out
    assert _report_lines(out) == want
    assert "bucket chain_16" in out and "bucket grid_4" in out
    assert "sync accounting: total=" in out
    assert out.count("partition==from-scratch: True") == 5
    assert "Traceback" not in out


# ---- the table9 smoke rows -----------------------------------------------

T9_SMOKE_MIX = (("chain_64", 8, 4, 8, 6), ("rmat_8", 2, 2, 32, 3))
T9_CADENCE = CadencePolicy(tour="full", bcc="off", every=2, queries=False)


def table9_groups(mix=T9_SMOKE_MIX, device="cpu"):
    groups, seed = [], 0
    for graph, tenants, slots, batch, units in mix:
        g = resolve_graph(graph, device=device)
        ss = []
        for _ in range(tenants):
            ss.append(streams.STREAMS["churn"](g, batch=batch,
                                               n_batches=units, seed=seed))
            seed += 1
        units = min(units, min(len(s.batches) for s in ss))
        capacity = max(td.stream_capacity(s) for s in ss)
        groups.append({"name": graph, "streams": ss, "units": units,
                       "slots": min(slots, tenants),
                       "schema": tf.FleetSchema(g.n_nodes, capacity,
                                                batch)})
    return groups


def _pad_unit(unit, n_small, schema):
    """A narrow tenant's unit at the wide schema's width, its sentinel
    remapped to the wide n (the benchmark's procedure)."""
    def pad(a):
        out = np.full(schema.batch, schema.n_nodes, np.int32)
        out[:a.shape[0]] = np.where(a == n_small, schema.n_nodes, a)
        return out
    return StreamBatch(ins_u=pad(unit.ins_u), ins_v=pad(unit.ins_v),
                       del_u=pad(unit.del_u), del_v=pad(unit.del_v))


def _wide_seed(stream, schema, device):
    state = td.forest_empty(schema.n_nodes, schema.capacity, device=device)
    if stream.init_u.shape[0]:
        state, _ = td.apply_batch(
            state, torch.from_numpy(stream.init_u).to(device),
            torch.from_numpy(stream.init_v).to(device),
            torch.zeros(schema.capacity, dtype=torch.bool, device=device))
    return state


def table9_counts(groups, tmp, device="cpu", use_kernel=None) -> dict:
    """Both sides of the table9 comparison by the benchmark's procedure:
    {side: (sync_total, padded_rows, applied events, BucketedFleet)}."""
    bucketed = tf.BucketedFleet(tmp / "bucketed", device=device,
                                use_kernel=use_kernel)
    for grp in groups:
        bucketed.add_bucket(grp["schema"], grp["slots"], cadence=T9_CADENCE,
                            name=grp["name"])
        for j, s in enumerate(grp["streams"]):
            tid = f"{grp['name']}.{j}"
            bucketed.route(tid, grp["schema"], seed=td.init_state(
                s, grp["schema"].capacity, device=device,
                use_kernel=use_kernel))
            for unit in s.batches[:grp["units"]]:
                bucketed.offer(tid, unit)
    with obs.SyncLedger() as led:
        bucketed.run()
        bucketed.finalize()
    assert led.total("fleet_apply") == sum(
        b.sync_apply for b in bucketed.buckets.values())
    assert led.by_bucket("fleet_apply") == {
        b.name: b.sync_apply for b in bucketed.buckets.values()
        if b.sync_apply}

    wide = tf.FleetSchema(
        n_nodes=max(g["schema"].n_nodes for g in groups),
        capacity=max(g["schema"].capacity for g in groups),
        batch=max(g["schema"].batch for g in groups))
    total = sum(len(g["streams"]) for g in groups)
    budget = sum(g["slots"] * g["schema"].slot_cost for g in groups)
    single = tf.BucketedFleet(tmp / "single", device=device,
                              use_kernel=use_kernel)
    single.add_bucket(wide, min(total, max(1, budget // wide.slot_cost)),
                      cadence=T9_CADENCE, name="single")
    for grp in groups:
        for j, s in enumerate(grp["streams"]):
            tid = f"{grp['name']}.{j}"
            single.route(tid, wide, seed=_wide_seed(s, wide, device))
            for unit in s.batches[:grp["units"]]:
                single.offer(tid, _pad_unit(unit, grp["schema"].n_nodes,
                                            wide))
    single.run()
    single.finalize()
    return {side: (bf.sync_total(), bf.padded_rows(), bf.applied_events(),
                   bf)
            for side, bf in (("bucketed", bucketed),
                             ("single_schema", single))}


def test_table9_smoke_rows(tmp_path):
    """The pinned rows: bucketed sync_total 62 and padded_rows 31,800
    against the single schema's 101 and 149,688, every tenant on both
    sides bit-equal to its own replay."""
    groups = table9_groups()
    got = table9_counts(groups, tmp_path)
    rows = bench_rows("table9_buckets/")
    mix = "+".join(f"{len(g['streams'])}x{g['name']}" for g in groups)
    for side in ("bucketed", "single_schema"):
        want = rows[f"table9_buckets/{mix}/T10/{side}"]
        assert (str(got[side][0]), str(got[side][1])) == \
            (want["sync_total"], want["padded_rows"]), side
    assert got["bucketed"][2] == got["single_schema"][2]
    bucketed, single = got["bucketed"][3], got["single_schema"][3]
    for grp in groups:
        n = grp["schema"].n_nodes
        for j, s in enumerate(grp["streams"]):
            tid = f"{grp['name']}.{j}"
            oracle = _oracle(s, grp["schema"].capacity, grp["units"])
            _assert_forest(bucketed.tenant_forest(tid), oracle,
                           fields=("parent", "rep", "pool_valid",
                                   "tree_mask"), tag=tid)
            wide = single.tenant_forest(tid)
            for f in ("parent", "rep"):
                assert torch.equal(getattr(wide, f)[:n],
                                   getattr(oracle, f)), (tid, f)
    bucketed.close()
    single.close()


def test_bucket_refresh_after_rotation_is_full(tmp_path):
    """A residency change forces the next refresh to be full: a rotated
    lane's numbering then equals a from-scratch numbering of its tenant."""
    g = graphs.grid2d(4, device="cpu")
    ss, units, schema = _group(g, 3, "churn", batch=8, n_units=3)
    bf = tf.BucketedFleet(tmp_path, device="cpu")
    b = bf.add_bucket(schema, 2, name="rot",
                      cadence=CadencePolicy(tour="incremental", every=1))
    for t, s in enumerate(ss):
        bf.route(t, schema, seed=td.init_state(s, schema.capacity,
                                               device="cpu"))
        for unit in s.batches[:units]:
            bf.offer(t, unit)
    bf.run()
    b.refresh()
    assert b.manager.evictions > 0
    for tenant, slot in b.manager.slot_of.items():
        tn = td.refresh_tour(b.manager.fleet.tenant(slot), None)[0]
        one = tf.tenant_slice(b.tn, slot)
        for f in TOUR:
            assert torch.equal(getattr(one, f), getattr(tn, f))
    assert dataclasses.is_dataclass(one)
    bf.close()
