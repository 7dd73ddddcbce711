"""The port's multi-tenant fleet against ``repro.dynamic.fleet``, bit for bit.

Each stream is made by both packages from the same graph (carried over with
``Graph.from_reference_arrays``) and seed. The reference's fleet vmaps its
single-tenant loops; the port runs one disjoint union of the lanes. After
every tick every stacked ``ForestFleet`` field, the versions and every
per-lane stat (``cuts``, ``links``, ``rounds``, ``overflow``, ``pending``,
``deletes_found``) must be equal, and so must every stacked field and
per-lane count of ``refresh_tours``, ``refresh_bccs`` (full, then
incremental) and ``build_fleet_tables``, and the ``obs`` ledger's totals
per phase, with one slot inactive. Also held: the fleet against the port's
own single-tenant loops, a cross-tenant event that must stay inert, one
lane's pool overflowing alone, eviction and re-admission, the dispatcher,
the manager and the per-tenant read policies, ``serve_fleet`` end to end
against the reference's report, and the 8 ``table8_fleet`` smoke rows'
counts from ``BENCH_rst.json``.
Tolerance: bit-equal (every output is int32 or bool, every count an int).
"""
import functools
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jax_obs
from repro.data import graphs as jax_graphs
from repro.data import streams as jax_streams
from repro.dynamic import fleet as jf
from repro.dynamic import forest as jforest
from repro.dynamic import replay as jreplay
from repro_torch import dynamic as td
from repro_torch import obs
from repro_torch.core import Graph
from repro_torch.core import queries as q
from repro_torch.data import graphs, streams
from repro_torch.data.streams import StreamBatch
from repro_torch.dynamic import fleet as tf

ROOT = pathlib.Path(__file__).resolve().parents[1]
STATE = ("parent", "rep", "pool_src", "pool_dst", "pool_valid", "tree_mask",
         "dirty")
STATS = ("cuts", "links", "rounds", "overflow", "pending", "deletes_found")
TOUR = ("pre", "size", "last", "comp", "parent")
BCC = ("parent", "pool_src", "pool_dst", "pool_valid", "tree_mask", "pre",
       "rep", "low", "high", "articulation", "bridge", "edge_bcc", "n_bcc",
       "aux_rounds", "seg_syncs", "dirty_count")
TABLES = ("pre", "last", "comp", "parent", "depth", "up", "build_syncs")
PHASES = ("fleet_apply", "fleet_refresh_tour", "fleet_refresh_bcc",
          "fleet_tables")
LANES = 4          # slots of the reference comparison; one stays empty
EMPTY = 2          # the inactive slot
TICKS = 4
CADENCE = 2


@functools.cache
def _graph(side: int):
    jg = jax_graphs.grid2d(side)
    return jg, Graph.from_reference_arrays(jg.n_nodes, np.asarray(jg.src),
                                           np.asarray(jg.dst), device="cpu")


def stream_kwargs(kind: str, batch: int, n_units: int = TICKS) -> dict:
    kw = {"batch": batch}
    if kind == "sliding_window":
        kw["window"] = 2
    if kind == "churn":
        kw["n_batches"] = n_units
    return kw


@functools.cache
def _streams(side: int, kind: str, batch: int, tenants: int = LANES - 1):
    jg, g = _graph(side)
    kw = stream_kwargs(kind, batch)
    return (tuple(jax_streams.STREAMS[kind](jg, **kw, seed=t)
                  for t in range(tenants)),
            tuple(streams.STREAMS[kind](g, **kw, seed=t)
                  for t in range(tenants)))


def lane_of(t: int) -> int:
    """The slot tenant t occupies (slot EMPTY stays inactive)."""
    return t if t < EMPTY else t + 1


def tick_block(ss, i: int, n: int, lanes: int = LANES) -> tuple:
    """The (T, B) block of tick i: tenant t's batch in slot ``lane_of(t)``,
    sentinel rows in the empty slot."""
    b = ss[0].batches[i].ins_u.shape[0]
    block = np.full((4, lanes, b), n, np.int32)
    for t, s in enumerate(ss):
        unit = s.batches[i]
        block[:, lane_of(t)] = (unit.ins_u, unit.ins_v, unit.del_u,
                                unit.del_v)
    return tuple(block)


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _fields(obj, names) -> dict:
    return {f: _np(getattr(obj, f)) for f in names}


def _run(pkg, ss, side, kind, capacity, incremental_bcc=True):
    """One fleet run: per tick the state, versions and stats; per refresh
    the numbering, BCC and tables; the ledger's totals."""
    jd_side = pkg is jf
    n = side * side
    if jd_side:
        fleet = jf.fleet_empty(LANES, n, capacity)
        for t, s in enumerate(ss):
            fleet = fleet.set_tenant(lane_of(t), jreplay.init_state(
                s, capacity=capacity))
        ledger = jax_obs.SyncLedger()
    else:
        fleet = tf.fleet_empty(LANES, n, capacity, device="cpu")
        for t, s in enumerate(ss):
            fleet.set_tenant(lane_of(t), td.init_state(s, capacity,
                                                       device="cpu"))
        ledger = obs.SyncLedger()
    ticks, refreshes = [], []
    tn = bcc = None
    with ledger:
        for i in range(TICKS):
            block = tick_block(ss, i, n)
            if jd_side:
                block = tuple(jnp.asarray(x) for x in block)
            fleet, stats = pkg.apply_batches(fleet, *block)
            ticks.append((_fields(fleet, STATE), _np(fleet.version),
                          _np(fleet.active),
                          {k: _np(stats[k]) for k in STATS},
                          pkg.fleet_sync_cost(stats)))
            if (i + 1) % CADENCE == 0:
                tn, fleet = pkg.refresh_tours(fleet, tn)
                bcc = pkg.refresh_bccs(fleet, bcc if incremental_bcc
                                       else None, tour=tn)
                tables = pkg.build_fleet_tables(tn)
                refreshes.append((_fields(tn, TOUR), _fields(bcc, BCC),
                                  _fields(tables, TABLES),
                                  _np(fleet.dirty)))
    return ticks, refreshes, {p: ledger.total(p) for p in PHASES}


@functools.cache
def _reference(side, kind, batch):
    js, _ = _streams(side, kind, batch)
    capacity = max(jreplay.stream_capacity(s) for s in js)
    return capacity, _run(jf, js, side, kind, capacity)


def _assert_dicts(want: dict, got: dict, what: str) -> None:
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k],
                                      err_msg=f"{what}: {k}")


@pytest.mark.parametrize("kind", ["churn", "sliding_window"])
def test_fleet_matches_reference(kind):
    """Every stacked field, version, per-lane stat, numbering, BCC (full,
    then incremental), table and ledger phase, tick by tick, with slot
    EMPTY inactive, against the reference's vmapped fleet."""
    capacity, (w_ticks, w_refr, w_led) = _reference(8, kind, 16)
    _, ts = _streams(8, kind, 16)
    g_ticks, g_refr, g_led = _run(tf, ts, 8, kind, capacity)
    for i, (want, got) in enumerate(zip(w_ticks, g_ticks)):
        _assert_dicts(want[0], got[0], f"tick {i} state")
        np.testing.assert_array_equal(got[1], want[1], f"tick {i} version")
        np.testing.assert_array_equal(got[2], want[2], f"tick {i} active")
        _assert_dicts(want[3], got[3], f"tick {i} stats")
        assert got[4] == want[4] == int(want[3]["rounds"].max()) + 1
    assert len(g_refr) == len(w_refr) == TICKS // CADENCE
    for r, (want, got) in enumerate(zip(w_refr, g_refr)):
        for j, what in enumerate(("tour", "bcc", "tables")):
            _assert_dicts(want[j], got[j], f"refresh {r} {what}")
        np.testing.assert_array_equal(got[3], want[3])
    assert g_led == w_led
    assert not g_ticks[-1][2][EMPTY]


@pytest.mark.parametrize("kind", sorted(streams.STREAMS))
def test_fleet_matches_own_single_tenant_loops(kind):
    """The port's fleet against T of its own single-tenant loops (replay,
    cadenced incremental tour refresh, incremental and full BCC, tables,
    query answers through the session), as the reference's
    ``test_fleet_replay_matches_independent_loops`` holds its own."""
    _, ts = _streams(8, kind, 16)
    capacity = max(td.stream_capacity(s) for s in ts)
    ticks, refr, _ = _run(tf, ts, 8, kind, capacity)
    _, refr_full, _ = _run(tf, ts, 8, kind, capacity, incremental_bcc=False)
    for t, s in enumerate(ts):
        lane = lane_of(t)
        state = td.init_state(s, capacity, device="cpu")
        tn = bcc = None
        r = 0
        sync_seq = 0
        for i in range(TICKS):
            state, stats = td.replay_batch(state, s.batches[i])
            sync_seq += stats["rounds"] + 1
            assert {k: int(stats[k]) for k in STATS} == \
                {k: int(ticks[i][3][k][lane]) for k in STATS}
            for f in STATE:
                np.testing.assert_array_equal(ticks[i][0][f][lane],
                                              _np(getattr(state, f)))
            assert ticks[i][1][lane] == state.version
            if (i + 1) % CADENCE == 0:
                tn, state = td.refresh_tour(state, tn)
                bcc = td.refresh_bcc(state, bcc, tour=tn)
                full = td.refresh_bcc(state, None, tour=tn)
                tab = q.build_tables(tn)
                for f in TOUR:
                    np.testing.assert_array_equal(refr[r][0][f][lane],
                                                  _np(getattr(tn, f)))
                for f in BCC:
                    np.testing.assert_array_equal(refr[r][1][f][lane],
                                                  _np(getattr(bcc, f)), f)
                    np.testing.assert_array_equal(refr_full[r][1][f][lane],
                                                  _np(getattr(full, f)), f)
                for f in TABLES:
                    np.testing.assert_array_equal(refr[r][2][f][lane],
                                                  _np(getattr(tab, f)), f)
                r += 1
    fleet_bill = sum(tk[4] for tk in ticks)
    assert fleet_bill == sum(int(tk[3]["rounds"].max()) + 1 for tk in ticks)
    assert fleet_bill < sum(int(tk[3]["rounds"].sum()) + LANES
                            for tk in ticks)


def _fleet_pair(n, capacity, states):
    """The same fleet in both packages from per-lane edge lists."""
    jfl = jf.fleet_empty(len(states), n, capacity)
    tfl = tf.fleet_empty(len(states), n, capacity, device="cpu")
    no_del_j = jnp.zeros((capacity,), jnp.bool_)
    for t, edges in enumerate(states):
        e = np.asarray(edges, np.int32).reshape(-1, 2)
        fj, _ = jforest.apply_batch(
            jforest.forest_empty(n, capacity), jnp.asarray(e[:, 0]),
            jnp.asarray(e[:, 1]), no_del_j)
        jfl = jfl.set_tenant(t, fj)
        ft = td.forest_empty(n, capacity, device="cpu")
        ft, _ = td.apply_batch(ft, torch.from_numpy(e[:, 0]),
                               torch.from_numpy(e[:, 1]),
                               torch.zeros(capacity, dtype=torch.bool))
        tfl.set_tenant(t, ft)
    return jfl, tfl


def _apply_both(jfl, tfl, block):
    jfl, jst = jf.apply_batches(jfl, *(jnp.asarray(np.asarray(x, np.int32))
                                       for x in block))
    tfl, tst = tf.apply_batches(tfl, *block)
    for f in STATE:
        np.testing.assert_array_equal(_np(getattr(tfl, f)),
                                      np.asarray(getattr(jfl, f)), f)
    for k in STATS:
        np.testing.assert_array_equal(_np(tst[k]), np.asarray(jst[k]), k)
    np.testing.assert_array_equal(tfl.version, np.asarray(jfl.version))
    return jfl, tfl, tst


def test_cross_tenant_events_stay_inert():
    """Tenant-local ids outside [0, n) map to the union sentinel before the
    offset: an insertion (0, n + 3) on lane 0 (in the union, lane 1's
    vertex 3) and (0, n) (lane 1's vertex 0), a deletion of the pair, and
    ids below 0 leave every lane as the reference leaves it."""
    n, cap = 8, 12
    chain = [(i, i + 1) for i in range(3)]
    jfl, tfl = _fleet_pair(n, cap, [chain, chain, []])
    block = np.full((4, 3, 4), n, np.int32)
    block[0, 0, :3] = (0, 0, -1)
    block[1, 0, :3] = (n + 3, n, 5)
    block[2, 0, 0], block[3, 0, 0] = 0, n + 3      # delete (0, n + 3)
    block[0, 1, 0], block[1, 1, 0] = 5, 6          # a real edge on lane 1
    before = _np(tfl.pool_valid[0]).copy(), _np(tfl.parent[0]).copy()
    jfl, tfl, st = _apply_both(jfl, tfl, tuple(block))
    np.testing.assert_array_equal(_np(tfl.pool_valid[0]), before[0])
    np.testing.assert_array_equal(_np(tfl.parent[0]), before[1])
    assert _np(st["links"]).tolist() == [0, 1, 0]
    assert _np(st["deletes_found"]).tolist() == [0, 0, 0]
    # Lane 1 holds no edge to any vertex of lane 0 or beyond its own n.
    live = _np(tfl.pool_valid[1])
    assert (_np(tfl.pool_src[1])[live] < n).all()
    assert (_np(tfl.pool_dst[1])[live] < n).all()


def test_per_lane_overflow_with_one_pool_full():
    """Lane 0's pool is full: its insertions overflow, counted on lane 0
    only, while lane 1 fills free slots of its own pool."""
    n, cap = 16, 6
    full = [(i, i + 1) for i in range(cap)]
    jfl, tfl = _fleet_pair(n, cap, [full, [(0, 1)]])
    block = np.full((4, 2, 4), n, np.int32)
    block[0, :, :3] = [(8, 9, 10), (2, 3, 4)]
    block[1, :, :3] = [(9, 10, 11), (3, 4, 5)]
    jfl, tfl, st = _apply_both(jfl, tfl, tuple(block))
    assert _np(st["overflow"]).tolist() == [3, 0]
    assert _np(tfl.pool_valid).sum(1).tolist() == [cap, 4]


def test_fleet_sync_cost_is_the_loop_count():
    """``fleet_sync_cost`` is the union loop's host count + 1, equal to
    max(rounds) + 1 and to the ledger's ``fleet_apply``; the loop reads
    the card once a round however many lanes there are."""
    _, ts = _streams(8, "churn", 16)
    capacity = max(td.stream_capacity(s) for s in ts)
    ticks, _, led = _run(tf, ts, 8, "churn", capacity)
    bills = [tk[4] for tk in ticks]
    assert bills == [int(tk[3]["rounds"].max()) + 1 for tk in ticks]
    assert led["fleet_apply"] == sum(bills)
    fleet = tf.fleet_empty(LANES, 64, capacity, device="cpu")
    for t, s in enumerate(ts):
        fleet.set_tenant(lane_of(t), td.init_state(s, capacity,
                                                   device="cpu"))
    real_apply = tf.apply_batch
    calls = []

    def spy(*a, **k):
        out = real_apply(*a, **k)
        calls.append(out[1]["link_rounds"])
        return out

    tf.apply_batch = spy
    try:
        fleet, st = tf.apply_batches(fleet, *tick_block(ts, 0, 64))
    finally:
        tf.apply_batch = real_apply
    assert calls == [int(_np(st["rounds"]).max())]
    assert tf.fleet_sync_cost(st) == calls[0] + 1


def test_fleet_empty_lanes_are_own_memory_and_set_tenant_checks():
    fleet = tf.fleet_empty(2, 16, 8, device="cpu")
    for f in STATE:
        x = getattr(fleet, f)
        assert x.is_contiguous() and x.stride(0) == x.shape[1]
    fleet.parent[0, 3] = 5
    assert int(fleet.parent[1, 3]) == 3
    with pytest.raises(ValueError, match="n_nodes"):
        fleet.set_tenant(0, td.forest_empty(32, 8, device="cpu"))
    with pytest.raises(ValueError, match="capacity"):
        fleet.set_tenant(0, td.forest_empty(16, 4, device="cpu"))


def test_clear_tenant_roundtrip_and_tenant_views():
    """``clear_tenant`` resets one lane; ``tenant(t)`` is a DynamicForest
    the single-tenant functions accept."""
    _, ts = _streams(4, "churn", 8, 2)
    capacity = max(td.stream_capacity(s) for s in ts)
    fleet = tf.fleet_empty(2, 16, capacity, device="cpu")
    states = [td.init_state(s, capacity, device="cpu") for s in ts]
    for t, s in enumerate(states):
        fleet.set_tenant(t, s)
    assert fleet.active.tolist() == [True, True]
    one = fleet.tenant(1)
    assert isinstance(one.version, int)
    assert bool(td.audit_forest(one).healthy)
    tn, _ = td.refresh_tour(one)
    tn1, _ = td.refresh_tour(states[1])
    assert torch.equal(tn.pre, tn1.pre)
    cleared = fleet.clear_tenant(0)
    assert cleared.active.tolist() == [False, True]
    empty = td.forest_empty(16, capacity, device="cpu")
    for f in STATE:
        assert torch.equal(getattr(cleared.tenant(0), f), getattr(empty, f))
        assert torch.equal(getattr(cleared.tenant(1), f),
                           getattr(states[1], f))


def _units(s, n, batch):
    """A tenant's unit sequence: its initial edges as insert-only units,
    then the stream's batches (every event rides the dispatcher)."""
    units = []
    for off in range(0, s.init_u.shape[0], batch):
        iu = np.full(batch, n, np.int32)
        iv = np.full(batch, n, np.int32)
        chunk = s.init_u[off:off + batch]
        iu[:chunk.shape[0]] = chunk
        iv[:chunk.shape[0]] = s.init_v[off:off + batch]
        units.append(StreamBatch(ins_u=iu, ins_v=iv,
                                 del_u=np.full(batch, n, np.int32),
                                 del_v=np.full(batch, n, np.int32)))
    return units + list(s.batches)


def test_evict_readmit_replay_equivalence(tmp_path):
    """3 tenants rotating through 2 slots: every tenant's final forest is
    bit-identical to replaying its unit sequence alone, though each was
    evicted (checkpoint) and re-admitted (restore) mid-history."""
    _, ts = _streams(8, "churn", 16, 3)
    n, batch = 64, 16
    capacity = max(td.stream_capacity(s) for s in ts)
    units = {t: _units(s, n, batch) for t, s in enumerate(ts)}
    manager = tf.FleetManager(tf.fleet_empty(2, n, capacity, device="cpu"),
                              tmp_path)
    dispatcher = tf.FleetDispatcher(n, batch, device="cpu")
    for t, seq in units.items():
        for b in seq:
            dispatcher.offer(t, b)
    tick = 0
    while dispatcher.pending():
        waiting = [t for t in units if dispatcher.pending(t)]
        rot = tick % max(len(waiting), 1)
        for t in (waiting[rot:] + waiting[:rot])[:2]:
            manager.ensure(t)
        block, served = dispatcher.tick(manager.tenant_at)
        manager.fleet, _ = tf.apply_batches(manager.fleet, *block)
        manager.note_applied(served)
        tick += 1
    assert manager.evictions > 0 and manager.restores > 0
    for t, seq in units.items():
        assert manager.cursors[t] == len(seq)
        slot = manager.ensure(t)
        state = td.forest_empty(n, capacity, device="cpu")
        for b in seq:
            state, _ = td.replay_batch(state, b)
        got = manager.fleet.tenant(slot)
        for f in STATE:
            assert torch.equal(getattr(got, f), getattr(state, f)), f
        assert got.version == state.version


def _mk(lo, n, b):
    return StreamBatch(
        ins_u=np.arange(lo, lo + b, dtype=np.int32) % n,
        ins_v=(np.arange(lo, lo + b, dtype=np.int32) + 1) % n,
        del_u=np.full(b, n, np.int32), del_v=np.full(b, n, np.int32))


def test_dispatcher_units_are_atomic_fifo_and_one_copy():
    n, b = 16, 4
    d = tf.FleetDispatcher(n, b, device="cpu")
    first, second = _mk(0, n, b), _mk(8, n, b)
    d.offer("a", first)
    d.offer("a", second)
    for expect in (first, second):
        (iu, iv, du, dv), served = d.tick(["a", None])
        assert iu.dtype == torch.int32 and iu.shape == (2, b)
        np.testing.assert_array_equal(iu[0].numpy(), expect.ins_u)
        np.testing.assert_array_equal(iv[0].numpy(), expect.ins_v)
        assert bool((iu[1] == n).all())
        assert served == {"a": b}
        # The four arrays are views of one block (one copy to the device).
        assert len({x.untyped_storage().data_ptr()
                    for x in (iu, iv, du, dv)}) == 1
    assert d.pending() == 0
    (iu, _, du, _), served = d.tick(["a", None])
    assert served == {} and bool((iu == n).all()) and bool((du == n).all())


def test_dispatcher_rejects_wrong_shape():
    d = tf.FleetDispatcher(16, 4, device="cpu")
    bad = StreamBatch(*(np.zeros(8, np.int32) for _ in range(4)))
    with pytest.raises(ValueError, match="fixed-shape"):
        d.offer("a", bad)


def test_manager_lru_eviction_order(tmp_path):
    manager = tf.FleetManager(tf.fleet_empty(2, 16, 8, device="cpu"),
                              tmp_path)
    assert manager.ensure("a") == 0
    assert manager.ensure("b") == 1
    manager.touch("a")
    assert manager.ensure("c") == 1 and "b" not in manager.slot_of
    assert manager.evictions == 1 and manager.restores == 0
    assert manager.ensure("b") == 0 and manager.restores == 1
    assert manager.tenant_at == ["b", "c"]


def _two_tenant_fleet():
    _, ts = _streams(4, "churn", 8, 2)
    capacity = max(td.stream_capacity(s) for s in ts)
    fleet = tf.fleet_empty(2, 16, capacity, device="cpu")
    for t, s in enumerate(ts):
        fleet.set_tenant(t, td.init_state(s, capacity, device="cpu"))
    block = tuple(np.stack([getattr(s.batches[0], f) for s in ts])
                  for f in ("ins_u", "ins_v", "del_u", "del_v"))
    return fleet, block


def test_fleet_session_policies_per_tenant():
    fleet, block = _two_tenant_fleet()
    sess = tf.FleetQuerySession.from_fleet(fleet, policy=("strict",
                                                          "stale"))
    u = np.arange(4, dtype=np.int32)
    sess.connected(fleet, 0, u, u)
    sess.connected(fleet, 1, u, u)
    fleet, _ = tf.apply_batches(fleet, *block)
    with pytest.raises(td.StaleQueryError):
        sess.connected(fleet, 0, u, u)
    sess.connected(fleet, 1, u, u)
    assert sess.sync_stats(1)["stale_served"] == 1
    assert sess.sync_stats(0)["stale_served"] == 0


def test_fleet_session_refresh_rebuilds_one_lane():
    """The refresh policy rebuilds lane 0 alone; its tables, reads and
    telemetry equal the reference session's on the same fleet."""
    fleet, block = _two_tenant_fleet()
    js, _ = _streams(4, "churn", 8, 2)
    capacity = fleet.capacity
    jfl = jf.fleet_empty(2, 16, capacity)
    for t, s in enumerate(js):
        jfl = jfl.set_tenant(t, jreplay.init_state(s, capacity=capacity))
    jsess = jf.FleetQuerySession.from_fleet(jfl, policy="refresh")
    sess = tf.FleetQuerySession.from_fleet(fleet, policy="refresh")
    jfl, _ = jf.apply_batches(jfl, *(jnp.asarray(x) for x in block))
    fleet, _ = tf.apply_batches(fleet, *block)
    u = np.arange(16, dtype=np.int32)
    assert sess.connected(fleet, 0, u, u).all()
    np.asarray(jsess.connected(jfl, 0, u, u))
    assert sess.sync_stats(0) == jsess.sync_stats(0)
    assert sess.sync_stats(1) == jsess.sync_stats(1)
    assert sess.is_fresh(fleet, 0) and not sess.is_fresh(fleet, 1)
    for f in TABLES:
        np.testing.assert_array_equal(_np(getattr(sess.tables, f)),
                                      np.asarray(getattr(jsess.tables, f)),
                                      f)
    rng = np.random.default_rng(3)
    a = rng.integers(-1, 17, 32).astype(np.int32)
    b = rng.integers(-1, 17, 32).astype(np.int32)
    for op in ("lca", "connected", "is_ancestor"):
        np.testing.assert_array_equal(
            getattr(sess, op)(fleet, 0, a, b).numpy(),
            np.asarray(getattr(jsess, op)(jfl, 0, a, b)), op)
    np.testing.assert_array_equal(sess.depth(fleet, 0, a).numpy(),
                                  np.asarray(jsess.depth(jfl, 0, a)))


def test_fleet_session_bcc_reads_match_reference():
    """``is_bridge`` and ``is_articulation`` read one lane of the stacked
    BCC as the reference's session reads its own."""
    fleet, _ = _two_tenant_fleet()
    js, _ = _streams(4, "churn", 8, 2)
    jfl = jf.fleet_empty(2, 16, fleet.capacity)
    for t, s in enumerate(js):
        jfl = jfl.set_tenant(t, jreplay.init_state(
            s, capacity=fleet.capacity))
    tn, fleet = tf.refresh_tours(fleet)
    jtn, jfl = jf.refresh_tours(jfl)
    sess = tf.FleetQuerySession.from_fleet(
        fleet, tn, tf.refresh_bccs(fleet, tour=tn))
    jsess = jf.FleetQuerySession.from_fleet(
        jfl, jtn, jf.refresh_bccs(jfl, tour=jtn))
    pool = fleet.tenant(1)
    live = pool.pool_valid.numpy()
    u = np.concatenate([pool.pool_src.numpy()[live], [0, 3, 16]])
    v = np.concatenate([pool.pool_dst.numpy()[live], [5, 3, 2]])
    u, v = u.astype(np.int32), v.astype(np.int32)
    for t in range(2):
        np.testing.assert_array_equal(
            sess.is_bridge(fleet, t, u, v).numpy(),
            np.asarray(jsess.is_bridge(jfl, t, u, v)))
        np.testing.assert_array_equal(
            sess.is_articulation(fleet, t, u).numpy(),
            np.asarray(jsess.is_articulation(jfl, t, u)))
    bare = tf.FleetQuerySession.from_fleet(fleet, tn)
    with pytest.raises(ValueError, match="biconnectivity"):
        bare.is_bridge(fleet, 0, u, v)


def test_fleet_session_rejects_bad_policy():
    fleet, _ = _two_tenant_fleet()
    with pytest.raises(ValueError, match="policy"):
        tf.FleetQuerySession.from_fleet(fleet, policy="yolo")
    with pytest.raises(ValueError, match="policies"):
        tf.FleetQuerySession.from_fleet(fleet, policy=("strict",) * 3)


def _tiny_suite(monkeypatch):
    from repro.data.graphs import SUITE as JSUITE
    monkeypatch.setitem(JSUITE, "tiny_grid8", (jax_graphs.grid2d,
                                               dict(side=8), "tiny"))
    monkeypatch.setitem(graphs.SUITE, "tiny_grid8", (graphs.grid2d,
                                                     dict(side=8), "tiny"))
    return "tiny_grid8"


def _report_lines(out: str) -> list:
    """The device-independent lines of a serve_fleet report."""
    keep = ("graph ", "sync accounting", "admission:", "validate",
            "query sync accounting", "bucket ")
    lines = []
    for line in out.splitlines():
        if line.startswith(keep):
            line = line.split(" (evict checkpoints")[0]
            lines.append(line)
    return lines


def test_serve_fleet_end_to_end_matches_reference(monkeypatch, tmp_path,
                                                  capsys):
    """``serve_fleet.main(argv, device="cpu")`` prints the reference's
    sync accounting, admission counts, query build counts and validation
    lines on the same flags."""
    name = _tiny_suite(monkeypatch)
    argv = ["--graph", name, "--stream", "churn", "--batch", "16",
            "--steps", "3", "--tenants", "3", "--slots", "2",
            "--tour-every", "2", "--bcc", "incremental", "--read-ratio",
            "0.3", "--read-batch", "8", "--validate"]
    from repro.launch import serve_fleet as jsf
    from repro_torch.launch import serve_fleet
    jsf.main(argv + ["--evict-dir", str(tmp_path / "j")])
    want = _report_lines(capsys.readouterr().out)
    serve_fleet.main(argv + ["--evict-dir", str(tmp_path / "t")],
                     device="cpu")
    out = capsys.readouterr().out
    got = _report_lines(out)
    assert got == want
    assert "sync accounting: fleet=" in out
    assert out.count("partition==from-scratch: True") == 3
    assert "evictions" in out and "Traceback" not in out


# ---- the table8 smoke rows -----------------------------------------------

T8_TENANTS, T8_BATCHES, T8_CADENCE = 4, 6, 2


def bench_rows(prefix: str) -> dict:
    rows = {}
    for r in json.loads((ROOT / "BENCH_rst.json").read_text()):
        if r.get("name", "").startswith(prefix):
            rows[r["name"]] = dict(kv.split("=")
                                   for kv in r["derived"].split(";"))
    return rows


def table8_counts(g, kind, device="cpu", use_kernel=None) -> dict:
    """The fleet and sequential ``sync_total`` of one table8 pair, by the
    benchmark's procedure (T = 4, B = 16, 6 batches, tours every 2), plus
    each side's final states."""
    ss = [streams.STREAMS[kind](g, batch=16, n_batches=T8_BATCHES, seed=t)
          for t in range(T8_TENANTS)]
    steps = min(T8_BATCHES, min(len(s.batches) for s in ss))
    capacity = max(td.stream_capacity(s) for s in ss)
    fleet = tf.fleet_empty(T8_TENANTS, g.n_nodes, capacity, device=device)
    for t, s in enumerate(ss):
        fleet.set_tenant(t, td.init_state(s, capacity, device=device,
                                          use_kernel=use_kernel))
    tn, bill = None, 0
    with obs.SyncLedger() as led:
        for i in range(steps):
            block = tuple(np.stack([getattr(s.batches[i], f) for s in ss])
                          for f in ("ins_u", "ins_v", "del_u", "del_v"))
            fleet, stats = tf.apply_batches(fleet, *block,
                                            use_kernel=use_kernel)
            bill += tf.fleet_sync_cost(stats)
            if (i + 1) % T8_CADENCE == 0:
                tn, fleet = tf.refresh_tours(fleet, tn,
                                             use_kernel=use_kernel)
        tn, fleet = tf.refresh_tours(fleet, tn, use_kernel=use_kernel)
    assert led.total("fleet_apply") == bill
    states = [td.init_state(s, capacity, device=device,
                            use_kernel=use_kernel) for s in ss]
    tns = [None] * len(ss)
    seq = 0
    with obs.SyncLedger() as led_seq:
        for i in range(steps):
            for t, s in enumerate(ss):
                states[t], stats = td.replay_batch(states[t], s.batches[i],
                                                   use_kernel=use_kernel)
                seq += stats["rounds"] + 1
                if (i + 1) % T8_CADENCE == 0:
                    tns[t], states[t] = td.refresh_tour(
                        states[t], tns[t], use_kernel=use_kernel)
        for t in range(len(ss)):
            tns[t], states[t] = td.refresh_tour(states[t], tns[t],
                                                use_kernel=use_kernel)
    assert led_seq.total("apply") == seq
    return {"fleet": led.total("fleet_apply"),
            "sequential": led_seq.total("apply"),
            "fleet_state": fleet, "states": states}


@pytest.mark.parametrize("kind", ["churn", "sliding_window"])
@pytest.mark.parametrize("glabel", ["smoke_chain_256", "smoke_rmat_6"])
def test_table8_smoke_rows(glabel, kind):
    """The pinned rows (fleet 15, 12, 13, 19 against 52, 48, 50, 62), each
    side's tenants bit-equal to the other's."""
    g = (graphs.chain(256, device="cpu") if glabel == "smoke_chain_256"
         else graphs.rmat(6, edge_factor=4, seed=0, device="cpu"))
    rows = bench_rows("table8_fleet/")
    got = table8_counts(g, kind)
    base = f"table8_fleet/{glabel}/{kind}/T{T8_TENANTS}/b16"
    for side in ("fleet", "sequential"):
        assert str(got[side]) == rows[f"{base}/{side}"]["sync_total"], side
    assert got["fleet"] < got["sequential"]
    for t, s in enumerate(got["states"]):
        f = got["fleet_state"].tenant(t)
        for field in ("parent", "rep", "pool_valid", "tree_mask"):
            assert torch.equal(getattr(f, field), getattr(s, field))
        assert f.version == s.version


def test_fleet_config_binding():
    import argparse

    from repro_torch.launch.config import FleetConfig
    ap = argparse.ArgumentParser()
    FleetConfig.add_args(ap)
    fcfg = FleetConfig.from_args(ap.parse_args(
        ["--tenants", "6", "--slots", "2"]))
    assert fcfg == FleetConfig(tenants=6, slots=2)
    with pytest.raises(ValueError):
        FleetConfig(tenants=0).check()


def test_tenant_slice_and_set_lane_leave_the_source():
    """``tenant_slice`` gives a lane's views; the session's lane writes
    copy the stacked tensors, so caches shared with a caller stay as
    they were."""
    fleet, _ = _two_tenant_fleet()
    tn, fleet = tf.refresh_tours(fleet)
    one = tf.tenant_slice(tn, 1)
    assert one.pre.shape == (16,)
    assert one.pre.data_ptr() == tn.pre[1].data_ptr()
    before = tn.pre.clone()
    sess = tf.FleetQuerySession.from_fleet(fleet, tn, policy="refresh")
    sess.rebuild_tenant(fleet, 0)
    assert torch.equal(tn.pre, before)
