"""The port's batch-dynamic forest against ``repro.dynamic``, bit for bit.

Each stream is made by both packages from the same graph (carried over with
``Graph.from_reference_arrays``) and seed, and replayed by both: the
reference on its plain path (``use_kernel=False``, and once through its
Pallas kernels in interpret mode), the port on the CPU. After the seed
state and after every batch, every ``DynamicForest`` field and every stat
(``cuts``, ``links``, ``rounds``, ``overflow``, ``pending``,
``deletes_found``) must be equal. Also held: ``edge_slots`` on multiset
requests, ``max_rounds`` truncation, pool overflow, ``forest_from_graph``,
the padded ``live_graph`` through ``connected_components`` and
``rooted_spanning_tree``, and the ``obs`` ledger's totals per phase.
Tolerance: bit-equal (every output is int32 or bool, every count an int).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import dynamic as jd
from repro import obs as jax_obs
from repro.core import connected_components as jax_cc
from repro.core import rooted_spanning_tree as jax_rst
from repro.core.graph import Graph as JaxGraph
from repro.data import graphs as jax_graphs
from repro.data import streams as jax_streams
from repro_torch import dynamic as td
from repro_torch import obs
from repro_torch.core import (Graph, connected_components,
                              rooted_spanning_tree, validate_rst)
from repro_torch.core import connectivity
from repro_torch.data import streams

GRAPHS = {
    "grid_12": lambda: jax_graphs.grid2d(12),
    "rmat_7": lambda: jax_graphs.rmat(7, edge_factor=4),
    "chain_256": lambda: jax_graphs.chain(256),
    "rmat_6": lambda: jax_graphs.rmat(6, edge_factor=4),
}
STATE_FIELDS = ("parent", "rep", "pool_src", "pool_dst", "pool_valid",
                "tree_mask", "dirty")
STATS = ("cuts", "links", "rounds", "overflow", "pending", "deletes_found")
N_BATCHES = 8


@functools.cache
def _graphs(name):
    jg = GRAPHS[name]()
    return jg, Graph.from_reference_arrays(jg.n_nodes, np.asarray(jg.src),
                                           np.asarray(jg.dst), device="cpu")


@functools.cache
def _streams(graph, stream, batch):
    jg, g = _graphs(graph)
    kw = dict(batch=batch, seed=0, n_batches=N_BATCHES)
    return (jax_streams.STREAMS[stream](jg, **kw),
            streams.STREAMS[stream](g, **kw))


def _fields(state) -> dict:
    return {f: np.asarray(getattr(state, f)) for f in STATE_FIELDS}


def _assert_state(want: dict, got: td.DynamicForest, what):
    for f in STATE_FIELDS:
        g = getattr(got, f)
        assert g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), want[f], err_msg=f"{what} {f}")


@functools.cache
def _reference_replay(graph, stream, batch):
    """Per step (the seed state, then each batch): the reference's state
    fields, stats and version."""
    js, _ = _streams(graph, stream, batch)
    s = jd.init_state(js)
    out = [(_fields(s), None, int(s.version))]
    for b in js.batches:
        s, stats = jd.replay_batch(s, b)
        out.append((_fields(s), {k: int(v) for k, v in stats.items()},
                    int(s.version)))
    return tuple(out)


@pytest.mark.parametrize("batch", [4, 16])
@pytest.mark.parametrize("stream", sorted(streams.STREAMS))
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_replay_matches_reference(graph, stream, batch):
    _, ts = _streams(graph, stream, batch)
    want = _reference_replay(graph, stream, batch)
    s = td.init_state(ts, device="cpu")
    _assert_state(want[0][0], s, "init")
    assert s.version == want[0][2]
    for i, b in enumerate(ts.batches):
        s, stats = td.replay_batch(s, b)
        fields, jstats, version = want[i + 1]
        _assert_state(fields, s, f"batch {i}")
        assert s.version == version
        assert isinstance(stats["rounds"], int)
        assert {k: int(stats[k]) for k in STATS} == \
            {k: jstats[k] for k in STATS}, f"batch {i}"


def test_replay_through_reference_kernels():
    """The reference through its Pallas kernels (interpret mode) against
    the port's plain path, over one small churn stream with refreshes."""
    js, ts = _streams("chain_256", "churn", 16)
    sj = jd.init_state(js)
    st = td.init_state(ts, device="cpu")
    tnj = tnt = None
    for b, c in zip(js.batches[:4], ts.batches[:4]):
        sj, statj = jd.replay_batch(sj, b, use_kernel=True)
        st, statt = td.replay_batch(st, c)
        _assert_state(_fields(sj), st, "kernel path")
        assert {k: int(statt[k]) for k in STATS} == \
            {k: int(statj[k]) for k in STATS}
        tnj, sj = jd.refresh_tour(sj, tnj, use_kernel=True)
        tnt, st = td.refresh_tour(st, tnt)
        for f in ("pre", "size", "last", "comp"):
            np.testing.assert_array_equal(getattr(tnt, f).numpy(),
                                          np.asarray(getattr(tnj, f)))
    bj = jd.refresh_bcc(sj, None, tour=tnj, use_kernel=True)
    bt = td.refresh_bcc(st, None, tour=tnt)
    for f in ("rep", "low", "high", "articulation", "bridge", "edge_bcc"):
        np.testing.assert_array_equal(getattr(bt, f).numpy(),
                                      np.asarray(getattr(bj, f)))
    assert bt.n_bcc == int(bj.n_bcc)


# ---- edge_slots ---------------------------------------------------------------

def _pool_pair(n, edges, capacity):
    """The same multigraph pool in both packages (``forest_from_graph``)."""
    edges = np.asarray(edges, np.int32)
    jg = JaxGraph.from_undirected(n, jnp.asarray(edges[:, 0]),
                                  jnp.asarray(edges[:, 1]))
    g = Graph.from_reference_arrays(n, np.asarray(jg.src), np.asarray(jg.dst),
                                    device="cpu")
    return (jd.forest_from_graph(jg, capacity),
            td.forest_from_graph(g, capacity))


# Pair (0, 1) has three parallel copies, (1, 2) two (one reversed), (2, 3)
# one; (3, 4) none.
MULTI_EDGES = [(0, 1), (1, 2), (1, 0), (2, 3), (0, 1), (2, 1), (4, 5)]
REQUESTS = {
    "k_below_copies": [(0, 1), (1, 0)],
    "k_equals_copies": [(1, 0), (0, 1), (1, 0), (2, 1), (1, 2)],
    "k_above_copies": [(0, 1)] * 5 + [(2, 3), (3, 2)],
    "not_found": [(3, 4), (0, 5), (5, 5), (0, 0)],
    "sentinel_and_invalid": [(6, 6), (6, 0), (-1, 2), (0, 7), (4, 5)],
    "interleaved": [(2, 1), (0, 1), (6, 6), (1, 2), (1, 0), (3, 4),
                    (1, 2), (0, 1), (2, 3)],
    "empty": [],
}


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_edge_slots_multiset(name):
    js, ts = _pool_pair(6, MULTI_EDGES, capacity=10)
    req = np.asarray(REQUESTS[name], np.int32).reshape(-1, 2)
    dm_j, found_j = jd.edge_slots(js, jnp.asarray(req[:, 0]),
                                  jnp.asarray(req[:, 1]))
    dm_t, found_t = td.edge_slots(ts, torch.from_numpy(req[:, 0].copy()),
                                  torch.from_numpy(req[:, 1].copy()))
    np.testing.assert_array_equal(dm_t.numpy(), np.asarray(dm_j))
    np.testing.assert_array_equal(found_t.numpy(), np.asarray(found_j))
    assert int(dm_t.sum()) == int(found_t.sum())


def test_edge_slots_skips_emptied_slots():
    """After a deletion empties slots, requests cannot claim them."""
    js, ts = _pool_pair(6, MULTI_EDGES, capacity=10)
    req = np.asarray([(0, 1), (0, 1)], np.int32)
    dm_j, _ = jd.edge_slots(js, jnp.asarray(req[:, 0]), jnp.asarray(req[:, 1]))
    none = np.zeros(0, np.int32)
    js, _ = jd.apply_batch(js, jnp.asarray(none), jnp.asarray(none), dm_j)
    ts, _ = td.apply_batch(ts, torch.from_numpy(none), torch.from_numpy(none),
                           torch.from_numpy(np.array(dm_j)))
    _assert_state(_fields(js), ts, "after delete")
    req = np.asarray([(1, 0)] * 3, np.int32)
    dm_j, f_j = jd.edge_slots(js, jnp.asarray(req[:, 0]),
                              jnp.asarray(req[:, 1]))
    dm_t, f_t = td.edge_slots(ts, torch.from_numpy(req[:, 0].copy()),
                              torch.from_numpy(req[:, 1].copy()))
    np.testing.assert_array_equal(dm_t.numpy(), np.asarray(dm_j))
    np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_j))
    assert f_t.tolist() == [True, False, False]


# ---- apply_batch options -------------------------------------------------------

def _apply_both(js, ts, ins, dmask, **kw):
    ins = np.asarray(ins, np.int32).reshape(-1, 2)
    js, sj = jd.apply_batch(js, jnp.asarray(ins[:, 0]),
                            jnp.asarray(ins[:, 1]), jnp.asarray(dmask), **kw)
    ts, st = td.apply_batch(ts, torch.from_numpy(ins[:, 0].copy()),
                            torch.from_numpy(ins[:, 1].copy()),
                            torch.from_numpy(np.array(dmask)), **kw)
    _assert_state(_fields(js), ts, kw)
    assert {k: int(st[k]) for k in STATS[:-1]} == \
        {k: int(sj[k]) for k in STATS[:-1]}, kw
    return js, ts, st


@pytest.mark.parametrize("max_rounds", [0, 1, 2, 3])
def test_apply_batch_max_rounds_truncation(max_rounds):
    """A chain and a star inserted at once need several link rounds; a
    bound leaves cross edges pending, and the next batch drains them."""
    n = 40
    rng = np.random.default_rng(4)
    edges = [(int(a), int(b)) for a, b in
             zip(rng.permutation(20)[:-1], rng.permutation(20)[1:])]
    edges += [(20, v) for v in range(21, 40)] + [(5, 25)]
    js = jd.forest_empty(n, 64)
    ts = td.forest_empty(n, 64, device="cpu")
    js, ts, st = _apply_both(js, ts, edges, np.zeros(64, bool),
                             max_rounds=max_rounds)
    assert st["rounds"] <= max_rounds
    js, ts, st = _apply_both(js, ts, np.zeros((0, 2)), np.zeros(64, bool))
    assert int(st["pending"]) == 0


def test_apply_batch_pool_overflow():
    n = 30
    edges = [(i, i + 1) for i in range(25)]
    js = jd.forest_empty(n, 10)
    ts = td.forest_empty(n, 10, device="cpu")
    js, ts, st = _apply_both(js, ts, edges[:8], np.zeros(10, bool))
    assert int(st["overflow"]) == 0
    dmask = np.zeros(10, bool)
    dmask[[1, 4]] = True
    js, ts, st = _apply_both(js, ts, edges[8:] + [(3, 3), (30, 2)], dmask)
    assert int(st["overflow"]) == 17 - 4 and int(st["cuts"]) == 2


def test_apply_batch_leaves_its_input_unchanged():
    _, ts = _streams("rmat_6", "churn", 16)
    s = td.init_state(ts, device="cpu")
    for b in ts.batches[:2]:
        s, _ = td.replay_batch(s, b)
    before = {f: getattr(s, f).clone() for f in STATE_FIELDS}
    s2, _ = td.replay_batch(s, ts.batches[2])
    for f in STATE_FIELDS:
        assert torch.equal(getattr(s, f), before[f]), f
    assert s2.version == s.version + 1
    assert not torch.equal(s2.pool_src, s.pool_src)


# ---- forest_from_graph ---------------------------------------------------------

@pytest.mark.parametrize("capacity", [None, "m", 300])
@pytest.mark.parametrize("root", [0, 17])
@pytest.mark.parametrize("graph", ["grid_12", "rmat_7"])
def test_forest_from_graph_matches_reference(graph, root, capacity):
    jg, g = _graphs(graph)
    cap = g.n_edges if capacity == "m" else capacity
    if cap is not None and cap < g.n_edges:
        with pytest.raises(ValueError, match="capacity"):
            td.forest_from_graph(g, cap)
        return
    js = jd.forest_from_graph(jg, cap, root)
    ts = td.forest_from_graph(g, cap, root)
    _assert_state(_fields(js), ts, "seed")
    assert ts.capacity == js.capacity
    # A batch on top of it: deletions of live edges and fresh insertions.
    _, stream = _streams(graph, "churn", 16)
    b = stream.batches[0]
    dm_j, _ = jd.edge_slots(js, jnp.asarray(b.del_u), jnp.asarray(b.del_v))
    js, ts, _ = _apply_both(js, ts, np.stack([b.ins_u, b.ins_v], 1),
                            np.asarray(dm_j))


def test_forest_from_graph_default_headroom():
    jg, g = _graphs("rmat_6")
    for hint in (1, 16, 400):
        assert td.forest_from_graph(g, batch_hint=hint).capacity == \
            jd.forest_from_graph(jg, batch_hint=hint).capacity
    m = g.n_edges
    assert td.forest_from_graph(g).capacity == max(m + 64, -(-5 * m // 4))


# ---- the padded live graph --------------------------------------------------------

@pytest.mark.parametrize("stream", ["sliding_window", "churn"])
@pytest.mark.parametrize("graph", ["rmat_7", "chain_256"])
def test_padded_live_graph_matches_reference(graph, stream, monkeypatch):
    """``live_graph`` keeps the sentinel rows (n, n); connected_components
    and rooted_spanning_tree (all three flavors) give the reference's
    answers on it, and hook_edges never sees an id outside [0, n)."""
    js_stream, ts_stream = _streams(graph, stream, 16)
    cap = td.stream_capacity(ts_stream, 8)
    sj = jd.init_state(js_stream, cap)
    st = td.init_state(ts_stream, cap, device="cpu")
    for b, c in zip(js_stream.batches[:5], ts_stream.batches[:5]):
        sj, _ = jd.replay_batch(sj, b)
        st, _ = td.replay_batch(st, c)
    lj, lt = jd.live_graph(sj), td.live_graph(st)
    n = lt.n_nodes
    assert lt.padded and bool((lt.src == n).any())
    np.testing.assert_array_equal(lt.src.numpy(), np.asarray(lj.src))
    np.testing.assert_array_equal(lt.dst.numpy(), np.asarray(lj.dst))

    seen = []
    real = connectivity.hook_edges

    def hook(src, dst, rep, use_min, **kw):
        seen.append(int(torch.maximum(src.max(), dst.max())))
        return real(src, dst, rep, use_min, **kw)
    monkeypatch.setattr(connectivity, "hook_edges", hook)

    rep, forest, rounds = connected_components(lt)
    rep_j, forest_j, rounds_j = jax_cc(lj)
    np.testing.assert_array_equal(rep.numpy(), np.asarray(rep_j))
    np.testing.assert_array_equal(forest.numpy(), np.asarray(forest_j))
    assert rounds == int(rounds_j)
    root = int(st.rep[0])
    res = rooted_spanning_tree(lt, root, "gconn_euler", device="cpu")
    want = jax_rst(lj, root, method="gconn_euler")
    np.testing.assert_array_equal(res.parent.numpy(), np.asarray(want.parent))
    assert res.steps == int(want.steps)
    assert seen and max(seen) < n
    assert validate_rst(lt, res.parent, root, connected=False)["all_ok"]
    # The other two flavors read the clamped rows as the reference does.
    for method in ("bfs", "pr_rst"):
        res = rooted_spanning_tree(lt, root, method, device="cpu")
        want = jax_rst(lj, root, method=method)
        np.testing.assert_array_equal(res.parent.numpy(),
                                      np.asarray(want.parent), err_msg=method)
        assert res.steps == int(want.steps), method
    assert validate_rst(lt, st.parent, int(st.rep[0]),
                        connected=False)["all_ok"]


def test_static_graphs_are_not_padded():
    _, g = _graphs("chain_256")
    assert not g.padded and g.clamped() is g
    assert Graph.from_numpy_undirected(3, np.array([(0, 1)]),
                                       device="cpu").padded is False


# ---- the obs ledger ------------------------------------------------------------

@pytest.mark.parametrize("stream", ["sliding_window", "churn"])
def test_ledger_totals_match_reference(stream):
    """The same stream through a ForestView (tour and BCC incremental,
    queries on, every batch) under a ledger in each package: equal totals
    and record counts per phase."""
    js_stream, ts_stream = _streams("rmat_6", stream, 16)
    with jax_obs.SyncLedger() as want:
        view = jd.ForestView(jd.CadencePolicy(tour="incremental",
                                              bcc="incremental",
                                              queries=True, every=1))
        s = view.prime(jd.init_state(js_stream))
        for i, b in enumerate(js_stream.batches):
            s, _ = jd.replay_batch(s, b)
            s = view.refresh(s, step=i)
    with obs.SyncLedger() as got:
        view = td.ForestView(td.CadencePolicy(tour="incremental",
                                              bcc="incremental",
                                              queries=True, every=1))
        s = view.prime(td.init_state(ts_stream, device="cpu"))
        for i, b in enumerate(ts_stream.batches):
            s, _ = td.replay_batch(s, b)
            s = view.refresh(s, step=i)
    assert got.totals() == want.totals()
    assert got.counts() == want.counts()
    assert set(got.totals()) == {"apply", "refresh_tour", "refresh_bcc",
                                 "build_tables"}
