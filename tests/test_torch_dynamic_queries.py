"""The port's ``QuerySession`` and ``ForestView`` against ``repro.dynamic``.

Both packages replay the same stream and serve the same seeded query
batches (ids include the −1 and n paddings): every answer of every query
kind and every counter (``builds``, ``build_syncs_total``,
``stale_served``, ``auto_refreshes``) must be equal, under each staleness
policy, and ``ForestView``'s cadence, cache adoption and latency lists
must behave as the reference's. Tolerance: bit-equal.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import dynamic as jd
from repro.data import graphs as jax_graphs
from repro.data import streams as jax_streams
from repro_torch import dynamic as td
from repro_torch.core import Graph
from repro_torch.data import streams

COUNTERS = ("builds", "build_syncs_total", "stale_served", "auto_refreshes")


@functools.cache
def _setup(graph="rmat_7", stream="churn", batch=16, warm=4):
    jg = (jax_graphs.rmat(7, edge_factor=4) if graph == "rmat_7"
          else jax_graphs.grid2d(12))
    g = Graph.from_reference_arrays(jg.n_nodes, np.asarray(jg.src),
                                    np.asarray(jg.dst), device="cpu")
    js = jax_streams.STREAMS[stream](jg, batch=batch, seed=0, n_batches=8)
    ts = streams.STREAMS[stream](g, batch=batch, seed=0, n_batches=8)
    return jg, g, js, ts


def _states(warm=4, **kw):
    _, _, js, ts = _setup(**kw)
    sj = jd.init_state(js)
    st = td.init_state(ts, device="cpu")
    for b, c in zip(js.batches[:warm], ts.batches[:warm]):
        sj, _ = jd.replay_batch(sj, b)
        st, _ = td.replay_batch(st, c)
    return js, ts, sj, st


def _refreshed(sj, st):
    tnj, sj = jd.refresh_tour(sj, None)
    tnt, st = td.refresh_tour(st, None)
    return (sj, tnj, jd.refresh_bcc(sj, None, tour=tnj),
            st, tnt, td.refresh_bcc(st, None, tour=tnt))


def _queries(n, state_t, k=300, seed=3):
    rng = np.random.default_rng(seed)
    u = rng.integers(-1, n + 1, k).astype(np.int32)
    v = rng.integers(-1, n + 1, k).astype(np.int32)
    # Half the bridge queries are live pool pairs, some reversed.
    valid = state_t.pool_valid.numpy()
    ps, pd = state_t.pool_src.numpy()[valid], state_t.pool_dst.numpy()[valid]
    pick = rng.integers(0, ps.size, k // 2)
    bu = np.concatenate([ps[pick], u[:k // 2]])
    bv = np.concatenate([pd[pick], v[:k // 2]])
    flip = rng.random(k) < 0.5
    bu, bv = np.where(flip, bv, bu), np.where(flip, bu, bv)
    pay_i = rng.integers(-50, 50, n).astype(np.int32)
    pay_f = rng.standard_normal(n).astype(np.float32)
    return u, v, bu.astype(np.int32), bv.astype(np.int32), pay_i, pay_f


def _answers(sess, state, q, to):
    u, v, bu, bv, pay_i, pay_f = (to(a) for a in q)
    out = {
        "connected": sess.connected(state, u, v),
        "depth": sess.depth(state, v),
        "lca": sess.lca(state, u, v),
        "is_ancestor": sess.is_ancestor(state, u, v),
        "subtree_add": sess.subtree_agg(state, v, pay_i, "add"),
        "subtree_min": sess.subtree_agg(state, v, pay_f, "min"),
        "subtree_max": sess.subtree_agg(state, u, pay_i, "max"),
        "path_add": sess.path_agg(state, u, v, pay_i, "add"),
        "path_min": sess.path_agg(state, u, v, pay_f, "min"),
        "scalar_lca": sess.lca(state, 3, 5),
    }
    if sess.bcc is not None:
        out["is_bridge"] = sess.is_bridge(state, bu, bv)
        out["is_articulation"] = sess.is_articulation(state, v)
    return {k: np.asarray(a) for k, a in out.items()}


def _to_jax(a):
    return jnp.asarray(a)


def _to_torch(a):
    return torch.from_numpy(np.array(a))


def _assert_answers(want, got):
    assert set(want) == set(got)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _counters(sess):
    return {c: getattr(sess, c) for c in COUNTERS}


@pytest.mark.parametrize("with_bcc", [True, False])
@pytest.mark.parametrize("graph", ["rmat_7", "grid_12"])
def test_session_answers_match_reference(graph, with_bcc):
    _, _, sj, st = _states(graph=graph)
    sj, tnj, bj, st, tnt, bt = _refreshed(sj, st)
    qj = jd.QuerySession.from_state(sj, tnj, bj if with_bcc else None)
    qt = td.QuerySession.from_state(st, tnt, bt if with_bcc else None)
    q = _queries(st.n_nodes, st)
    _assert_answers(_answers(qj, sj, q, _to_jax),
                    _answers(qt, st, q, _to_torch))
    assert _counters(qt) == {c: int(v) for c, v in _counters(qj).items()}
    # A session built without caches numbers the tour itself.
    qt2 = td.QuerySession.from_state(st)
    np.testing.assert_array_equal(qt2.tn.pre.numpy(), tnt.pre.numpy())


def test_session_policies_match_reference():
    js, ts, sj, st = _states()
    sj, tnj, bj, st, tnt, bt = _refreshed(sj, st)
    q = _queries(st.n_nodes, st)
    sess = {p: (jd.QuerySession.from_state(sj, tnj, bj, policy=p),
                td.QuerySession.from_state(st, tnt, bt, policy=p))
            for p in td.POLICIES}
    before = _answers(sess["stale"][1], st, q, _to_torch)
    sj2, _ = jd.replay_batch(sj, js.batches[4])
    st2, _ = td.replay_batch(st, ts.batches[4])
    assert st2.version == int(sj2.version) == st.version + 1

    # strict raises in both.
    with pytest.raises(jd.StaleQueryError):
        sess["strict"][0].connected(sj2, 0, 1)
    with pytest.raises(td.StaleQueryError, match="version"):
        sess["strict"][1].connected(st2, 0, 1)
    # stale serves the frozen view and counts each query.
    stale = _answers(sess["stale"][1], st2, q, _to_torch)
    _assert_answers(before, stale)
    _answers(sess["stale"][0], sj2, q, _to_jax)
    # refresh rebuilds once, then answers as a fresh session would.
    got = _answers(sess["refresh"][1], st2, q, _to_torch)
    want = _answers(sess["refresh"][0], sj2, q, _to_jax)
    _assert_answers(want, got)
    tn2, st3 = td.refresh_tour(st2, None)
    fresh = td.QuerySession.from_state(
        st3, tn2, td.refresh_bcc(st3, None, tour=tn2))
    _assert_answers(_answers(fresh, st3, q, _to_torch), got)
    for p in td.POLICIES:
        assert _counters(sess[p][1]) == \
            {c: int(v) for c, v in _counters(sess[p][0]).items()}, p
    assert sess["stale"][1].stale_served == len(before)
    assert sess["refresh"][1].auto_refreshes == 1
    assert sess["refresh"][1].builds == 2
    assert sess["refresh"][1].is_fresh(st2)


def test_session_rejects_stale_caches():
    js, ts, sj, st = _states()
    sj, tnj, bj, st, tnt, bt = _refreshed(sj, st)
    st2, _ = td.replay_batch(st, ts.batches[4])
    with pytest.raises(ValueError, match="stale TourNumbering"):
        td.QuerySession.from_state(st2, tnt)
    tn2, st2 = td.refresh_tour(st2, tnt)
    with pytest.raises(ValueError, match="stale DynamicBCC"):
        td.QuerySession.from_state(st2, tn2, bt)
    sess = td.QuerySession.from_state(st2, tn2)
    with pytest.raises(ValueError, match="biconnectivity"):
        sess.is_bridge(st2, 0, 1)
    with pytest.raises(ValueError, match="policy"):
        td.QuerySession.from_state(st2, tn2, policy="lazy")


# ---- ForestView ----------------------------------------------------------------

def _view_run(pkg, stream, state, policy, n_steps, forced_at=()):
    """Drive a view; per step, what is observable: the tour/bcc latency
    counts, the session's counters and identity changes, the tour."""
    view = pkg.ForestView(policy)
    state = view.prime(state)
    trace = []
    last_session = view.session
    for i, b in enumerate(stream.batches[:n_steps]):
        state, _ = pkg.replay_batch(state, b)
        if i in forced_at:
            state = view.refresh(state, bcc=False, queries=True)
        else:
            state = view.refresh(state, step=i)
        sess = view.session
        trace.append((len(view.tour_lat), len(view.bcc_lat),
                      None if sess is None else
                      {c: int(v) for c, v in sess.sync_stats().items()},
                      sess is not last_session,
                      None if view.tn is None else np.asarray(view.tn.pre),
                      None if view.bcc is None else int(view.bcc.n_bcc),
                      bool(np.asarray(state.dirty).any())))
        last_session = sess
    return trace


@pytest.mark.parametrize("policy", [
    dict(tour="incremental", bcc="incremental", queries=True, every=1),
    dict(tour="incremental", bcc="off", queries=True, every=2,
         staleness="strict"),
    dict(tour="full", bcc="full", queries=False, every=3),
    dict(tour="off", bcc="incremental", queries=True, every=2),
    dict(tour="off", bcc="off", queries=False, every=0),
])
def test_forest_view_matches_reference(policy):
    js, ts, sj, st = _states(warm=0)
    want = _view_run(jd, js, sj, jd.CadencePolicy(**policy), 6,
                     forced_at=(4,))
    got = _view_run(td, ts, st, td.CadencePolicy(**policy), 6,
                    forced_at=(4,))
    assert len(want) == len(got)
    for i, (w, g) in enumerate(zip(want, got)):
        assert w[:4] == g[:4], (i, w[:4], g[:4])
        assert (w[4] is None) == (g[4] is None)
        if w[4] is not None:
            np.testing.assert_array_equal(g[4], w[4])
        assert w[5:] == g[5:], i


def test_cadence_policy_validates_and_schedules():
    with pytest.raises(ValueError, match="tour mode"):
        td.CadencePolicy(tour="sometimes")
    with pytest.raises(ValueError, match="bcc mode"):
        td.CadencePolicy(bcc="always")
    with pytest.raises(ValueError, match="staleness"):
        td.CadencePolicy(staleness="eventual")
    p = td.CadencePolicy(every=3)
    assert [p.due(i) for i in range(6)] == \
        [jd.CadencePolicy(every=3).due(i) for i in range(6)]
    assert p.due(None) and not td.CadencePolicy(every=0).due(5)


def test_forest_view_session_adoption_is_by_identity():
    _, ts, _, st = _states(warm=2)
    view = td.ForestView(td.CadencePolicy(tour="incremental",
                                          bcc="incremental", queries=True,
                                          every=1))
    st = view.prime(st)
    first = view.adopt_session(st)
    assert view.adopt_session(st) is first
    st, _ = td.replay_batch(st, ts.batches[2])
    st = view.refresh(st, step=0)
    assert view.session is not first
    assert view.session.builds == first.builds + 1
    assert view.session.bcc is view.bcc and view.session.tn is view.tn
