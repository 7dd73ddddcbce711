"""The port's fault injection, stream pollution, sanitizer and audit against
``repro.dynamic``, bit for bit.

Both packages reach the same churn steady state (grid2d(16), the reference
test's fixture), then every injector runs on it under seeds 1–3: the
corrupted state, the corrupted BCC cache and the description must be
equal, and so must every field of the ``AuditReport`` (verdicts, masks,
counts, syncs) on the healthy and on each corrupted state. Every polluter
and their composition give the same batches, and ``sanitize_batch`` the
same batches and quarantine counters. Tolerance: bit-equal (every output
is int32 or bool, every count an int, every description a string).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro import dynamic as jd
from repro.data import graphs as jax_graphs
from repro.data import streams as jax_streams
from repro_torch import dynamic as td
from repro_torch import obs
from repro_torch.core import Graph
from repro_torch.data import streams

STATE_FIELDS = ("parent", "rep", "pool_src", "pool_dst", "pool_valid",
                "tree_mask", "dirty")
BCC_FIELDS = ("parent", "pool_src", "pool_dst", "pool_valid", "tree_mask",
              "pre", "rep", "low", "high", "articulation", "bridge",
              "edge_bcc")
TOUR_FIELDS = ("pre", "size", "last", "comp", "parent")
REPORT_FIELDS = ("acyclic", "roots_fixed", "rep_consistent",
                 "tree_cover_ok", "tree_slots_ok", "spanning_ok",
                 "counts_ok", "forest_ok", "tour_fresh", "bcc_fresh",
                 "healthy", "violating", "comp_violating", "sever", "stale",
                 "bad_slots", "n_violating")
SEEDS = (1, 2, 3)


def _eq(got: torch.Tensor, want, what):
    assert got.device.type == "cpu", what
    np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                  err_msg=str(what))


def assert_state(got, want, what):
    for f in STATE_FIELDS:
        _eq(getattr(got, f), getattr(want, f), (what, f))
    assert got.version == int(want.version), what


def assert_bcc(got, want, what):
    for f in BCC_FIELDS:
        _eq(getattr(got, f), getattr(want, f), (what, f))
    for f in ("n_bcc", "aux_rounds", "seg_syncs", "dirty_count"):
        assert getattr(got, f) == int(getattr(want, f)), (what, f)


def assert_tour(got, want, what):
    for f in TOUR_FIELDS:
        _eq(getattr(got, f), getattr(want, f), (what, f))


def assert_report(got, want, what):
    for f in REPORT_FIELDS:
        _eq(getattr(got, f), getattr(want, f), (what, f))
    assert got.syncs == int(want.syncs), what
    assert got.n_nodes == want.n_nodes
    assert got.violations() == want.violations(), what
    assert got.summary() == want.summary(), what


@functools.cache
def _steady():
    """The reference test's fixture in both packages: grid2d(16) churn, 8
    batches of 32, seed 0, then a full tour and BCC refresh."""
    jg = jax_graphs.grid2d(16)
    g = Graph.from_reference_arrays(jg.n_nodes, np.asarray(jg.src),
                                    np.asarray(jg.dst), device="cpu")
    js = jax_streams.STREAMS["churn"](jg, batch=32, n_batches=8, seed=0)
    ts = streams.STREAMS["churn"](g, batch=32, n_batches=8, seed=0)
    sj, st = jd.init_state(js), td.init_state(ts, device="cpu")
    for a, b in zip(js.batches, ts.batches):
        sj, _ = jd.replay_batch(sj, a)
        st, _ = td.replay_batch(st, b)
    tnj, sj = jd.refresh_tour(sj, None)
    tnt, st = td.refresh_tour(st, None)
    bj = jd.refresh_bcc(sj, None, tour=tnj)
    bt = td.refresh_bcc(st, None, tour=tnt)
    return (sj, tnj, bj), (st, tnt, bt)


@functools.cache
def _reference_injection(name, seed):
    (sj, tnj, bj), _ = _steady()
    bad, bad_bcc, desc = jd.inject(name, sj, bj, seed=seed)
    return bad, bad_bcc, desc, jd.audit_forest(bad, tnj, bad_bcc)


def test_steady_states_match_and_audit_healthy():
    (sj, tnj, bj), (st, tnt, bt) = _steady()
    assert_state(st, sj, "steady")
    assert_tour(tnt, tnj, "steady")
    assert_bcc(bt, bj, "steady")
    for args in ((), ("tn",), ("tn", "bcc")):
        jargs = [{"tn": tnj, "bcc": bj}[a] for a in args]
        targs = [{"tn": tnt, "bcc": bt}[a] for a in args]
        with obs.SyncLedger() as led:
            rt = td.audit_forest(st, *targs)
        rj = jd.audit_forest(sj, *jargs)
        assert bool(rt.healthy)
        assert_report(rt, rj, ("healthy", args))
        assert led.total("audit") == rt.syncs
        assert rt.healthy.dim() == 0 and rt.healthy.dtype == torch.bool
        assert isinstance(rt.syncs, int)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(jd.INJECTORS))
def test_injector_matches_reference(name, seed):
    """The corrupted state, BCC and description, and the audit of each."""
    _, (st, tnt, bt) = _steady()
    bad_j, bcc_j, desc_j, rep_j = _reference_injection(name, seed)
    snap = {f: getattr(st, f).clone() for f in STATE_FIELDS}
    bad_t, bcc_t, desc_t = td.inject(name, st, bt, seed=seed)
    assert desc_t == desc_j
    assert_state(bad_t, bad_j, name)
    assert_bcc(bcc_t, bcc_j, name)
    # The injection writes into copies only.
    for f in STATE_FIELDS:
        assert torch.equal(getattr(st, f), snap[f]), f
    report = td.audit_forest(bad_t, tnt, bcc_t)
    assert not bool(report.healthy)
    assert_report(report, rep_j, (name, seed))
    # Without the caches, as the resilient loop's structural guard audits.
    assert_report(td.audit_forest(bad_t), jd.audit_forest(bad_j),
                  (name, seed, "bare"))


@pytest.mark.parametrize("name", sorted(jd.INJECTORS))
def test_injector_without_bcc(name):
    """``bcc=None``: stale_bcc falls back to a rep fault, as in the
    reference; the others pass None through."""
    (sj, _, _), (st, _, _) = _steady()
    bad_j, bj, desc_j = jd.inject(name, sj, None, seed=11)
    bad_t, bt, desc_t = td.inject(name, st, None, seed=11)
    assert bt is None and bj is None
    assert desc_t == desc_j
    assert_state(bad_t, bad_j, name)


@pytest.mark.parametrize("name", ["parent_bitflip", "parent_cycle",
                                  "tree_mask_desync", "rep_corrupt"])
def test_repeated_injections_match_reference(name):
    """Four injections in a row, each on the last one's output (the table6
    procedure's K = 4): a cycle walk on an already cyclic table ends where
    the reference's n hops end."""
    (sj, _, bj), (st, _, bt) = _steady()
    for seed in range(4000, 4004):
        sj, bj, desc_j = jd.inject(name, sj, bj, seed=seed)
        st, bt, desc_t = td.inject(name, st, bt, seed=seed)
        assert desc_t == desc_j
        assert_state(st, sj, (name, seed))
        assert_report(td.audit_forest(st), jd.audit_forest(sj),
                      (name, seed))


def _edgeless_pair(n=6, capacity=8):
    return jd.forest_empty(n, capacity), td.forest_empty(n, capacity,
                                                         device="cpu")


@pytest.mark.parametrize("name", ["parent_bitflip", "parent_cycle",
                                  "tree_mask_desync", "pool_desync"])
def test_injector_on_an_empty_pool(name):
    """The reference's fallbacks: vertex 0 on an edgeless forest, a forged
    bit on dead slot 0, a rep fault on an empty pool."""
    sj, st = _edgeless_pair()
    bad_j, _, desc_j = jd.inject(name, sj, None, seed=5)
    bad_t, _, desc_t = td.inject(name, st, None, seed=5)
    assert desc_t == desc_j
    assert_state(bad_t, bad_j, name)
    assert_report(td.audit_forest(bad_t), jd.audit_forest(bad_j), name)


def test_parent_cycle_rejects_an_out_of_range_table():
    _, (st, _, _) = _steady()
    bad, _, _ = td.inject("parent_bitflip", st, None, seed=3)
    big = bad.parent.clone()
    big[0] = st.n_nodes + 5
    with pytest.raises(ValueError, match="outside"):
        td.inject("parent_cycle", dataclasses.replace(bad, parent=big),
                  None, seed=0)


def test_audit_stale_tour_and_dirty_exemption():
    """A tour numbering of an older state is stale outside ``dirty`` and
    exempt inside it."""
    (sj, tnj, _), (st, tnt, _) = _steady()
    jst = jax_streams.STREAMS["churn"](jax_graphs.grid2d(16), batch=32,
                                       n_batches=9, seed=0).batches[-1]
    tst = streams.StreamBatch(*(np.asarray(getattr(jst, f)).copy() for f in
                                ("ins_u", "ins_v", "del_u", "del_v")))
    sj2, _ = jd.replay_batch(sj, jst)
    st2, _ = td.replay_batch(st, tst)
    assert_state(st2, sj2, "extra batch")
    assert_report(td.audit_forest(st2, tnt), jd.audit_forest(sj2, tnj),
                  "dirty exempt")
    cleared_t = dataclasses.replace(st2, dirty=torch.zeros_like(st2.dirty))
    cleared_j = dataclasses.replace(sj2, dirty=np.zeros(sj2.n_nodes, bool))
    rt = td.audit_forest(cleared_t, tnt)
    assert_report(rt, jd.audit_forest(cleared_j, tnj), "dirty cleared")
    assert not bool(rt.tour_fresh)


# ---- stream pollution and the sanitizer --------------------------------------

@functools.cache
def _streams(stream, seed):
    jg = jax_graphs.grid2d(8)
    g = Graph.from_reference_arrays(jg.n_nodes, np.asarray(jg.src),
                                    np.asarray(jg.dst), device="cpu")
    kw = dict(batch=16, seed=seed)
    if stream == "churn":
        kw["n_batches"] = 6
    return (jax_streams.STREAMS[stream](jg, **kw),
            streams.STREAMS[stream](g, **kw))


def _assert_batches(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        for f in ("ins_u", "ins_v", "del_u", "del_v"):
            x, y = getattr(a, f), getattr(b, f)
            assert np.asarray(x).dtype == np.asarray(y).dtype, (i, f)
            np.testing.assert_array_equal(x, y, err_msg=f"batch {i} {f}")


KINDS = [[k] for k in sorted(jd.POLLUTERS)] + [sorted(jd.POLLUTERS),
                                               list(jd.POLLUTERS)[::-1]]


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("kinds", KINDS, ids=lambda k: "+".join(k))
@pytest.mark.parametrize("stream", ["churn", "insert_heavy"])
def test_pollute_and_sanitize_match_reference(stream, kinds, seed):
    js, ts = _streams(stream, seed)
    pj = jd.pollute_stream(js, kinds, seed=seed)
    pt = td.pollute_stream(ts, kinds, seed=seed)
    assert pt.n_nodes == pj.n_nodes and pt.name == pj.name
    _assert_batches(pt.batches, pj.batches)
    total_j, total_t = {}, {}
    clean_j, clean_t = [], []
    for a, b in zip(pj.batches, pt.batches):
        cj, qj = jd.sanitize_batch(a, pj.n_nodes)
        ct, qt = td.sanitize_batch(b, pt.n_nodes)
        assert qt == qj
        clean_j.append(cj)
        clean_t.append(ct)
        jd.merge_quarantine(total_j, qj)
        td.merge_quarantine(total_t, qt)
    _assert_batches(clean_t, clean_j)
    assert total_t == total_j


def test_sanitizer_counters_and_safety():
    """The reference test's hand-made batch: one event of each category,
    rewritten to padding, and the clean batch applies."""
    js, ts = _streams("insert_heavy", 0)
    n = ts.n_nodes
    b = ts.batches[0]
    ins_u, ins_v = b.ins_u.copy(), b.ins_v.copy()
    del_u, del_v = b.del_u.copy(), b.del_v.copy()
    ins_u[0] = n + 7
    ins_u[1] = ins_v[1] = 3
    del_u[0], del_v[0] = -2, 5
    dirty = streams.StreamBatch(ins_u=ins_u, ins_v=ins_v, del_u=del_u,
                                del_v=del_v)
    clean, q = td.sanitize_batch(dirty, n)
    cj, qj = jd.sanitize_batch(
        jax_streams.StreamBatch(ins_u=ins_u, ins_v=ins_v, del_u=del_u,
                                del_v=del_v), n)
    assert q == qj == {"ins_out_of_range": 1, "ins_self_loop": 1,
                       "del_out_of_range": 1, "del_self_loop": 0}
    _assert_batches([clean], [cj])
    total = td.merge_quarantine({}, q)
    assert td.merge_quarantine(total, q)["ins_out_of_range"] == 2
    state = td.init_state(ts, device="cpu")
    state, _ = td.replay_batch(state, clean)
    assert bool(td.audit_forest(state).forest_ok)
