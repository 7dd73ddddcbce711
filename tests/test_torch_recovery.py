"""The port's repair ladder against ``repro.dynamic.recovery``, bit for bit.

On the reference test's churn steady state (grid2d(16)), every injector ×
seeds 1–3 goes through ``recover`` in both packages: the healed state,
tour numbering, BCC cache, the initial report and ``info`` (mode, reason,
counts) must be equal. ``repair_forest`` and ``rebuild_forest`` are held to
the reference's states and stats (host ints and 0-d tensors alike) and to
each other's partition; a forged odd cycle escalates to ``full``; a live
edge across two components fails the spanning check; the ``obs`` events
and ledger phases are the reference's. The 13
``table6_robustness/grid_32/*`` rows of ``BENCH_rst.json`` are reproduced by
``benchmarks/table6_robustness.py``'s procedure. Tolerance: bit-equal.
"""
import dataclasses
import functools
import json
import pathlib

import numpy as np
import pytest
import torch

from repro import dynamic as jd
from repro import obs as jax_obs
from repro.data import graphs as jax_graphs
from repro_torch import dynamic as td
from repro_torch import obs
from repro_torch.core import Graph, connected_components
from repro_torch.data import streams
from test_torch_chaos import (_steady, assert_bcc, assert_report,
                              assert_state, assert_tour)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SEEDS = (1, 2, 3)
STRUCTURAL = {name: name != "stale_bcc" for name in jd.INJECTORS}
REPAIR_STATS = ("rounds", "links", "severed", "repaired",
                "quarantined_slots", "sync_total")
REBUILD_STATS = ("cc_rounds", "rank_syncs", "quarantined_slots",
                 "sync_total")


def _canon(rep) -> np.ndarray:
    _, first, inverse = np.unique(np.asarray(rep), return_index=True,
                                  return_inverse=True)
    return np.argsort(np.argsort(first))[inverse]


def _info(info: dict) -> dict:
    return {k: v if isinstance(v, str) else int(v) for k, v in info.items()}


@functools.cache
def _reference_recover(name, seed):
    (sj, tnj, bj), _ = _steady()
    bad, bad_bcc, _ = jd.inject(name, sj, bj, seed=seed)
    with jax_obs.Tracer() as tr:
        out = jd.recover(bad, tnj, bad_bcc)
    return out, [(e["name"], e["args"]) for e in tr.events()], \
        tr.ledger.totals()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(jd.INJECTORS))
def test_recover_matches_reference(name, seed):
    _, (st, tnt, bt) = _steady()
    (fj, tnj, bcj, rj, ij), events_j, ledger_j = \
        _reference_recover(name, seed)
    bad, bad_bcc, _ = td.inject(name, st, bt, seed=seed)
    snap = {f: getattr(bad, f).clone() for f in
            ("parent", "rep", "pool_src", "pool_dst", "pool_valid",
             "tree_mask", "dirty")}
    with obs.Tracer() as tr:
        ft, tnt2, bct, rt, it = td.recover(bad, tnt, bad_bcc)
    assert it == _info(ij)
    assert it["mode"] in (("scoped", "full") if STRUCTURAL[name]
                          else ("refresh",))
    assert_state(ft, fj, (name, seed))
    assert_tour(tnt2, tnj, (name, seed))
    assert_bcc(bct, bcj, (name, seed))
    assert_report(rt, rj, (name, seed))
    assert [(e["name"], e["args"]) for e in tr.events()] == events_j
    assert tr.ledger.totals() == ledger_j
    assert bool(td.audit_forest(ft, tnt2, bct).healthy)
    for f, t in snap.items():
        assert torch.equal(getattr(bad, f), t), f


def test_recover_on_a_healthy_state_is_clean():
    (sj, tnj, bj), (st, tnt, bt) = _steady()
    ft, tn2, b2, rt, info = td.recover(st, tnt, bt)
    *_, ij = jd.recover(sj, tnj, bj)
    assert info == _info(ij) and info["mode"] == "clean"
    assert ft is st and tn2 is tnt and b2 is bt


def test_recover_through_reference_kernels():
    """The reference's ladder through its Pallas kernels (interpret mode)
    against the port's plain path, on two structural faults."""
    (sj, tnj, bj), (st, tnt, bt) = _steady()
    for name in ("parent_cycle", "pool_desync"):
        bad_j, bcc_j, _ = jd.inject(name, sj, bj, seed=2)
        bad_t, bcc_t, _ = td.inject(name, st, bt, seed=2)
        fj, tn_j, b_j, _, ij = jd.recover(bad_j, tnj, bcc_j, use_kernel=True)
        ft, tn_t, b_t, _, it = td.recover(bad_t, tnt, bcc_t)
        assert it == _info(ij)
        assert_state(ft, fj, name)
        assert_tour(tn_t, tn_j, name)
        assert_bcc(b_t, b_j, name)


@pytest.mark.parametrize("name", ["parent_bitflip", "parent_cycle",
                                  "tree_mask_desync", "pool_desync",
                                  "rep_corrupt"])
def test_repair_and_rebuild_match_reference(name):
    """Both rungs on the same fault: the reference's states and stats, the
    same partition, each passing a fresh audit."""
    (sj, _, bj), (st, _, bt) = _steady()
    bad_j, _, _ = jd.inject(name, sj, bj, seed=7)
    bad_t, _, _ = td.inject(name, st, bt, seed=7)
    rep_j, rep_t = jd.audit_forest(bad_j), td.audit_forest(bad_t)
    assert not bool(rep_t.forest_ok)
    with obs.SyncLedger() as led:
        fixed_t, rs_t = td.repair_forest(bad_t, rep_t)
        rebuilt_t, bs_t = td.rebuild_forest(bad_t)
    fixed_j, rs_j = jd.repair_forest(bad_j, rep_j)
    rebuilt_j, bs_j = jd.rebuild_forest(bad_j)
    assert_state(fixed_t, fixed_j, (name, "repair"))
    assert_state(rebuilt_t, rebuilt_j, (name, "rebuild"))
    assert {k: int(rs_t[k]) for k in REPAIR_STATS} == \
        {k: int(rs_j[k]) for k in REPAIR_STATS}
    assert {k: int(bs_t[k]) for k in REBUILD_STATS} == \
        {k: int(bs_j[k]) for k in REBUILD_STATS}
    assert isinstance(rs_t["rounds"], int)
    assert isinstance(rs_t["sync_total"], int)
    assert led.totals() == {"repair": rs_t["sync_total"],
                            "rebuild": bs_t["sync_total"]}
    assert bool(td.audit_forest(fixed_t).forest_ok)
    assert bool(td.audit_forest(rebuilt_t).forest_ok)
    assert np.array_equal(_canon(fixed_t.rep), _canon(rebuilt_t.rep))
    lg = td.live_graph(rebuilt_t)
    rep, _, _ = connected_components(lg)
    assert np.array_equal(_canon(rebuilt_t.rep), _canon(rep))


def _forged_odd_cycle(parent, src, dst, valid, tree):
    """The reference test's construction: a live path u - v - w closed into
    a 3-cycle by forging w → u onto a spare live non-tree slot, all three
    links tree-backed with a consistent cover."""
    parent, tree = parent.copy(), tree.copy()
    slot_of = {}
    for i, (a, b, ok) in enumerate(zip(src, dst, valid)):
        if ok:
            slot_of[(int(a), int(b))] = i
            slot_of[(int(b), int(a))] = i
    spare = np.flatnonzero(valid & ~tree)
    for (u, v), s1 in slot_of.items():
        if parent[u] != v:
            continue
        w = int(parent[v])
        if w in (u, v) or (v, w) not in slot_of:
            continue
        s2 = slot_of[(v, w)]
        forged = next((int(s) for s in spare if s not in (s1, s2)), None)
        if forged is None:
            continue
        parent[w] = u
        src2, dst2 = src.copy(), dst.copy()
        src2[forged], dst2[forged] = w, u
        tree[[s1, s2, forged]] = True
        return parent, src2, dst2, tree
    raise AssertionError("fixture lacks a forgeable path")


def test_forged_odd_cycle_escalates_to_full():
    (sj, _, _), (st, _, _) = _steady()
    parent, src, dst, tree = _forged_odd_cycle(
        st.parent.numpy(), st.pool_src.numpy(), st.pool_dst.numpy(),
        st.pool_valid.numpy(), st.tree_mask.numpy())
    bad_t = dataclasses.replace(
        st, parent=torch.from_numpy(parent), pool_src=torch.from_numpy(src),
        pool_dst=torch.from_numpy(dst), tree_mask=torch.from_numpy(tree))
    bad_j = dataclasses.replace(sj, parent=parent, pool_src=src,
                                pool_dst=dst, tree_mask=tree)
    rt = td.audit_forest(bad_t)
    assert not bool(rt.forest_ok)
    assert_report(rt, jd.audit_forest(bad_j), "forged")
    from repro_torch.dynamic.recovery import _post_sever_acyclic
    assert not bool(_post_sever_acyclic(bad_t, rt.sever))
    ft, tn, bcc, _, info = td.recover(bad_t)
    fj, tnj, bj, _, ij = jd.recover(bad_j)
    assert info == _info(ij)
    assert info["mode"] == "full" and info["reason"] == "sever_insufficient"
    assert_state(ft, fj, "forged")
    assert_tour(tn, tnj, "forged")
    assert_bcc(bcc, bj, "forged")
    assert bool(td.audit_forest(ft).forest_ok)


def test_spanning_check_and_its_repair():
    """A live non-tree edge redirected across two components fails the
    spanning verdict; the repair treats the two as one."""
    (sj, _, _), (st, _, _) = _steady()
    rep = st.rep.numpy()
    src, dst = st.pool_src.numpy().copy(), st.pool_dst.numpy().copy()
    valid, tree = st.pool_valid.numpy(), st.tree_mask.numpy()
    roots = np.unique(rep)
    s = int(np.flatnonzero(valid & ~tree)[0])
    dst[s] = roots[roots != rep[src[s]]][0]
    bad_t = dataclasses.replace(st, pool_src=torch.from_numpy(src),
                                pool_dst=torch.from_numpy(dst))
    bad_j = dataclasses.replace(sj, pool_src=src, pool_dst=dst)
    rt = td.audit_forest(bad_t)
    assert not bool(rt.spanning_ok) and not bool(rt.forest_ok)
    assert_report(rt, jd.audit_forest(bad_j), "spanning")
    ft, *_, info = td.recover(bad_t)
    fj, *_, ij = jd.recover(bad_j)
    assert info == _info(ij)
    assert_state(ft, fj, "spanning")
    assert bool(td.audit_forest(ft).forest_ok)
    rep_s, _, _ = connected_components(td.live_graph(ft))
    assert np.array_equal(_canon(ft.rep), _canon(rep_s))


def test_quarantine_of_out_of_range_pool_slots():
    """A live slot whose endpoint left [0, n) is quarantined by both rungs:
    invalidated, its ends set to the sentinel, and counted."""
    (sj, _, _), (st, _, _) = _steady()
    src = st.pool_src.numpy().copy()
    s = int(np.flatnonzero(st.pool_valid.numpy())[3])
    src[s] = st.n_nodes + 9
    bad_t = dataclasses.replace(st, pool_src=torch.from_numpy(src))
    bad_j = dataclasses.replace(sj, pool_src=src)
    rt, rj = td.audit_forest(bad_t), jd.audit_forest(bad_j)
    assert_report(rt, rj, "quarantine")
    fixed_t, rs_t = td.repair_forest(bad_t, rt)
    fixed_j, rs_j = jd.repair_forest(bad_j, rj)
    assert int(rs_t["quarantined_slots"]) == int(rs_j["quarantined_slots"])
    assert int(rs_t["quarantined_slots"]) == 1
    assert_state(fixed_t, fixed_j, "repair")
    rebuilt_t, bs_t = td.rebuild_forest(bad_t)
    rebuilt_j, _ = jd.rebuild_forest(bad_j)
    assert int(bs_t["quarantined_slots"]) == 1
    assert_state(rebuilt_t, rebuilt_j, "rebuild")


# ---- the table6_robustness/grid_32 rows ---------------------------------------

TABLE6_INJECTORS = ("parent_bitflip", "rep_corrupt", "tree_mask_desync")
TABLE6_COUNTS = (1, 4)


def _table6_rows() -> dict:
    rows = {}
    for r in json.loads((ROOT / "BENCH_rst.json").read_text()):
        if r.get("name", "").startswith("table6_robustness/grid_32/"):
            rows[r["name"]] = dict(kv.split("=")
                                   for kv in r["derived"].split(";"))
    assert len(rows) == 13
    return rows


@functools.cache
def _table6_state():
    """``table6_robustness._steady_state`` on grid_32: churn at batch 16,
    seed 0, the first 6 batches, a full tour and BCC."""
    jg = jax_graphs.grid2d(32)
    g = Graph.from_reference_arrays(jg.n_nodes, np.asarray(jg.src),
                                    np.asarray(jg.dst), device="cpu")
    stream = streams.STREAMS["churn"](g, batch=16, seed=0)
    state = td.init_state(stream, device="cpu")
    for b in stream.batches[:6]:
        state, _ = td.replay_batch(state, b)
    tn, state = td.refresh_tour(state, None)
    return state, tn, td.refresh_bcc(state, None, tour=tn)


def test_table6_audit_row():
    state, tn, bcc = _table6_state()
    want = _table6_rows()["table6_robustness/grid_32/audit"]
    with obs.SyncLedger() as led:
        report = td.audit_forest(state, tn, bcc)
    assert led.total("audit") == report.syncs
    assert {"syncs": str(led.total("audit")),
            "healthy": str(int(bool(report.healthy)))} == want


@pytest.mark.parametrize("k", TABLE6_COUNTS)
@pytest.mark.parametrize("injector", TABLE6_INJECTORS)
def test_table6_fault_rows(injector, k):
    """K effective injections from seed 1000·K (re-audited, the seed bumped
    until the damage sticks), then the scoped and full rows' counts."""
    state, _, bcc = _table6_state()
    bad, bad_bcc = state, bcc
    seed, landed, tries = 1000 * k, 0, 0
    while landed < k and tries < 16 * k:
        nxt, nxt_bcc, _ = td.inject(injector, bad, bad_bcc, seed=seed)
        seed += 1
        tries += 1
        if not bool(td.audit_forest(nxt).forest_ok):
            bad, bad_bcc = nxt, nxt_bcc
            landed += 1
    report = td.audit_forest(bad)
    assert not bool(report.forest_ok)
    with obs.SyncLedger() as led_s:
        fixed, rstats = td.repair_forest(bad, report)
    assert led_s.total("repair") == rstats["sync_total"]
    with obs.SyncLedger() as led_f:
        rebuilt, bstats = td.rebuild_forest(bad)
    assert led_f.total("rebuild") == bstats["sync_total"]
    assert bool(td.audit_forest(fixed).forest_ok)
    assert bool(td.audit_forest(rebuilt).forest_ok)
    assert np.array_equal(_canon(fixed.rep), _canon(rebuilt.rep))

    rows = _table6_rows()
    base = f"table6_robustness/grid_32/{injector}/f{k}"
    scoped = {"sync_total": led_s.total("repair"),
              "rounds": rstats["rounds"],
              "severed": int(rstats["severed"]),
              "repaired": int(rstats["repaired"]),
              "audit_syncs": report.syncs}
    full = {"sync_total": led_f.total("rebuild"),
            "cc_rounds": bstats["cc_rounds"],
            "rank_syncs": bstats["rank_syncs"]}
    assert {k_: str(v) for k_, v in scoped.items()} == rows[f"{base}/scoped"]
    assert {k_: str(v) for k_, v in full.items()} == rows[f"{base}/full"]
