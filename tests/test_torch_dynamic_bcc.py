"""The port's incremental tour and BCC refresh against ``repro.dynamic``.

Both packages replay the same streams (from the same graph and seed) and
refresh after every batch, incrementally and from scratch; every field of
``TourNumbering`` and ``DynamicBCC`` (and its counts) must be equal to the
reference's of the same mode, and the port's incremental refresh equal to
its own full one. Then the derived counts of the 32 ``table4_dynamic`` and
``table5_dynamic_bcc`` smoke rows of ``BENCH_rst.json`` are reproduced on
the port by the same procedure the benchmarks follow. The reference runs
its plain path (``use_kernel=False``). Tolerance: bit-equal.
"""
import functools
import json
import pathlib

import numpy as np
import pytest

from repro import dynamic as jd
from repro.data import graphs as jax_graphs
from repro.data import streams as jax_streams
from repro_torch import dynamic as td
from repro_torch import obs
from repro_torch.core import Graph, tour_numbering
from repro_torch.data import graphs, streams

ROOT = pathlib.Path(__file__).resolve().parent.parent
GRAPHS = {
    "grid_12": lambda: jax_graphs.grid2d(12),
    "rmat_7": lambda: jax_graphs.rmat(7, edge_factor=4),
    "chain_256": lambda: jax_graphs.chain(256),
    "rmat_6": lambda: jax_graphs.rmat(6, edge_factor=4),
}
TOUR_FIELDS = ("pre", "size", "last", "comp", "parent")
BCC_FIELDS = ("parent", "pool_src", "pool_dst", "pool_valid", "tree_mask",
              "pre", "rep", "low", "high", "articulation", "bridge",
              "edge_bcc")
BCC_COUNTS = ("n_bcc", "aux_rounds", "seg_syncs", "dirty_count")


@functools.cache
def _graphs(name):
    jg = GRAPHS[name]()
    return jg, Graph.from_reference_arrays(jg.n_nodes, np.asarray(jg.src),
                                           np.asarray(jg.dst), device="cpu")


def _tour(tn) -> dict:
    return {f: np.asarray(getattr(tn, f)) for f in TOUR_FIELDS}


def _bcc(b) -> dict:
    out = {f: np.asarray(getattr(b, f)) for f in BCC_FIELDS}
    out.update({c: int(getattr(b, c)) for c in BCC_COUNTS})
    return out


def _assert_tour(want: dict, got, what):
    for f in TOUR_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), want[f],
                                      err_msg=f"{what} {f}")


def _assert_bcc(want: dict, got, what):
    for f in BCC_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), want[f],
                                      err_msg=f"{what} {f}")
    assert {c: getattr(got, c) for c in BCC_COUNTS} == \
        {c: want[c] for c in BCC_COUNTS}, what
    assert all(type(getattr(got, c)) is int for c in BCC_COUNTS)


@functools.cache
def _reference_refreshes(graph, stream, batch):
    """Per batch: the reference's incremental and full tour and BCC."""
    jg, _ = _graphs(graph)
    js = jax_streams.STREAMS[stream](jg, batch=batch, seed=0, n_batches=6)
    s = jd.init_state(js)
    tn, s = jd.refresh_tour(s, None)
    bcc = jd.refresh_bcc(s, None, tour=tn)
    out = [(_tour(tn), _bcc(bcc), None, None)]
    for b in js.batches:
        s, _ = jd.replay_batch(s, b)
        tn_full, _ = jd.refresh_tour(s, None, incremental=False)
        tn, s = jd.refresh_tour(s, tn)
        bcc_full = jd.refresh_bcc(s, None, tour=tn_full, incremental=False)
        bcc = jd.refresh_bcc(s, bcc, tour=tn)
        out.append((_tour(tn), _bcc(bcc), _tour(tn_full), _bcc(bcc_full)))
    return tuple(out)


@pytest.mark.parametrize("batch", [4, 16])
@pytest.mark.parametrize("stream", sorted(streams.STREAMS))
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_refresh_matches_reference(graph, stream, batch):
    _, g = _graphs(graph)
    ts = streams.STREAMS[stream](g, batch=batch, seed=0, n_batches=6)
    want = _reference_refreshes(graph, stream, batch)
    s = td.init_state(ts, device="cpu")
    tn, s = td.refresh_tour(s, None)
    bcc = td.refresh_bcc(s, None, tour=tn)
    _assert_tour(want[0][0], tn, "seed")
    _assert_bcc(want[0][1], bcc, "seed")
    for i, b in enumerate(ts.batches):
        s, _ = td.replay_batch(s, b)
        tn_full, s_full = td.refresh_tour(s, None, incremental=False)
        assert not s_full.dirty.any()
        tn, s = td.refresh_tour(s, tn)
        assert not s.dirty.any() and s.parent is s_full.parent
        bcc_full = td.refresh_bcc(s, None, tour=tn_full, incremental=False)
        bcc = td.refresh_bcc(s, bcc, tour=tn)
        w_tn, w_bcc, w_tn_full, w_bcc_full = want[i + 1]
        _assert_tour(w_tn, tn, f"batch {i} incremental")
        _assert_tour(w_tn_full, tn_full, f"batch {i} full")
        _assert_bcc(w_bcc, bcc, f"batch {i} incremental")
        _assert_bcc(w_bcc_full, bcc_full, f"batch {i} full")
        # Incremental and full agree but for the recomputed-vertex count.
        _assert_tour(_tour(tn_full), tn, f"batch {i} incremental vs full")
        assert bcc_full.dirty_count == g.n_nodes
        assert bcc.dirty_count <= g.n_nodes


def test_refresh_bcc_without_tour_computes_one():
    _, g = _graphs("rmat_6")
    ts = streams.churn(g, batch=16, n_batches=3)
    s = td.init_state(ts, device="cpu")
    for b in ts.batches:
        s, _ = td.replay_batch(s, b)
    with obs.SyncLedger() as led:
        got = td.refresh_bcc(s, None)
    want = td.refresh_bcc(s, None, tour=tour_numbering(s.parent))
    _assert_bcc(_bcc(want), got, "tour=None")
    assert set(led.totals()) == {"refresh_tour", "refresh_bcc"}
    assert led.total("refresh_bcc") == got.seg_syncs + got.aux_rounds


# ---- the table4_dynamic / table5_dynamic_bcc smoke rows ------------------------

def _smoke_rows() -> dict:
    rows = json.loads((ROOT / "BENCH_rst.json").read_text())
    out = {}
    for r in rows:
        name = r.get("name", "")
        if name.startswith(("table4_dynamic/smoke_",
                            "table5_dynamic_bcc/smoke_")):
            out[name] = dict(kv.split("=") for kv in r["derived"].split(";"))
    return out


SMOKE_GRAPHS = {"smoke_chain_256": lambda: graphs.chain(256, device="cpu"),
                "smoke_rmat_6": lambda: graphs.rmat(6, edge_factor=4, seed=0,
                                                    device="cpu")}
SMOKE_CONFIGS = [(g, s, b) for g in SMOKE_GRAPHS
                 for s in ("sliding_window", "churn") for b in (4, 16)]


def smoke_counts(g, stream, batch) -> dict:
    """The derived counts of one configuration's four smoke rows, by the
    benchmarks' procedure: 5 warm batches, refresh, then the 6th batch
    incrementally (replay, incremental tour, incremental BCC) and from
    scratch (replay, full numbering, full BCC)."""
    s_ = streams.STREAMS[stream](g, batch=batch, seed=0, n_batches=6)
    state = td.init_state(s_, device=g.device)
    for b in s_.batches[:-1]:
        state, _ = td.replay_batch(state, b)
    tn, state = td.refresh_tour(state, None)
    bcc = td.refresh_bcc(state, None, tour=tn)
    b = s_.batches[-1]

    s2, stats = td.replay_batch(state, b)
    with obs.SyncLedger() as led_i:
        tn2, s2 = td.refresh_tour(s2, tn, incremental=True)
        bcc_i = td.refresh_bcc(s2, bcc, tour=tn2, incremental=True)
    s3, _ = td.replay_batch(state, b)
    with obs.SyncLedger() as led_f:
        bcc_f = td.refresh_bcc(s3, None, tour=tour_numbering(s3.parent),
                               incremental=False)
    live = int(s3.n_live_edges)
    out = {"table4/incremental": {"rounds": stats["rounds"], "live": live},
           "table4/recompute": {"live": live}}
    for tag, bc, led in (("incremental", bcc_i, led_i),
                         ("recompute", bcc_f, led_f)):
        assert led.total("refresh_bcc") == bc.seg_syncs + bc.aux_rounds
        out[f"table5/{tag}"] = {
            "sync_total": led.total("refresh_bcc"),
            "seg_syncs": bc.seg_syncs, "aux_rounds": bc.aux_rounds,
            "dirty": bc.dirty_count, "n_bcc": bc.n_bcc,
            "bridges": int(bc.n_bridges)}
    return out


@pytest.mark.parametrize("graph,stream,batch", SMOKE_CONFIGS)
def test_smoke_rows_counts(graph, stream, batch):
    rows = _smoke_rows()
    got = smoke_counts(SMOKE_GRAPHS[graph](), stream, batch)
    for table, prefix in (("table4", "table4_dynamic"),
                          ("table5", "table5_dynamic_bcc")):
        for tag in ("incremental", "recompute"):
            want = rows[f"{prefix}/{graph}/{stream}/b{batch}/{tag}"]
            counts = got[f"{table}/{tag}"]
            assert {k: str(v) for k, v in counts.items()} == \
                {k: want[k] for k in counts}, (table, tag)
    assert len(rows) == 32
