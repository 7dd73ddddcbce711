"""Small parity gaps of the port, against the reference.

* ``repro_torch.core`` re-exports the query functions as
  ``repro.core`` does (``from repro_torch.core import lca`` works);
* the kernels' convenience entries over the engine
  (``pointer_jump.ops.pointer_jump_until_converged``,
  ``list_rank.ops.list_rank``, ``list_rank.ref.list_rank_full_ref``) give
  the reference's values on ``tests/test_kernels.py``'s inputs;
* the 8 ``table7_queries/smoke_*`` rows of ``BENCH_rst.json``:
  ``build_syncs`` after ``benchmarks/table7_queries.py``'s churn stream,
  ``serve_syncs`` 0 for the amortized reads (the ``obs`` ledger records
  nothing while they are served) and ``build_syncs`` a read batch when
  recomputed.
Tolerance: bit-equal.
"""
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jax_core
from repro.kernels.list_rank import ops as jax_lr_ops
from repro.kernels.list_rank import ref as jax_lr_ref
from repro.kernels.pointer_jump import ops as jax_pj_ops
from repro_torch import core, dynamic, obs
from repro_torch.core import queries
from repro_torch.data import graphs, streams
from repro_torch.kernels.list_rank.ops import list_rank
from repro_torch.kernels.list_rank.ref import list_rank_full_ref
from repro_torch.kernels.pointer_jump.ops import pointer_jump_until_converged

ROOT = pathlib.Path(__file__).resolve().parent.parent
QUERY_EXPORTS = ("connected", "depth_of", "edge_membership", "is_ancestor",
                 "lca", "path_agg", "subtree_agg")


@pytest.mark.parametrize("name", QUERY_EXPORTS)
def test_core_reexports_the_query_functions(name):
    assert getattr(core, name) is getattr(queries, name)
    assert name in core.__all__
    assert hasattr(jax_core, name)


def test_core_exports_every_name_of_the_reference():
    """Every public name ``repro.core`` exports, its ``distributed``
    module (the multi-rank connectivity) included."""
    import repro.core.distributed  # noqa: F401
    import repro_torch.core.distributed  # noqa: F401
    missing = [n for n in dir(jax_core) if not n.startswith("_")
               and n not in dir(core)]
    assert "distributed" in dir(jax_core) and missing == []


def test_pointer_jump_until_converged_deep_chain():
    n = 3000
    p = torch.from_numpy(np.maximum(np.arange(n) - 1, 0).astype(np.int32))
    out = pointer_jump_until_converged(p)
    assert (out == 0).all()


@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("n", [3, 64, 1025, 5000])
def test_pointer_jump_until_converged_matches_reference(n, k):
    rng = np.random.default_rng(n * 10 + k)
    below = (rng.random(n) * np.arange(n)).astype(np.int32)
    perm = rng.permutation(n).astype(np.int32)
    p = np.empty(n, np.int32)
    p[perm] = perm[below]                 # a relabelled random forest
    want = jax_pj_ops.pointer_jump_until_converged(jnp.asarray(p),
                                                   n_jumps=k)
    got = pointer_jump_until_converged(torch.from_numpy(p), n_jumps=k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _random_list(n, seed):
    perm = np.random.default_rng(seed).permutation(n)
    succ = np.full(n, -1, np.int32)
    for a, b in zip(perm[:-1], perm[1:]):
        succ[a] = b
    return succ


@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("n", [2, 129, 2048])
def test_list_rank_matches_reference(n, k):
    succ = _random_list(n, n + k)
    valid = np.ones(n, bool)
    valid[::7] = False
    want = jax_lr_ops.list_rank(jnp.asarray(succ), jnp.asarray(valid),
                                n_steps=k)
    want_full = jax_lr_ref.list_rank_full_ref(jnp.asarray(succ),
                                              jnp.asarray(valid))
    st, vt = torch.from_numpy(succ), torch.from_numpy(valid)
    got = list_rank(st, vt, n_steps=k)
    got_full = list_rank_full_ref(st, vt)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_full.numpy(), np.asarray(want_full))
    np.testing.assert_array_equal(got.numpy(), got_full.numpy())


def test_convenience_entries_refuse_the_kernel_on_the_cpu():
    p = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        pointer_jump_until_converged(p, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        list_rank(torch.tensor([1, 2, 3, -1], dtype=torch.int32),
                  torch.ones(4, dtype=torch.bool), use_kernel=True)


# ---- table7_queries/smoke_* ---------------------------------------------------

SMOKE_GRAPHS = {
    "smoke_chain_256": lambda: graphs.chain(256, device="cpu"),
    "smoke_rmat_6": lambda: graphs.rmat(6, edge_factor=4, seed=0,
                                        device="cpu"),
}
SCENARIOS = {"read_heavy": 8, "write_heavy": 1}
N_QUERIES = 256


def _table7_rows(graph) -> dict:
    rows = {}
    for r in json.loads((ROOT / "BENCH_rst.json").read_text()):
        if r.get("name", "").startswith(f"table7_queries/{graph}/"):
            rows[r["name"]] = dict(kv.split("=")
                                   for kv in r["derived"].split(";"))
    assert len(rows) == 4
    return rows


def _bundle(tables, u, v, payload):
    return (queries.lca(tables, u, v), queries.connected(tables, u, v),
            queries.subtree_agg(tables, u, payload, "add"),
            queries.path_agg(tables, u, v, payload, "min"))


@pytest.mark.parametrize("graph", sorted(SMOKE_GRAPHS))
def test_table7_smoke_rows(graph):
    """``table7_queries.py``'s procedure: churn at batch 32, 4 batches,
    seed 0, then a full tour; 256 seeded pairs a read batch."""
    g = SMOKE_GRAPHS[graph]()
    n = g.n_nodes
    stream = streams.STREAMS["churn"](g, batch=32, seed=0, n_batches=4)
    state = dynamic.init_state(stream, device="cpu")
    for b in stream.batches:
        state, _ = dynamic.replay_batch(state, b)
    tn, state = dynamic.refresh_tour(state, None)
    rng = np.random.default_rng(0)
    u = torch.from_numpy(rng.integers(0, n, N_QUERIES).astype(np.int32))
    v = torch.from_numpy(rng.integers(0, n, N_QUERIES).astype(np.int32))
    payload = torch.from_numpy(rng.integers(1, 100, n).astype(np.int32))
    with obs.SyncLedger() as led:
        tables = core.build_tables(tn)
    build_syncs = led.total("build_tables")
    assert build_syncs == tables.build_syncs

    rows = _table7_rows(graph)
    for scen, reads in SCENARIOS.items():
        with obs.SyncLedger() as amort:
            tables = core.build_tables(tn)
            with obs.SyncLedger() as serve:
                answers = [_bundle(tables, u, v, payload)
                           for _ in range(reads)]
        with obs.SyncLedger() as rec:
            tn2 = core.tour_numbering(state.parent)
            with obs.SyncLedger() as rec_build:
                again = _bundle(core.build_tables(tn2), u, v, payload)
        for a, b in zip(answers[0], again):
            assert torch.equal(a, b)
        assert amort.total() == build_syncs and serve.totals() == {}
        assert rec_build.total() == build_syncs
        assert rec.total() == build_syncs
        base = f"table7_queries/{graph}/{scen}"
        got = {f"{base}/amortized": {
            "reads_per_refresh": str(reads), "queries": str(N_QUERIES),
            "sync_per_read": f"{amort.total() / reads:.2f}",
            "serve_syncs": str(serve.total()),
            "build_syncs": str(build_syncs)},
            f"{base}/recompute": {
            "reads_per_refresh": str(reads), "queries": str(N_QUERIES),
            "sync_per_read": f"{rec_build.total():.2f}",
            "serve_syncs": str(rec_build.total()),
            "build_syncs": str(build_syncs)}}
        for name, derived in got.items():
            assert derived == rows[name], name
