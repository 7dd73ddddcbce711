"""The tree-query slice of the port against ``repro``, bit for bit.

Parent arrays are made with numpy from a seed: a random forest (several
components, one of them a 70-vertex path, relabelled ids), and the port's
GConn + Euler tree of a grid. Both sides number the tour and build
their tables; the port is also fed the reference's numbering and tables
through ``from_reference_arrays``. Queries include out-of-range ids (n, −1),
identical pairs and cross-component pairs, with int32 and float32
payloads. Tolerance: bit-equal. Float ``add`` aggregates are held on
integer-valued float32 payloads, whose sums are exact in any order:
``subtree_agg`` sums through a prefix sum, whose order of additions is the
library's own on each side.
"""
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import queries as jq
from repro.core.euler import tour_numbering as jax_tour_numbering
from repro_torch.core import (QueryTables, TourNumbering, build_tables,
                              queries, rooted_spanning_tree, tour_numbering)
from repro_torch.data import graphs

TN_FIELDS = ("pre", "size", "last", "comp", "parent")
TABLE_FIELDS = ("pre", "last", "comp", "parent", "depth", "up")
OPS = ("add", "min", "max")


def _random_forest(n, seed, path=70):
    """Random forest whose first ``path`` vertices form one path."""
    rng = np.random.default_rng(seed)
    p = (rng.random(n) * np.arange(n)).astype(np.int64)
    roots = rng.random(n) < 0.05
    p[roots] = np.arange(n)[roots]
    p[:path] = np.maximum(np.arange(path) - 1, 0)
    p[path] = path
    perm = rng.permutation(n)
    q = np.empty(n, np.int64)
    q[perm] = perm[p]
    return q.astype(np.int32)


def _grid_tree():
    g = graphs.grid2d(9, device="cpu")
    return rooted_spanning_tree(g, 40, "gconn_euler",
                                device="cpu").parent.numpy()


PARENTS = {
    "forest_300": lambda: _random_forest(300, 1),
    "grid_9_tree": _grid_tree,
}


@functools.cache
def _case(name):
    """(parent, reference numbering, reference tables, port numbering,
    port tables), each built once."""
    parent = PARENTS[name]()
    jtn = jax_tour_numbering(jnp.asarray(parent))
    tn = tour_numbering(torch.from_numpy(parent.copy()))
    return parent, jtn, jq.build_tables(jtn), tn, build_tables(tn)


def _pairs(parent, seed):
    """Random pairs, an identical pair, invalid ids and cross-component
    pairs (when the forest has two components)."""
    n = parent.size
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n, 40).tolist()
    v = rng.integers(0, n, 40).tolist()
    w = int(rng.integers(0, n))
    u += [w, 0, n, -1, n, -1]
    v += [w, n, 0, 2 % n, -1, n]
    roots = np.nonzero(parent == np.arange(n))[0]
    if roots.size >= 2:
        verts = np.arange(n)
        # A vertex's root by repeated parent steps.
        r = verts.copy()
        for _ in range(n):
            r = parent[r]
        a = verts[r == roots[0]]
        b = verts[r == roots[1]]
        u += rng.choice(a, 4).tolist()
        v += rng.choice(b, 4).tolist()
    return np.asarray(u, np.int32), np.asarray(v, np.int32)


def _payload(n, dtype, op, seed):
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return rng.integers(-100, 100, n).astype(np.int32)
    if op == "add":
        return rng.integers(-100, 100, n).astype(np.float32)
    return rng.standard_normal(n).astype(np.float32)


def _same(jax_arr, t: torch.Tensor, msg=""):
    np.testing.assert_array_equal(np.asarray(jax_arr), t.numpy(),
                                  err_msg=msg)


@pytest.mark.parametrize("name", sorted(PARENTS))
def test_tour_numbering_and_tables_match_jax(name):
    parent, jtn, jtab, tn, tab = _case(name)
    for f in TN_FIELDS:
        _same(getattr(jtn, f), getattr(tn, f), f)
    for f in TABLE_FIELDS:
        _same(getattr(jtab, f), getattr(tab, f), f)
    assert tab.build_syncs == int(jtab.build_syncs)
    assert tab.levels == jtab.levels and tab.n_nodes == jtab.n_nodes
    carried = QueryTables.from_reference_arrays(
        *(np.asarray(getattr(jtab, f)) for f in TABLE_FIELDS),
        jtab.build_syncs, device="cpu")
    for f in TABLE_FIELDS:
        assert torch.equal(getattr(carried, f), getattr(tab, f)), f
    assert carried.build_syncs == tab.build_syncs
    fed = TourNumbering.from_reference_arrays(
        *(np.asarray(getattr(jtn, f)) for f in TN_FIELDS), device="cpu")
    assert build_tables(fed).build_syncs == tab.build_syncs


@pytest.mark.parametrize("name", sorted(PARENTS))
def test_predicates_lca_and_depth_match_jax(name):
    parent, _jtn, jtab, _tn, tab = _case(name)
    u, v = _pairs(parent, 3)
    ju, jv = jnp.asarray(u), jnp.asarray(v)
    tu, tv = torch.from_numpy(u), torch.from_numpy(v)
    _same(jq.connected(jtab, ju, jv), queries.connected(tab, tu, tv))
    _same(jq.depth_of(jtab, ju), queries.depth_of(tab, tu))
    _same(jq.is_ancestor(jtab, ju, jv), queries.is_ancestor(tab, tu, tv))
    _same(jq.is_ancestor(jtab, jv, ju), queries.is_ancestor(tab, tv, tu))
    lca = queries.lca(tab, tu, tv)
    assert lca.dtype == torch.int32
    _same(jq.lca(jtab, ju, jv), lca)
    assert (lca[41:46] == -1).all()       # invalid ids
    if name == "forest_300":              # cross-component pairs
        assert (lca[-4:] == -1).all()


@pytest.mark.parametrize("name", sorted(PARENTS))
@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("op", OPS)
def test_aggregates_match_jax(name, dtype, op):
    parent, _jtn, jtab, _tn, tab = _case(name)
    u, v = _pairs(parent, 5)
    pay = _payload(parent.size, dtype, op, 11)
    ju, jv, jp = jnp.asarray(u), jnp.asarray(v), jnp.asarray(pay)
    tu, tv, tp = (torch.from_numpy(u), torch.from_numpy(v),
                  torch.from_numpy(pay))
    sub = queries.subtree_agg(tab, tu, tp, op)
    assert sub.dtype == tp.dtype
    _same(jq.subtree_agg(jtab, ju, jp, op), sub, "subtree_agg")
    path = queries.path_agg(tab, tu, tv, tp, op)
    assert path.dtype == tp.dtype
    _same(jq.path_agg(jtab, ju, jv, jp, op), path, "path_agg")
    if op != "add":
        assert torch.equal(sub, queries.subtree_agg(tab, tu, tp, op,
                                                    use_kernel=False))


def test_edge_membership_matches_jax():
    rng = np.random.default_rng(2)
    n, e, b = 30, 80, 50
    es = rng.integers(0, n, e).astype(np.int32)
    ed = rng.integers(0, n, e).astype(np.int32)
    valid = rng.random(e) < 0.8
    flags = rng.random(e) < 0.3
    qu = np.concatenate([ed[:20], rng.integers(-1, n + 1, b - 20)]
                        ).astype(np.int32)
    qv = np.concatenate([es[:20], rng.integers(-1, n + 1, b - 20)]
                        ).astype(np.int32)
    want = jq.edge_membership(*(jnp.asarray(a)
                                for a in (qu, qv, es, ed, valid, flags)))
    got = queries.edge_membership(*(torch.from_numpy(a)
                                    for a in (qu, qv, es, ed, valid, flags)))
    _same(want[0], got[0])
    _same(want[1], got[1])
    assert bool(got[0][:20][valid[:20]].all())


def test_lca_goldens():
    """A path and a star, as in tests/test_queries.py."""
    t = build_tables(tour_numbering(torch.tensor([0, 0, 1, 2, 3],
                                                 dtype=torch.int32)))
    assert queries.lca(t, torch.tensor([4, 2, 0]),
                       torch.tensor([2, 3, 4])).tolist() == [2, 2, 0]
    assert queries.depth_of(t, torch.arange(5)).tolist() == [0, 1, 2, 3, 4]
    t = build_tables(tour_numbering(torch.zeros(5, dtype=torch.int32)))
    assert queries.lca(t, torch.tensor([1, 2, 3]),
                       torch.tensor([2, 3, 3])).tolist() == [0, 0, 3]
