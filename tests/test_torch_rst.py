"""The GConn + Euler slice of the port against ``repro``, bit for bit.

Every graph is built once by ``repro.data.graphs`` and carried over with
``Graph.from_reference_arrays`` (same half-edge ids). The JAX pipeline runs
with ``use_kernel=False`` and with ``use_kernel=True`` (Pallas interpret
mode); the port runs on the CPU. Compared: parent, rep, rounds,
forest_mask, list-ranking syncs, tree depth, tour numbering and
``validate_rst``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import connected_components as jax_cc
from repro.core import rooted_spanning_tree as jax_rst
from repro.core.euler import _tour_successors as jax_tour_successors
from repro.core.euler import euler_tour_root as jax_euler
from repro.core.euler import tour_numbering as jax_tour_numbering
from repro.core.graph import Graph as JaxGraph
from repro.core.rst import tree_depth as jax_tree_depth
from repro.core.validate import validate_rst as jax_validate
from repro.data import graphs as jax_graphs
from repro_torch.core import (METHODS, Graph, components_reference,
                              connected_components, count_components,
                              rooted_spanning_tree, tour_numbering,
                              tree_depth, validate_rst)
from repro_torch.core.euler import _lexsort_edges, _tour_successors


def _same(jax_arr, t: torch.Tensor):
    np.testing.assert_array_equal(np.asarray(jax_arr), t.numpy())


def _disconnected():
    """Two components (a path and a small random graph) plus isolated
    vertices 30..39."""
    rng = np.random.default_rng(5)
    path = np.stack([np.arange(0, 9), np.arange(1, 10)], 1)
    blob = rng.integers(10, 30, (60, 2))
    blob = np.concatenate([blob, np.stack([np.arange(10, 29),
                                           np.arange(11, 30)], 1)])
    return JaxGraph.from_numpy_undirected(40, np.concatenate([path, blob]))


GRAPHS = {
    "chain_256": lambda: jax_graphs.chain(256),
    "grid_16": lambda: jax_graphs.grid2d(16),
    "rmat_8": lambda: jax_graphs.rmat(8, edge_factor=4),
    "er_500": lambda: jax_graphs.erdos_renyi(500),
    "ba_300": lambda: jax_graphs.pref_attach(300),
    "disconnected_40": _disconnected,
}


def _port(jg) -> Graph:
    return Graph.from_reference_arrays(jg.n_nodes, np.asarray(jg.src),
                                       np.asarray(jg.dst), device="cpu")


def _jax_forest(jg, root, use_kernel=False):
    """``repro.core.rst.gconn_euler_rst`` up to the rooting: the compacted
    forest slots ``(fu, fv, valid, comp_root)``."""
    n, m2 = jg.n_nodes, jg.src.shape[0]
    rep, forest_mask, _ = jax_cc(jg, use_kernel=use_kernel)
    slots = jnp.nonzero(forest_mask, size=max(n - 1, 1), fill_value=m2)[0]
    valid = slots < m2
    fu = jnp.where(valid, jg.src[jnp.clip(slots, 0, m2 - 1)], n)
    fv = jnp.where(valid, jg.dst[jnp.clip(slots, 0, m2 - 1)], n)
    return fu, fv, valid, jnp.where(rep == rep[root], root, rep)


def _jax_rank_syncs(jg, root, use_kernel):
    """The list-ranking syncs of the reference pipeline (its RSTResult does
    not carry them)."""
    return int(jax_euler(jg.n_nodes, *_jax_forest(jg, root, use_kernel),
                         use_kernel=use_kernel, return_syncs=True)[1])


@pytest.mark.parametrize("name", list(GRAPHS))
@pytest.mark.parametrize("root_pick", ["zero", "nonzero"])
def test_gconn_euler_matches_jax(name, root_pick):
    jg = GRAPHS[name]()
    g = _port(jg)
    root = 0 if root_pick == "zero" else jg.n_nodes // 3 + 1
    r = rooted_spanning_tree(g, root, "gconn_euler", device="cpu")
    _, jax_forest, _ = jax_cc(jg)
    for use_kernel in (False, True):
        jr = jax_rst(jg, root, "gconn_euler", use_kernel=use_kernel)
        _same(jr.parent, r.parent)
        _same(jr.rep, r.rep)
        assert r.steps == int(jr.steps)
        assert r.rank_syncs == _jax_rank_syncs(jg, root, use_kernel)
    _same(jax_forest, r.forest_mask)
    assert tree_depth(r.parent) == int(jax_tree_depth(jr.parent))
    assert validate_rst(g, r.parent, root, connected=False) == jax_validate(
        jg, jr.parent, root, connected=False)
    assert validate_rst(g, r.parent, root, connected=False)["all_ok"]
    np.testing.assert_array_equal(
        components_reference(g)[r.rep.numpy()], components_reference(g))
    assert count_components(r.rep) == len(set(components_reference(g)))


def test_lexsort_edges_matches_jnp_lexsort():
    """The packed-key stable sort gives jnp.lexsort's permutation, ties
    (the sentinel slots) included."""
    rng = np.random.default_rng(0)
    n = 50
    frm = rng.integers(0, n + 1, 400).astype(np.int32)
    to = rng.integers(0, n + 1, 400).astype(np.int32)
    frm[::7] = to[::7] = n
    want = jnp.lexsort((jnp.asarray(to), jnp.asarray(frm)))
    _same(want, _lexsort_edges(torch.from_numpy(frm), torch.from_numpy(to),
                               n))


@pytest.mark.parametrize("name", list(GRAPHS))
def test_tour_successors_match_jax(name):
    """The Euler lists, which carry the sort permutation's effect, are
    bit-equal before any ranking."""
    jg = GRAPHS[name]()
    root = jg.n_nodes // 4
    jax_args = _jax_forest(jg, root)
    jsucc, jvalid = jax_tour_successors(jg.n_nodes, *jax_args)
    succ, dvalid = _tour_successors(
        jg.n_nodes, *(torch.from_numpy(np.array(a)) for a in jax_args))
    _same(jsucc, succ)
    _same(jvalid, dvalid)


@pytest.mark.parametrize("name", list(GRAPHS))
def test_tour_numbering_matches_jax(name):
    jg = GRAPHS[name]()
    root = jg.n_nodes // 2
    parent = np.array(jax_rst(jg, root, "gconn_euler").parent)
    jtn, jsyncs = jax_tour_numbering(jnp.asarray(parent), return_syncs=True)
    tn, syncs = tour_numbering(torch.from_numpy(parent), return_syncs=True)
    for field in ("pre", "size", "last", "comp", "parent"):
        _same(getattr(jtn, field), getattr(tn, field))
    assert syncs == int(jsyncs)


@pytest.mark.parametrize("name", ["rmat_8", "er_500", "disconnected_40"])
@pytest.mark.parametrize("max_rounds", [None, 1])
def test_alternate_hooking_matches_jax(name, max_rounds):
    jg = GRAPHS[name]()
    jrep, jforest, jrounds = jax_cc(jg, alternate_hooking=True,
                                    max_rounds=max_rounds)
    rep, forest, rounds = connected_components(
        _port(jg), alternate_hooking=True, max_rounds=max_rounds)
    _same(jrep, rep)
    _same(jforest, forest)
    assert rounds == int(jrounds)


@pytest.mark.parametrize("make,rounds", [
    (lambda: jax_graphs.chain(256), 1),
    (lambda: jax_graphs.rmat(6, edge_factor=4), 2)])
def test_table1_smoke_rounds(make, rounds):
    """The ``table1/smoke_*`` rows of BENCH_rst.json: gconn_rounds."""
    assert rooted_spanning_tree(_port(make()), 0, device="cpu").steps == rounds


def test_validate_rst_rejects_broken_parents():
    jg = jax_graphs.grid2d(8)
    g = _port(jg)
    parent = rooted_spanning_tree(g, 0, device="cpu").parent.clone()
    parent[10], parent[11] = 11, 10          # a 2-cycle
    parent[20] = 63                          # not an edge of the grid
    got = validate_rst(g, parent, 0)
    assert got == jax_validate(jg, parent.numpy(), 0)
    assert not got["acyclic"] and not got["parent_edges_in_graph"]


@pytest.mark.parametrize("n", [2, 3])
def test_smallest_graphs_match_jax(n):
    jg = jax_graphs.chain(n)
    r = rooted_spanning_tree(_port(jg), n - 1, device="cpu")
    jr = jax_rst(jg, n - 1, "gconn_euler")
    _same(jr.parent, r.parent)
    assert r.steps == int(jr.steps)


def test_single_vertex_and_edgeless_graphs():
    """The reference crashes on these (a gather from an empty edge list);
    the port roots every vertex at itself."""
    for n in (1, 4):
        g = Graph.from_numpy_undirected(n, np.zeros((0, 2)), device="cpu")
        r = rooted_spanning_tree(g, 0, device="cpu")
        assert r.parent.tolist() == list(range(n))
        assert (r.steps, r.rank_syncs) == (0, 0)
        assert validate_rst(g, r.parent, 0, connected=n == 1)["all_ok"]


def test_other_methods_are_not_ported_yet():
    """Every method of METHODS runs through the entry point; any other
    name raises, and ``gconn_euler`` takes no method keyword."""
    g = _port(jax_graphs.chain(8))
    for method in METHODS:
        r = rooted_spanning_tree(g, 0, method, device="cpu")
        assert r.method == method
        assert r.parent.tolist() == [0, 0, 1, 2, 3, 4, 5, 6]
    with pytest.raises(ValueError, match="unknown method"):
        rooted_spanning_tree(g, 0, "dfs", device="cpu")
    with pytest.raises(TypeError, match="max_rounds"):
        rooted_spanning_tree(g, 0, "gconn_euler", device="cpu", max_rounds=1)
