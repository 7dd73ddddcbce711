"""The port's graph container and generators against ``repro``.

For the same arguments and seed every generator must give the same
half-edge arrays: edge ids decide which forest edges win, and so the tour.
``build_suite``, ``build_csr``, ``degrees`` and ``bfs_depths_reference``
are bit-equal to the reference's on the suite's graphs.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.graph import Graph as JaxGraph
from repro.core.graph import build_csr as jax_build_csr
from repro.core.graph import degrees as jax_degrees
from repro.core.validate import (bfs_depths_reference as
                                 jax_bfs_depths_reference)
from repro.data import graphs as jax_graphs
from repro_torch.core import bfs_depths_reference, build_csr, degrees
from repro_torch.core.graph import Graph
from repro_torch.data import graphs

SMALL = {
    "chain": dict(n=300),
    "grid2d": dict(side=12),
    "erdos_renyi": dict(n=400, avg_degree=6),
    "rmat": dict(scale=7, edge_factor=4),
    "pref_attach": dict(n=200, m_per=3),
}


def _same_graph(jg, g: Graph):
    assert g.n_nodes == jg.n_nodes
    assert g.src.dtype == g.dst.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(jg.src), g.src.numpy())
    np.testing.assert_array_equal(np.asarray(jg.dst), g.dst.numpy())


@pytest.mark.parametrize("name", list(SMALL))
@pytest.mark.parametrize("seed", [0, 3])
def test_generators_match_jax(name, seed):
    kwargs = dict(SMALL[name], seed=seed)
    _same_graph(getattr(jax_graphs, name)(**kwargs),
                getattr(graphs, name)(**kwargs, device="cpu"))


@pytest.mark.parametrize("name", list(jax_graphs.SUITE))
def test_suite_matches_jax(name):
    _same_graph(jax_graphs.resolve_graph(name),
                graphs.resolve_graph(name, device="cpu"))


@pytest.mark.parametrize("name", ["chain_50", "grid_9", "rmat_6", "er_80"])
def test_parametric_names_match_jax(name):
    _same_graph(jax_graphs.resolve_graph(name, seed=2),
                graphs.resolve_graph(name, seed=2, device="cpu"))


def test_suite_keys_match_jax():
    assert list(graphs.SUITE) == list(jax_graphs.SUITE)
    for key, (factory, kwargs, regime) in graphs.SUITE.items():
        jf, jkwargs, jregime = jax_graphs.SUITE[key]
        assert (factory.__name__, kwargs, regime) == (jf.__name__, jkwargs,
                                                      jregime)
    with pytest.raises(ValueError, match="unknown graph"):
        graphs.resolve_graph("torus_5", device="cpu")


def test_from_numpy_undirected_dedupes_like_jax():
    edges = np.array([(0, 1), (1, 0), (2, 2), (3, 1), (1, 3), (4, 0)])
    jg = JaxGraph.from_numpy_undirected(5, edges)
    g = Graph.from_numpy_undirected(5, edges, device="cpu")
    _same_graph(jg, g)
    assert g.n_edges == 3
    e = torch.arange(g.n_half_edges)
    assert torch.equal(g.rev(g.rev(e)), e)
    assert torch.equal(g.src[g.rev(e)], g.dst)


def test_from_reference_arrays_keeps_half_edge_ids():
    jg = jax_graphs.erdos_renyi(60, seed=1)
    g = Graph.from_reference_arrays(jg.n_nodes, np.asarray(jg.src),
                                    np.asarray(jg.dst), device="cpu")
    _same_graph(jg, g)
    with pytest.raises(ValueError, match="outside"):
        Graph.from_reference_arrays(3, np.array([0, 5]), np.array([5, 0]),
                                    device="cpu")


def test_empty_edge_list():
    g = Graph.from_numpy_undirected(4, np.zeros((0, 2)), device="cpu")
    assert g.n_half_edges == 0 and g.src.dtype == torch.int32


# The public functions of the ported modules that came after them (ROADMAP
# §1 A): each bit-equal to the reference's, values and dtypes, on every
# suite graph.

@functools.cache
def _suites():
    return jax_graphs.build_suite(), graphs.build_suite(device="cpu")


def _bit_equal(got, want):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_build_suite_matches_jax():
    theirs, mine = _suites()
    assert list(mine) == list(theirs) == list(jax_graphs.SUITE)
    for name in theirs:
        _same_graph(theirs[name], mine[name])
    some = graphs.build_suite(["grid_64", "chain_4k"], device="cpu")
    assert list(some) == ["grid_64", "chain_4k"]


@pytest.mark.parametrize("name", list(jax_graphs.SUITE))
def test_build_csr_and_degrees_match_jax(name):
    theirs, mine = _suites()
    for got, want in zip(build_csr(mine[name]), jax_build_csr(theirs[name])):
        _bit_equal(got, want)
    g = mine[name]
    _bit_equal(degrees(g.src, g.n_nodes),
               jax_degrees(theirs[name].src, g.n_nodes))


def test_build_csr_ties_keep_half_edge_order():
    """Parallel half-edges (same src and dst) keep their ids' order, as the
    reference's stable lexsort keeps them; ``degrees`` of ids outside
    [0, n) as ``jnp.bincount(length=n)`` counts them."""
    u, v = np.array([2, 0, 2, 1, 2]), np.array([1, 2, 1, 0, 0])
    jg = JaxGraph.from_undirected(3, jnp.asarray(u, jnp.int32),
                                  jnp.asarray(v, jnp.int32))
    g = Graph.from_undirected(3, u, v, device="cpu")
    for got, want in zip(build_csr(g), jax_build_csr(jg)):
        _bit_equal(got, want)
    ids = [0, 3, 1, -1, 1, 7]
    _bit_equal(degrees(torch.tensor(ids, dtype=torch.int32), 3),
               jax_degrees(jnp.asarray(ids, jnp.int32), 3))


@pytest.mark.parametrize("name", list(jax_graphs.SUITE))
def test_bfs_depths_reference_matches_jax(name):
    theirs, mine = _suites()
    root = mine[name].n_nodes // 3
    _bit_equal(bfs_depths_reference(mine[name], root),
               jax_bfs_depths_reference(theirs[name], root))


def test_bfs_depths_reference_marks_unreached():
    edges = np.array([(0, 1), (1, 2), (3, 4)])
    want = jax_bfs_depths_reference(JaxGraph.from_numpy_undirected(6, edges),
                                    1)
    got = bfs_depths_reference(Graph.from_numpy_undirected(6, edges,
                                                           device="cpu"), 1)
    _bit_equal(got, want)
    assert got.tolist() == [1, 0, 1, -1, -1, -1]
