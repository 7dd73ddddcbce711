"""The port's graph container and generators against ``repro``.

For the same arguments and seed every generator must give the same
half-edge arrays: edge ids decide which forest edges win, and so the tour.
"""
import numpy as np
import pytest
import torch

from repro.core.graph import Graph as JaxGraph
from repro.data import graphs as jax_graphs
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
