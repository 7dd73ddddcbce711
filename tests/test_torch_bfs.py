"""The BFS flavor of the port against ``repro``, bit for bit.

Graphs are the ``GRAPHS`` set of ``test_torch_rst.py`` (and, for the level
by level check, stars whose hub takes 10^4 proposals), built by
``repro.data.graphs`` or ``repro.core.graph.Graph`` and carried over with
``Graph.from_reference_arrays``. The JAX BFS runs with ``use_kernel=False``
and with ``use_kernel=True`` (the Pallas ``frontier_relax`` kernel in
interpret mode); the port runs on the CPU, where ``bfs_level`` runs its
plain version. Compared: parent, dist and levels. Tolerance: bit-equal
(every output is an integer).
"""
import numpy as np
import pytest
import torch

from repro.core import bfs_rst as jax_bfs
from repro.core import rooted_spanning_tree as jax_rst
from repro.core.graph import Graph as JaxGraph
from repro.core.validate import bfs_depths_reference
from repro.data import graphs as jax_graphs
from repro_torch.core import bfs_rst, rooted_spanning_tree, validate_rst
from repro_torch.core.bfs import INF32
from repro_torch.kernels.frontier_relax.ops import (bfs_level,
                                                    bfs_level_buffer,
                                                    frontier_relax)
from test_torch_rst import GRAPHS, _port, _same


@pytest.mark.parametrize("name", list(GRAPHS))
@pytest.mark.parametrize("root_pick", ["zero", "nonzero", "last"])
def test_bfs_matches_jax(name, root_pick):
    jg = GRAPHS[name]()
    g = _port(jg)
    n = jg.n_nodes
    root = {"zero": 0, "nonzero": n // 3 + 1, "last": n - 1}[root_pick]
    r = rooted_spanning_tree(g, root, "bfs", device="cpu")
    for use_kernel in (False, True):
        jr = jax_rst(jg, root, "bfs", use_kernel=use_kernel)
        _same(jr.parent, r.parent)
        _same(jr.dist, r.dist)
        assert r.steps == int(jr.steps)
    # Unreachable vertices keep parent -1 and dist INF32; the rest are
    # at their BFS depth from the root.
    depth = bfs_depths_reference(jg, root)
    reach = depth >= 0
    np.testing.assert_array_equal(r.dist.numpy()[reach], depth[reach])
    assert (r.dist.numpy()[~reach] == INF32).all()
    assert (r.parent.numpy()[~reach] == -1).all()
    assert r.steps == depth.max()
    if reach.all():
        assert validate_rst(g, r.parent, root)["all_ok"]


@pytest.mark.parametrize("name", ["chain_256", "grid_16", "disconnected_40"])
@pytest.mark.parametrize("max_levels", [0, 1, 3, 10])
def test_bfs_max_levels_matches_jax(name, max_levels):
    jg = GRAPHS[name]()
    parent, dist, levels = bfs_rst(_port(jg), 5, max_levels=max_levels)
    jp, jd, jl = jax_bfs(jg, 5, max_levels=max_levels)
    _same(jp, parent)
    _same(jd, dist)
    assert levels == int(jl)


def _star(leaves, hubs):
    """``hubs`` hubs (vertices 0..hubs-1), each joined to every one of
    ``leaves`` leaves: from a hub, the leaves make the next level and every
    leaf proposes each other hub."""
    hub = np.repeat(np.arange(hubs), leaves)
    leaf = np.tile(np.arange(hubs, hubs + leaves), hubs)
    return JaxGraph.from_numpy_undirected(hubs + leaves,
                                          np.stack([hub, leaf], 1))


LEVEL_GRAPHS = {
    "grid_16": GRAPHS["grid_16"],
    "rmat_8": GRAPHS["rmat_8"],
    "disconnected_40": GRAPHS["disconnected_40"],
    "star_10k": lambda: _star(10_000, 1),
    "two_hub_star_10k": lambda: _star(10_000, 2),
}


@pytest.mark.parametrize("name", list(LEVEL_GRAPHS))
@pytest.mark.parametrize("root_pick", ["zero", "last"])
def test_bfs_level_matches_jax_level_by_level(name, root_pick):
    """``bfs_level`` (its plain version on the CPU), one level at a time,
    against the reference cut after the same number of levels
    (``max_levels``, plain and Pallas paths) and against the BFS depths:
    after level L every vertex of depth <= L + 1 has its depth, the rest
    INF32, and the flag says whether level L found a vertex."""
    jg = LEVEL_GRAPHS[name]()
    g = _port(jg)
    n = jg.n_nodes
    root = {"zero": 0, "last": n - 1}[root_pick]
    depth = bfs_depths_reference(jg, root)
    deepest = int(depth.max())
    dist = torch.full((n,), INF32, dtype=torch.int32)
    dist[root] = 0
    parent = torch.full((n,), -1, dtype=torch.int32)
    parent[root] = root
    cand = bfs_level_buffer(n, "cpu")
    cuts = {1, max(2, deepest // 2), deepest + 1}
    for level in range(deepest + 1):
        changed = bfs_level(dist, parent, cand, g.src, g.dst, level)
        assert changed == (level < deepest)
        want = np.where((depth >= 0) & (depth <= level + 1), depth, INF32)
        np.testing.assert_array_equal(dist.numpy(), want)
        if level + 1 in cuts:
            for use_kernel in (False, True):
                jp, jd, jl = jax_bfs(jg, root, max_levels=level + 1,
                                     use_kernel=use_kernel)
                _same(jp, parent)
                _same(jd, dist)
                assert int(jl) == level
    if name == "two_hub_star_10k" and root_pick == "zero":
        # The second hub's parent: the smallest of 10^4 proposing leaves.
        assert int(parent[1]) == 2


@pytest.mark.parametrize("make,levels", [
    (lambda: jax_graphs.chain(256), 255),
    (lambda: jax_graphs.rmat(6, edge_factor=4), 3)])
def test_table1_smoke_bfs_steps(make, levels):
    """The ``table1/smoke_*`` rows of BENCH_rst.json: bfs_steps, and the
    tree bit-equal to the reference's."""
    jg = make()
    r = rooted_spanning_tree(_port(jg), 0, "bfs", device="cpu")
    assert r.steps == levels
    jr = jax_rst(jg, 0, "bfs")
    _same(jr.parent, r.parent)
    _same(jr.dist, r.dist)
    assert r.steps == int(jr.steps)


def test_bfs_on_cpu_launches_no_kernel():
    before = (frontier_relax.launches, bfs_level.launches)
    rooted_spanning_tree(_port(GRAPHS["grid_16"]()), 0, "bfs", device="cpu")
    assert (frontier_relax.launches, bfs_level.launches) == before
