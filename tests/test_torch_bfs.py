"""The BFS flavor of the port against ``repro``, bit for bit.

Graphs are the ``GRAPHS`` set of ``test_torch_rst.py``, built by
``repro.data.graphs`` and carried over with ``Graph.from_reference_arrays``.
The JAX BFS runs with ``use_kernel=False`` and with ``use_kernel=True``
(the Pallas ``frontier_relax`` kernel in interpret mode); the port runs on
the CPU. Compared: parent, dist and levels. Tolerance: bit-equal (every
output is an integer).
"""
import numpy as np
import pytest

from repro.core import bfs_rst as jax_bfs
from repro.core import rooted_spanning_tree as jax_rst
from repro.core.validate import bfs_depths_reference
from repro.data import graphs as jax_graphs
from repro_torch.core import bfs_rst, rooted_spanning_tree, validate_rst
from repro_torch.core.bfs import INF32
from repro_torch.kernels.frontier_relax.ops import frontier_relax
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


@pytest.mark.parametrize("make,levels", [
    (lambda: jax_graphs.chain(256), 255),
    (lambda: jax_graphs.rmat(6, edge_factor=4), 3)])
def test_table1_smoke_bfs_steps(make, levels):
    """The ``table1/smoke_*`` rows of BENCH_rst.json: bfs_steps."""
    r = rooted_spanning_tree(_port(make()), 0, "bfs", device="cpu")
    assert r.steps == levels


def test_bfs_on_cpu_launches_no_kernel():
    before = frontier_relax.launches
    rooted_spanning_tree(_port(GRAPHS["grid_16"]()), 0, "bfs", device="cpu")
    assert frontier_relax.launches == before
