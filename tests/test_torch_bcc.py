"""The biconnectivity slice of the port against ``repro``, bit for bit.

Every graph is built by ``repro`` and carried over with
``Graph.from_reference_arrays`` (same half-edge ids); the port runs on the
CPU. Compared: every ``BCCResult`` field (articulation, bridge, edge_bcc,
pre, size, low, high) and every count (n_bcc, rst_steps, aux_rounds,
seg_syncs), for all three RST flavors. The goldens of ``tests/test_bcc.py``
are the components of one graph, each rooted in turn, so the reference
compiles that shape once. Tolerance: bit-equal (every output is int32 or
bool).
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import bcc as jax_bcc
from repro.core import rooted_spanning_tree as jax_rst
from repro.core.euler import tour_numbering as jax_tour_numbering
from repro.core.graph import Graph as JaxGraph
from repro.data import graphs as jax_graphs
from repro_torch.core import (METHODS, BCCResult, Graph, TourNumbering,
                              bcc_batch, bcc_from_parent, bcc_from_tour,
                              biconnectivity)

FIELDS = ("articulation", "bridge", "edge_bcc", "pre", "size", "low", "high")
COUNTS = ("n_bcc", "rst_steps", "aux_rounds", "seg_syncs")

# The goldens of tests/test_bcc.py: a path, a cycle, a bowtie, a cycle
# with a tail, and a triangle beside a path.
GOLDENS = (
    (9, [(i, i + 1) for i in range(8)]),
    (7, [(i, (i + 1) % 7) for i in range(7)]),
    (5, [(0, 1), (1, 2), (2, 0), (2, 3), (3, 4), (4, 2)]),
    (6, [(0, 1), (1, 2), (2, 3), (3, 0), (0, 4), (4, 5)]),
    (6, [(0, 1), (1, 2), (2, 0), (3, 4), (4, 5)]),
)
GOLDEN_ROOTS = tuple(np.cumsum([0] + [n for n, _ in GOLDENS[:-1]]).tolist())


def _golden_edges():
    edges, off = [], 0
    for n, es in GOLDENS:
        edges += [(u + off, v + off) for u, v in es]
        off += n
    return off, np.asarray(edges)


def _goldens():
    n, edges = _golden_edges()
    return JaxGraph.from_numpy_undirected(n, edges)


GRAPHS = {
    "goldens": _goldens,
    "chain_256": lambda: jax_graphs.chain(256),
    "rmat_6": lambda: jax_graphs.rmat(6, edge_factor=4),
    "grid_6": lambda: jax_graphs.grid2d(6),
    "er_72": lambda: jax_graphs.erdos_renyi(72, avg_degree=3, seed=2),
}
CASES = ([("goldens", r) for r in GOLDEN_ROOTS]
         + [("chain_256", 0), ("rmat_6", 0), ("grid_6", 0), ("er_72", 0),
            ("er_72", 23)])

# table3/smoke_* of BENCH_rst.json: n_bcc, articulation points, bridges
# (undirected), aux rounds, seg syncs; and rst_steps per flavor.
TABLE3 = {"chain_256": ((255, 254, 255, 0, 16),
                        {"gconn_euler": 1, "bfs": 255, "pr_rst": 1}),
          "rmat_6": ((3, 2, 2, 2, 12),
                     {"gconn_euler": 2, "bfs": 3, "pr_rst": 2})}


@functools.cache
def _jax_graph(name):
    return GRAPHS[name]()


def _t(a) -> torch.Tensor:
    """A CPU tensor holding a copy of a JAX or numpy array."""
    return torch.from_numpy(np.array(a))


def _port(jg) -> Graph:
    return Graph.from_reference_arrays(jg.n_nodes, np.asarray(jg.src),
                                       np.asarray(jg.dst), device="cpu")


@pytest.fixture(scope="module")
def reference():
    """The reference's ``biconnectivity`` per (graph, root, flavor), run
    once per module."""
    cache = {}

    def get(name, root, flavor):
        key = (name, root, flavor)
        if key not in cache:
            cache[key] = jax_bcc.biconnectivity(_jax_graph(name), root,
                                                rst_flavor=flavor)
        return cache[key]
    return get


def _assert_same(want, got: BCCResult, tag):
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(want, f)),
                                      getattr(got, f).numpy(),
                                      err_msg=f"{tag} {f}")
    for c in COUNTS:
        assert int(getattr(want, c)) == getattr(got, c), (tag, c)


@pytest.mark.parametrize("flavor", METHODS)
@pytest.mark.parametrize("name,root", CASES)
def test_biconnectivity_matches_jax(reference, name, root, flavor):
    got = biconnectivity(_port(_jax_graph(name)), root, rst_flavor=flavor,
                         device="cpu")
    assert got.method == flavor
    _assert_same(reference(name, root, flavor), got, (name, root, flavor))


@pytest.mark.parametrize("name", sorted(TABLE3))
def test_table3_counts(name):
    counts, steps = TABLE3[name]
    for flavor in METHODS:
        got = biconnectivity(_port(_jax_graph(name)), 0, rst_flavor=flavor,
                             device="cpu")
        assert (got.n_bcc, int(got.articulation.sum()),
                int(got.bridge.sum()) // 2, got.aux_rounds,
                got.seg_syncs) == counts, flavor
        assert got.rst_steps == steps[flavor]


def test_bfs_decomposes_the_root_component_only():
    """On the goldens graph BFS from the bowtie spans the bowtie alone:
    every other edge is labelled −1, and the decomposition of the bowtie
    equals the forest flavors' there."""
    root = GOLDEN_ROOTS[2]
    g = _port(_jax_graph("goldens"))
    bfs = biconnectivity(g, root, rst_flavor="bfs", device="cpu")
    full = biconnectivity(g, root, rst_flavor="gconn_euler", device="cpu")
    inside = torch.zeros(g.n_nodes, dtype=torch.bool)
    inside[root:root + GOLDENS[2][0]] = True
    edge_in = inside[g.src.long()] & inside[g.dst.long()]
    assert bool((bfs.edge_bcc[~edge_in] == -1).all())
    assert bool((bfs.edge_bcc[edge_in] >= 0).all())
    assert torch.equal(bfs.articulation, full.articulation & inside)
    assert torch.equal(bfs.bridge, full.bridge & edge_in)
    assert bfs.n_bcc == 2


def _multigraph():
    """The goldens with parallel copies of three edges: the path's first
    edge (a bridge that stops being one), the tail edge (0, 4) of the cycle
    with a tail, and one cycle edge."""
    n, edges = _golden_edges()
    off4 = GOLDEN_ROOTS[3]
    extra = np.asarray([(0, 1), (off4, off4 + 4), (GOLDEN_ROOTS[1] + 2,
                                                   GOLDEN_ROOTS[1] + 3)])
    all_edges = np.concatenate([edges, extra])
    return JaxGraph.from_undirected(n, jnp.asarray(all_edges[:, 0]),
                                    jnp.asarray(all_edges[:, 1]))


def _tree_mask(jg, parent):
    """Both halves of exactly one copy of every tree edge."""
    src, dst = np.asarray(jg.src), np.asarray(jg.dst)
    m = src.size // 2
    par = np.asarray(parent)
    mask = np.zeros(2 * m, bool)
    taken = set()
    for e in range(m):
        u, v = int(src[e]), int(dst[e])
        pair = (min(u, v), max(u, v))
        if pair in taken:
            continue
        if (par[v] == u and u != v) or (par[u] == v and u != v):
            mask[e] = mask[e + m] = True
            taken.add(pair)
    return mask


@pytest.mark.parametrize("flavor", ["gconn_euler", "bfs"])
@pytest.mark.parametrize("scoped", [False, True])
def test_bcc_from_tour_with_tree_mask_and_scope(flavor, scoped):
    """Fed the reference's own numbering: active outputs and counts equal.
    The scope holds the path, the bowtie and the triangle-and-path golden
    (component-closed)."""
    jg = _multigraph()
    n = jg.n_nodes
    parent = jax_rst(jg, GOLDEN_ROOTS[0], flavor).parent
    jtn = jax_tour_numbering(parent)
    mask = _tree_mask(jg, parent)
    scope = np.zeros(n, bool)
    for i in (0, 2, 4):
        scope[GOLDEN_ROOTS[i]:GOLDEN_ROOTS[i] + GOLDENS[i][0]] = True
    want = jax.jit(jax_bcc.bcc_from_tour)(
        jg, parent, jtn, tree_mask=jnp.asarray(mask),
        scope=jnp.asarray(scope) if scoped else None)
    tn = TourNumbering.from_reference_arrays(
        *(np.asarray(getattr(jtn, f))
          for f in ("pre", "size", "last", "comp", "parent")), device="cpu")
    got = bcc_from_tour(_port(jg), _t(parent), tn,
                        tree_mask=torch.from_numpy(mask),
                        scope=torch.from_numpy(scope) if scoped else None)
    src, dst = np.asarray(jg.src), np.asarray(jg.dst)
    vert_on = scope if scoped else np.ones(n, bool)
    vert_on &= np.asarray(parent) >= 0
    edge_on = vert_on[src] & vert_on[dst]
    for f, on in (("articulation", vert_on), ("rep", vert_on),
                  ("low", vert_on), ("high", vert_on), ("bridge", edge_on),
                  ("edge_bcc", edge_on)):
        np.testing.assert_array_equal(np.asarray(want[f])[on],
                                      got[f].numpy()[on], err_msg=f)
    for c in ("aux_rounds", "seg_syncs"):
        assert int(want[c]) == got[c], c
    if not scoped:
        assert int(want["n_bcc"]) == got["n_bcc"]
    # The parallel copy of the path's first edge is not a bridge; the
    # path's second edge still is.
    e01 = np.nonzero((src == 0) & (dst == 1))[0]
    e12 = np.nonzero((src == 1) & (dst == 2))[0]
    assert not got["bridge"][e01].any() and got["bridge"][e12].all()


@pytest.mark.parametrize("name", ["chain_256", "goldens"])
def test_aux_sentinel_rows_keep_rep_and_rounds(name):
    """Inactive rule slots are the self-loop (n − 1, n − 1) in the port
    and (n, n) in the reference; the aux labels and rounds agree, also
    where nearly every slot is inactive (chain: no rule fires, 0 rounds)."""
    jg = _jax_graph(name)
    parent = jax_rst(jg, 0, "gconn_euler").parent
    jtn = jax_tour_numbering(parent)
    want = jax.jit(jax_bcc.bcc_from_tour)(jg, parent, jtn)
    tn = TourNumbering.from_reference_arrays(
        *(np.asarray(getattr(jtn, f))
          for f in ("pre", "size", "last", "comp", "parent")), device="cpu")
    got = bcc_from_tour(_port(jg), _t(parent), tn)
    np.testing.assert_array_equal(np.asarray(want["rep"]), got["rep"].numpy())
    assert int(want["aux_rounds"]) == got["aux_rounds"]
    if name == "chain_256":
        assert got["aux_rounds"] == 0
    from_parent = bcc_from_parent(_port(jg),
                                  _t(parent))
    assert torch.equal(from_parent["low"], got["low"])


@pytest.mark.parametrize("flavor", METHODS)
def test_bcc_batch_matches_jax(flavor):
    """The three chains with a moving chord of tests/test_bcc.py."""
    n = 16
    base = [(i, i + 1) for i in range(n - 1)]
    gs = [JaxGraph.from_numpy_undirected(n, np.asarray(base + [(0, j)]))
          for j in (5, 9, 14)]
    src = np.stack([np.asarray(g.src) for g in gs])
    dst = np.stack([np.asarray(g.dst) for g in gs])
    roots = np.asarray([0, 3, 15], np.int32)
    want = jax_bcc.bcc_batch(jnp.asarray(src), jnp.asarray(dst),
                             jnp.asarray(roots), n_nodes=n, rst_flavor=flavor)
    got = bcc_batch(torch.from_numpy(src), torch.from_numpy(dst),
                    torch.from_numpy(roots), n_nodes=n, rst_flavor=flavor,
                    device="cpu")
    for f in FIELDS + COUNTS:
        np.testing.assert_array_equal(np.asarray(getattr(want, f)),
                                      getattr(got, f).numpy(), err_msg=f)
    bad = src.copy()
    bad[0, 0] = n
    with pytest.raises(ValueError, match="outside"):
        bcc_batch(torch.from_numpy(bad), torch.from_numpy(dst),
                  torch.from_numpy(roots), n_nodes=n, device="cpu")


def test_unknown_flavor_raises():
    g = Graph.from_numpy_undirected(4, np.asarray([(0, 1), (1, 2), (2, 3)]),
                                    device="cpu")
    with pytest.raises(ValueError, match="rst_flavor"):
        biconnectivity(g, 0, rst_flavor="dfs", device="cpu")


@pytest.mark.parametrize("flavor", METHODS)
def test_bcc_batch_union_matches_jax_on_mixed_graphs(flavor):
    """One union program over graphs whose counts differ lane by lane
    (a path, a cycle with chords, a graph in three parts with a parallel
    edge, a sparse random one): every field and per-graph count equal to
    the reference's vmapped batch."""
    n, m = 24, 30
    rng = np.random.default_rng(5)
    path = [(i, i + 1) for i in range(n - 1)]
    cycle = [(i, (i + 1) % n) for i in range(n)] + [(0, 12), (5, 17)]
    parts = ([(i, i + 1) for i in range(7)] + [(8, 9), (9, 10), (10, 8)]
             + [(12, 13), (12, 13), (13, 14), (14, 20)])
    rand = [tuple(rng.choice(n, 2, replace=False)) for _ in range(m)]
    lists = []
    for es in (path, cycle, parts, rand):
        es = list(es)[:m]
        es += [es[-1]] * (m - len(es))      # pad with parallel copies
        lists.append(np.asarray(es, np.int32))
    gs = [JaxGraph.from_undirected(n, jnp.asarray(e[:, 0]),
                                   jnp.asarray(e[:, 1])) for e in lists]
    src = np.stack([np.asarray(g.src) for g in gs])
    dst = np.stack([np.asarray(g.dst) for g in gs])
    roots = np.asarray([0, 7, 9, 3], np.int32)
    want = jax_bcc.bcc_batch(jnp.asarray(src), jnp.asarray(dst),
                             jnp.asarray(roots), n_nodes=n, rst_flavor=flavor)
    got = bcc_batch(torch.from_numpy(src), torch.from_numpy(dst),
                    torch.from_numpy(roots), n_nodes=n, rst_flavor=flavor,
                    device="cpu")
    for f in FIELDS + COUNTS:
        np.testing.assert_array_equal(np.asarray(getattr(want, f)),
                                      getattr(got, f).numpy(), err_msg=f)
    assert len(set(got.rst_steps.tolist())) > 1 or flavor != "bfs"
