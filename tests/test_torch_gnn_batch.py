"""The GNN data path in the port against the JAX package on the CPU: every
array bit-equal.

``build_triplets`` (the port's is vectorized) on random multigraphs with
the cut at ``max_triplets`` below, at and above the count;
``random_graph_batch`` for each flag combination (one sentinel row where
``n_edges`` is odd; the reference's triplet builder fails on sentinels, so
triplets only with an even count); ``neighbor_sample`` and
``sampled_batch`` (drawn and given features); the GNN branch of
``synthetic_batches`` for each architecture; and ``reorder_by_rst`` on
``erdos_renyi(64)``, ``rmat(8, 4)``, ``grid2d(8)`` and a graph of two
components, for each RST method.
"""
import dataclasses
import itertools

import numpy as np
import torch
import pytest

from repro.configs import get_arch as jax_get_arch
from repro.core.graph import Graph as JaxGraph
from repro.core.graph import build_csr as jax_build_csr
from repro.data import gnn_batch as jb
from repro.data import graphs as jax_graphs
from repro.launch.train import synthetic_batches as jax_batches
from repro_torch.configs import get_arch
from repro_torch.data import gnn_batch as tb
from repro_torch.launch.train import SMOKE_SHAPES, synthetic_batches

FIELDS = ("node_feat", "src", "dst", "positions", "graph_id", "trip_in",
          "trip_out")


def assert_same(want, got, what):
    if want is None:
        assert got is None, what
        return
    want = np.asarray(want)
    got = got.numpy() if hasattr(got, "numpy") else np.asarray(got)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


def assert_batches_equal(want, got):
    assert want.n_nodes == got.n_nodes and want.n_graphs == got.n_graphs
    for f in FIELDS:
        assert_same(getattr(want, f), getattr(got, f), f)


@pytest.mark.parametrize("n,e,max_t", [(3, 4, 8), (30, 64, 10), (64, 256, 1024),
                                       (300, 2000, 100_000), (500, 3000, 0),
                                       (40, 0, 5)])
def test_build_triplets_bit_equal(n, e, max_t):
    rng = np.random.default_rng(n + e)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    if n == 3:                         # the reference test's path 0-1-2
        src, dst = np.array([0, 1, 1, 2]), np.array([1, 2, 0, 1])
    want = jb.build_triplets(src, dst, n, max_t)
    got = tb.build_triplets(src, dst, n, max_t)
    for w, g in zip(want, got):
        assert_same(w, g, "triplets")


def test_build_triplets_rejects_sentinel_ids():
    with pytest.raises(ValueError, match="outside"):
        tb.build_triplets(np.array([0, 4]), np.array([1, 4]), 4, 8)


FLAGS = [dict(zip(("positions", "atom_types", "n_graphs", "max_triplets"),
                  combo))
         for combo in itertools.product((False, True), (False, True), (1, 4),
                                        (0, 1024))]


@pytest.mark.parametrize("flags", FLAGS,
                         ids=lambda f: "-".join(f"{k}={v}" for k, v in
                                                f.items()))
def test_random_graph_batch_bit_equal(flags):
    for n, e in ((64, 256), (64, 255), (100, 90)):
        if flags["max_triplets"] and e % 2:
            continue
        want = jb.random_graph_batch(n, e, 16, seed=3, **flags)
        got = tb.random_graph_batch(n, e, 16, seed=3, device="cpu", **flags)
        assert_batches_equal(want, got)


def test_neighbor_sample_and_sampled_batch_bit_equal():
    jg = jax_graphs.erdos_renyi(500, avg_degree=10, seed=4)
    row_ptr, col, _ = (np.asarray(a) for a in jax_build_csr(jg))
    seeds = np.arange(8)
    for fanouts, seed in (([5, 3], 0), ([15, 10], 2), ([2, 2, 2], 5)):
        want = jb.neighbor_sample(row_ptr, col, seeds, fanouts, seed)
        got = tb.neighbor_sample(row_ptr, col, seeds, fanouts, seed)
        for w, g in zip(want, got):
            assert_same(w, g, "neighbor_sample")
    feats = np.random.default_rng(1).standard_normal((500, 6)
                                                      ).astype(np.float32)
    for kw in (dict(pad_nodes=64, pad_edges=128, seed=1),
               dict(pad_nodes=512, pad_edges=1024, seed=2),
               dict(pad_nodes=40, pad_edges=90, seed=3, feats=feats)):
        want = jb.sampled_batch(row_ptr, col, seeds, [5, 3], 6, **kw)
        got = tb.sampled_batch(row_ptr, col, seeds, [5, 3], 6, device="cpu",
                               **kw)
        assert_batches_equal(want, got)


@pytest.mark.parametrize("arch", ["gat-cora", "schnet", "dimenet",
                                  "meshgraphnet"])
def test_synthetic_gnn_batches_bit_equal(arch):
    """Two batches of the smoke shape and seed 5: graphs (seed + cursor)
    and labels (the seed's generator, after the graphs)."""
    jspec = jax_get_arch(arch)
    jcfg = jspec.make_smoke_config()
    shape = dict(SMOKE_SHAPES["gnn"])
    spec = get_arch(arch)
    cfg = spec.make_smoke_config()
    want_it = jax_batches(dataclasses.replace(jspec, shapes={"s": shape}),
                          shape, jcfg, seed=5)
    got_it = synthetic_batches(spec, shape, cfg, seed=5, device="cpu")
    for _ in range(2):
        (cw, want), (cg, got) = next(want_it), next(got_it)
        assert cw == cg
        assert sorted(want["graph"]) == sorted(got["graph"])
        for k, v in want["graph"].items():
            assert_same(v, got["graph"][k], k)
        assert_same(want["labels"], got["labels"], "labels")


def _two_components():
    a = jax_graphs.rmat(5, edge_factor=4, seed=1)
    b = jax_graphs.grid2d(4)
    n = a.n_nodes + b.n_nodes
    src = np.concatenate([np.asarray(a.src), np.asarray(b.src) + a.n_nodes])
    dst = np.concatenate([np.asarray(a.dst), np.asarray(b.dst) + a.n_nodes])
    # Keep the paired-half-edge layout: first halves, then second halves.
    ma, mb = a.n_edges, b.n_edges
    order = np.concatenate([np.arange(ma), 2 * ma + np.arange(mb),
                            ma + np.arange(ma), 2 * ma + mb + np.arange(mb)])
    return JaxGraph(n_nodes=n, src=src[order], dst=dst[order])


GRAPHS = {"erdos_renyi(64)": lambda: jax_graphs.erdos_renyi(64, 4, 7),
          "rmat(8, 4)": lambda: jax_graphs.rmat(8, edge_factor=4),
          "grid2d(8)": lambda: jax_graphs.grid2d(8),
          "two components": _two_components}


@pytest.mark.parametrize("method", ["gconn_euler", "bfs", "pr_rst"])
@pytest.mark.parametrize("gname", list(GRAPHS))
def test_reorder_by_rst_bit_equal(gname, method):
    g = GRAPHS[gname]()
    src, dst = np.asarray(g.src), np.asarray(g.dst)
    want = jb.reorder_by_rst(src, dst, g.n_nodes, method=method)
    got = tb.reorder_by_rst(src, dst, g.n_nodes, method=method,
                            device="cpu")
    assert_same(want, got, "perm")
    assert sorted(got.tolist()) == list(range(g.n_nodes))
    plain = tb.reorder_by_rst(src, dst, g.n_nodes, method=method,
                              device="cpu", use_kernel=False)
    assert_same(want, plain, "perm, plain path")


def test_the_data_path_runs_on_the_card_by_default():
    """No device: the card, and where there is none, an error (never the
    CPU on its own)."""
    g = jax_graphs.grid2d(4)
    calls = (lambda: tb.reorder_by_rst(np.asarray(g.src), np.asarray(g.dst),
                                       g.n_nodes),
             lambda: tb.random_graph_batch(8, 16, 4).src)
    for call in calls:
        if torch.cuda.is_available():
            assert call().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
