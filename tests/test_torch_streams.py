"""The port's edge-stream generators against ``repro.data.streams``.

For the same graph, arguments and seed each generator of the port makes
the reference's ``rng`` calls in the reference's order, so every
``StreamBatch`` array, the initially-live edges and ``n_events`` are
bit-equal (tolerance: exact; every array is int32). The graphs come from
``repro`` and are carried over with ``Graph.from_reference_arrays`` (same
half-edge ids).
"""
import functools

import numpy as np
import pytest

from repro.data import graphs as jax_graphs
from repro.data import streams as jax_streams
from repro.dynamic import stream_capacity as jax_stream_capacity
from repro_torch.core import Graph
from repro_torch.data import streams
from repro_torch.dynamic import stream_capacity

GRAPHS = {
    "grid_12": lambda: jax_graphs.grid2d(12),
    "rmat_7": lambda: jax_graphs.rmat(7, edge_factor=4),
    "chain_256": lambda: jax_graphs.chain(256),
    "rmat_6": lambda: jax_graphs.rmat(6, edge_factor=4),
}
FIELDS = ("ins_u", "ins_v", "del_u", "del_v")


@functools.cache
def _graphs(name):
    jg = GRAPHS[name]()
    return jg, Graph.from_reference_arrays(jg.n_nodes, np.asarray(jg.src),
                                           np.asarray(jg.dst), device="cpu")


def _assert_same_stream(want, got):
    assert got.name == want.name and got.n_nodes == want.n_nodes
    assert got.n_events == want.n_events
    for f in ("init_u", "init_v"):
        a, b = getattr(want, f), getattr(got, f)
        assert b.dtype == np.int32 and np.array_equal(a, b), f
    assert len(got.batches) == len(want.batches)
    for i, (a, b) in enumerate(zip(want.batches, got.batches)):
        for f in FIELDS:
            x, y = getattr(a, f), getattr(b, f)
            assert y.dtype == x.dtype == np.int32, (i, f)
            assert np.array_equal(x, y), (i, f)


@pytest.mark.parametrize("batch", [4, 16])
@pytest.mark.parametrize("seed", [0, 1, 5])
@pytest.mark.parametrize("stream", sorted(streams.STREAMS))
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_stream_matches_reference(graph, stream, seed, batch):
    jg, g = _graphs(graph)
    kw = dict(batch=batch, seed=seed, n_batches=8)
    want = jax_streams.STREAMS[stream](jg, **kw)
    got = streams.STREAMS[stream](g, **kw)
    _assert_same_stream(want, got)
    assert stream_capacity(got) == jax_stream_capacity(want)
    assert stream_capacity(got, 7) == jax_stream_capacity(want, 7)


@pytest.mark.parametrize("stream,kw", [
    ("sliding_window", dict(batch=16, window=2)),
    ("sliding_window", dict(batch=64)),
    ("insert_heavy", dict(batch=16, p_delete=0.5)),
    ("insert_heavy", dict(batch=64)),
    ("churn", dict(batch=1, n_batches=20)),
    ("churn", dict(batch=255, n_batches=3)),
])
def test_stream_options_match_reference(stream, kw):
    """Whole streams (no ``n_batches`` cut where the generator allows it),
    other windows and deletion rates, and churn batches that drain the
    live or dead set."""
    jg, g = _graphs("chain_256")
    want = jax_streams.STREAMS[stream](jg, seed=3, **kw)
    got = streams.STREAMS[stream](g, seed=3, **kw)
    _assert_same_stream(want, got)


def test_padding_is_the_sentinel():
    _, g = _graphs("rmat_6")
    s = streams.sliding_window(g, batch=16, window=2, n_batches=4)
    n = g.n_nodes
    assert (s.batches[0].del_u == n).all() and (s.batches[0].del_v == n).all()
    assert (s.batches[2].del_u < n).all()
    assert s.n_events == sum(int((b.ins_u < n).sum() + (b.del_u < n).sum())
                             for b in s.batches)
