"""Edge-stream workload generators over the synthetic graph suite.

The port of ``repro.data.streams``: serving traffic for the batch-dynamic
layer (DESIGN.md §9). Each generator turns a static ``data.graphs`` graph
into a stream of fixed-shape update batches, ``StreamBatch`` arrays padded
with the ``n_nodes`` sentinel, so every batch has the same shapes.

Three traffic regimes (numpy, deterministic per seed):

  * ``sliding_window`` — batches of edges arrive in a random order and
    expire ``window`` batches later (temporal networks, session graphs);
  * ``insert_heavy``  — the graph grows toward the full edge set with a
    small deletion rate ``p_delete`` (social or citation growth);
  * ``churn``         — starts from a random half of the edges and swaps
    ``batch/2`` live edges for dead ones every step: the steady state.

For the same graph, arguments and seed every generator makes the same
``rng`` calls in the same order as the reference, so the streams are
bit-equal to its streams. The live and dead sets are numpy arrays (an
edge packed into one int64 word), not lists of tuples: a run of
``list.pop(i)`` in descending index order is one ``np.delete`` (which
keeps the order of the rest, as the pops do), and the deleted edges come
out in that descending order. At grid2d(4096)'s 33.5M edges the lists
would take hours.

Deletions are (u, v) pairs: ``dynamic.edge_slots`` resolves them to pool
slots (multiset-aware) at apply time.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.graph import Graph


@dataclasses.dataclass(frozen=True)
class StreamBatch:
    """One update batch; all arrays int32, ``n_nodes``-sentinel padded.

    ins_u/ins_v: [batch] edges to insert; del_u/del_v: [batch] edges to
    delete (pairs, not pool slots).
    """

    ins_u: np.ndarray
    ins_v: np.ndarray
    del_u: np.ndarray
    del_v: np.ndarray


@dataclasses.dataclass(frozen=True)
class EdgeStream:
    """A replayable edge-update workload over n_nodes vertices."""

    name: str
    n_nodes: int
    init_u: np.ndarray          # edges live before the first batch
    init_v: np.ndarray
    batches: tuple[StreamBatch, ...]

    @property
    def n_events(self) -> int:
        """Total insert + delete events across all batches."""
        n = self.n_nodes
        return int(sum((b.ins_u < n).sum() + (b.del_u < n).sum()
                       for b in self.batches))


def _edges_of(graph: Graph) -> np.ndarray:
    """The M undirected edges as an int32 [M, 2] array."""
    m = graph.n_edges
    return np.stack([graph.src[:m].cpu().numpy(),
                     graph.dst[:m].cpu().numpy()], axis=1).astype(np.int32)


def _pad(pairs: np.ndarray, width: int, n: int):
    """The first ``width`` rows of ``pairs`` [k, 2], sentinel-padded."""
    u = np.full(width, n, np.int32)
    v = np.full(width, n, np.int32)
    k = min(pairs.shape[0], width)
    u[:k] = pairs[:k, 0]
    v[:k] = pairs[:k, 1]
    return u, v


def _mk_batch(ins, dels, batch, n) -> StreamBatch:
    iu, iv = _pad(ins, batch, n)
    du, dv = _pad(dels, batch, n)
    return StreamBatch(ins_u=iu, ins_v=iv, del_u=du, del_v=dv)


def _packed(rows: np.ndarray) -> np.ndarray:
    """[k, 2] int32 edge rows as k int64 words (one copy-free view), so a
    delete or a concatenation moves one contiguous array."""
    return np.ascontiguousarray(rows, np.int32).view(np.int64).reshape(-1)


def _rows(words: np.ndarray) -> np.ndarray:
    """The inverse of ``_packed``: int64 words as [k, 2] int32 rows."""
    return words.view(np.int32).reshape(-1, 2)


def _take(words: np.ndarray, idx: np.ndarray):
    """``words[i]`` popped for each i of ``idx`` in descending order, as a
    run of ``list.pop``: returns (the popped words in that order, the rest
    in their order)."""
    idx = np.sort(np.asarray(idx, np.int64))[::-1]
    return words[idx], np.delete(words, idx)


_NONE = np.zeros((0, 2), np.int32)


def sliding_window(graph: Graph, *, batch: int = 64, window: int = 4,
                   n_batches: int | None = None, seed: int = 0) -> EdgeStream:
    """Edges arrive in random order and expire ``window`` batches later."""
    n = graph.n_nodes
    rng = np.random.default_rng(seed)
    edges = _edges_of(graph)
    order = rng.permutation(edges.shape[0])
    n_blocks = -(-edges.shape[0] // batch)
    if n_batches is not None:
        n_blocks = min(n_blocks, n_batches)
    blocks = [edges[order[i * batch:(i + 1) * batch]]
              for i in range(n_blocks)]
    batches = tuple(
        _mk_batch(blk, blocks[t - window] if t >= window else _NONE,
                  batch, n)
        for t, blk in enumerate(blocks))
    return EdgeStream(name="sliding_window", n_nodes=n,
                      init_u=np.zeros(0, np.int32),
                      init_v=np.zeros(0, np.int32), batches=batches)


def insert_heavy(graph: Graph, *, batch: int = 64, p_delete: float = 0.1,
                 n_batches: int | None = None, seed: int = 0) -> EdgeStream:
    """Growth regime: insert toward the full edge set, rare deletions."""
    n = graph.n_nodes
    rng = np.random.default_rng(seed)
    edges = _edges_of(graph)
    order = rng.permutation(edges.shape[0])
    live = _packed(_NONE)
    batches = []
    n_ins = max(1, batch - int(batch * p_delete))
    total = (edges.shape[0] + n_ins - 1) // n_ins
    if n_batches is not None:
        total = min(total, n_batches)
    for t in range(total):
        ins = edges[order[t * n_ins:(t + 1) * n_ins]]
        k = min(int(rng.binomial(batch, p_delete)), live.shape[0])
        dels = _NONE
        if k:
            dels, live = _take(live, rng.choice(live.shape[0], size=k,
                                                replace=False))
            dels = _rows(dels)
        live = np.concatenate([live, _packed(ins)])
        batches.append(_mk_batch(ins, dels, batch, n))
    return EdgeStream(name="insert_heavy", n_nodes=n,
                      init_u=np.zeros(0, np.int32),
                      init_v=np.zeros(0, np.int32), batches=tuple(batches))


def churn(graph: Graph, *, batch: int = 64, n_batches: int = 16,
          seed: int = 0) -> EdgeStream:
    """Steady state: half the edges live; swap batch/2 per step."""
    n = graph.n_nodes
    rng = np.random.default_rng(seed)
    edges = _edges_of(graph)
    m = edges.shape[0]
    perm = rng.permutation(m)
    words = _packed(edges)
    live = words[perm[:m // 2]]
    dead = words[perm[m // 2:]]
    init_u = _rows(live)[:, 0].copy()
    init_v = _rows(live)[:, 1].copy()
    k = max(1, batch // 2)
    batches = []
    for _ in range(n_batches):
        kk = min(k, live.shape[0], dead.shape[0])
        dels, live = _take(live, rng.choice(live.shape[0], size=kk,
                                            replace=False))
        ins, dead = _take(dead, rng.choice(dead.shape[0], size=kk,
                                           replace=False))
        live = np.concatenate([live, ins])
        dead = np.concatenate([dead, dels])
        batches.append(_mk_batch(_rows(ins), _rows(dels), batch, n))
    return EdgeStream(name="churn", n_nodes=n, init_u=init_u, init_v=init_v,
                      batches=tuple(batches))


#: name → generator, mirroring ``data.graphs.SUITE``'s shape.
STREAMS = {
    "sliding_window": sliding_window,
    "insert_heavy": insert_heavy,
    "churn": churn,
}
