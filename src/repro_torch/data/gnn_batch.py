"""GraphBatch builders: synthetic graphs, triplets, molecule batching,
neighbor sampling (fanout), and RST-based locality reordering.

The port of ``repro.data.gnn_batch``. The builders make the reference's
numpy draws in the reference's order, so one seed gives the reference's
arrays bit for bit; the tensors go on ``device`` (the card unless the
caller names another). ``reorder_by_rst`` is where the paper's technique
enters the GNN pipeline: it runs the port's ``rooted_spanning_tree`` over
the input graph and relabels nodes by tree order, for gather locality.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.graph import Graph, resolve_device
from repro_torch.core.rst import rooted_spanning_tree
from repro_torch.models.gnn import GraphBatch


def build_triplets(src: np.ndarray, dst: np.ndarray, n_nodes: int,
                   max_triplets: int) -> tuple[np.ndarray, np.ndarray]:
    """Triplet index arrays for DimeNet: pairs of edges (k→j, j→i).

    Returns (trip_in, trip_out), int32 of length max_triplets, padded with
    E (sentinel). trip_in[t] is the edge id of (k→j); trip_out[t] of (j→i).
    Edge ids must lie in [0, n_nodes) (the reference's loop fails on
    sentinel rows). The reference's loop, vectorized: for each edge j→i in edge order, the
    edges into j in edge order, less the one from i (no backtracking), cut
    at ``max_triplets``.
    """
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    e = len(src)
    if e and (min(src.min(), dst.min()) < 0
              or max(src.max(), dst.max()) >= n_nodes):
        raise ValueError(f"edge ids outside [0, {n_nodes})")
    in_edges = np.argsort(dst, kind="stable")     # edges into each node
    counts = np.bincount(dst, minlength=n_nodes)
    starts = np.cumsum(counts) - counts
    deg = counts[src]                             # edges into j, per j→i
    to = np.repeat(np.arange(e), deg)
    rank = np.arange(len(to)) - np.repeat(np.cumsum(deg) - deg, deg)
    ti = in_edges[np.repeat(starts[src], deg) + rank]
    keep = src[ti] != dst[to]                     # exclude k == i
    # The reference tests the count after each append, so it keeps one
    # triplet even at max_triplets = 0.
    cut = max(max_triplets, 1)
    ti, to = ti[keep][:cut], to[keep][:cut]
    pad = max(max_triplets - len(ti), 0)
    return (np.concatenate([ti, np.full(pad, e)]).astype(np.int32),
            np.concatenate([to, np.full(pad, e)]).astype(np.int32))


def random_graph_batch(n_nodes: int, n_edges: int, d_feat: int, *,
                       seed: int = 0, positions: bool = False,
                       atom_types: bool = False, n_graphs: int = 1,
                       max_triplets: int = 0,
                       device: str | torch.device | None = None
                       ) -> GraphBatch:
    """Random connected-ish GraphBatch with optional 3D positions/triplets,
    on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    # Tree backbone + random extra edges, directed both ways.
    tree_dst = np.arange(1, n_nodes)
    tree_src = (rng.random(n_nodes - 1) * tree_dst).astype(np.int64)
    m_extra = max(n_edges // 2 - (n_nodes - 1), 0)
    ex = rng.integers(0, n_nodes, (m_extra, 2))
    und = np.concatenate([np.stack([tree_src, tree_dst], 1), ex])
    src = np.concatenate([und[:, 0], und[:, 1]])[:n_edges]
    dst = np.concatenate([und[:, 1], und[:, 0]])[:n_edges]
    if len(src) < n_edges:                       # pad with sentinels
        pad = n_edges - len(src)
        src = np.concatenate([src, np.full(pad, n_nodes)])
        dst = np.concatenate([dst, np.full(pad, n_nodes)])

    def tensor(a, dtype):
        return torch.from_numpy(np.asarray(a, dtype)).to(dev)

    if atom_types:
        node_feat = tensor(rng.integers(0, 10, n_nodes), np.int32)
    else:
        node_feat = tensor(rng.standard_normal((n_nodes, d_feat)),
                           np.float32)
    pos = tensor(rng.standard_normal((n_nodes, 3)) * 2.0, np.float32) \
        if positions else None
    gid = tensor(rng.integers(0, n_graphs, n_nodes), np.int32) \
        if n_graphs > 1 else torch.zeros(n_nodes, dtype=torch.int32,
                                         device=dev)
    ti = to = None
    if max_triplets:
        ti_np, to_np = build_triplets(src, dst, n_nodes, max_triplets)
        ti, to = tensor(ti_np, np.int32), tensor(to_np, np.int32)
    return GraphBatch(n_nodes=n_nodes, node_feat=node_feat,
                      src=tensor(src, np.int32), dst=tensor(dst, np.int32),
                      positions=pos, graph_id=gid, n_graphs=n_graphs,
                      trip_in=ti, trip_out=to)


def neighbor_sample(row_ptr: np.ndarray, col: np.ndarray,
                    seeds: np.ndarray, fanouts: list[int],
                    seed: int = 0) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Multi-hop uniform neighbor sampler (GraphSAGE-style, fanout list).

    Returns (nodes, sub_src, sub_dst): sampled node set (seeds first) and
    the sampled subgraph edges in *local* node numbering.
    """
    rng = np.random.default_rng(seed)
    nodes = list(dict.fromkeys(seeds.tolist()))
    local = {v: i for i, v in enumerate(nodes)}
    sub_src, sub_dst = [], []
    frontier = list(nodes)
    for fan in fanouts:
        nxt = []
        for v in frontier:
            lo, hi = int(row_ptr[v]), int(row_ptr[v + 1])
            deg = hi - lo
            if deg == 0:
                continue
            k = min(fan, deg)
            picks = rng.choice(deg, size=k, replace=False)
            for pk in picks:
                u = int(col[lo + pk])
                if u not in local:
                    local[u] = len(nodes)
                    nodes.append(u)
                    nxt.append(u)
                sub_src.append(local[u])
                sub_dst.append(local[v])
        frontier = nxt
    return (np.asarray(nodes, np.int64), np.asarray(sub_src, np.int64),
            np.asarray(sub_dst, np.int64))


def sampled_batch(row_ptr, col, seeds, fanouts, d_feat: int, *,
                  pad_nodes: int, pad_edges: int, seed: int = 0,
                  feats: np.ndarray | None = None,
                  device: str | torch.device | None = None) -> GraphBatch:
    """Fixed-shape GraphBatch from a neighbor sample (pads to static dims),
    on ``device``."""
    dev = resolve_device(device)
    nodes, s, d = neighbor_sample(row_ptr, col, seeds, fanouts, seed)
    nodes = nodes[:pad_nodes]
    keep = (s < pad_nodes) & (d < pad_nodes)
    s, d = s[keep][:pad_edges], d[keep][:pad_edges]
    e_pad = pad_edges - len(s)
    rng = np.random.default_rng(seed + 1)
    if feats is None:
        f = rng.standard_normal((pad_nodes, d_feat)).astype(np.float32)
    else:
        f = np.zeros((pad_nodes, d_feat), np.float32)
        f[:len(nodes)] = feats[nodes]
    src = np.concatenate([s, np.full(e_pad, pad_nodes)])
    dst = np.concatenate([d, np.full(e_pad, pad_nodes)])
    return GraphBatch(
        n_nodes=pad_nodes, node_feat=torch.from_numpy(f).to(dev),
        src=torch.from_numpy(src.astype(np.int32)).to(dev),
        dst=torch.from_numpy(dst.astype(np.int32)).to(dev))


def reorder_by_rst(graph_src: np.ndarray, graph_dst: np.ndarray,
                   n_nodes: int, method: str = "gconn_euler", *,
                   device: str | torch.device | None = None,
                   use_kernel: bool | None = None) -> torch.Tensor:
    """Relabel nodes by RST order (the paper's technique in the data
    pipeline).

    ``graph_src`` / ``graph_dst`` are the half-edge arrays of a ``Graph``
    (host arrays). Returns ``perm`` (int64, on ``device``: the card unless
    the caller names another) with ``perm[old_id] = new_id``: nodes sorted
    stably by parent, so children of one parent are contiguous, for better
    gather locality. ``use_kernel`` goes to ``rooted_spanning_tree``.
    """
    g = Graph.from_reference_arrays(n_nodes, graph_src, graph_dst, device)
    parent = rooted_spanning_tree(g, 0, method=method, use_kernel=use_kernel,
                                  device=g.device).parent
    # The reference's np.lexsort((arange, parent)): a stable sort by parent.
    order = torch.sort(parent.long(), stable=True).indices
    perm = torch.empty(n_nodes, dtype=torch.int64, device=g.device)
    perm[order] = torch.arange(n_nodes, device=g.device)
    return perm
