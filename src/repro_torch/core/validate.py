"""Validity checks for rooted spanning trees (used by tests and chip_smoke).

A parent array P is a valid RST of G rooted at r iff:
  1. P[r] == r;
  2. every reachable vertex v != r has (v, P[v]) ∈ E(G);
  3. following parents from any reachable vertex ends at r (acyclicity and
     connectivity);
  4. unreachable vertices are marked (-1) or self-rooted in their own
     component (connectivity-based methods).

The port of ``repro.core.validate``. The checks run as tensor code on the
graph's device; ``bfs_depths_reference`` and ``components_reference`` are
the numpy BFS and union-find oracles.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.compress import compress_full
from repro_torch.core.graph import Graph


def reaches_root(parent: torch.Tensor) -> torch.Tensor:
    """bool[n]: following parents from v reaches a self-loop (a root)."""
    verts = torch.arange(parent.numel(), dtype=parent.dtype,
                         device=parent.device)
    mapped = torch.where(parent < 0, verts, parent)
    # Bounded compression: odd cycles never converge (64 checks × 5
    # doublings covers any real depth) and even cycles collapse to spurious
    # fixed points, so a fixed point counts only if it is a self-loop of the
    # ORIGINAL table.
    hop = compress_full(mapped, max_syncs=64)
    return mapped[hop] == hop


def validate_rst(graph: Graph, parent: torch.Tensor, root, *,
                 connected: bool = True) -> dict:
    """Vectorized validation; returns a dict of named booleans.

    Robust to corrupted input: negative parents are self-rooted singletons,
    out-of-range parents fail the edge check, cycles fail the acyclicity
    check. Edge membership packs (a, b) as ``a·(n+1)+b`` (endpoints ≤ n, so
    keys are collision-free) and looks both orientations up in the sorted
    half-edge keys.
    """
    n = graph.n_nodes
    dev = graph.device
    parent = torch.as_tensor(parent, device=dev)
    root = int(root)
    src = graph.src.long()
    dst = graph.dst.long()
    verts = torch.arange(n, dtype=torch.int64, device=dev)

    ok_root = bool(parent[root] == root)

    pclip = torch.clamp(parent.long(), 0, n)
    edge_keys = torch.sort(torch.cat([src * (n + 1) + dst,
                                      dst * (n + 1) + src])).values
    query = verts * (n + 1) + pclip
    need = (parent >= 0) & (parent.long() != verts) & (verts != root)
    if edge_keys.numel():
        pos = torch.searchsorted(edge_keys, query)
        present = edge_keys[torch.clamp(pos, max=edge_keys.numel() - 1)] == query
    else:
        present = torch.zeros_like(need)
    ok_edges = bool(torch.all(present | ~need))

    in_range = (parent >= 0) & (parent < n)
    mapped = torch.where(in_range, parent.to(torch.int32),
                         verts.to(torch.int32))
    hop = compress_full(mapped, max_syncs=64)
    reach = mapped[hop.long()] == hop
    ok_acyclic = bool(torch.all(reach | (parent < 0)))

    reach_root_count = int(torch.sum((parent >= 0) & reach & (hop == root)))
    ok_connected = (not connected) or (reach_root_count == n)
    return {
        "root_fixed": ok_root,
        "parent_edges_in_graph": ok_edges,
        "acyclic": ok_acyclic,
        "spans": ok_connected,
        "all_ok": ok_root and ok_edges and ok_acyclic and ok_connected,
    }


def bfs_depths_reference(graph: Graph, root: int) -> np.ndarray:
    """Reference BFS distances via numpy/deque (oracle for tests); -1 where
    the root does not reach."""
    from collections import deque

    n = graph.n_nodes
    adj: list[list[int]] = [[] for _ in range(n)]
    for u, v in zip(graph.src.cpu().tolist(), graph.dst.cpu().tolist()):
        adj[u].append(v)
    dist = np.full(n, -1, np.int64)
    dist[root] = 0
    q = deque([root])
    while q:
        u = q.popleft()
        for v in adj[u]:
            if dist[v] < 0:
                dist[v] = dist[u] + 1
                q.append(v)
    return dist


def components_reference(graph: Graph) -> np.ndarray:
    """Union-find component labels (oracle for connectivity tests)."""
    n = graph.n_nodes
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for u, v in zip(graph.src.cpu().tolist(), graph.dst.cpu().tolist()):
        ru, rv = find(u), find(v)
        if ru != rv:
            parent[max(ru, rv)] = min(ru, rv)
    return np.asarray([find(v) for v in range(n)], np.int64)
