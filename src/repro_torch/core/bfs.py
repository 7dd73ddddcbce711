"""Edge-centric BFS rooted spanning tree (the paper's baseline, §III-A).

The port of ``repro.core.bfs``: every level relaxes *all* half-edges with
dense ops. The ``frontier_relax`` kernel (one launch per level) marks the
half-edges whose source is on the frontier and whose destination is
undiscovered; a deterministic scatter-min then gives each newly discovered
vertex its smallest proposing source as parent. The reference's
``lax.while_loop`` becomes a host loop with one convergence read per level
(``bool(torch.any(discovered))``): the Θ(diam(G)) round trips the paper
charges to BFS.

Returns (parent, dist, levels): ``parent[root] == root``; unreachable
vertices keep ``parent == -1`` and ``dist == INF32``.
"""
from __future__ import annotations

import torch

from repro_torch.core.graph import Graph
from repro_torch.kernels.frontier_relax.ops import frontier_relax

INF32 = torch.iinfo(torch.int32).max


def bfs_rst(graph: Graph, root, *, max_levels: int | None = None,
            use_kernel: bool | None = None):
    """Level-synchronous edge-centric BFS spanning tree.

    Args:
      graph: Graph (paired half-edges).
      root: vertex id.
      max_levels: optional bound on loop bodies (defaults to n_nodes).
      use_kernel: the per-level relaxation through the ``frontier_relax``
        kernel (see ``repro_torch.kernels.kernel_wanted``).

    Returns:
      parent: int32[n] parent array (-1 = unreachable, parent[root] = root).
      dist:   int32[n] hop distance (INF32 = unreachable).
      levels: int, loop bodies run minus one (= the tree's depth when the
        loop ran to convergence).
    """
    n = graph.n_nodes
    src, dst = graph.src, graph.dst
    dev = src.device
    root = int(root)

    dist = torch.full((n,), INF32, dtype=torch.int32, device=dev)
    dist[root] = 0
    parent = torch.full((n,), -1, dtype=torch.int32, device=dev)
    parent[root] = root

    # Graph constants, hoisted out of the level loop. Edges off the frontier
    # scatter the min's identity into n extra slots spread by edge id, cut
    # off after: sent to their own destination, as in the reference, a
    # power-law hub would take ~10^5 atomics on one address every level.
    dst64 = dst.long()
    drop = n + torch.arange(src.numel(), dtype=torch.int64,
                            device=dev) % max(n, 1)

    bound = n if max_levels is None else max_levels
    level, changed = 0, True
    while changed and level < bound:
        active = frontier_relax(dist, src, dst, level, use_kernel=use_kernel)
        winner = torch.full((2 * n,), INF32, dtype=torch.int32, device=dev)
        winner.scatter_reduce_(0, torch.where(active, dst64, drop),
                               torch.where(active, src, INF32), "amin")
        winner = winner[:n]
        discovered = winner != INF32
        parent = torch.where(discovered, winner, parent)
        dist = torch.where(discovered, level + 1, dist)
        changed = bool(torch.any(discovered))
        level += 1
    return parent, dist, level - 1
