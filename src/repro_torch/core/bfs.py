"""Edge-centric BFS rooted spanning tree (the paper's baseline, §III-A).

The port of ``repro.core.bfs``: every level relaxes *all* half-edges. Each
undiscovered vertex with an edge from the frontier takes the smallest
proposing source as its parent (the reference's deterministic scatter-min).
On the card one ``bfs_level`` call runs the level (the mask, the min and
the updates in two launches, no temporary); on the CPU its plain version
runs the reference's dense ops. The reference's ``lax.while_loop`` becomes
a host loop with one convergence read per level (the level's flag): the
Θ(diam(G)) round trips the paper charges to BFS.

Returns (parent, dist, levels): ``parent[root] == root``; unreachable
vertices keep ``parent == -1`` and ``dist == INF32``.
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.core.graph import Graph
from repro_torch.kernels import kernel_wanted
from repro_torch.kernels.frontier_relax.ops import bfs_level, bfs_level_buffer
from repro_torch.kernels.frontier_relax.ref import level_constants

INF32 = torch.iinfo(torch.int32).max


def bfs_rst(graph: Graph, root, *, max_levels: int | None = None,
            use_kernel: bool | None = None, lanes: int | None = None):
    """Level-synchronous edge-centric BFS spanning tree.

    Args:
      graph: Graph (paired half-edges).
      root: vertex id.
      max_levels: optional bound on loop bodies (defaults to n_nodes).
      use_kernel: each level through the ``bfs_level`` kernel (see
        ``repro_torch.kernels.kernel_wanted``).
      lanes: the graph is a disjoint union of that many equal lanes of
        vertices (``core.bcc.bcc_batch``) and ``root`` an int32 tensor of
        one root a lane: one search from all roots, each lane's tree its
        own search's (the smallest proposer keeps its order in a lane),
        and ``levels`` int32[lanes], each lane's deepest level (its own
        loop's bodies minus one).

    Returns:
      parent: int32[n] parent array (-1 = unreachable, parent[root] = root).
      dist:   int32[n] hop distance (INF32 = unreachable).
      levels: int, loop bodies run minus one (= the tree's depth when the
        loop ran to convergence).

    The level loop is the ``bfs.levels`` span (``obs``).
    """
    n = graph.n_nodes
    src, dst = graph.src, graph.dst
    dev = src.device
    dist = torch.full((n,), INF32, dtype=torch.int32, device=dev)
    parent = torch.full((n,), -1, dtype=torch.int32, device=dev)
    if lanes is None:
        root = int(root)
        dist[root] = 0
        parent[root] = root
    else:
        roots = root.to(dev, torch.int32)
        dist[roots.long()] = 0
        parent[roots.long()] = roots

    # What the levels share: the kernel's proposal buffer, or the plain
    # version's graph constants.
    if kernel_wanted(src, use_kernel):
        cand, consts = bfs_level_buffer(n, dev), None
    else:
        cand, consts = None, level_constants(src, dst, n)
    bound = (n if lanes is None else n // lanes) if max_levels is None \
        else max_levels
    level, changed = 0, True
    with obs.span("bfs.levels"):
        while changed and level < bound:
            changed = bfs_level(dist, parent, cand, src, dst, level,
                                consts=consts, use_kernel=use_kernel)
            level += 1
    if lanes is not None:
        reached = torch.where(dist < INF32, dist, 0).view(lanes, -1)
        return parent, dist, torch.amax(reached, 1)
    return parent, dist, level - 1
