"""Downstream tree analytics on rooted spanning trees.

The port of ``repro.core.analytics``: the two classic consumers of a rooted
forest, on the engine primitives (DESIGN.md §3).

  * ``depths(parent)``        — exact depth of every vertex;
  * ``subtree_sizes(parent)`` — |subtree(v)| for every v, level by level
                                from the deepest up: O(depth) steps, the
                                depth cost the paper's Fig. 2 measures.
                                ``core/bcc.py`` gets the same numbers in
                                O(log n) from ``euler.tour_numbering``.
"""
from __future__ import annotations

import torch

from repro_torch.core.compress import rank_to_root


def depths(parent: torch.Tensor) -> torch.Tensor:
    """int32[n] depth of each vertex from its root (roots carry 0).

    Engine pointer doubling (``compress.rank_to_root``): O(log depth)
    steps with amortized convergence syncs. ``parent`` is a self-rooted
    acyclic table.
    """
    d, _root = rank_to_root(parent)
    return d


def subtree_sizes(parent: torch.Tensor) -> torch.Tensor:
    """int32[n] vertex count of v's subtree, v included.

    One host read of the maximum depth, then a host loop from that depth
    up to 1 with one scatter-add into the parents per level (the
    reference's ``lax.while_loop``). Vertices off the level scatter 0 into
    n drop slots, one per vertex, that are cut off, so no address takes
    more writers than a real parent has children.
    """
    n = parent.numel()
    dep = depths(parent)
    max_d = int(torch.max(dep)) if n else 0
    verts = torch.arange(n, dtype=parent.dtype, device=parent.device)
    nonroot = parent != verts
    drop = (verts + n).long()
    sizes = torch.ones(n, dtype=torch.int32, device=parent.device)
    for level in range(max_d, 0, -1):
        at = (dep == level) & nonroot
        buf = torch.cat([sizes, torch.zeros_like(sizes)])
        buf.scatter_add_(0, torch.where(at, parent.long(), drop),
                         torch.where(at, sizes, 0))
        sizes = buf[:n]
    return sizes
