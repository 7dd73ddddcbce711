"""Is a parent array a spanning tree of the graph rooted at the root?

A rooted spanning tree of a connected graph (the configurations state that
theirs are) is right when the root points to itself, every other vertex
points to a neighbour, and every chain of parents ends at the root. Any
such tree is a right answer: the check judges the array by what it says.
"""
from __future__ import annotations

import torch


def edge_keys(src: torch.Tensor, dst: torch.Tensor, n: int) -> torch.Tensor:
    """Sorted int64 keys ``u * n + v`` of every half-edge (u, v)."""
    return torch.sort(src.long() * n + dst.long()).values


def is_edge(keys: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
            n: int) -> torch.Tensor:
    """bool: (u[i], v[i]) is a half-edge of the graph."""
    q = u.long() * n + v.long()
    i = torch.searchsorted(keys, q).clamp_max(keys.numel() - 1)
    return keys[i] == q


def tree_roots(parent: torch.Tensor) -> torch.Tensor:
    """int64[n]: where each vertex's chain of parents ends, by doubling.

    An id outside [0, n) stops its chain where it stands, so a vertex on a
    cycle or below a bad id ends somewhere other than a self-pointing
    root."""
    n = parent.numel()
    verts = torch.arange(n, device=parent.device)
    p = parent.long()
    anc = torch.where((p >= 0) & (p < n), p, verts)
    for _ in range(max(n, 2).bit_length()):
        anc = anc[anc]
    return anc


def check_spanning_tree(keys: torch.Tensor, n: int, root: int,
                        parent: torch.Tensor) -> tuple[dict, torch.Tensor]:
    """``({"bad_parent": k, "unrooted": u}, ends)``.

    k counts vertices whose parent is out of range, is themselves (but at
    the root), is not a neighbour, or, at the root, is not the root; u
    counts vertices whose chain of parents does not end at the root.
    ``ends`` is where each chain ends."""
    verts = torch.arange(n, device=parent.device)
    p = parent.long()
    in_range = (p >= 0) & (p < n)
    nonroot = verts != root
    pc = p.clamp(0, n - 1)
    bad = ~in_range | (nonroot & (p == verts))
    bad |= nonroot & in_range & ~is_edge(keys, verts, pc, n)
    bad |= ~nonroot & (p != root)
    ends = tree_roots(parent)
    return ({"bad_parent": int(bad.sum()),
             "unrooted": int((ends != root).sum())}, ends)


def check_component_rep(ends: torch.Tensor, rep: torch.Tensor) -> dict:
    """Representatives judged against the components the tree shows.

    ``ends`` (from ``check_spanning_tree``) names each vertex's tree. A
    right ``rep`` names a vertex of the same tree, the same one for the
    whole tree, and another one for every other tree. Counts the vertices
    that break this, plus the trees that share a representative."""
    n = rep.numel()
    verts = torch.arange(n, device=rep.device)
    r = rep.long()
    in_range = (r >= 0) & (r < n)
    rc = r.clamp(0, n - 1)
    bad = ~in_range | (ends[rc] != ends) | (r != r[ends])
    tops = rc[ends == verts]
    shared = torch.bincount(tops, minlength=n) > 1
    return {"bad_rep": int(bad.sum()) + int(shared.sum())}
