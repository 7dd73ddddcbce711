"""Breadth-first search, level by level, in plain PyTorch.

The BFS tree the program states: every vertex at distance d > 0 from the
root takes, among its neighbours at distance d - 1, the smallest id as its
parent. That tree is unique, so the check is exact.
"""
from __future__ import annotations

import torch

INF32 = torch.iinfo(torch.int32).max


def bfs(src: torch.Tensor, dst: torch.Tensor, n: int, root: int):
    """``(dist, parent)`` int64[n]: -1 where the root does not reach."""
    s, d = src.long(), dst.long()
    dist = torch.full((n,), -1, dtype=torch.int64, device=src.device)
    dist[root] = 0
    level = 0
    while True:
        reach = (dist[s] == level) & (dist[d] < 0)
        if not bool(reach.any()):
            break
        dist[d[reach]] = level + 1
        level += 1
    ds = dist[d]
    offer = (ds > 0) & (dist[s] == ds - 1)
    parent = torch.full((n,), INF32, dtype=torch.int64, device=src.device)
    parent.scatter_reduce_(0, d[offer], s[offer], "amin")
    parent[root] = root
    parent[dist < 0] = -1
    return dist, parent


def check_bfs_tree(ref_dist: torch.Tensor, ref_parent: torch.Tensor,
                   parent: torch.Tensor, dist: torch.Tensor | None) -> dict:
    """Vertices whose parent, or whose distance (INF32 where unreached),
    differs from the reference's. A missing ``dist`` counts every vertex."""
    out = {"bad_bfs_parent": int((parent.long() != ref_parent).sum())}
    if dist is None:
        out["bad_dist"] = ref_dist.numel()
    else:
        want = torch.where(ref_dist < 0, INF32, ref_dist)
        out["bad_dist"] = int((dist.long() != want).sum())
    return out
