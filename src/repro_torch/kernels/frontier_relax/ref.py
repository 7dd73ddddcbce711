"""Plain PyTorch versions of the frontier_relax kernels."""
from __future__ import annotations

import torch

INF32 = torch.iinfo(torch.int32).max


def frontier_relax_ref(dist: torch.Tensor, src: torch.Tensor,
                       dst: torch.Tensor, level: int) -> torch.Tensor:
    """bool[E]: the half-edges whose source is on BFS level ``level`` and
    whose destination is undiscovered (``dist == INF32``)."""
    return (dist[src] == level) & (dist[dst] == INF32)


def level_constants(src: torch.Tensor, dst: torch.Tensor, n: int):
    """The plain level's graph constants: ``dst`` as int64, and for each
    half-edge a drop slot in [n, 2n) spread by edge id. A caller that runs
    many levels builds them once."""
    drop = n + torch.arange(src.numel(), dtype=torch.int64,
                            device=src.device) % max(n, 1)
    return dst.long(), drop


def bfs_level_ref(dist: torch.Tensor, parent: torch.Tensor,
                  src: torch.Tensor, dst: torch.Tensor, level: int, *,
                  active: torch.Tensor | None = None,
                  consts=None) -> bool:
    """One level of the edge-centric BFS, in place on ``dist`` and
    ``parent``; returns whether it discovered a vertex (one host read).

    Every undiscovered vertex with an edge from the frontier takes the
    smallest proposing source as its parent and ``level + 1`` as its
    distance: the reference's deterministic scatter-min. ``active`` is the
    level's ``frontier_relax`` mask where the caller has it, else it is
    computed here; ``consts`` is ``level_constants(src, dst, n)``, built
    here where None. Edges off the frontier scatter the min's identity
    into their drop slots, cut off after: sent to their own destination,
    as in the reference, a power-law hub would take ~10^5 atomics on one
    address on the card.
    """
    n = dist.numel()
    if active is None:
        active = frontier_relax_ref(dist, src, dst, level)
    dst64, drop = level_constants(src, dst, n) if consts is None else consts
    winner = torch.full((2 * n,), INF32, dtype=torch.int32, device=src.device)
    winner.scatter_reduce_(0, torch.where(active, dst64, drop),
                           torch.where(active, src, INF32), "amin")
    winner = winner[:n]
    discovered = winner != INF32
    parent.copy_(torch.where(discovered, winner, parent))
    dist.masked_fill_(discovered, level + 1)
    return bool(torch.any(discovered))
