"""Plain PyTorch version of the frontier_relax kernel."""
from __future__ import annotations

import torch

INF32 = torch.iinfo(torch.int32).max


def frontier_relax_ref(dist: torch.Tensor, src: torch.Tensor,
                       dst: torch.Tensor, level: int) -> torch.Tensor:
    """bool[E]: the half-edges whose source is on BFS level ``level`` and
    whose destination is undiscovered (``dist == INF32``)."""
    return (dist[src] == level) & (dist[dst] == INF32)
