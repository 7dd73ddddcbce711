"""Plain PyTorch version of the list_rank doubling kernel."""
from __future__ import annotations

import torch

NO_SUCC = -1


def list_rank_double_ref(succ: torch.Tensor, dist: torch.Tensor,
                         n_steps: int):
    """``n_steps`` Wyllie doubling steps; each reads the previous step's
    (succ, dist) tables. Returns the new ``(succ, dist)``."""
    for _ in range(n_steps):
        has = succ != NO_SUCC
        safe = torch.where(has, succ, 0)
        dist = dist + torch.where(has, dist[safe], 0)
        succ = torch.where(has, succ[safe], NO_SUCC)
    return succ, dist
