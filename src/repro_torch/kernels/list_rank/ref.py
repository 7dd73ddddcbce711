"""Plain PyTorch versions of the list_rank kernels."""
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


def list_rank_steps_ref(succ: torch.Tensor, dist: torch.Tensor,
                        n_steps: int):
    """``n_steps`` Wyllie updates against one snapshot of the input tables:
    the (k+1)-hop chain prefix sums. Returns the new ``(succ, dist)``."""
    succ_tab, dist_tab = succ, dist
    for _ in range(n_steps):
        has = succ != NO_SUCC
        safe = torch.where(has, succ, 0)
        dist = dist + torch.where(has, dist_tab[safe], 0)
        succ = torch.where(has, succ_tab[safe], NO_SUCC)
    return succ, dist


def list_rank_full_ref(succ: torch.Tensor, valid: torch.Tensor
                       ) -> torch.Tensor:
    """Distance-to-end for every list element: Wyllie steps until no list
    is open (the full-convergence oracle)."""
    dist = (valid & (succ != NO_SUCC)).to(torch.int32)
    while bool(torch.any(succ != NO_SUCC)):
        succ, dist = list_rank_double_ref(succ, dist, 1)
    return dist
