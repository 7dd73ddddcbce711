"""Plain PyTorch version of the pointer_jump doubling kernel."""
from __future__ import annotations

import torch


def pointer_jump_double_ref(p: torch.Tensor, n_jumps: int) -> torch.Tensor:
    """Apply ``p = p[p]`` ``n_jumps`` times (each step doubles the jump)."""
    for _ in range(n_jumps):
        p = p[p]
    return p
