"""Plain PyTorch versions of the pointer_jump kernels."""
from __future__ import annotations

import torch


def pointer_jump_double_ref(p: torch.Tensor, n_jumps: int) -> torch.Tensor:
    """Apply ``p = p[p]`` ``n_jumps`` times (each step doubles the jump)."""
    for _ in range(n_jumps):
        p = p[p]
    return p


def pointer_jump_ref(p: torch.Tensor, n_jumps: int) -> torch.Tensor:
    """Apply ``idx = p[idx]`` ``n_jumps`` times, starting from ``idx = p``:
    ``n_jumps + 1`` hops against the fixed table ``p``."""
    idx = p
    for _ in range(n_jumps):
        idx = p[idx]
    return idx
