"""Plain PyTorch version of the hook_edges kernel."""
from __future__ import annotations

import torch


def hook_edges_ref(src: torch.Tensor, dst: torch.Tensor, rep: torch.Tensor,
                   use_min: bool, n_nodes: int):
    """Per half-edge ``(tgt, val)``; ``tgt == n_nodes`` where the edge does
    not cross components."""
    ru = rep[src]
    rv = rep[dst]
    lo = torch.minimum(ru, rv)
    hi = torch.maximum(ru, rv)
    tgt, val = (hi, lo) if use_min else (lo, hi)
    return torch.where(ru != rv, tgt, n_nodes), val
