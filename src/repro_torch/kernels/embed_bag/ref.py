"""Plain PyTorch version of the embed_bag kernel."""
from __future__ import annotations

import torch


def embed_bag_ref(idx: torch.Tensor, weights: torch.Tensor | None,
                  table: torch.Tensor, *, mean: bool = False) -> torch.Tensor:
    """out[b] = Σ_h w[b, h] · table[idx[b, h]]; with ``mean``, divided by
    max(Σ_h w[b, h], 1e-9). ``weights=None`` means all ones.

    As in the reference, each weight is cast to the table's dtype and each
    product rounded to it; the sum (and Σw) is then taken in float32 and
    rounded to the table's dtype once, as the kernel does.
    """
    rows = table[idx]                                 # [B, hot, D]
    if weights is not None:
        rows = rows * weights[..., None].to(table.dtype)
    acc = rows.float().sum(1)
    if mean:
        w_sum = (torch.full_like(acc[:, :1], idx.shape[1]) if weights is None
                 else weights.float().sum(1, keepdim=True))
        acc = acc / w_sum.clamp_min(1e-9)
    return acc.to(table.dtype)
