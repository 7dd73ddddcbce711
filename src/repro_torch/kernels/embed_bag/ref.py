"""Plain PyTorch version of the embed_bag kernel."""
from __future__ import annotations

import torch


def embed_bag_ref(idx: torch.Tensor, weights: torch.Tensor | None,
                  table: torch.Tensor, *, mean: bool = False) -> torch.Tensor:
    """out[b] = Σ_h w[b, h] · table[idx[b, h]]; with ``mean``, divided by
    max(Σ_h w[b, h], 1e-9). ``weights=None`` means all ones.

    As in the reference, each weight is cast to the table's dtype and each
    product rounded to it; the sum (and Σw) is then taken in float32, in the
    order h = 0 .. hot - 1 as the kernel takes it (a reduction on the card
    would group the terms otherwise), and rounded to the table's dtype once.
    """
    rows = table[idx]                                 # [B, hot, D]
    if weights is not None:
        rows = rows * weights[..., None].to(table.dtype)
    acc = rows.new_zeros((rows.shape[0], rows.shape[2]), dtype=torch.float32)
    for h in range(rows.shape[1]):
        acc += rows[:, h].float()
    if mean:
        w_sum = acc.new_full((idx.shape[0], 1), idx.shape[1])
        if weights is not None:
            w_sum.zero_()
            for h in range(weights.shape[1]):
                w_sum += weights[:, h:h + 1].float()
        acc = acc / w_sum.clamp_min(1e-9)
    return acc.to(table.dtype)
