"""Plain PyTorch version of the segment_table kernel."""
from __future__ import annotations

import torch

_COMBINE = {"min": torch.minimum, "max": torch.maximum}


def segment_table_ref(values: torch.Tensor, *, levels: int,
                      op: str) -> torch.Tensor:
    """[levels + 1, n] table: row k holds op over values[i : min(i + 2^k, n)].

    Row k + 1 is ``op(row_k[i], row_k[i + 2^k])``; positions past the end
    keep ``row_k[i]``, which is what folding the op's identity (the
    reference's Pallas kernel) and clamping the shifted read to n − 1 (its
    plain path) both give. Float min/max propagate NaN.
    """
    combine = _COMBINE[op]
    n = values.numel()
    table = values.new_empty((levels + 1, n))
    table[0] = values
    for k in range(levels):
        s = min(1 << k, n)
        combine(table[k, :n - s], table[k, s:], out=table[k + 1, :n - s])
        table[k + 1, n - s:] = table[k, n - s:]
    return table
