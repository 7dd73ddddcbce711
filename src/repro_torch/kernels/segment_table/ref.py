"""Plain PyTorch version of the segment_table kernel, and the min/max it
folds with."""
from __future__ import annotations

import torch


def minimum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.minimum`` with -0.0 below +0.0, as ``jnp.minimum`` and torch
    on the card order them; on the CPU torch keeps the first operand of a
    tie of zeros. NaN propagates."""
    out = torch.minimum(a, b)
    if out.is_floating_point() and not out.is_cuda:
        out = torch.where((a == b) & torch.signbit(b), b, out)
    return out


def maximum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.maximum`` with +0.0 above -0.0 (see ``minimum``)."""
    out = torch.maximum(a, b)
    if out.is_floating_point() and not out.is_cuda:
        out = torch.where((a == b) & torch.signbit(a), b, out)
    return out


_COMBINE = {"min": minimum, "max": maximum}


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
        table[k + 1, :n - s] = combine(table[k, :n - s], table[k, s:])
        table[k + 1, n - s:] = table[k, n - s:]
    return table
