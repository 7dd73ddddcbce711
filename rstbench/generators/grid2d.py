"""A side x side 2-D lattice (a 5-point stencil without its diagonal),
vertex ids row-major.

Built on the device. Each undirected edge appears once, ordered by
(smaller end, larger end); half-edge ``i`` and ``i + M`` are its two
directions (``src = [lo, hi]``, ``dst = [hi, lo]``). The seed plays no
part: the grid is the same in every run.
"""
from __future__ import annotations

import torch


def build(params: dict, seed: int, device) -> tuple[int, torch.Tensor,
                                                    torch.Tensor]:
    side = int(params["side"])
    n = side * side
    ids = torch.arange(n, dtype=torch.int64, device=device).view(side, side)
    lo = torch.cat([ids[:, :-1].reshape(-1), ids[:-1, :].reshape(-1)])
    hi = torch.cat([ids[:, 1:].reshape(-1), ids[1:, :].reshape(-1)])
    key, _ = torch.sort(lo * n + hi)
    lo, hi = (key // n).to(torch.int32), (key % n).to(torch.int32)
    return n, torch.cat([lo, hi]), torch.cat([hi, lo])
