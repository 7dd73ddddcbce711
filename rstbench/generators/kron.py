"""The Graph500 Kronecker (R-MAT) generator, built on the device.

``edgefactor * 2**scale`` edge samples, each of ``scale`` levels choosing
a quadrant with probabilities A, B, C and 1 - A - B - C, as the Graph500
specification's generator does. With ``implant_tree`` a random recursive
tree (each vertex, in a random order, attaches to a uniformly chosen
earlier one) is added, so every vertex is reachable. The vertex labels are
permuted, as the specification permutes them. The samples, the tree and
the permutation all come from the configuration's ``graph_seed``, so every
run holds the same graph: the port's time on it moved by up to 1.9x from
one permutation to another at edgefactor 16, so a permutation drawn from
the run's seed would change the work from run to run. Self-loops and
repeated edges are dropped; the edges are ordered by (smaller end, larger
end) of the permuted labels, and half-edge ``i`` and ``i + M`` are the two
directions of edge ``i``.
"""
from __future__ import annotations

import torch

from rstbench import seeds


def build(params: dict, seed: int, device) -> tuple[int, torch.Tensor,
                                                    torch.Tensor]:
    scale = int(params["scale"])
    a, b, c = float(params["a"]), float(params["b"]), float(params["c"])
    n = 1 << scale
    m = n * int(params["edgefactor"])
    g = seeds.torch_generator(device, params["graph_seed"], seeds.GRAPH)
    src = torch.zeros(m, dtype=torch.int64, device=device)
    dst = torch.zeros(m, dtype=torch.int64, device=device)
    for _ in range(scale):
        r1 = torch.rand(m, generator=g, device=device)
        r2 = torch.rand(m, generator=g, device=device)
        lower = r1 > a + b
        right = torch.where(lower, r2 > c / (1 - a - b), r2 > a / (a + b))
        src = src * 2 + lower
        dst = dst * 2 + right
    if params.get("implant_tree"):
        order = torch.randperm(n, generator=g, device=device)
        earlier = torch.arange(1, n, dtype=torch.float64, device=device)
        pick = torch.rand(n - 1, generator=g, dtype=torch.float64,
                          device=device) * earlier
        pick = torch.minimum(pick.long(), earlier.long() - 1)
        src = torch.cat([src, order[1:]])
        dst = torch.cat([dst, order[pick]])
    labels = torch.randperm(n, generator=g, device=device)
    src, dst = labels[src], labels[dst]
    lo, hi = torch.minimum(src, dst), torch.maximum(src, dst)
    keep = lo != hi
    key = torch.unique(lo[keep] * n + hi[keep])
    lo, hi = (key // n).to(torch.int32), (key % n).to(torch.int32)
    return n, torch.cat([lo, hi]), torch.cat([hi, lo])
