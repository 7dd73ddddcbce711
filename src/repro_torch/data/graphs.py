"""Synthetic graph suite with controlled diameter (paper Table II analogue).

The paper's datasets span three structural regimes the generators below
reproduce at laptop scale:
  * high-diameter sparse (road_usa, europe_osm)  → ``grid2d`` / ``chain``
  * power-law low-diameter (kron_g500, orkut)    → ``rmat``
  * mid-diameter web-ish (web-BerkStan, uk-2002) → ``pref_attach``
  * uniform random (control)                     → ``erdos_renyi``

All generators return a connected ``Graph`` (a random spanning tree is
implanted first, extra edges added on top), so RST validity is always
well-defined for any root.

A copy of ``repro.data.graphs``: for the same arguments and seed every
generator gives the same half-edge arrays. ``device`` places the graph; it
defaults to the card (``core.graph.resolve_device``).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.graph import Graph


def _implant_tree(n: int, rng: np.random.Generator) -> np.ndarray:
    """Random spanning tree edges (uniform attachment)."""
    perm = rng.permutation(n)
    attach = (rng.random(n - 1) * np.arange(1, n)).astype(np.int64)
    return np.stack([perm[1:], perm[attach]], axis=1)


def chain(n: int, seed: int = 0, device=None) -> Graph:
    """Path graph — the worst case for BFS (diameter n-1)."""
    edges = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)
    return Graph.from_numpy_undirected(n, edges, device)


def grid2d(side: int, seed: int = 0, device=None) -> Graph:
    """side × side grid — road-network analogue (diameter 2·(side-1))."""
    n = side * side
    ids = np.arange(n).reshape(side, side)
    horiz = np.stack([ids[:, :-1].ravel(), ids[:, 1:].ravel()], axis=1)
    vert = np.stack([ids[:-1, :].ravel(), ids[1:, :].ravel()], axis=1)
    return Graph.from_numpy_undirected(n, np.concatenate([horiz, vert]),
                                      device)


def erdos_renyi(n: int, avg_degree: float = 4.0, seed: int = 0,
                device=None) -> Graph:
    rng = np.random.default_rng(seed)
    m = int(n * avg_degree / 2)
    extra = rng.integers(0, n, (m, 2))
    edges = np.concatenate([_implant_tree(n, rng), extra])
    return Graph.from_numpy_undirected(n, edges, device)


def rmat(scale: int, edge_factor: int = 8, seed: int = 0,
         a: float = 0.57, b: float = 0.19, c: float = 0.19,
         device=None) -> Graph:
    """Kronecker/R-MAT power-law generator (kron_g500 analogue)."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * edge_factor
    src = np.zeros(m, np.int64)
    dst = np.zeros(m, np.int64)
    for _ in range(scale):
        r1 = rng.random(m)
        r2 = rng.random(m)
        src_bit = (r1 > a + b).astype(np.int64)
        dst_bit = (((r1 <= a + b) & (r2 > a / (a + b))) |
                   ((r1 > a + b) & (r2 > c / (1 - a - b)))).astype(np.int64)
        src = (src << 1) | src_bit
        dst = (dst << 1) | dst_bit
    edges = np.concatenate([np.stack([src, dst], 1), _implant_tree(n, rng)])
    return Graph.from_numpy_undirected(n, edges, device)


def pref_attach(n: int, m_per: int = 4, seed: int = 0,
                device=None) -> Graph:
    """Preferential attachment (Barabási–Albert) — web-graph analogue."""
    rng = np.random.default_rng(seed)
    targets = np.zeros(max((n - 1) * m_per, 1), np.int64)
    edges = []
    k = 0
    for v in range(1, n):
        lim = max(2 * k, 1)
        for _ in range(min(m_per, v)):
            if rng.random() < 0.5 or k == 0:
                t = int(rng.integers(0, v))
            else:
                t = int(targets[rng.integers(0, min(k, targets.shape[0]))] % v)
            edges.append((v, t))
            targets[k % targets.shape[0]] = t
            targets[(k + 1) % targets.shape[0]] = v
            k += 2
    return Graph.from_numpy_undirected(n, np.asarray(edges), device)


SUITE = {
    # name: (factory, kwargs, regime) — laptop-scale Table II analogue.
    "chain_4k": (chain, dict(n=4096), "extreme-diameter"),
    "grid_64": (grid2d, dict(side=64), "high-diameter road-like"),
    "grid_128": (grid2d, dict(side=128), "high-diameter road-like"),
    "er_16k": (erdos_renyi, dict(n=16384, avg_degree=8), "random control"),
    "rmat_14": (rmat, dict(scale=14, edge_factor=8), "power-law low-diameter"),
    "rmat_16": (rmat, dict(scale=16, edge_factor=4), "power-law low-diameter"),
    "ba_8k": (pref_attach, dict(n=8192, m_per=4), "web-like"),
}


def build_suite(names=None, device=None) -> dict[str, Graph]:
    """The ``SUITE`` graphs named (all of them by default), by name."""
    names = names or list(SUITE)
    return {k: SUITE[k][0](**SUITE[k][1], device=device) for k in names}


def resolve_graph(name: str, seed: int = 0, device=None) -> Graph:
    """Build a graph from a suite name or a parametric pattern.

    Accepts every ``SUITE`` key plus the patterns ``chain_<n>``,
    ``grid_<side>``, ``rmat_<scale>``, and ``er_<n>`` so fleet bucket
    specs (``--buckets chain_64:12``, DESIGN.md §15) aren't limited to
    the benchmark suite's sizes. Parametric ``rmat_<scale>`` uses
    ``edge_factor=4`` (the small-session regime buckets target); suite
    names keep their registered kwargs.
    """
    if name in SUITE:
        factory, kwargs, _ = SUITE[name]
        return factory(**kwargs, device=device)
    kind, _, arg = name.partition("_")
    if not arg.isdigit():
        raise ValueError(
            f"unknown graph {name!r}: not in SUITE ({', '.join(SUITE)}) "
            f"and not a chain_<n>/grid_<side>/rmat_<scale>/er_<n> pattern")
    k = int(arg)
    if kind == "chain":
        return chain(k, seed=seed, device=device)
    if kind == "grid":
        return grid2d(k, seed=seed, device=device)
    if kind == "rmat":
        return rmat(k, edge_factor=4, seed=seed, device=device)
    if kind == "er":
        return erdos_renyi(k, seed=seed, device=device)
    raise ValueError(
        f"unknown graph {name!r}: not in SUITE ({', '.join(SUITE)}) "
        f"and not a chain_<n>/grid_<side>/rmat_<scale>/er_<n> pattern")
