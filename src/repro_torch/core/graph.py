"""Graph container: an undirected graph as paired int32 half-edges.

An undirected graph with M edges is stored as 2M directed half-edges so that
``rev(e) = (e + M) % 2M``: half-edge ``i`` and ``i + M`` are the two
directions of one undirected edge. The edge order matters: edge ids decide
which forest edges win a hooking round, and so decide the Euler tour. The
constructors keep the order of ``repro.core.graph.Graph``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another. Raises when the card is wanted and there is none; it never
    drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class Graph:
    """COO undirected graph as paired directed half-edges.

    Attributes:
      n_nodes: number of vertices.
      src, dst: int32[2M] half-edges on one device; ``rev(e) = (e + M) % 2M``.
      padded: the half-edges may hold ids outside [0, n): the sentinel rows
        ``src = dst = n`` of a dynamic forest's edge pool
        (``dynamic.forest.live_graph``). ``connected_components`` clamps
        such ids into [0, n), as the reference's gathers clamp them, before
        any kernel sees them; graphs built by the constructors below hold
        only valid ids and pay nothing.
    """

    n_nodes: int
    src: torch.Tensor
    dst: torch.Tensor
    padded: bool = False

    @property
    def device(self) -> torch.device:
        return self.src.device

    @property
    def n_half_edges(self) -> int:
        return self.src.numel()

    @property
    def n_edges(self) -> int:
        """Number of undirected edges M."""
        return self.n_half_edges // 2

    def rev(self, e: torch.Tensor) -> torch.Tensor:
        """Index of the reverse half-edge."""
        m = self.n_edges
        return (e + m) % (2 * m)

    def clamped(self) -> "Graph":
        """The graph with every id clamped into [0, n), as the reference's
        gathers read it: a ``padded`` graph's sentinel row (n, n) becomes
        the self-loop (n - 1, n - 1), which never crosses components. A
        graph that is not ``padded`` is returned as it is."""
        if not self.padded:
            return self
        n = self.n_nodes
        return Graph(n, torch.clamp(self.src, 0, n - 1),
                     torch.clamp(self.dst, 0, n - 1))

    def to(self, device: str | torch.device) -> "Graph":
        return Graph(self.n_nodes, self.src.to(device), self.dst.to(device),
                     self.padded)

    @staticmethod
    def from_reference_arrays(n_nodes: int, src: np.ndarray, dst: np.ndarray,
                              device: str | torch.device | None = None
                              ) -> "Graph":
        """Rebuild a graph from another implementation's half-edge arrays
        (for example ``np.asarray(jax_graph.src)``), keeping every half-edge
        id."""
        src = np.asarray(src)
        dst = np.asarray(dst)
        if src.shape != dst.shape or src.ndim != 1 or src.size % 2:
            raise ValueError("src/dst must be equal-length 1-D arrays of "
                             f"even length, got {src.shape} and {dst.shape}")
        _check_ids(n_nodes, src, dst)
        dev = resolve_device(device)
        return Graph(n_nodes,
                     torch.from_numpy(src.astype(np.int32)).to(dev),
                     torch.from_numpy(dst.astype(np.int32)).to(dev))

    @staticmethod
    def from_undirected(n_nodes: int, u: np.ndarray, v: np.ndarray,
                        device: str | torch.device | None = None) -> "Graph":
        """Build from M undirected edges (u[i], v[i]); no dedupe."""
        u = np.asarray(u, np.int32)
        v = np.asarray(v, np.int32)
        return Graph.from_reference_arrays(
            n_nodes, np.concatenate([u, v]), np.concatenate([v, u]), device)

    @staticmethod
    def from_numpy_undirected(n_nodes: int, edges: np.ndarray,
                              device: str | torch.device | None = None
                              ) -> "Graph":
        """edges: int array [M, 2]. Removes self-loops and duplicates."""
        edges = np.asarray(edges, dtype=np.int64)
        if edges.size == 0:
            e = np.zeros((0,), np.int32)
            return Graph.from_undirected(n_nodes, e, e, device)
        lo = np.minimum(edges[:, 0], edges[:, 1])
        hi = np.maximum(edges[:, 0], edges[:, 1])
        keep = lo != hi
        lo, hi = lo[keep], hi[keep]
        _, idx = np.unique(lo * n_nodes + hi, return_index=True)
        return Graph.from_undirected(n_nodes, lo[idx], hi[idx], device)


def build_csr(graph: Graph) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """CSR over directed half-edges: (row_ptr[n+1], col[2M], half_edge_id[2M]),
    int32 on the graph's device.

    ``col`` / ``half_edge_id`` are sorted by (src, dst) lexicographically,
    ties in half-edge order: the "circular adjacency list" ordering the
    Euler tour needs.
    """
    n = graph.n_nodes
    src, dst = graph.src.long(), graph.dst.long()
    order = torch.sort(src * max(n, 1) + dst, stable=True).indices
    row_ptr = torch.zeros(n + 1, dtype=torch.int32, device=graph.device)
    row_ptr[1:] = torch.cumsum(degrees(graph.src, n), 0)
    return row_ptr, graph.dst[order], order.to(torch.int32)


def degrees(src: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """int32[n_nodes]: how many of ``src`` name each vertex. As in the
    reference's ``jnp.bincount(src, length=n_nodes)``, a negative id counts
    for vertex 0 and an id from ``n_nodes`` up is not counted."""
    src = src.long().clamp_min(0)
    return torch.bincount(src[src < n_nodes],
                          minlength=n_nodes).to(torch.int32)


def _check_ids(n_nodes: int, src: np.ndarray, dst: np.ndarray) -> None:
    # The kernels index with these ids unchecked; JAX would clamp them.
    if n_nodes >= 2**31:
        raise ValueError(f"n_nodes={n_nodes} does not fit int32 vertex ids")
    for name, a in (("src", src), ("dst", dst)):
        if a.size and (a.min() < 0 or a.max() >= n_nodes):
            raise ValueError(f"{name} holds vertex ids outside [0, {n_nodes})")
