"""Rooted-spanning-tree entry point.

``rooted_spanning_tree(graph, root, method=...)`` returns the parent array
plus the step and sync counts the paper's analysis turns on, for the
paper's three strategies: ``"gconn_euler"`` (connectivity → spanning
forest → Euler-tour rooting, the headline pipeline), ``"bfs"`` (the
edge-centric baseline) and ``"pr_rst"`` (path-reversal rounds).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

from repro_torch.core.bfs import bfs_rst
from repro_torch.core.compress import rank_to_root
from repro_torch.core.connectivity import connected_components
from repro_torch.core.euler import euler_tour_root
from repro_torch.core.graph import Graph, resolve_device
from repro_torch.core.pr_rst import pr_rst

Method = Literal["bfs", "gconn_euler", "pr_rst"]
METHODS: tuple[str, ...] = ("bfs", "gconn_euler", "pr_rst")


@dataclasses.dataclass(frozen=True)
class RSTResult:
    parent: torch.Tensor                    # int32[n]
    method: str
    steps: int                              # parallel steps (levels, rounds)
    dist: torch.Tensor | None = None        # bfs: int32[n] hop distances
    rep: torch.Tensor | None = None         # gconn: int32[n] component reps
    forest_mask: torch.Tensor | None = None  # gconn: bool[2M] forest edges
    compress_syncs: int | None = None       # gconn, pr_rst: compress checks
    rank_syncs: int | None = None           # gconn: list-ranking checks


def forest_edges(graph: Graph, forest_mask: torch.Tensor):
    """Compact the marked half-edges into n-1 fixed slots.

    Returns ``(fu, fv, valid)``: int32[t] endpoints and bool[t] validity,
    t = max(n-1, 1). Empty slots carry ``fu == fv == n``: they index one
    past the end of the endpoint arrays, where ``n`` is appended.
    """
    n = graph.n_nodes
    m2 = graph.n_half_edges
    t = max(n - 1, 1)
    marked = torch.nonzero(forest_mask).flatten()[:t]
    slots = torch.full((t,), m2, dtype=torch.int64, device=graph.device)
    slots[:marked.numel()] = marked
    sentinel = graph.src.new_full((1,), n)
    fu = torch.cat([graph.src, sentinel])[slots]
    fv = torch.cat([graph.dst, sentinel])[slots]
    return fu, fv, slots < m2


def gconn_euler_rst(graph: Graph, root, *, use_kernel: bool | None = None,
                    lanes: int | None = None) -> RSTResult:
    """The paper's winning pipeline: connectivity → forest → Euler rooting.

    ``use_kernel`` reaches all three kernels: hooking, GConn's shortcutting
    (pointer_jump) and the Euler list ranking (list_rank). With ``lanes``
    the graph is a disjoint union of that many equal lanes of vertices
    (``core.bcc.bcc_batch``), ``root`` an int32 tensor of one root a lane,
    and ``steps`` int32[lanes]; a tree and its root fix the rooted parents,
    so each lane's parents are its own call's.
    """
    n = graph.n_nodes
    rep, forest_mask, rounds, compress_syncs = connected_components(
        graph, use_kernel=use_kernel, return_syncs=True, lanes=lanes)
    fu, fv, valid = forest_edges(graph, forest_mask)

    # The component holding ``root`` is rooted at ``root``; others at
    # their representative.
    if lanes is None:
        comp_root = torch.where(rep == rep[root], int(root), rep)
    else:
        lane_rep = rep.view(lanes, -1)
        root = root.to(rep.dtype)
        comp_root = torch.where(lane_rep == rep[root.long()][:, None],
                                root[:, None], lane_rep).view(-1)

    parent, rank_syncs = euler_tour_root(n, fu, fv, valid, comp_root,
                                         use_kernel=use_kernel,
                                         return_syncs=True)
    return RSTResult(parent=parent, method="gconn_euler", steps=rounds,
                     rep=rep, forest_mask=forest_mask,
                     compress_syncs=compress_syncs, rank_syncs=rank_syncs)


def rooted_spanning_tree(graph: Graph, root, method: Method = "gconn_euler",
                         *, use_kernel: bool | None = None,
                         device: str | torch.device | None = None,
                         **kwargs) -> RSTResult:
    """Build a rooted spanning tree with the chosen strategy.

    Runs on ``device``: the card unless the caller passes another (it
    raises when the card is wanted and missing). The graph is moved there
    if it lies elsewhere. ``use_kernel`` follows
    ``repro_torch.kernels.kernel_wanted``. ``kwargs`` go to the method:
    ``max_levels`` for ``bfs_rst``; ``max_rounds``, ``alternate_hooking``
    and ``n_jumps`` for ``pr_rst``; ``gconn_euler`` takes none.

    Steps: BFS levels (the tree's depth), or rounds minus one. ``bfs``
    spans only the root's component. A ``padded`` graph (a dynamic forest's
    pool, ``dynamic.forest.live_graph``) is clamped first.
    """
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; choose from {METHODS}")
    # A padded graph's sentinel rows become self-loops, as the reference's
    # clamped gathers read them (``Graph.clamped``).
    graph = graph.to(resolve_device(device)).clamped()
    if method == "bfs":
        parent, dist, levels = bfs_rst(graph, root, use_kernel=use_kernel,
                                       **kwargs)
        return RSTResult(parent=parent, method=method, steps=levels,
                         dist=dist)
    if method == "pr_rst":
        parent, rounds, syncs = pr_rst(graph, root, use_kernel=use_kernel,
                                       return_syncs=True, **kwargs)
        return RSTResult(parent=parent, method=method, steps=rounds,
                         compress_syncs=syncs)
    return gconn_euler_rst(graph, root, use_kernel=use_kernel, **kwargs)


def tree_depth(parent: torch.Tensor) -> int:
    """Max depth of the rooted forest (engine pointer doubling)."""
    depth, _root = rank_to_root(parent)
    return int(torch.max(depth))
