"""Tarjan–Vishkin biconnectivity on top of any RST flavor (DESIGN.md §4).

The port of ``repro.core.bcc``: the consumer the paper builds rooted
spanning trees for. The Euler-tour formulation (Tarjan & Vishkin 1985):

  1. **Tour numbering**: ``euler.tour_numbering`` turns the flavor's parent
     array into dense preorder numbers and subtree sizes, so subtree(v) is
     the interval ``[pre[v], pre[v] + size[v])``.
  2. **low/high**: per vertex, the extreme preorder numbers reachable from
     its subtree over one non-tree edge, as two min/max range reductions
     over the preorder-ordered array (``compress.segment_reduce``, the
     segment_table kernel on the card).
  3. **Auxiliary graph**: one vertex per tree edge (named by its child);
     two tree edges share a block iff connected under the rules
       R1  non-tree edge {u, w}, u and w unrelated: aux(u) — aux(w);
       R2  tree edge (w = parent(v), v), low(v) < pre(w): aux(v) — aux(w);
       R3  tree edge (w, v), high(v) ≥ pre(w) + size(w): aux(v) — aux(w);
     labelled by GConn (``connectivity.connected_components``).
  4. **Readout**: per-half-edge block labels, bridges and articulation
     points.

The aux graph keeps the reference's fixed shape, 2M + 2n half-edges, one
per rule slot. The reference fills inactive slots with ``src = dst = n``,
which its connectivity gathers clamp to vertex n − 1; here they are the
self-loop ``(n − 1, n − 1)`` itself, which never crosses and so gives the
same representatives and rounds without an out-of-range id on the card.

Every scatter whose inactive writers the reference sends to one drop slot
(index n) writes into n spread drop slots instead, cut off after: on the
card, writers that share one address queue on it.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.compress import (_table_levels, segment_reduce,
                                       segment_reduce_scoped)
from repro_torch.core.connectivity import connected_components
from repro_torch.core.euler import TourNumbering, tour_numbering
from repro_torch.core.graph import Graph, resolve_device
from repro_torch.core.rst import METHODS, rooted_spanning_tree

INF32 = torch.iinfo(torch.int32).max


@dataclasses.dataclass(frozen=True)
class BCCResult:
    """Biconnectivity decomposition of a graph.

    Attributes:
      articulation: bool[n], cut vertices.
      bridge:       bool[2M] per half-edge (both directions of a bridge).
      edge_bcc:     int32[2M] block label per half-edge (an aux-graph
                    representative; −1 on edges outside the spanned part).
      n_bcc:        number of biconnected components.
      pre, size:    int32[n] tour numbering.
      low, high:    int32[n] subtree preorder extremes over one non-tree
                    edge.
      rst_steps:    parallel steps of the RST build (levels or rounds).
      aux_rounds:   GConn rounds on the aux graph.
      seg_syncs:    doubling levels of the two low/high tables.
      method:       the ``rst_flavor`` that built the tree.

    From ``bcc_batch`` every tensor carries a leading batch axis and the
    four counts are int32[B] tensors.
    """

    articulation: torch.Tensor
    bridge: torch.Tensor
    edge_bcc: torch.Tensor
    n_bcc: int
    pre: torch.Tensor
    size: torch.Tensor
    low: torch.Tensor
    high: torch.Tensor
    rst_steps: int
    aux_rounds: int
    seg_syncs: int
    method: str = "gconn_euler"


def bcc_from_tour(graph: Graph, parent: torch.Tensor, tn: TourNumbering, *,
                  tree_mask: torch.Tensor | None = None,
                  scope: torch.Tensor | None = None,
                  use_kernel: bool | None = None) -> dict:
    """Tarjan–Vishkin core driven by an existing ``TourNumbering``.

    Args:
      graph: Graph on the device of ``parent``; it may be a multigraph only
        if ``tree_mask`` is given.
      parent: int32[n] rooted forest ``tn`` was built from (roots
        self-point; negative entries mark unspanned vertices).
      tn: ``euler.TourNumbering`` of ``parent``; not recomputed here.
      tree_mask: optional bool[2M] explicit tree classification (both
        halves of a tree edge True). ``None`` infers tree edges from
        ``parent``, which is sound on simple graphs only.
      scope: optional bool[n] component-closed activity mask. Edges and
        vertices outside it are treated as padding; their outputs are
        garbage for the caller to merge from a cache, the low/high tables
        build only to the longest scoped component
        (``segment_reduce_scoped``), and ``n_bcc`` is meaningful only
        without a scope.
      use_kernel: see ``repro_torch.kernels.kernel_wanted`` (the scoped
        low/high build has no kernel).

    Returns:
      dict with articulation, bridge, edge_bcc, rep (int32[n] aux label per
      vertex), n_bcc, low, high, aux_rounds, seg_syncs.
    """
    n = graph.n_nodes
    dev = parent.device
    verts = torch.arange(n, dtype=torch.int32, device=dev)
    pre, size, par = tn.pre, tn.size, tn.parent
    nonroot = par != verts
    spanned = parent >= 0

    src, dst = graph.src, graph.dst
    pad = (src >= n) | (dst >= n) | (src < 0) | (dst < 0)
    sc = torch.clamp(src, 0, n - 1).long()
    dc = torch.clamp(dst, 0, n - 1).long()
    # Edges touching unspanned vertices lie outside the decomposed part.
    pad = pad | ~spanned[sc] | ~spanned[dc]
    if scope is None:
        in_scope = torch.ones(n, dtype=torch.bool, device=dev)
    else:
        in_scope = scope
        pad = pad | ~in_scope[sc] | ~in_scope[dc]
    if tree_mask is None:
        is_tree = ~pad & ((par[dc] == sc) | (par[sc] == dc))
    else:
        is_tree = ~pad & tree_mask
    nontree = ~pad & ~is_tree

    # Own preorder number, and the extremes over one non-tree edge.
    m2 = src.numel()
    drop = n + torch.arange(m2, device=dev) % max(n, 1)
    tgt = torch.where(nontree, sc, drop)
    pre_dc = pre[dc]
    loc_low = torch.cat([pre, pre]).scatter_reduce_(
        0, tgt, torch.where(nontree, pre_dc, INF32), "amin")[:n]
    loc_high = torch.cat([pre, pre]).scatter_reduce_(
        0, tgt, torch.where(nontree, pre_dc, -1), "amax")[:n]

    # Subtrees are contiguous in preorder: two range reductions.
    pre64 = pre.long()
    a_low = torch.zeros_like(pre)
    a_low[pre64] = loc_low
    a_high = torch.zeros_like(pre)
    a_high[pre64] = loc_high
    if scope is None:
        low = segment_reduce(a_low, pre, tn.last, "min",
                             use_kernel=use_kernel)
        high = segment_reduce(a_high, pre, tn.last, "max",
                              use_kernel=use_kernel)
        seg_syncs = 2 * _table_levels(n)
    else:
        low, s_lo = segment_reduce_scoped(a_low, pre, tn.last, in_scope,
                                          "min", return_syncs=True)
        high, s_hi = segment_reduce_scoped(a_high, pre, tn.last, in_scope,
                                           "max", return_syncs=True)
        seg_syncs = s_lo + s_hi

    # Aux edges. R1: unrelated non-tree edges, once per undirected edge
    # (the half with the smaller source preorder).
    pre_sc = pre[sc]
    src_anc = (pre_sc <= pre_dc) & (pre_dc < pre_sc + size[sc])
    r1 = nontree & (pre_sc < pre_dc) & ~src_anc
    # R2/R3: tree edge (w = parent(v), v) joins the tree edge above w.
    w = par.long()
    w_nonroot = par[w] != par
    r2 = nonroot & in_scope & w_nonroot & (low < pre[w])
    r3 = nonroot & in_scope & w_nonroot & (high >= pre[w] + size[w])
    # Inactive slots: the self-loop (n − 1, n − 1), the vertex JAX's
    # clamped gathers read for the reference's sentinel n.
    last_v = n - 1
    aux_src = torch.cat([torch.where(r1, src, last_v),
                         torch.where(r2, verts, last_v),
                         torch.where(r3, verts, last_v)])
    aux_dst = torch.cat([torch.where(r1, dst, last_v),
                         torch.where(r2, par, last_v),
                         torch.where(r3, par, last_v)])
    rep, _forest, aux_rounds = connected_components(
        Graph(n_nodes=n, src=aux_src, dst=aux_dst), use_kernel=use_kernel)

    # Every edge belongs to the block of the tree edge above its deeper
    # (larger-preorder) endpoint.
    deeper = torch.where(pre_dc > pre_sc, dc, sc)
    edge_bcc = torch.where(pad, -1, rep[deeper])

    # Bridges: no non-tree edge escapes subtree(v) in either direction.
    bridge_v = nonroot & (low >= pre) & (high < pre + size)
    bridge = is_tree & bridge_v[deeper]

    articulation = _articulation(par, rep)

    # One block per aux component that holds a tree edge; pure-min hooking
    # makes its representative its smallest (non-root) member.
    n_bcc = int(torch.sum(nonroot & (rep == verts)))

    return dict(articulation=articulation, bridge=bridge, edge_bcc=edge_bcc,
                rep=rep, n_bcc=n_bcc, low=low, high=high,
                aux_rounds=aux_rounds, seg_syncs=seg_syncs)


def _articulation(par: torch.Tensor, rep: torch.Tensor) -> torch.Tensor:
    """bool[n]: a vertex whose children's aux labels differ from its own
    (at a root: from each other). Non-tree edges add no label that the
    tree edges do not carry, so the children's labels suffice.

    Two scatters (min, max) of every child's label into its parent: all of
    a hub's children land on the hub, a contention that is the data's.
    Roots write into their own drop slot n + v.
    """
    n = par.numel()
    verts = torch.arange(n, dtype=par.dtype, device=par.device)
    nonroot = par != verts
    ptgt = torch.where(nonroot, par, verts + n).long()
    mn = torch.full((2 * n,), INF32, dtype=torch.int32, device=par.device)
    mn.scatter_reduce_(0, ptgt, torch.where(nonroot, rep, INF32), "amin")
    mx = torch.full((2 * n,), -1, dtype=torch.int32, device=par.device)
    mx.scatter_reduce_(0, ptgt, torch.where(nonroot, rep, -1), "amax")
    mn, mx = mn[:n], mx[:n]
    has_child = mn != INF32
    return torch.where(nonroot, has_child & ((mn != rep) | (mx != rep)),
                       has_child & (mn != mx))


def bcc_from_parent(graph: Graph, parent: torch.Tensor, *,
                    use_kernel: bool | None = None) -> dict:
    """Tarjan–Vishkin biconnectivity from an already-built parent array.

    Numbers the tour, then runs ``bcc_from_tour``. Vertices the parent
    array leaves unspanned (BFS's −1) are outside the decomposition: their
    edges carry label −1, are never bridges, and they are never
    articulation points.

    Returns:
      dict with the ``BCCResult`` fields except ``rst_steps`` and ``method``.
    """
    tn = tour_numbering(parent, use_kernel=use_kernel)
    out = bcc_from_tour(graph, parent, tn, use_kernel=use_kernel)
    out.pop("rep")
    return dict(pre=tn.pre, size=tn.size, **out)


def biconnectivity(graph: Graph, root=0, *, rst_flavor: str = "gconn_euler",
                   use_kernel: bool | None = None,
                   device: str | torch.device | None = None,
                   **rst_kwargs) -> BCCResult:
    """Biconnected components, bridges and articulation points of ``graph``.

    ``rst_flavor`` picks the RST pipeline (``"bfs"``, ``"gconn_euler"`` or
    ``"pr_rst"``) whose tree the Tarjan–Vishkin layer consumes; the result
    does not depend on it on connected graphs, its cost does. ``bfs``
    spans only the root's component, so on a disconnected graph it
    decomposes that component alone.

    Runs on ``device``: the card unless the caller passes another; the
    graph is moved there. ``use_kernel`` follows
    ``repro_torch.kernels.kernel_wanted``; ``rst_kwargs`` go to the flavor.
    """
    if rst_flavor not in METHODS:
        raise ValueError(
            f"unknown rst_flavor {rst_flavor!r}; choose from {METHODS}")
    graph = graph.to(resolve_device(device))
    res = rooted_spanning_tree(graph, root, method=rst_flavor,
                               use_kernel=use_kernel, device=graph.device,
                               **rst_kwargs)
    out = bcc_from_parent(graph, res.parent, use_kernel=use_kernel)
    return BCCResult(rst_steps=res.steps, method=rst_flavor, **out)


def bcc_batch(src: torch.Tensor, dst: torch.Tensor, roots: torch.Tensor, *,
              n_nodes: int, rst_flavor: str = "gconn_euler",
              use_kernel: bool | None = None,
              device: str | torch.device | None = None) -> BCCResult:
    """Biconnectivity of many same-shape graphs, one after another.

    The reference vmaps ``biconnectivity``; here a host loop runs it per
    graph and stacks the fields, which gives the vmap lanes' values.

    Args:
      src, dst: int32[B, 2M] stacked half-edge lists, ids in [0, n_nodes).
      roots: int32[B] root per graph.
      n_nodes: vertex count shared by the batch.

    Returns:
      BCCResult whose tensors carry a leading batch axis; ``n_bcc``,
      ``rst_steps``, ``aux_rounds`` and ``seg_syncs`` are int32[B].
    """
    dev = resolve_device(device)
    src, dst = src.to(dev), dst.to(dev)
    if src.numel() and bool((torch.minimum(src.min(), dst.min()) < 0)
                            | (torch.maximum(src.max(), dst.max())
                               >= n_nodes)):
        raise ValueError(f"bcc_batch: vertex ids outside [0, {n_nodes})")
    outs = [biconnectivity(Graph(n_nodes, src[i], dst[i]), int(roots[i]),
                           rst_flavor=rst_flavor, use_kernel=use_kernel,
                           device=dev)
            for i in range(src.shape[0])]
    fields = {}
    for f in dataclasses.fields(BCCResult):
        if f.name == "method":
            continue
        vals = [getattr(o, f.name) for o in outs]
        fields[f.name] = (torch.stack(vals) if isinstance(vals[0],
                                                          torch.Tensor)
                          else torch.tensor(vals, dtype=torch.int32,
                                            device=dev))
    return BCCResult(method=rst_flavor, **fields)
