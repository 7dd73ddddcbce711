"""Incremental biconnectivity on the batch-dynamic forest (DESIGN.md §10).

The port of ``repro.dynamic.bcc``. It maintains per-half-edge BCC labels,
bridges and articulation points of the ``DynamicForest``'s live edge pool
across ``apply_batch`` calls, scoped to dirty components the way
``dynamic.tour`` scopes the tour re-ranking.

Why caching is sound (the §10 contract):

  * **Dirty detection is a snapshot diff.** A ``DynamicBCC`` keeps the
    parent and pool tensors it was computed against (``apply_batch`` never
    writes into a state's tensors, so the snapshots stay as they were). At
    refresh time a vertex has changed if its parent differs or it is an
    endpoint (old or new) of a pool slot whose (src, dst, valid, tree)
    differs; a component is dirty iff it holds a changed vertex (closure
    over the new ``state.rep``). This catches non-tree pool edits, which
    the tour's ``dirty`` mask ignores.
  * **Clean components are bit-stable.** GConn labels the aux graph by
    pure-min hooking, so a block's label is its minimum member id: a clean
    component has the same aux subgraph and the same labels.
  * **low/high shift by a per-component δ.** A clean component keeps its
    relative preorder, but its block may slide, so the cached values are
    re-based by ``δ[v] = pre_new[v] − pre_cached[v]``.

The scoped recompute is one ``core.bcc.bcc_from_tour`` call with
``scope=dirty``. ``refresh_bcc(state, cached, incremental=...)`` is
bit-equal to a full recompute either way.

Every ``mode="drop"`` scatter of the reference writes into spread drop
slots (``dynamic.forest._mark``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.bcc import bcc_from_tour
from repro_torch.core.euler import TourNumbering
from repro_torch.dynamic.forest import DynamicForest, _mark, live_graph


@dataclasses.dataclass(frozen=True)
class DynamicBCC:
    """Biconnectivity of the live pool + the snapshots that validate it.

    Attributes (C = pool capacity; half-edge arrays follow the pool's
    ``Graph`` view: slot e < C is pool direction src→dst, e + C its
    reverse):
      n_nodes:      vertex count n.
      parent:       int32[n], the parent snapshot the decomposition is for.
      pool_src, pool_dst: int32[C] pool snapshot (sentinel-padded).
      pool_valid:   bool[C] occupancy snapshot.
      tree_mask:    bool[C] tree-slot snapshot.
      pre:          int32[n] tour preorder the low/high values live in.
      rep:          int32[n] aux-component label per vertex (the BCC label
                    of the tree edge above v; garbage at roots).
      low, high:    int32[n] subtree preorder extremes (DESIGN.md §4).
      articulation: bool[n] cut vertices.
      bridge:       bool[2C] per half-edge (both directions marked).
      edge_bcc:     int32[2C] BCC label per half-edge (−1 on padding).
      n_bcc:        int, number of biconnected components.
      aux_rounds:   int, GConn rounds of the last refresh.
      seg_syncs:    int, low/high doubling levels of the last refresh.
      dirty_count:  int, vertices recomputed by the last refresh (n for a
                    full recompute).

    The fleet's stacked ``DynamicBCC`` (``dynamic.fleet.refresh_bccs``)
    carries a leading tenant axis on every tensor and its four counts as
    int32[T] tensors.
    """

    n_nodes: int
    parent: torch.Tensor
    pool_src: torch.Tensor
    pool_dst: torch.Tensor
    pool_valid: torch.Tensor
    tree_mask: torch.Tensor
    pre: torch.Tensor
    rep: torch.Tensor
    low: torch.Tensor
    high: torch.Tensor
    articulation: torch.Tensor
    bridge: torch.Tensor
    edge_bcc: torch.Tensor
    n_bcc: int
    aux_rounds: int
    seg_syncs: int
    dirty_count: int

    @property
    def n_bridges(self) -> torch.Tensor:
        """0-d int32: undirected bridges (each marks both halves)."""
        return torch.sum(self.bridge, dtype=torch.int32) // 2

    @property
    def n_articulation(self) -> torch.Tensor:
        return torch.sum(self.articulation, dtype=torch.int32)


def _snapshot(state: DynamicForest, tn: TourNumbering, out: dict,
              dirty_count, lanes: int | None = None) -> DynamicBCC:
    if lanes is not None:
        # A union's counts stay int32[T] tensors on the device.
        return DynamicBCC(
            n_nodes=state.n_nodes, parent=state.parent,
            pool_src=state.pool_src, pool_dst=state.pool_dst,
            pool_valid=state.pool_valid, tree_mask=state.tree_mask,
            pre=tn.pre, rep=out["rep"], low=out["low"], high=out["high"],
            articulation=out["articulation"], bridge=out["bridge"],
            edge_bcc=out["edge_bcc"], n_bcc=out["n_bcc"],
            aux_rounds=out["aux_rounds"], seg_syncs=out["seg_syncs"],
            dirty_count=dirty_count)
    return DynamicBCC(
        n_nodes=state.n_nodes, parent=state.parent,
        pool_src=state.pool_src, pool_dst=state.pool_dst,
        pool_valid=state.pool_valid, tree_mask=state.tree_mask,
        pre=tn.pre, rep=out["rep"], low=out["low"], high=out["high"],
        articulation=out["articulation"], bridge=out["bridge"],
        edge_bcc=out["edge_bcc"], n_bcc=int(out["n_bcc"]),
        aux_rounds=int(out["aux_rounds"]), seg_syncs=int(out["seg_syncs"]),
        dirty_count=int(dirty_count))


def _pool_tree_mask(state: DynamicForest) -> torch.Tensor:
    """Per-half-edge tree classification of the pool's Graph view."""
    return torch.cat([state.tree_mask, state.tree_mask])


def _refresh_full(state: DynamicForest, tn: TourNumbering, *,
                  use_kernel: bool | None = None,
                  lanes: int | None = None) -> DynamicBCC:
    """The full recompute. ``lanes``: ``state`` and ``tn`` are a disjoint
    union of that many tenants (``dynamic.fleet``); the counts come back
    int32[lanes], each lane's own."""
    out = bcc_from_tour(live_graph(state), state.parent, tn,
                        tree_mask=_pool_tree_mask(state),
                        use_kernel=use_kernel, lanes=lanes)
    dirty_count = state.n_nodes
    if lanes is not None:
        dirty_count = torch.full((lanes,), state.n_nodes // lanes,
                                 dtype=torch.int32, device=state.device)
    return _snapshot(state, tn, out, dirty_count, lanes)


def _refresh_incremental(state: DynamicForest, tn: TourNumbering,
                         cached: DynamicBCC, *,
                         use_kernel: bool | None = None,
                         lanes: int | None = None) -> DynamicBCC:
    """The dirty-scoped refresh; ``lanes`` as in ``_refresh_full``."""
    n = state.n_nodes
    verts = torch.arange(n, dtype=torch.int32, device=state.device)

    # ---- dirty detection: diff against the cached snapshots ---------------
    changed = state.parent != cached.parent
    slot_changed = ((state.pool_src != cached.pool_src)
                    | (state.pool_dst != cached.pool_dst)
                    | (state.pool_valid != cached.pool_valid)
                    | (state.tree_mask != cached.tree_mask))
    for ends in (cached.pool_src, cached.pool_dst,
                 state.pool_src, state.pool_dst):
        # The sentinel end n of an empty slot is dropped, as in the
        # reference.
        changed = _mark(n, ends, slot_changed & (ends < n), changed)
    # Closure over the new components: merges and splits both leave a
    # changed vertex in every affected new component.
    comp_changed = _mark(n, state.rep, changed)
    dirty = comp_changed[state.rep.long()]
    dirty_count = (torch.sum(dirty, dtype=torch.int32) if lanes is None
                   else dirty.view(lanes, -1).sum(1, dtype=torch.int32))

    # ---- scoped recompute + merge with the cache --------------------------
    out = bcc_from_tour(live_graph(state), state.parent, tn,
                        tree_mask=_pool_tree_mask(state), scope=dirty,
                        use_kernel=use_kernel, lanes=lanes)

    # Per-vertex merges; clean low/high re-base by δ = pre_new − pre_cached.
    delta = tn.pre - cached.pre
    rep = torch.where(dirty, out["rep"], cached.rep)
    low = torch.where(dirty, out["low"], cached.low + delta)
    high = torch.where(dirty, out["high"], cached.high + delta)
    articulation = torch.where(dirty, out["articulation"],
                               cached.articulation)

    # Per-half-edge merges: a live slot in a clean component keeps its
    # cached values; dirty and padding slots take the scoped result (which
    # already holds the −1/False padding values of a full recompute).
    src2 = torch.cat([state.pool_src, state.pool_dst])
    valid2 = torch.cat([state.pool_valid, state.pool_valid])
    clean_slot = valid2 & ~dirty[torch.clamp(src2, 0, n - 1).long()]
    edge_bcc = torch.where(clean_slot, cached.edge_bcc, out["edge_bcc"])
    bridge = torch.where(clean_slot, cached.bridge, out["bridge"])

    # The global count from the merged labels (the scoped run's own count
    # treats every clean vertex as a singleton block).
    nonroot = tn.parent != verts
    block = nonroot & (rep == verts)
    n_bcc = (torch.sum(block, dtype=torch.int32) if lanes is None
             else block.view(lanes, -1).sum(1, dtype=torch.int32))

    out = dict(rep=rep, low=low, high=high, articulation=articulation,
               bridge=bridge, edge_bcc=edge_bcc, n_bcc=n_bcc,
               aux_rounds=out["aux_rounds"], seg_syncs=out["seg_syncs"])
    return _snapshot(state, tn, out, dirty_count, lanes)


def refresh_bcc(state: DynamicForest, cached: DynamicBCC | None = None, *,
                tour: TourNumbering | None = None, incremental: bool = True,
                use_kernel: bool | None = None) -> DynamicBCC:
    """Refresh the pool's biconnectivity after ``apply_batch`` calls.

    A thin wrapper kept for the reference's callers: the canonical entry
    is ``dynamic.view.refresh_bcc_once`` (or ``ForestView.refresh``).

    Args:
      state: the dynamic forest (spanning invariant restored).
      cached: the ``DynamicBCC`` of the previous refresh; ``None`` forces a
        full recompute.
      tour: the current ``TourNumbering`` of ``state.parent``; ``None``
        computes a full numbering here.
      incremental: ``False`` always recomputes from scratch. The result is
        bit-equal either way.
      use_kernel: see ``repro_torch.kernels.kernel_wanted``.

    Returns:
      DynamicBCC, to pass back as ``cached``. ``state.dirty`` is left to
      the tour refresh; dirty tracking here is the snapshot diff.
    """
    from repro_torch.dynamic.view import refresh_bcc_once

    return refresh_bcc_once(state, cached, tour=tour,
                            incremental=incremental, use_kernel=use_kernel)
